"""Minimal GeoTIFF (SRTM-style) reader and writer, host side.

Native replacement for the ``geotiff-rs`` crate (reference
src/terrain/geotiff.rs): SRTM-style 1°×1° tiles georeferenced by filename
(``N49E021``-pattern regex, geotiff.rs:16-31), square post grids with
inclusive edges (3601×3601 for 1″), elevation int16/float.

Supports the baseline TIFF feature set these tiles actually use: both byte
orders, strip-based storage, no compression or Deflate (zlib), int/uint/float
samples. Anything else raises with a clear message.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path

import numpy as np

_NAME_RE = re.compile(r"(N|S)(\d+)(E|W)(\d+)")

_TAG_WIDTH = 256
_TAG_LENGTH = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_STRIP_OFFSETS = 273
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_SAMPLE_FORMAT = 339

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d"}


def coords_from_name(path) -> tuple | None:
    """Tile SW corner from an ``N49E021``-style filename (geotiff.rs:16-31)."""
    m = _NAME_RE.search(Path(path).name)
    if not m:
        return None
    lat = int(m.group(2)) * (-1 if m.group(1) == "S" else 1)
    lon = int(m.group(4)) * (-1 if m.group(3) == "W" else 1)
    return lat, lon


def _read_ifd_values(buf, endian, type_, count, value_field):
    size = _TYPE_SIZES[type_] * count
    if size <= 4:
        data = value_field[:size]
    else:
        offset = struct.unpack(endian + "I", value_field)[0]
        data = buf[offset : offset + size]
    fmt = _TYPE_FMT.get(type_)
    if fmt is None:
        raise ValueError(f"unsupported TIFF field type {type_}")
    return list(struct.unpack(f"{endian}{count}{fmt}", data))


def read_geotiff(path) -> np.ndarray:
    """Returns elevation[rows, cols] float32, row 0 = NORTH edge (image order).

    Callers index geographically; ``store.Tile`` flips to south-first rows.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        endian = "<"
    elif buf[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic, ifd_off = struct.unpack(endian + "HI", buf[2:8])
    if magic != 42:
        raise ValueError(f"{path}: bad TIFF magic {magic}")

    tags = {}
    (n_entries,) = struct.unpack(endian + "H", buf[ifd_off : ifd_off + 2])
    for i in range(n_entries):
        e = ifd_off + 2 + 12 * i
        tag, type_, count = struct.unpack(endian + "HHI", buf[e : e + 8])
        if tag in (
            _TAG_WIDTH, _TAG_LENGTH, _TAG_BITS, _TAG_COMPRESSION,
            _TAG_STRIP_OFFSETS, _TAG_ROWS_PER_STRIP, _TAG_STRIP_COUNTS,
            _TAG_SAMPLE_FORMAT,
        ):
            tags[tag] = _read_ifd_values(buf, endian, type_, count, buf[e + 8 : e + 12])

    width = tags[_TAG_WIDTH][0]
    height = tags[_TAG_LENGTH][0]
    bits = tags.get(_TAG_BITS, [16])[0]
    compression = tags.get(_TAG_COMPRESSION, [1])[0]
    sample_format = tags.get(_TAG_SAMPLE_FORMAT, [2])[0]  # SRTM default: int
    rows_per_strip = tags.get(_TAG_ROWS_PER_STRIP, [height])[0]
    offsets = tags[_TAG_STRIP_OFFSETS]
    counts = tags.get(_TAG_STRIP_COUNTS, [width * height * bits // 8])

    if compression == 1:
        raw = b"".join(buf[o : o + c] for o, c in zip(offsets, counts))
    elif compression in (8, 32946):  # Deflate
        raw = b"".join(zlib.decompress(buf[o : o + c]) for o, c in zip(offsets, counts))
    else:
        raise ValueError(f"{path}: unsupported TIFF compression {compression}")
    del rows_per_strip

    if sample_format == 2 and bits == 16:
        dt = endian + "i2"
    elif sample_format == 1 and bits == 16:
        dt = endian + "u2"
    elif sample_format == 3 and bits == 32:
        dt = endian + "f4"
    elif sample_format == 2 and bits == 32:
        dt = endian + "i4"
    else:
        raise ValueError(f"{path}: unsupported sample format {sample_format}/{bits}")
    arr = np.frombuffer(raw, dtype=dt, count=width * height).reshape(height, width)
    return arr.astype(np.float32)


def write_geotiff(path, elev: np.ndarray):
    """Write a minimal uncompressed little-endian int16 TIFF (north-up rows).

    ``elev``: [rows, cols], row 0 = north edge (standard image orientation).
    Used for synthetic fixtures; georeferencing is by filename, matching the
    reference's behavior (geotiff.rs:16-42).
    """
    elev = np.asarray(elev)
    h, w = elev.shape
    data = elev.astype("<i2").tobytes()
    header = b"II" + struct.pack("<HI", 42, 8)
    entries = []
    data_offset = 8 + 2 + 9 * 12 + 4

    def entry(tag, type_, count, value):
        return struct.pack("<HHII", tag, type_, count, value)

    entries.append(entry(_TAG_WIDTH, 4, 1, w))
    entries.append(entry(_TAG_LENGTH, 4, 1, h))
    entries.append(entry(_TAG_BITS, 3, 1, 16))
    entries.append(entry(_TAG_COMPRESSION, 3, 1, 1))
    entries.append(entry(262, 3, 1, 1))  # PhotometricInterpretation
    entries.append(entry(_TAG_STRIP_OFFSETS, 4, 1, data_offset))
    entries.append(entry(_TAG_ROWS_PER_STRIP, 4, 1, h))
    entries.append(entry(_TAG_STRIP_COUNTS, 4, 1, len(data)))
    entries.append(entry(_TAG_SAMPLE_FORMAT, 3, 1, 2))
    ifd = struct.pack("<H", len(entries)) + b"".join(entries) + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(header + ifd + data)
