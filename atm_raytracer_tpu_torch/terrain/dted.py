"""DTED reader and writer (MIL-PRF-89020B), host side.

Native replacement for the ``dted`` Rust crate used by the reference
(src/terrain/mod.rs:4,24,86; src/terrain/tile.rs:11-31). Pure numpy; the
format is simple: UHL(80) + DSI(648) + ACC(2700) headers followed by one
record per longitude line, elevations as big-endian *signed-magnitude* int16.
The writer builds synthetic tiles for tests and ``chip_smoke.py``; its bytes
are those of the JAX package's writer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_UHL_LEN = 80
_DSI_LEN = 648
_ACC_LEN = 2700
_DATA_OFFSET = _UHL_LEN + _DSI_LEN + _ACC_LEN
VOID = -32767


@dataclasses.dataclass(frozen=True)
class DtedHeader:
    origin_lat: float  # degrees of the south-west corner
    origin_lon: float
    n_lon: int  # number of longitude lines
    n_lat: int  # number of latitude points per line


def _parse_angle(b: bytes) -> float:
    """DDDMMSS.?H or DDMMSS H fields: degrees+minutes+seconds + hemisphere."""
    s = b.decode("ascii")
    hemi = s[-1]
    digits = s[:-1]
    # longitude: DDDMMSS, latitude: DDDMMSS too in UHL (8 chars incl hemi)
    sec = float(digits[-2:])
    minute = float(digits[-4:-2])
    deg = float(digits[:-4])
    val = deg + minute / 60.0 + sec / 3600.0
    if hemi in ("S", "W"):
        val = -val
    return val


def read_dted_header(path) -> DtedHeader:
    with open(path, "rb") as f:
        uhl = f.read(_UHL_LEN)
    if len(uhl) < _UHL_LEN or uhl[:4] != b"UHL1":
        raise ValueError(f"{path}: not a DTED file (no UHL1 sentinel)")
    origin_lon = _parse_angle(uhl[4:12])
    origin_lat = _parse_angle(uhl[12:20])
    n_lon = int(uhl[47:51])
    n_lat = int(uhl[51:55])
    return DtedHeader(origin_lat, origin_lon, n_lon, n_lat)


def read_dted(path):
    """Returns (header, elevations[n_lat, n_lon] float32, south-to-north rows).

    elevations[i, j] = post at (origin_lat + i/(n_lat-1), origin_lon + j/(n_lon-1)).
    Void posts (-32767) are mapped to 0.0 (the reference pipeline treats
    missing data as sea level via unwrap_or(0.0)).
    """
    hdr = read_dted_header(path)
    with open(path, "rb") as f:
        raw = f.read()
    rec_len = 12 + 2 * hdr.n_lat  # sentinel+count(4) + lon(2) + lat(2) + data + cksum(4)
    data = raw[_DATA_OFFSET : _DATA_OFFSET + rec_len * hdr.n_lon]
    if len(data) < rec_len * hdr.n_lon:
        raise ValueError(f"{path}: truncated DTED data section")
    arr = np.frombuffer(data, dtype=np.uint8).reshape(hdr.n_lon, rec_len)
    if not np.all(arr[:, 0] == 0xAA):
        raise ValueError(f"{path}: bad data record sentinel")
    words = arr[:, 8 : 8 + 2 * hdr.n_lat].copy().view(">u2").astype(np.int64)
    # signed magnitude: high bit = negative
    neg = (words & 0x8000) != 0
    vals = np.where(neg, -(words & 0x7FFF), words)
    vals = np.where(vals == VOID, 0, vals)
    # record r = longitude line r (west→east); within record: south→north
    elev = vals.reshape(hdr.n_lon, hdr.n_lat).T.astype(np.float32)
    return hdr, elev


def _format_angle_lon(deg: float) -> bytes:
    hemi = b"W" if deg < 0 else b"E"
    d = abs(deg)
    dd = int(d)
    mm = int((d - dd) * 60)
    ss = int(round((d - dd - mm / 60) * 3600))
    return f"{dd:03d}{mm:02d}{ss:02d}".encode() + hemi


def _format_angle_lat(deg: float) -> bytes:
    hemi = b"S" if deg < 0 else b"N"
    d = abs(deg)
    dd = int(d)
    mm = int((d - dd) * 60)
    ss = int(round((d - dd - mm / 60) * 3600))
    return f"{dd:03d}{mm:02d}{ss:02d}".encode() + hemi


def write_dted(path, origin_lat: float, origin_lon: float, elev: np.ndarray):
    """Write a minimal but spec-conformant DTED tile.

    elev: [n_lat, n_lon] int-valued meters, row 0 = south edge.
    """
    n_lat, n_lon = elev.shape
    lon_interval = int(round(36000 / max(n_lon - 1, 1)))  # tenths of arcsec
    lat_interval = int(round(36000 / max(n_lat - 1, 1)))
    uhl = bytearray(b" " * _UHL_LEN)
    uhl[0:4] = b"UHL1"
    uhl[4:12] = _format_angle_lon(origin_lon)
    uhl[12:20] = _format_angle_lat(origin_lat)
    uhl[20:24] = f"{lon_interval:04d}".encode()
    uhl[24:28] = f"{lat_interval:04d}".encode()
    uhl[28:32] = b"0000"  # absolute vertical accuracy
    uhl[32:35] = b"U  "  # security
    uhl[35:47] = b" " * 12
    uhl[47:51] = f"{n_lon:04d}".encode()
    uhl[51:55] = f"{n_lat:04d}".encode()
    uhl[55:56] = b"0"
    dsi = b"DSI" + b" " * (_DSI_LEN - 3)
    acc = b"ACC" + b" " * (_ACC_LEN - 3)

    vals = np.asarray(elev, np.int64)
    mag = np.where(vals < 0, (-vals) | 0x8000, vals).astype(">u2")
    records = []
    for j in range(n_lon):
        body = bytearray()
        body.append(0xAA)
        body += int(j).to_bytes(3, "big")
        body += int(j).to_bytes(2, "big")
        body += (0).to_bytes(2, "big")
        body += mag[:, j].tobytes()
        checksum = sum(body) & 0xFFFFFFFF
        body += checksum.to_bytes(4, "big")
        records.append(bytes(body))
    with open(path, "wb") as f:
        f.write(bytes(uhl))
        f.write(dsi)
        f.write(acc)
        for r in records:
            f.write(r)
