"""DTED reader (MIL-PRF-89020B), host side.

Native replacement for the ``dted`` Rust crate used by the reference
(src/terrain/mod.rs:4,24,86; src/terrain/tile.rs:11-31). Pure numpy; the
format is simple: UHL(80) + DSI(648) + ACC(2700) headers followed by one
record per longitude line, elevations as big-endian *signed-magnitude* int16.
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
