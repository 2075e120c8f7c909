"""ctypes bindings of the native (C++) tile loaders.

``native/dted_loader.cpp`` parses DTED tiles and ``native/geotiff_loader.cpp``
decodes baseline GeoTIFF tiles, each batch with one worker thread per tile
(up to ``max_threads``): the counterpart of the reference's ``dted`` and
``geotiff-rs`` crates, batched. Their output is bit-equal to the Python
parsers ``terrain.dted.read_dted`` and ``terrain.geotiff.read_geotiff``
(flipped to south-first rows). Both libraries are built by g++ at first use
(``_kernels.LOADERS``). Where one cannot be built (no g++, or no ``zlib.h``
for the GeoTIFF loader), ``available()`` / ``gtif_available()`` print one
line naming the build error and return False, and the store reads that
format with the Python parsers, as the JAX package does without its
libraries.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import List, Optional, Tuple

import numpy as np

from .. import _kernels

_C_INT_P = ctypes.POINTER(ctypes.c_int)
_C_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_C_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def _bind(lib: ctypes.CDLL, name: str, argtypes, restype) -> None:
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype


@functools.cache
def _dted() -> ctypes.CDLL:
    lib = _kernels.DTED_LOADER.load()
    _bind(lib, "dted_probe", [ctypes.c_char_p, _C_DOUBLE_P, _C_DOUBLE_P, _C_INT_P, _C_INT_P],
          ctypes.c_int)
    _bind(lib, "dted_load_batch", [ctypes.c_char_p, ctypes.c_int, _C_FLOAT_P, _C_DOUBLE_P,
                                   _C_INT_P, ctypes.c_int, ctypes.c_int, ctypes.c_int], None)
    return lib


@functools.cache
def _gtif() -> ctypes.CDLL:
    lib = _kernels.GEOTIFF_LOADER.load()
    _bind(lib, "gtif_probe", [ctypes.c_char_p, _C_INT_P, _C_INT_P], ctypes.c_int)
    _bind(lib, "gtif_load_batch", [ctypes.c_char_p, ctypes.c_int, _C_FLOAT_P, _C_INT_P,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int], None)
    return lib


def _buildable(load, what: str) -> bool:
    """Whether ``load()`` binds its library; if not, one line on stderr
    naming the build error (the caller's cache prints it once a process)."""
    try:
        load()
        return True
    except (RuntimeError, OSError) as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        errors = [ln for ln in lines[1:] if "error" in ln.lower()]
        reason = "; ".join(lines[:1] + errors[:1])
        print(f"WARNING: the native {what} loader could not be built ({reason}); "
              f"reading {what} tiles with the Python parser", file=sys.stderr)
        return False


@functools.cache
def available() -> bool:
    """Whether the DTED loader builds and loads here (JAX ``native.available``)."""
    return _buildable(_dted, "DTED")


@functools.cache
def gtif_available() -> bool:
    """Whether the GeoTIFF loader builds and loads here (JAX
    ``native.gtif_available``)."""
    return _buildable(_gtif, "GeoTIFF")


def _blob(paths) -> bytes:
    return b"\0".join(str(p).encode() for p in paths) + b"\0"


def probe(path) -> Optional[Tuple[float, float, int, int]]:
    """(origin_lat, origin_lon, n_lat, n_lon) or None if not DTED."""
    lat, lon = ctypes.c_double(), ctypes.c_double()
    n_lat, n_lon = ctypes.c_int(), ctypes.c_int()
    rc = _dted().dted_probe(str(path).encode(), ctypes.byref(lat), ctypes.byref(lon),
                            ctypes.byref(n_lat), ctypes.byref(n_lon))
    if rc != 0:
        return None
    return lat.value, lon.value, n_lat.value, n_lon.value


def load_batch(paths: List, rows: int, cols: int,
               max_threads: int = 8) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse DTED tiles in parallel into [n, rows, cols] float32, south-first
    rows. Returns (tiles, origins[n, 2], status[n]); status 0 is a parsed
    tile. Tiles smaller than (rows, cols) are zero-padded at the top/right."""
    n = len(paths)
    out = np.zeros((n, rows, cols), np.float32)
    origins = np.zeros((n, 2), np.float64)
    status = np.zeros(n, np.int32)
    _dted().dted_load_batch(
        _blob(paths), n, out.ctypes.data_as(_C_FLOAT_P),
        origins.ctypes.data_as(_C_DOUBLE_P), status.ctypes.data_as(_C_INT_P),
        rows, cols, max_threads,
    )
    return out, origins, status


def gtif_probe(path) -> Optional[Tuple[int, int]]:
    """(rows, cols) of a baseline TIFF whose width and height are stored
    inline, or None."""
    rows, cols = ctypes.c_int(), ctypes.c_int()
    rc = _gtif().gtif_probe(str(path).encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    return rows.value, cols.value


def gtif_load_batch(paths: List, rows: int, cols: int,
                    max_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode GeoTIFF tiles in parallel into [n, rows, cols] float32.

    Rows come out SOUTH-first (the Tile orientation; the flip happens in
    C++). Returns (tiles, status[n]); status 0 is a decoded tile, anything
    else a file the Python parser must read (or reject)."""
    n = len(paths)
    out = np.zeros((n, rows, cols), np.float32)
    status = np.zeros(n, np.int32)
    _gtif().gtif_load_batch(
        _blob(paths), n, out.ctypes.data_as(_C_FLOAT_P), status.ctypes.data_as(_C_INT_P),
        rows, cols, max_threads,
    )
    return out, status
