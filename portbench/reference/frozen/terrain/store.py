# Frozen copy of atm_raytracer_tpu_torch/terrain/store.py (commit 05461a6), without the tile files and their loaders; the benchmark's reference, not the program.
"""Tile store: lazy host-side tile registry + a device tile stack (PyTorch).

Counterpart of ``atm_raytracer_tpu/terrain/store.py`` (reference
src/terrain/mod.rs:55-127): a map from (floor(lat), floor(lon)) to a 1°×1°
tile, scanned from a folder (DTED keyed by header origin, GeoTIFF by its
``N49E021`` filename) and loaded lazily. ``Terrain.preload`` decodes the
tiles a render can reach through the native loaders (``terrain/native.py``),
one threaded call per format, or with the Python parsers for a format whose
loader cannot be built here; ``Terrain.pack`` stacks them into one plain
[T, S, S] tensor on a device.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.earth import DEGREE_DISTANCE


@dataclasses.dataclass
class Tile:
    """One 1°×1° tile: south-first rows, inclusive edges.

    elev[i, j] = post at (lat0 + i/(n_lat-1), lon0 + j/(n_lon-1)).
    """

    lat0: int
    lon0: int
    elev: np.ndarray  # [n_lat, n_lon] float32, row 0 = south

    def get_elev(self, lat: float, lon: float) -> Optional[float]:
        """Bilinear sample (geotiff.rs:61-100 semantics incl. edge clamp)."""
        if not (self.lat0 <= lat <= self.lat0 + 1 and self.lon0 <= lon <= self.lon0 + 1):
            return None
        n_lat, n_lon = self.elev.shape
        r = (lat - self.lat0) * (n_lat - 1)
        c = (lon - self.lon0) * (n_lon - 1)
        ri = min(int(r), n_lat - 2)
        ci = min(int(c), n_lon - 2)
        rf, cf = r - ri, c - ci
        e = self.elev
        return float(
            e[ri, ci] * (1 - rf) * (1 - cf)
            + e[ri + 1, ci] * rf * (1 - cf)
            + e[ri, ci + 1] * (1 - rf) * cf
            + e[ri + 1, ci + 1] * rf * cf
        )


@dataclasses.dataclass
class TerrainPack:
    """Device mosaic: dense [n_rows*n_cols, S, S] tile stack.

    Slot (r, c) = r * n_cols + c covers the 1°×1° cell at
    (lat_min + r, lon_min + c); missing tiles are all-zero slots (elevation
    0.0, the reference's missing-tile fallback). ``rows_m1``/``cols_m1``
    hold each slot's post count minus one, so mixed resolutions stay exact.
    """

    tiles: torch.Tensor  # [T, S, S] int16 (integer-meter tiles) or f32
    rows_m1: torch.Tensor  # [T] f32
    cols_m1: torch.Tensor  # [T] f32
    lat_min: int
    lon_min: int
    n_rows: int
    n_cols: int
    # the mosaic's Lipschitz bound |∇elev| (m/m) and its largest step across
    # a tile seam inside the requested box (m): the slack of the culled
    # Rectilinear path's terrain envelope. Both must be conservative — a
    # smaller value silently drops real crossings, a larger one culls less.
    grad_bound: float
    seam_jump: float


class Terrain:
    """Folder-scanned tile registry with lazy host loading.

    ``native=False`` reads every file with the Python parsers (the oracle
    the native loaders are held to) instead of the native loaders."""

    def __init__(self, native: bool = True):
        self.native = native
        self._paths: Dict[Tuple[int, int], Path] = {}
        self._loaded: Dict[Tuple[int, int], Tile] = {}
        self._pack_cache: Dict[tuple, TerrainPack] = {}

    def add_tile(self, tile: Tile) -> None:
        """Register an in-memory tile; drops memoized device stacks (their
        key is the tile KEYS, so a replaced tile would be served stale)."""
        self._loaded[(tile.lat0, tile.lon0)] = tile
        self._pack_cache.clear()

    @property
    def keys(self):
        return set(self._paths) | set(self._loaded)

    def _tile(self, key: Tuple[int, int]) -> Optional[Tile]:
        if key in self._loaded:
            return self._loaded[key]
        return None

    def preload(self, keys) -> None:
        """Every tile of the reference is in memory: nothing to load."""

    def get_elev(self, lat: float, lon: float) -> Optional[float]:
        """Host bilinear elevation (terrain/mod.rs:120-126)."""
        tile = self._tile((int(math.floor(lat)), int(math.floor(lon))))
        if tile is None:
            return None
        return tile.get_elev(lat, lon)

    def get_elev_or0(self, lat: float, lon: float) -> float:
        e = self.get_elev(lat, lon)
        return 0.0 if e is None else e

    def pack(self, lat_range: Tuple[float, float], lon_range: Tuple[float, float],
             device) -> TerrainPack:
        """Stack every tile intersecting the lat/lon box on ``device``.

        The tiles load through ``preload``. The grid spans the PRESENT
        tiles' bounding box; tiles pad to the largest post count.
        Integer-meter mosaics pack as int16. Memoized per (box, tile keys,
        device): repeat renders reuse the device copy.
        """
        device = torch.device(device)
        lat_lo, lat_hi = (int(math.floor(v)) for v in lat_range)
        lon_lo, lon_hi = (int(math.floor(v)) for v in lon_range)
        keys = [
            (la, lo)
            for la in range(lat_lo, lat_hi + 1)
            for lo in range(lon_lo, lon_hi + 1)
            if (la, lo) in self._paths or (la, lo) in self._loaded
        ]
        cache_key = (lat_lo, lat_hi, lon_lo, lon_hi, tuple(keys), str(device))
        cached = self._pack_cache.get(cache_key)
        if cached is not None:
            return cached
        self.preload(keys)
        tiles = [self._tile(k) for k in keys]
        if keys:
            lat_lo = min(k[0] for k in keys)
            lat_hi = max(k[0] for k in keys)
            lon_lo = min(k[1] for k in keys)
            lon_hi = max(k[1] for k in keys)
        n_lats = lat_hi - lat_lo + 1
        n_lons = lon_hi - lon_lo + 1
        s = max(max(t.elev.shape) for t in tiles) if tiles else 2
        int_exact = bool(tiles) and all(
            np.all(t.elev == np.round(t.elev))
            and t.elev.min() >= -32768 and t.elev.max() < 32768
            for t in tiles
        )
        stack = np.zeros((n_lats * n_lons, s, s), np.int16 if int_exact else np.float32)
        rows_m1 = np.ones((n_lats * n_lons,), np.float32)
        cols_m1 = np.ones((n_lats * n_lons,), np.float32)
        for k, t in zip(keys, tiles):
            slot = (k[0] - lat_lo) * n_lons + (k[1] - lon_lo)
            nr, nc = t.elev.shape
            stack[slot, :nr, :nc] = t.elev
            rows_m1[slot] = nr - 1
            cols_m1[slot] = nc - 1
        result = TerrainPack(
            tiles=torch.from_numpy(stack).to(device),
            rows_m1=torch.from_numpy(rows_m1).to(device),
            cols_m1=torch.from_numpy(cols_m1).to(device),
            lat_min=lat_lo,
            lon_min=lon_lo,
            n_rows=n_lats,
            n_cols=n_lons,
            # rounded as the JAX package rounds them, so both cull alike
            grad_bound=round(_grad_bound(keys, tiles), 6),
            seam_jump=round(_seam_jump(dict(zip(keys, tiles)), lat_range,
                                       lon_range), 3),
        )
        self._pack_cache[cache_key] = result
        return result


def _grad_bound(keys, tiles) -> float:
    """Lipschitz bound of the bilinear mosaic, meters of elevation per meter:
    per tile sqrt(gx² + gy²) of its worst post differences along each axis
    over the post spacing (longitude spacing at the tile's mid latitude,
    cos clamped at 0.1)."""
    bound = 0.0
    for k, t in zip(keys, tiles):
        nr, nc = t.elev.shape
        e = t.elev.astype(np.float32)
        sp_lat = DEGREE_DISTANCE / max(nr - 1, 1)
        sp_lon = (DEGREE_DISTANCE * max(0.1, math.cos(math.radians(k[0] + 0.5)))
                  / max(nc - 1, 1))
        gy = float(np.abs(np.diff(e, axis=0)).max(initial=0.0)) / sp_lat
        gx = float(np.abs(np.diff(e, axis=1)).max(initial=0.0)) / sp_lon
        bound = max(bound, math.hypot(gx, gy))
    return bound


def _seam_jump(tile_by_key: Dict[Tuple[int, int], Tile], lat_range, lon_range) -> float:
    """Largest step of the sampled field across a tile seam inside the
    requested box, meters: where a missing cell (the 0.0 fallback) meets
    real elevation, or adjacent tiles disagree on their shared edge. No
    gradient bound covers a step, so the envelope adds it as slack."""

    def edge(key, side):
        t = tile_by_key.get(key)
        if t is None:
            return np.zeros(2, np.float32)
        e = t.elev
        return {"n": e[-1, :], "s": e[0, :], "e": e[:, -1], "w": e[:, 0]}[side].astype(
            np.float32)

    def jump(ea, eb):
        # the largest difference of two piecewise-linear edges lies at a
        # breakpoint of EITHER edge, so compare on the union of both grids
        xa = np.linspace(0.0, 1.0, len(ea))
        xb = np.linspace(0.0, 1.0, len(eb))
        xs = np.union1d(xa, xb)
        return float(np.abs(np.interp(xs, xa, ea) - np.interp(xs, xb, eb)).max(initial=0.0))

    req_lat = range(math.floor(lat_range[0]), math.floor(lat_range[1]) + 1)
    req_lon = range(math.floor(lon_range[0]), math.floor(lon_range[1]) + 1)
    worst = 0.0
    for la in req_lat:
        for lo in req_lon:
            here = (la, lo) in tile_by_key
            if (here or (la, lo + 1) in tile_by_key) and lo + 1 in req_lon:
                worst = max(worst, jump(edge((la, lo), "e"), edge((la, lo + 1), "w")))
            if (here or (la + 1, lo) in tile_by_key) and la + 1 in req_lat:
                worst = max(worst, jump(edge((la, lo), "n"), edge((la + 1, lo), "s")))
    return worst
