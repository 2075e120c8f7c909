# Frozen copy of atm_raytracer_tpu_torch/terrain/sample.py (commit 05461a6); the benchmark's reference, not the program.
"""Device terrain sampling: 4-tap bilinear gather + gradient surface normals.

Counterpart of ``atm_raytracer_tpu/terrain/sample.py`` (plain 4-tap path;
the grouped/win4 sampler there is a TPU gather-launch trick). Replaces the
reference's per-point ``Terrain::get_elev`` (geotiff.rs:61-100 bilinear)
and ``find_normal`` (utils.rs:15-40).

Positions arrive as f32 *deltas from the observer*; the observer's absolute
position enters through its integer-degree floor and the f32 fraction, so
tile-local coordinates keep full f32 precision.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..models.earth import NORMAL_DIFF, EarthModel
from .store import TerrainPack


def _locate(pack: TerrainPack, dlat, dlon, lat0: float, lon0: float):
    """Observer-relative degrees → (valid, tile slot, cell indices, cell
    fractions, per-tile (rows−1, cols−1) scales)."""
    lat0_floor = math.floor(lat0)
    lon0_floor = math.floor(lon0)
    a_lat = float(np.float32(lat0 - lat0_floor)) + dlat  # tile-continuous
    a_lon = float(np.float32(lon0 - lon0_floor)) + dlon
    cell_lat = torch.floor(a_lat)
    cell_lon = torch.floor(a_lon)
    local_lat = a_lat - cell_lat  # in [0, 1)
    local_lon = a_lon - cell_lon

    row_cell = cell_lat.to(torch.int64) + (lat0_floor - pack.lat_min)
    col_cell = cell_lon.to(torch.int64) + (lon0_floor - pack.lon_min)
    n_rows, n_cols = pack.n_rows, pack.n_cols
    valid = (row_cell >= 0) & (row_cell < n_rows) & (col_cell >= 0) & (col_cell < n_cols)
    # dense grid: the slot is arithmetic; missing tiles are all-zero slots
    t = row_cell.clamp(0, n_rows - 1) * n_cols + col_cell.clamp(0, n_cols - 1)
    t_rows_m1 = pack.rows_m1[t]
    t_cols_m1 = pack.cols_m1[t]
    r = local_lat * t_rows_m1
    c = local_lon * t_cols_m1
    ri = torch.minimum(torch.floor(r), t_rows_m1 - 1.0).to(torch.int64)
    ci = torch.minimum(torch.floor(c), t_cols_m1 - 1.0).to(torch.int64)
    rf = r - ri.to(torch.float32)
    cf = c - ci.to(torch.float32)
    return valid, t, ri, ci, rf, cf, t_rows_m1, t_cols_m1


def sample_elevation(pack: TerrainPack, dlat, dlon, lat0: float, lon0: float,
                     with_gradient: bool = False):
    """Bilinear elevation at (lat0+dlat, lon0+dlon); missing tiles → 0.0.

    ``with_gradient`` also returns (dE/dlat, dE/dlon) in meters per degree —
    the exact gradient of the sampled bilinear patch from the same 4 taps.
    """
    valid, t, ri, ci, rf, cf, t_rows_m1, t_cols_m1 = _locate(
        pack, dlat, dlon, lat0, lon0
    )
    s = pack.tiles.shape[1]
    flat = pack.tiles.reshape(-1)
    base = t * (s * s) + ri * s + ci
    e00 = flat[base].to(torch.float32)
    e10 = flat[base + s].to(torch.float32)
    e01 = flat[base + 1].to(torch.float32)
    e11 = flat[base + s + 1].to(torch.float32)
    return _combine_taps(e00, e01, e10, e11, rf, cf, valid, t_rows_m1,
                         t_cols_m1, with_gradient)


def _combine_taps(e00, e01, e10, e11, rf, cf, valid, t_rows_m1, t_cols_m1,
                  with_gradient):
    """Bilinear value (+ exact patch gradient) from the four cell taps."""
    elev = (
        e00 * (1 - rf) * (1 - cf)
        + e10 * rf * (1 - cf)
        + e01 * (1 - rf) * cf
        + e11 * rf * cf
    )
    zero = torch.zeros_like(elev)
    if not with_gradient:
        return torch.where(valid, elev, zero)
    # d(elev)/d(row coord) and /d(col coord), scaled to per-degree
    de_dr = (e10 - e00) * (1 - cf) + (e11 - e01) * cf
    de_dc = (e01 - e00) * (1 - rf) + (e11 - e10) * rf
    return (
        torch.where(valid, elev, zero),
        torch.where(valid, de_dr * t_rows_m1, zero),
        torch.where(valid, de_dc * t_cols_m1, zero),
    )


def sample_terrain_data(pack: TerrainPack, model: EarthModel, dlat, dlon,
                        lat0: float, lon0: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elevation [...] and outward unit normal [..., 3] at each point.

    Gradient normals: the exact gradient of the sampled bilinear patch
    (the arm → 0 limit of the reference's ±15 m central differences,
    utils.rs:15-40), composed in the global cartesian frame as
    normalize(vec_ew × vec_ns) from the local (north, east, up) basis.
    """
    lat_abs = float(np.float32(lat0)) + dlat
    lon_abs = float(np.float32(lon0)) + dlon
    north, east, up = model.world_directions(lat_abs, lon_abs)
    elev, de_dlat, de_dlon = sample_elevation(
        pack, dlat, dlon, lat0, lon0, with_gradient=True
    )
    # meters per degree along the model's meridian / parallel at the point
    off_lat, off_lon = model.normal_offsets(lat_abs)  # deg per NORMAL_DIFF m
    slope_n = de_dlat / (NORMAL_DIFF / off_lat)  # dz per meter north
    slope_e = de_dlon / (NORMAL_DIFF / off_lon)
    vec_ns = north + slope_n[..., None] * up
    vec_ew = east + slope_e[..., None] * up
    normal = torch.linalg.cross(vec_ew, vec_ns, dim=-1)
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return elev, normal / norm.clamp(min=1e-30)
