"""Carry state from the JAX package into this one, as numpy arrays.

The JAX package's objects cannot be imported here (that would import jax),
so the caller hands over ``np.asarray`` of each field and these converters
rebuild this package's counterparts on the torch device the caller names
(no default: a converter never picks the CPU on its own). Parity tests feed
both packages the same refraction table, terrain mosaic, hit grid and scene
objects this way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .generators.base import HitBuffer
from .ops.objects import ARRAY_FIELDS, ObjectSet
from .physics.ray import RefractionTable
from .terrain.store import TerrainPack


def table_from_arrays(h0, inv_dh, values, poly, device) -> RefractionTable:
    """A ``RefractionTable`` from the JAX table's (h0, inv_dh, values, poly)."""
    return RefractionTable.from_values(
        np.asarray(values, np.float32), float(np.asarray(h0)),
        float(np.asarray(inv_dh)), poly, device,
    )


def sweep_table_from_arrays(h0, inv_dh, values, pairs, device) -> RefractionTable:
    """A stacked sweep ``RefractionTable`` from the JAX sweep's table
    (``parallel/mesh.py``: h0, inv_dh, values [F, n], pairs [F, n-1, 2],
    poly None): one l(h) table a frame, no fit."""
    values = np.asarray(values, np.float32)
    pairs = np.asarray(pairs, np.float32)
    if values.ndim != 2 or pairs.shape != (values.shape[0], values.shape[1] - 1, 2):
        raise ValueError(f"values must be [F, n] and pairs [F, n-1, 2], got "
                         f"{values.shape} and {pairs.shape}")
    return RefractionTable(
        h0=float(np.float32(np.asarray(h0))),
        inv_dh=float(np.float32(np.asarray(inv_dh))),
        values=torch.tensor(values, device=device),
        pairs=torch.tensor(pairs, device=device),
        poly=None,
    )


def pack_from_arrays(tiles, rows_m1, cols_m1, lat_min: int, lon_min: int,
                     n_rows: int, n_cols: int, device,
                     grad_bound: float = math.inf,
                     seam_jump: float = math.inf) -> TerrainPack:
    """A plain ``TerrainPack`` from a [T, S, S] tile stack (int16 or f32)
    and its per-slot (rows−1, cols−1) scales. Pass the JAX pack's
    ``grad_bound`` and ``seam_jump``; left unknown they are infinite, which
    is conservative: the culled Rectilinear path then culls nothing."""
    tiles = np.asarray(tiles)
    if tiles.dtype not in (np.int16, np.float32):
        raise ValueError(f"tiles must be int16 or float32, got {tiles.dtype}")
    if tiles.ndim != 3 or tiles.shape[0] != n_rows * n_cols:
        raise ValueError(f"tiles must be [{n_rows * n_cols}, S, S], got {tiles.shape}")
    return TerrainPack(
        tiles=torch.tensor(tiles, device=device),
        rows_m1=torch.tensor(np.asarray(rows_m1, np.float32), device=device),
        cols_m1=torch.tensor(np.asarray(cols_m1, np.float32), device=device),
        lat_min=int(lat_min),
        lon_min=int(lon_min),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
        grad_bound=float(grad_bound),
        seam_jump=float(seam_jump),
    )


def hits_from_arrays(valid, key, dlat, dlon, distance, elevation, path_length,
                     normal, kind, rgba, device) -> HitBuffer:
    """A ``HitBuffer`` from the JAX hit buffer's fields, in its field order
    ([H, W, K] planes; normal [..., 3]; rgba [..., 4])."""
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return HitBuffer(
        valid=torch.tensor(np.asarray(valid, bool), device=device),
        key=f32(key), dlat=f32(dlat), dlon=f32(dlon), distance=f32(distance),
        elevation=f32(elevation), path_length=f32(path_length), normal=f32(normal),
        kind=torch.tensor(np.asarray(kind, np.int32), device=device), rgba=f32(rgba),
    )


def objects_from_arrays(*arrays, seg_window: int, host_meta, device) -> ObjectSet:
    """An ``ObjectSet`` from the JAX ObjectSet's 14 arrays, in its field
    order (kind, dlat, dlon, elev, r1, r2, height, width, rgba, basis,
    tex_id, textures, tex_hw, cull_r2), and its static ``seg_window`` and
    ``host_meta``."""
    if len(arrays) != len(ARRAY_FIELDS):
        raise ValueError(f"expected {len(ARRAY_FIELDS)} arrays, got {len(arrays)}")
    return ObjectSet.from_arrays(dict(zip(ARRAY_FIELDS, arrays)), seg_window=seg_window,
                                 host_meta=host_meta, device=device)
