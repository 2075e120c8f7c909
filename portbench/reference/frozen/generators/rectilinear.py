# Frozen copy of atm_raytracer_tpu_torch/generators/rectilinear.py (commit 05461a6); the benchmark's reference, not the program.
"""Rectilinear generator: exact pinhole lens, one ray per pixel (PyTorch),
the plain paths of opaque terrain without scene objects.

Counterpart of ``atm_raytracer_tpu/generators/rectilinear.py`` (reference
src/generator/generators/rectilinear.rs): every pixel marches its own ray
along its own geodesic (rectilinear.rs:78-186). Two regimes, both exact:

* tilt == 0 (``fused_shared_core``): at pitch 0 the pixel azimuth is
  ``direction + atan2(x_off, z_focal)``, constant down each image column,
  so the terrain scan is shared per column as in the Fast generator, and
  the per-pixel march streams window by window into the crossing search
  without forming the [H, W, N] ray grid (``tilt0_hits_plain``:
  ``march_scan_light``, then the exact re-test of the flagged window).
* tilt != 0 (``fused_culled_core``): azimuth couples both pixel axes, so
  nothing is shared; a conservative terrain envelope culls the per-pixel
  sampling to a few candidate blocks (the capture scan,
  ``culled_capture_plain``, a ``march_scan`` over the coarse windows),
  which re-integrate from captured ODE states and are tested exactly.

Every stage is PyTorch ops on the device of its inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Params
from ..models import camera
from ..models.earth import EarthModel
from ..ops import combine
from ..ops.composite import composite
from ..physics.ray import (
    DEATH_ALTITUDE,
    EarthShape,
    RefractionTable,
    _f32,
    hermite_coeffs,
    hermite_plane,
    march_coarse,
    march_scan,
    march_scan_light,
    rk4_window,
)
from ..terrain.sample import sample_elevation, sample_terrain_data
from ..terrain.store import Terrain, TerrainPack
from .base import HitBuffer, RenderResult, fetch_flat
from .fast import build_refraction_table, terrain_bbox, terrain_columns

M_CAND = 4  # candidate blocks captured per pixel per round (culled path)
BLOCK_WINDOWS = 4  # coarse windows per envelope block (culled path)
# elements of one [pixels, M_CAND, block + 1] chunk of the culled exact test
EXACT_TEST_ELEMS = 1 << 27


def _endpoint_pair_terrain(pack: TerrainPack, model: EarthModel, dl1, dn1, dl2,
                           dn2, lat0: float, lon0: float):
    """Terrain elevation + normal at both ends of the crossing segments, in
    one sampling call."""
    te, no = sample_terrain_data(pack, model, torch.stack([dl1, dl2], dim=-1),
                                 torch.stack([dn1, dn2], dim=-1), lat0, lon0)
    return te[..., 0], no[..., 0, :], te[..., 1], no[..., 1, :]


def _terrain_hits(valid, key, dlat, dlon, distance, elevation, path_length,
                  normal, terrain_alpha: float) -> HitBuffer:
    """A HitBuffer of terrain hits (kind 0, alpha ``terrain_alpha``)."""
    rgba = torch.zeros(key.shape + (4,), dtype=torch.float32, device=key.device)
    rgba[..., 3] = float(terrain_alpha)
    return HitBuffer(
        valid=valid, key=key, dlat=dlat, dlon=dlon, distance=distance,
        elevation=elevation, path_length=path_length, normal=normal,
        kind=torch.zeros(key.shape, dtype=torch.int32, device=key.device),
        rgba=rgba,
    )


def _composite_hits(coloring, fog_distance, hits: HitBuffer) -> torch.Tensor:
    return composite(
        coloring, fog_distance, hits.valid, hits.rgba[..., 3], hits.distance,
        hits.elevation, hits.path_length, hits.normal, hits.kind,
        hits.rgba[..., :3],
    )


# ---------------------------------------------------------------------------
# tilt == 0: column-shared terrain, march streamed into the crossing search
# ---------------------------------------------------------------------------


def first_window_scan(elev_hw, terr_pad, alt0, *, shape: EarthShape,
                      table: Optional[RefractionTable], straight: bool,
                      step: float, n_seg: int, coarse: int):
    """K = 1, the scan: each pixel's FIRST window holding a sign change of
    ray − terrain, and the ODE state at its start.

    Returns (best_w [H, W] int32, n_coarse + 1 where none; s_h, s_v, s_p
    [H, W]: altitude, slope and path length at that window's start).
    ``terr_pad`` [W, n_coarse·C + 1] is each column's terrain, zero-padded
    past the march. ``first_hit_retest`` resolves the flagged windows.
    """
    h_n, w_n = elev_hw.shape
    n_coarse = -(-n_seg // coarse)
    big_w = n_coarse + 1  # "no window yet"
    coeffs = hermite_coeffs(coarse)
    dxw = _f32(step * coarse)
    terr_rows = terr_pad.t().contiguous()  # [n_coarse·C + 1, W]

    def consumer(carry, k0, nodes, alive0):
        best_w, s_h, s_v, s_p = carry
        h0, v0, h1, v1, p0 = nodes
        vdx = v0 * dxw
        v1dx = v1 * dxw
        # min over the window's segment products (h_j − t_j)(h_j+1 − t_j+1),
        # one fine plane at a time
        mn = win_min = d_prev = None
        for j in range(coarse + 1):
            hj = hermite_plane(h0, vdx, h1, v1dx, coeffs, j)
            if j < coarse:
                win_min = hj if j == 0 else torch.minimum(win_min, hj)
            dj = hj - terr_rows[k0 + j]
            if d_prev is not None:
                pr = d_prev * dj
                mn = pr if mn is None else torch.minimum(mn, pr)
            d_prev = dj
        # death inside the window or the padded tail can make this a false
        # positive; the exact re-test below resolves both
        has = (mn < 0.0) & alive0 & (best_w >= big_w)
        carry = (
            best_w.masked_fill(has, k0 // coarse),
            torch.where(has, h0, s_h),
            torch.where(has, v0, s_v),
            torch.where(has, p0, s_p),
        )
        return carry, win_min

    z2 = torch.zeros((h_n, w_n), dtype=torch.float32, device=elev_hw.device)
    init = (torch.full((h_n, w_n), big_w, dtype=torch.int32, device=elev_hw.device),
            z2, z2, z2)
    return march_scan_light(alt0, elev_hw, step, n_seg, shape, table, straight, consumer,
                            init, coarse=coarse)


def first_hit_retest(best_w, s_h, s_v, s_p, terr_pad, *, shape: EarthShape,
                     table: Optional[RefractionTable], straight: bool,
                     step: float, n_seg: int, coarse: int):
    """K = 1, after the scan: re-expand each pixel's flagged window and run
    the exact per-segment test with the path-death prefix; (key, path
    length) [H, W, 1], key +inf where there is no hit.

    The scan's fine samples and these are the same ``hermite_plane``
    expression on bitwise-equal node states (``rk4_window`` re-steps from
    the captured state), so this test sees exactly the values the scan
    flagged.
    """
    h_n, w_n = best_w.shape
    big_w = -(-n_seg // coarse) + 1
    coeffs = hermite_coeffs(coarse)
    dxw = _f32(step * coarse)
    z2 = torch.zeros_like(s_h)
    valid_w = best_w < big_w
    bw = best_w.masked_fill(~valid_w, 0)
    _, plen_fw, h1w, v1w = rk4_window(s_h, s_v, s_p, step, coarse, table,
                                      straight, shape.radius)
    s_vdx = s_v * dxw
    v1dxw = v1w * dxw
    h_pl = [hermite_plane(s_h, s_vdx, h1w, v1dxw, coeffs, j) for j in range(coarse + 1)]
    # each pixel's window of its column's terrain: [H, W, C+1]
    terr_win = terr_pad.unfold(1, coarse + 1, coarse)  # [W, n_coarse, C+1]
    col = torch.arange(w_n, device=best_w.device)[None, :]
    t_win = terr_win[col, bw.to(torch.int64)]
    kglob0 = bw * coarse  # global index of the window start
    # death prefix as ray_alive_mask: segment j dies only from samples
    # strictly before it (death before the window is the scan's job)
    found = torch.zeros((h_n, w_n), dtype=torch.bool, device=best_w.device)
    dead = torch.zeros_like(found)
    d1s = d2s = pl1 = pl2 = j_star = z2
    for j in range(coarse):
        d_lo = h_pl[j] - t_win[..., j]
        d_hi = h_pl[j + 1] - t_win[..., j + 1]
        cross = (d_lo * d_hi < 0.0) & ~dead & (kglob0 + j < n_seg) & ~found
        d1s = torch.where(cross, d_lo, d1s)
        d2s = torch.where(cross, d_hi, d2s)
        pl1 = torch.where(cross, plen_fw[..., j], pl1)
        pl2 = torch.where(cross, plen_fw[..., j + 1], pl2)
        j_star = j_star.masked_fill(cross, float(j))
        found = found | cross
        dead = dead | (h_pl[j] < DEATH_ALTITUDE)
    denom = d1s - d2s
    prop = d1s / torch.where(denom == 0.0, 1.0, denom)  # utils.rs:232
    key = torch.where(valid_w & found, kglob0.to(torch.float32) + j_star + prop,
                      combine.NO_HIT)
    return key[..., None], (pl1 * (1.0 - prop) + pl2 * prop)[..., None]


def tilt0_hits_plain(elev_hw, terr_pad, alt0, *, shape: EarthShape,
                     table: Optional[RefractionTable], straight: bool, step: float,
                     n_seg: int, coarse: int):
    """The tilt-0 scan in plain PyTorch for opaque terrain (K = 1), on any
    device: (key, path length) [H, W, 1]; key +inf (path length 0) where
    there is no hit. ``first_window_scan`` + ``first_hit_retest``."""
    scan_kw = dict(shape=shape, table=table, straight=straight, step=step, n_seg=n_seg,
                   coarse=coarse)
    found = first_window_scan(elev_hw, terr_pad, alt0, **scan_kw)
    return first_hit_retest(*found, terr_pad, **scan_kw)


def fused_shared_core(pack: TerrainPack, table: Optional[RefractionTable],
                      az_deg: torch.Tensor, alt0, *, cam: tuple,
                      model: EarthModel, shape: EarthShape, straight: bool,
                      step: float, n_terr: int, lat0: float,
                      lon0: float, coloring, fog_distance: Optional[float],
                      terrain_alpha: float):
    """The whole tilt-0 Rectilinear frame of opaque terrain on the device of
    ``az_deg`` [W]: (image [H, W, 3] u8, hits [H, W, 1]). ``cam`` = (width,
    height, fov). The scan is ``tilt0_hits_plain``.

    The pixel elevation grid is derived on the device in float32; it does
    not depend on the view direction, so direction 0 serves.
    """
    elev_hw, terr_pad, stacked, coarse = tilt0_inputs(
        pack, az_deg, cam=cam, model=model, step=step, n_terr=n_terr, lat0=lat0,
        lon0=lon0)
    key, plh = tilt0_hits_plain(elev_hw, terr_pad, alt0, shape=shape, table=table,
                                straight=straight, step=step, n_seg=n_terr - 1,
                                coarse=coarse)
    hits = column_hits(stacked, key, plh, az_deg.to(torch.float32), model=model,
                       lat0=lat0, lon0=lon0, step=step, terrain_alpha=terrain_alpha)
    return _composite_hits(coloring, fog_distance, hits), hits


def tilt0_inputs(pack: TerrainPack, az_deg: torch.Tensor, *, cam: tuple,
                 model: EarthModel, step: float, n_terr: int, lat0: float, lon0: float):
    """The tilt-0 scan's inputs on the device of ``az_deg`` [W]: (elev_hw
    [H, W], terr_pad [W, n_coarse·C + 1], the
    columns' elevation and normal stack [W, N, 4], the window length C).

    C is clamped as the scans clamp it: the K = 1 re-expansion and the
    window bookkeeping must use the window length the scan integrated.
    """
    n_seg = n_terr - 1
    coarse = max(1, min(march_coarse(step), n_seg))
    width, height, fov = cam
    elev_hw, _ = camera.rectilinear_ray_params_device(width, height, fov, 0.0, 0.0,
                                                      az_deg.device)
    # the shared per-column terrain scan (utils.rs:176-199)
    terr_elev, terr_normal = terrain_columns(pack, model, az_deg.to(torch.float32), lat0,
                                             lon0, step, n_terr)
    stacked = torch.cat([terr_elev[..., None], terr_normal], dim=-1)  # [W, N, 4]
    n_coarse = -(-n_seg // coarse)
    terr_pad = torch.nn.functional.pad(terr_elev, (0, n_coarse * coarse + 1 - n_terr))
    return elev_hw, terr_pad, stacked, coarse


def column_hits(stacked: torch.Tensor, key: torch.Tensor, plh: torch.Tensor,
                az: torch.Tensor, *, model: EarthModel, lat0: float, lon0: float,
                step: float, terrain_alpha: float) -> HitBuffer:
    """Tilt-0 hit fields at the keys [H, W, K]: terrain elevation and normal
    lerped from each column's [W, N, 4] stack, positions on the column
    geodesic at the lerped distance (the azimuth is constant down each
    column)."""
    valid = torch.isfinite(key)
    safe = torch.where(valid, key, 0.0)
    ks = torch.floor(safe).to(torch.int64)
    prop = (safe - ks.to(torch.float32))[..., None]
    c_lo, c_hi = combine.gather_column_pairs(stacked, ks)  # [H, W, K, 4]
    hit = c_lo * (1.0 - prop) + c_hi * prop
    distance = safe * _f32(step)
    hit_dlat, hit_dlon = model.geodesic_delta(lat0, lon0, az[None, :, None], distance)
    return _terrain_hits(valid, key, hit_dlat, hit_dlon, distance, hit[..., 0], plh,
                         hit[..., 1:4], terrain_alpha)


# ---------------------------------------------------------------------------
# tilt == 0 with scene objects: column-shared terrain, row chunks marched in
# full (the object tests consume each chunk's dense ray grid)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# tilt != 0, opaque terrain: envelope-culled exact path
# ---------------------------------------------------------------------------


class CulledInputs(NamedTuple):
    """What the culled path derives once a frame (``culled_envelope``), on
    the device of the pack."""

    elev: torch.Tensor  # [P] float32: the pixels' elevations (rad), row-major
    az_px: torch.Tensor  # [P] float32: their azimuths (deg), unwrapped about the view
    env_hi: torch.Tensor  # [A-1, nb] float32: the envelope's highs, slack added
    env_lo: torch.Tensor  # [A-1, nb] float32: its lows, slack taken off
    j_px: torch.Tensor  # [P] int64: each pixel's azimuth interval, a row of env_*


class CulledBlocks(NamedTuple):
    """The culled path's march geometry (``culled_blocks``)."""

    n_seg: int  # segments of the march
    coarse: int  # steps a window
    b_len: int  # segments a block of BLOCK_WINDOWS windows
    nb: int  # blocks
    n_march: int  # steps marched: whole blocks; masks trim the tail


def culled_blocks(n_terr: int, step: float) -> CulledBlocks:
    """The culled path's march geometry for ``n_terr`` terrain samples
    ``step`` apart, windows as in ``fused_shared_core``."""
    n_seg = n_terr - 1
    coarse = max(1, min(march_coarse(step), n_seg))
    b_len = BLOCK_WINDOWS * coarse
    nb = -(-n_seg // b_len)
    return CulledBlocks(n_seg, coarse, b_len, nb, nb * b_len)


def culled_envelope(pack: TerrainPack, *, cam: tuple, model: EarthModel, step: float,
                    blocks: CulledBlocks, lat0: float, lon0: float) -> CulledInputs:
    """Stage 1 of ``fused_culled_core``: the pixels' angles and the
    conservative terrain envelope, on the device of ``pack``."""
    width, height, fov, tilt, direction = cam
    dev = pack.tiles.device
    _, _, b_len, nb, n_march = blocks
    f_step = _f32(step)

    elev_hw, dirr_hw = camera.rectilinear_ray_params_device(
        width, height, fov, tilt, direction, dev)
    elev = elev_hw.reshape(-1)
    # unwrap azimuths about the view direction, so a view across ±180° does
    # not span 360° of envelope (which would cull nothing)
    az_raw = torch.rad2deg(dirr_hw.reshape(-1))
    az_off = torch.remainder(az_raw - _f32(direction) + 180.0, 360.0) - 180.0
    az_px = _f32(direction) + az_off

    n_env = 2 * width
    az_lo = az_px.min()
    span = (az_px.max() - az_lo).clamp(min=1e-7)
    d_az = span / (n_env - 1)
    az_grid = az_lo + torch.arange(n_env, dtype=torch.float32, device=dev) * d_az
    dists = torch.arange(n_march + 1, dtype=torch.float32, device=dev) * f_step
    env_dl, env_dn = model.geodesic_delta(lat0, lon0, az_grid[:, None], dists[None, :])
    env = sample_elevation(pack, env_dl, env_dn, lat0, lon0)  # [A, n_march+1]
    blk_hi = torch.maximum(env[:, :-1], env[:, 1:]).reshape(n_env, nb, b_len).amax(-1)
    blk_lo = torch.minimum(env[:, :-1], env[:, 1:]).reshape(n_env, nb, b_len).amin(-1)
    int_hi = torch.maximum(blk_hi[:-1], blk_hi[1:])  # [A-1, nb]
    int_lo = torch.minimum(blk_lo[:-1], blk_lo[1:])
    d_far = ((torch.arange(nb, dtype=torch.float32, device=dev) + 1.0)
             * _f32(b_len * step))
    slack = (_f32(pack.grad_bound) * d_far * torch.deg2rad(d_az) * 1.1
             + 1.0 + _f32(pack.seam_jump))  # [nb]
    j_px = torch.floor((az_px - az_lo) / d_az).to(torch.int64).clamp(0, n_env - 2)
    return CulledInputs(elev, az_px, int_hi + slack, int_lo - slack, j_px)


def culled_capture_plain(elev, alt0, env_hi, env_lo, j_px, *, skip: int,
                         shape: EarthShape, table: Optional[RefractionTable],
                         straight: bool, step: float, blocks: CulledBlocks):
    """Stage 2 of ``fused_culled_core`` in plain PyTorch, on any device: one
    ``march_scan`` over the pixels ``elev`` [P] that captures candidate
    blocks skip .. skip + M_CAND - 1. A block whose ray range (the min and
    max of its fine samples) meets the envelope ``env_hi`` / ``env_lo``
    [A-1, nb] at the pixel's row ``j_px`` [P], and whose ray was alive at its
    start, is a candidate; its start state goes to the pixel's slot
    ``cnt - skip``.

    Returns (cnt [P] int32, every candidate; s_h, s_v, s_p [P, M_CAND]
    float32: altitude, slope and path length at the block's start; s_d
    [P, M_CAND] bool: dead at its start; s_b [P, M_CAND] int32: the block,
    nb in an empty slot)."""
    dev = elev.device
    p_n = elev.shape[0]
    n_seg, coarse, b_len, nb, n_march = blocks
    # [nb, P]: one contiguous row per block
    env_hi_p = env_hi.t().contiguous()[:, j_px]
    env_lo_p = env_lo.t().contiguous()[:, j_px]
    slot_iota = torch.arange(M_CAND, dtype=torch.int32, device=dev)[None, :]

    def consumer(user, k0, h_f, plen_f, alive, v, _h1, _v1):
        bh, bv, bp, bd, rmin, rmax, cnt, s_h, s_v, s_p, s_d, s_b = user
        w_idx = k0 // coarse
        wmin = h_f.amin(-1)
        wmax = h_f.amax(-1)
        if w_idx % BLOCK_WINDOWS == 0:  # block start: its state, fresh range
            bh, bv, bp, bd = h_f[:, 0], v, plen_f[:, 0], ~alive[:, 0]
            rmin, rmax = wmin, wmax
        else:
            rmin = torch.minimum(rmin, wmin)
            rmax = torch.maximum(rmax, wmax)
        b = w_idx // BLOCK_WINDOWS
        if w_idx % BLOCK_WINDOWS == BLOCK_WINDOWS - 1 and b * b_len < n_seg:
            cand = (rmin <= env_hi_p[b]) & (rmax >= env_lo_p[b]) & ~bd
            wm = cand[:, None] & (slot_iota == (cnt - skip)[:, None])
            s_h = torch.where(wm, bh[:, None], s_h)
            s_v = torch.where(wm, bv[:, None], s_v)
            s_p = torch.where(wm, bp[:, None], s_p)
            s_d = torch.where(wm, bd[:, None], s_d)
            s_b = s_b.masked_fill(wm, b)
            cnt = cnt + cand.to(torch.int32)
        return bh, bv, bp, bd, rmin, rmax, cnt, s_h, s_v, s_p, s_d, s_b

    z = torch.zeros(p_n, dtype=torch.float32, device=dev)
    zm = torch.zeros((p_n, M_CAND), dtype=torch.float32, device=dev)
    init = (
        z, z, z, torch.zeros(p_n, dtype=torch.bool, device=dev), z, z,
        torch.zeros(p_n, dtype=torch.int32, device=dev),
        zm, zm, zm, torch.zeros((p_n, M_CAND), dtype=torch.bool, device=dev),
        torch.full((p_n, M_CAND), nb, dtype=torch.int32, device=dev),
    )
    out = march_scan(alt0, elev, step, n_march, shape, table, straight,
                     consumer, init, coarse=coarse, with_slope=True)
    return out[6:]  # cnt, s_h, s_v, s_p, s_d, s_b


def culled_exact_test(pack: TerrainPack, s_h, s_v, s_p, s_d, s_b, az, *, model: EarthModel,
                      shape: EarthShape, table: Optional[RefractionTable], straight: bool,
                      step: float, blocks: CulledBlocks, lat0: float, lon0: float):
    """Stage 3 of ``fused_culled_core``: re-integrate the candidate blocks
    (slots [p, M_CAND]) of pixels with azimuths ``az`` [p]; the first exact
    crossing (key [p, 1], path length [p, 1])."""
    dev = s_h.device
    p_c = s_h.shape[0]
    n_seg, coarse, b_len, nb, _ = blocks
    f_step = _f32(step)
    h, v, pl = s_h.reshape(-1), s_v.reshape(-1), s_p.reshape(-1)
    parts_h = [h[:, None]]
    parts_p = [pl[:, None]]
    for _ in range(BLOCK_WINDOWS):
        h_f, plen_f, h, v = rk4_window(h, v, pl, step, coarse, table, straight,
                                       shape.radius)
        parts_h.append(h_f[:, 1:])
        parts_p.append(plen_f[:, 1:])
        pl = plen_f[:, -1]
    h_fine = torch.cat(parts_h, dim=-1).reshape(p_c, M_CAND, b_len + 1)
    p_fine = torch.cat(parts_p, dim=-1).reshape(p_c, M_CAND, b_len + 1)
    # death rule inside the block (prefix over samples before a segment)
    pref = torch.cumsum((h_fine[..., :-1] < DEATH_ALTITUDE).to(torch.int32), dim=-1)
    no_prior = torch.cat([torch.zeros_like(pref[..., :1]), pref[..., :-1]], dim=-1)
    alive = ~s_d[..., None] & (no_prior == 0)

    local = torch.arange(b_len + 1, dtype=torch.float32, device=dev)
    d = s_b[..., None].to(torch.float32) * _f32(b_len * step) + local * f_step
    dl, dn = model.geodesic_delta(lat0, lon0, az[:, None, None], d)
    dd = h_fine - sample_elevation(pack, dl, dn, lat0, lon0)  # [p, M, B+1]
    d1 = dd[..., :-1]
    d2 = dd[..., 1:]
    seg = s_b[..., None] * b_len + torch.arange(b_len, dtype=torch.int32, device=dev)
    crossing = (d1 * d2 < 0.0) & alive & (seg < n_seg) & (s_b[..., None] < nb)
    cand = torch.where(crossing, seg, combine.NO_HIT_SEG).reshape(p_c, -1)
    cmin, arg = cand.min(dim=-1, keepdim=True)  # candidate segments are unique

    def sel(x):
        return x.reshape(p_c, -1).gather(-1, arg)

    d1s, d2s = sel(d1), sel(d2)
    denom = d1s - d2s
    prop = d1s / torch.where(denom == 0.0, 1.0, denom)
    keyc = torch.where(cmin < combine.NO_HIT_SEG, cmin.to(torch.float32) + prop,
                       combine.NO_HIT)
    return keyc, sel(p_fine[..., :-1]) * (1.0 - prop) + sel(p_fine[..., 1:]) * prop


def culled_test_round(pack: TerrainPack, slots, az_px, key, plh, *, blocks: CulledBlocks,
                      **kw):
    """One round's exact test (``culled_exact_test``) in pixel chunks of
    EXACT_TEST_ELEMS, keeping the nearer hit in ``key`` / ``plh`` [P, 1]
    (updated in place). ``slots`` = (s_h, s_v, s_p, s_d, s_b)."""
    chunk = max(1, EXACT_TEST_ELEMS // (M_CAND * (blocks.b_len + 1)))
    for p0 in range(0, key.shape[0], chunk):
        px = slice(p0, p0 + chunk)
        keyc, plc = culled_exact_test(pack, *(s[px] for s in slots), az_px[px],
                                      blocks=blocks, **kw)
        better = keyc < key[px]
        key[px] = torch.where(better, keyc, key[px])
        plh[px] = torch.where(better, plc, plh[px])


def fused_culled_core(pack: TerrainPack, table: Optional[RefractionTable], alt0,
                      *, cam: tuple, model: EarthModel, shape: EarthShape,
                      straight: bool, step: float, n_terr: int, lat0: float,
                      lon0: float, coloring, fog_distance: Optional[float],
                      terrain_alpha: float):
    """Exact tilted-pinhole frame without dense per-pixel terrain sampling,
    on the device of ``pack``: (image [P, 3] u8, hits [P, 1], rounds) with
    P = W·H pixels in row-major order. ``cam`` = (width, height, fov, tilt,
    direction).

    1. envelope (``culled_envelope``): terrain on an azimuth grid of two
       columns per pixel column, reduced to per-(azimuth interval, block of
       BLOCK_WINDOWS windows) min/max, widened by slack = G·d·δa·1.1 + 1 m +
       seam jump, with G the mosaic's Lipschitz bound
       (``TerrainPack.grad_bound``): conservative, so culling never drops a
       real crossing;
    2. capture (``culled_capture_plain``): one march a round; a block whose
       ray range meets its envelope range stores its start state (h, h', P,
       death) in the pixel's next free slot of M_CAND;
    3. exact test (``culled_test_round``): candidate blocks re-integrate
       from those states (``rk4_window``, bitwise the march's values) and
       sample terrain at each pixel's own azimuth only there;
    4. rounds: 2-3 repeat on the next M_CAND candidates for pixels with
       candidates left and no hit yet, one host sync per round.
    """
    blocks = culled_blocks(n_terr, step)
    nb = blocks.nb
    inp = culled_envelope(pack, cam=cam, model=model, step=step, blocks=blocks, lat0=lat0,
                          lon0=lon0)
    scan_kw = dict(shape=shape, table=table, straight=straight, step=step, blocks=blocks)
    key = torch.full((inp.elev.shape[0], 1), combine.NO_HIT, dtype=torch.float32,
                     device=inp.elev.device)
    plh = torch.zeros_like(key)
    skip = 0
    rounds = 0
    while True:
        cnt, *slots = culled_capture_plain(inp.elev, alt0, inp.env_hi, inp.env_lo,
                                           inp.j_px, skip=skip, **scan_kw)
        culled_test_round(pack, slots, inp.az_px, key, plh, model=model, lat0=lat0,
                          lon0=lon0, **scan_kw)
        skip += M_CAND
        rounds += 1
        if skip >= nb or not bool((torch.isinf(key[:, 0]) & (cnt > skip)).any()):
            break

    hits = ray_hits(pack, model, inp.az_px[:, None], key, plh, lat0=lat0, lon0=lon0,
                    step=step, terrain_alpha=terrain_alpha)
    return _composite_hits(coloring, fog_distance, hits), hits, rounds


def ray_hits(pack: TerrainPack, model: EarthModel, az_col: torch.Tensor,
             key: torch.Tensor, path_length: torch.Tensor, *, lat0: float,
             lon0: float, step: float, terrain_alpha: float) -> HitBuffer:
    """Hit fields at the keys [P, K] of rays with their own azimuths
    ``az_col`` [P, 1] (the tilted paths): positions on each ray's geodesic
    and terrain elevation and normal lerped between the crossing segment's
    two ends."""
    valid = torch.isfinite(key)
    safe = torch.where(valid, key, 0.0)
    k = torch.floor(safe)
    prop = safe - k
    f_step = _f32(step)
    dl1, dn1 = model.geodesic_delta(lat0, lon0, az_col, k * f_step)
    dl2, dn2 = model.geodesic_delta(lat0, lon0, az_col, (k + 1.0) * f_step)
    te1, no1, te2, no2 = _endpoint_pair_terrain(pack, model, dl1, dn1, dl2, dn2,
                                                lat0, lon0)

    def lerp(a, b):
        return a * (1.0 - prop) + b * prop

    return _terrain_hits(
        valid, key, lerp(dl1, dl2), lerp(dn1, dn2), safe * f_step, lerp(te1, te2),
        path_length, no1 * (1.0 - prop[..., None]) + no2 * prop[..., None],
        terrain_alpha,
    )


# ---------------------------------------------------------------------------
# the dense exact per-pixel program
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def _frame_hits(parts, h: int, w: int) -> HitBuffer:
    """[P, K, ...] hit buffers (pixel-row-major chunks) → one [H, W, K, ...]."""
    fields = {}
    for f in dataclasses.fields(HitBuffer):
        x = torch.cat([getattr(p, f.name) for p in parts], dim=0)
        fields[f.name] = x.reshape((h, w) + tuple(x.shape[1:]))
    return HitBuffer(**fields)


def render_rectilinear(params: Params, terrain: Terrain, device) -> RenderResult:
    """Full Rectilinear render (rectilinear.rs:24-60) of opaque terrain
    without scene objects on ``device``, by the plain paths: tilt 0 the
    fused shared-column path, a tilted frame the envelope-culled path. Any
    other frame raises: the reference has no route for it. The image comes
    back to the host; the hits stay on the device. The angle grids of the
    result are the host f64 ones.
    """
    device = torch.device(device)
    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt0 = float(pos.abs_altitude(terrain))
    h, w = out.height, out.width
    if params.terrain_alpha < 1.0 or params.objects:
        raise ValueError("the reference renders Rectilinear frames of opaque terrain "
                         "without objects only")

    elev_rad, dir_rad = camera.rectilinear_ray_params(
        w, h, frame.fov, frame.tilt, frame.direction)  # [H, W] f64
    pack = terrain.pack(*terrain_bbox(params), device)
    table = build_refraction_table(params, alt0, device)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    kw = dict(
        model=params.model,
        shape=params.model.to_shape(),
        straight=params.straight_rays,
        step=float(params.simulation_step),
        n_terr=n_terr,
        lat0=float(pos.latitude),
        lon0=float(pos.longitude),
        coloring=params.coloring,
        fog_distance=params.view.fog_distance,
        terrain_alpha=float(params.terrain_alpha),
    )
    rounds = None
    if frame.tilt == 0.0:
        az = torch.from_numpy(camera.rectilinear_column_azimuths(
            w, frame.fov, frame.direction).astype(np.float32)).to(device)
        image, hits = fused_shared_core(
            pack, table, az, alt0, cam=(w, h, float(frame.fov)), **kw)
    else:
        image, hits, rounds = fused_culled_core(
            pack, table, alt0,
            cam=(w, h, float(frame.fov), float(frame.tilt), float(frame.direction)), **kw)
        image = image.reshape(h, w, 3)
        hits = _frame_hits([hits], h, w)
    return RenderResult(
        image=fetch_flat(image).reshape(image.shape),
        hits=hits,
        elevation_deg=np.rad2deg(elev_rad),
        azimuth_deg=np.rad2deg(dir_rad),
        observer=(pos.latitude, pos.longitude, alt0),
        culled_rounds=rounds,
    )
