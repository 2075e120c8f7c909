"""Rectilinear generator: exact pinhole lens, one ray per pixel (PyTorch).

Counterpart of ``atm_raytracer_tpu/generators/rectilinear.py`` (reference
src/generator/generators/rectilinear.rs): every pixel marches its own ray
along its own geodesic (rectilinear.rs:78-186). Three regimes, all exact:

* tilt == 0 (``fused_shared_core``): at pitch 0 the pixel azimuth is
  ``direction + atan2(x_off, z_focal)``, constant down each image column,
  so the terrain scan is shared per column as in the Fast generator, and
  the per-pixel march streams window by window into the crossing search
  without forming the [H, W, N] ray grid (``tilt0_hits``: on the card the
  CUDA kernel ``csrc/rect_scan.cu``, K3, one thread a pixel in one launch a
  progress stride; on the CPU, or with ``plain``, ``tilt0_hits_plain``:
  ``march_scan_light`` for K = 1, ``march_scan`` for K > 1).
* tilt != 0, opaque terrain (``fused_culled_core``): azimuth couples both
  pixel axes, so nothing is shared; a conservative terrain envelope culls
  the per-pixel sampling to a few candidate blocks (the capture scan,
  ``culled_capture``), which re-integrate from captured ODE states and are
  tested exactly.
* everything else (tilted translucent or object frames, or ``cull=False``):
  ``pixelwise_hits``, the dense per-pixel program, 64 image rows at a time.

Scene objects: at tilt 0, ``shared_column_core`` marches row chunks of rays
in full (the march kernel on the card), finds their crossings against the
shared column terrain (``combine.aligned_crossing_segments``) and merges
``ops.objects.object_hits_pixelwise``; a tilted object frame takes the dense
path, which merges the same object hits. Every other stage is PyTorch ops on
the device of its inputs. The culled path's capture scan is
``culled_capture``: on the card the CUDA kernel ``csrc/rect_culled.cu``, K4,
one thread a pixel in one launch a round; on the CPU, or with ``plain``,
``culled_capture_plain``, a ``march_scan`` over the coarse windows. Its exact
test is ``culled_test_round``: on the card the CUDA kernel
``csrc/rect_exact.cu``, K5, one thread a pixel in one launch a round; on the
CPU, or with ``plain``, ``culled_exact_test`` in pixel chunks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels, tracing
from ..config import Params
from ..models import camera
from ..models.earth import DEGREE_DISTANCE, EarthModel
from ..ops import combine
from ..ops.composite import composite
from ..ops.objects import ObjectSet, merge_hits, object_hits_pixelwise
from ..physics.ray import (
    DEATH_ALTITUDE,
    EarthShape,
    RefractionTable,
    _f32,
    _hermite_basis,
    _scan_start,
    hermite_coeffs,
    hermite_plane,
    march_coarse,
    march_rays,
    march_scan,
    march_scan_light,
    rk4_window,
)
from ..terrain.sample import sample_elevation, sample_terrain_data
from ..terrain.store import Terrain, TerrainPack
from .base import HitBuffer, RenderResult, frame_setup
from .fast import terrain_columns

M_CAND = 4  # candidate blocks captured per pixel per round (culled path)
BLOCK_WINDOWS = 4  # coarse windows per envelope block (culled path)
PIXEL_ROWS = 64  # image rows per chunk of the dense pixelwise path
SEG_CHUNK = 512  # march segments per terrain-sampling chunk of that path
# elements of one [pixels, M_CAND, block + 1] chunk of the culled exact test
EXACT_TEST_ELEMS = 1 << 27
# elements of one row chunk's [R·W, N] march on the tilt-0 object path
# (~1 GB of float32 altitudes)
RECT_CHUNK_ELEMS = 250_000_000


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


def percent_reporter(progress):
    """``emit(frac)`` for a render's host loops: hands ``progress`` the whole
    percent round(100·frac) when it rises, so the values it sees are
    monotone (the reference's per-percent counter, rectilinear.rs:40-49)."""
    last = [-1]

    def emit(frac: float) -> None:
        pct = min(100, int(round(float(frac) * 100.0)))
        if progress is not None and pct > last[0]:
            last[0] = pct
            progress(pct)

    return emit


def _window_progress(emit, k0: int, coarse: int, n_coarse: int) -> None:
    """Progress of the tilt-0 scans after the window at ``k0``: about 32
    lines a frame and always the last window, as the JAX package emits."""
    if emit is None:
        return
    w_i = k0 // coarse
    if w_i % max(1, n_coarse // 32) == 0 or w_i == n_coarse - 1:
        emit(min(1.0, (k0 + coarse) / (n_coarse * coarse)))


# ---------------------------------------------------------------------------
# tilt == 0: column-shared terrain, march streamed into the crossing search
# ---------------------------------------------------------------------------


def first_window_scan(elev_hw, terr_pad, alt0, *, shape: EarthShape,
                      table: Optional[RefractionTable], straight: bool,
                      step: float, n_seg: int, coarse: int, emit=None,
                      rules: Optional["ScanRules"] = None):
    """K = 1, the scan: each pixel's FIRST window holding a sign change of
    ray − terrain, and the ODE state at its start.

    Returns (best_w [H, W] int32, n_coarse + 1 where none; s_h, s_v, s_p
    [H, W]: altitude, slope and path length at that window's start).
    ``terr_pad`` [W, n_coarse·C + 1] is each column's terrain, zero-padded
    past the march. ``first_hit_retest`` resolves the flagged windows.
    ``emit`` (``percent_reporter``) receives the scan's progress. Without
    ``rules`` this is the oracle K3 is held to; with them
    (``tilt0_hits_ruled``) K3's two rules mask the windows they prove idle
    and the returned tuple gains ``_RuleTally``'s fields.
    """
    h_n, w_n = elev_hw.shape
    n_coarse = -(-n_seg // coarse)
    big_w = n_coarse + 1  # "no window yet"
    coeffs = hermite_coeffs(coarse)
    dxw = _f32(step * coarse)
    terr_rows = terr_pad.t().contiguous()  # [n_coarse·C + 1, W]
    inv_r = 0.0 if shape.radius is None else _f32(1.0 / shape.radius)

    def consumer(carry, k0, nodes, alive0):
        best_w, s_h, s_v, s_p, *tally = carry
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
        if rules is not None:
            live = alive0 & (best_w >= big_w)
            go, clear, tally = _RuleTally(*tally).window(
                rules, k0 // coarse, live, h0, v0, vdx, h1, v1dx, dxw, inv_r)
            test = go & ~clear
            has = has & test
            win_min = torch.where(test, win_min, float("inf"))  # K3 ran no samples
            tally = tally.dying(test & ~has & (win_min < DEATH_ALTITUDE))
        carry = (
            best_w.masked_fill(has, k0 // coarse),
            torch.where(has, h0, s_h),
            torch.where(has, v0, s_v),
            torch.where(has, p0, s_p),
            *tally,
        )
        _window_progress(emit, k0, coarse, n_coarse)
        return carry, win_min

    z2 = torch.zeros((h_n, w_n), dtype=torch.float32, device=elev_hw.device)
    init = (torch.full((h_n, w_n), big_w, dtype=torch.int32, device=elev_hw.device),
            z2, z2, z2)
    if rules is not None:
        init = init + tuple(_RuleTally.zeros((h_n, w_n), elev_hw.device))
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


def _multi_hit_scan(elev_hw, terr_pad, alt0, *, shape: EarthShape,
                    table: Optional[RefractionTable], straight: bool,
                    step: float, n_seg: int, coarse: int, max_hits: int, emit=None,
                    rules: Optional["ScanRules"] = None):
    """K > 1: the first ``max_hits`` crossing keys and path lengths
    ([H, W, K], ascending; +inf = empty slot, path length 0 there). Without
    ``rules`` the oracle; with them as in ``first_window_scan``: (key, plh,
    *_RuleTally)."""
    h_n, w_n = elev_hw.shape
    dev = elev_hw.device
    n_coarse = -(-n_seg // coarse)
    dxw = _f32(step * max(1, min(int(coarse), n_seg)))
    inv_r = 0.0 if shape.radius is None else _f32(1.0 / shape.radius)

    def consumer(carry, k0, h_f, plen_f, alive, *slope):
        key, plh, *tally = carry
        c = h_f.shape[-1] - 1
        d = h_f - terr_pad[:, k0:k0 + c + 1]  # [H, W, C+1]
        d1 = d[..., :-1]
        d2 = d[..., 1:]
        seg = torch.arange(k0, k0 + c, dtype=torch.int32, device=dev)
        crossing = (d1 * d2 < 0.0) & alive & (seg < n_seg)
        if rules is not None:
            v0, h1, v1 = slope
            h0 = h_f[..., 0]
            live = alive[..., 0] & (torch.isfinite(key).sum(-1) < max_hits)
            go, clear, tally = _RuleTally(*tally).window(
                rules, k0 // c, live, h0, v0, v0 * dxw, h1, v1 * dxw, dxw, inv_r)
            test = go & ~clear
            crossing = crossing & test[..., None]
            tally = tally.dying(test & (h_f[..., :-1] < DEATH_ALTITUDE).any(-1))
        cmin = combine.k_smallest(torch.where(crossing, seg, combine.NO_HIT_SEG),
                                  max_hits)  # [H, W, K]
        found = cmin < combine.NO_HIT_SEG
        idx = (cmin - k0).clamp(0, c - 1).to(torch.int64)
        d1s = d1.gather(-1, idx)
        d2s = d2.gather(-1, idx)
        pl1 = plen_f[..., :-1].gather(-1, idx)
        pl2 = plen_f[..., 1:].gather(-1, idx)
        denom = d1s - d2s
        prop = d1s / torch.where(denom == 0.0, 1.0, denom)  # utils.rs:232
        keyc = torch.where(found, cmin.to(torch.float32) + prop, combine.NO_HIT)
        plc = torch.where(found, pl1 * (1.0 - prop) + pl2 * prop, 0.0)
        # keys are unique per pixel (windows are disjoint): keep the K
        # smallest of carry + window, each with its own path length
        key, order = torch.topk(torch.cat([key, keyc], dim=-1), max_hits,
                                dim=-1, largest=False, sorted=True)
        _window_progress(emit, k0, coarse, n_coarse)
        return (key, torch.cat([plh, plc], dim=-1).gather(-1, order), *tally)

    key0 = torch.full((h_n, w_n, max_hits), combine.NO_HIT, dtype=torch.float32,
                      device=dev)
    init = (key0, torch.zeros_like(key0))
    if rules is not None:
        init = init + tuple(_RuleTally.zeros((h_n, w_n), dev))
    return march_scan(alt0, elev_hw, step, n_seg, shape, table, straight,
                      consumer, init, coarse=coarse, with_slope=rules is not None)


# K3's two exact rules (csrc/ray_device.cuh, where they are argued)
RULE_U_TOP = 1.5  # the band's highest u = 1 + h/R (sphere)
RULE_DELTA = 1e-3  # the share of the geometric term h'' keeps on the band
RULE_L_UP = 1e-2  # the band's highest l, times R (sphere): rays bend up <= R/100
RULE_U_EXIT = 1.1  # the exit's highest u
RULE_TAN_CAP = 0.1  # the exit's cap: v sin(T) <= 0.1 u, T the march's arc
RULE_THETA_MAX = 0.5  # the longest march (arc / R) the cap covers
RULE_M_ABS = 1e-3  # meters, the exit margin's floor
RULE_M_REL = 2.0 ** -19  # the hull's rounding margin, of |h0| + |h1| + |vdx| + |v1dx|
RULE_M_EXIT = 2.0 ** -18  # the exit's rounding margin, of |h| + v dx
RULE_THIRD = _f32(1.0 / 3.0)


def _f32_up(x: float) -> float:
    """The least float32 >= x."""
    y = np.float32(x)
    return float(y if y >= x else np.nextafter(y, np.float32(np.inf)))


def _f32_down(x: float) -> float:
    """The greatest float32 <= x."""
    y = np.float32(x)
    return float(y if y <= x else np.nextafter(y, np.float32(-np.inf)))


@dataclasses.dataclass(frozen=True)
class ScanRules:
    """The inputs of K3's two rules for one scan (``scan_rules``): each
    window's terrain maximum ``tmax`` and its suffix maximum ``smax``
    [n_coarse, W] (the highest terrain of this and every later window,
    +inf where a window's terrain holds a NaN), and the exit's band
    (``h_safe``), cap (``h_top``, ``k_cap``) and margin floor ``m_abs``, as
    float32 values rounded the safe way."""

    tmax: torch.Tensor
    smax: torch.Tensor
    h_safe: float
    h_top: float
    k_cap: float
    m_abs: float


def scan_rules(terr_rows, *, coarse: int, n_coarse: int, shape: EarthShape,
               table: Optional[RefractionTable], straight: bool, step: float) -> ScanRules:
    """K3's rule inputs for ``terr_rows`` [n_coarse·C + 1, W] (zero past the
    march) on its device; the wrapper passes them to the kernel and
    ``tilt0_hits_ruled`` to the plain predicates. ``h_safe`` is the lowest
    altitude above which l, as the launch evaluates it, keeps every ray with
    h' >= 0 climbing: -(1 - RULE_DELTA)/(RULE_U_TOP·R) <= l <=
    RULE_L_UP / R on the sphere, l = 0 on the flat shape
    (``RefractionTable.band_altitude``), and
    never below DEATH_ALTITUDE; straight rays drop l, so it is
    DEATH_ALTITUDE. On the sphere a march longer than RULE_THETA_MAX·R
    turns the exit off."""
    windows = terr_rows[: n_coarse * coarse + 1].unfold(0, coarse + 1, coarse)
    tmax = windows.amax(-1)  # [n_coarse, W]
    tmax = tmax.masked_fill(torch.isnan(tmax), float("inf"))
    smax = tmax.flip(0).cummax(0).values.flip(0)
    refract = not straight and table is not None
    if shape.is_flat:
        floor = ceil = 0.0
    else:
        floor = -(1.0 - RULE_DELTA) / (RULE_U_TOP * shape.radius)
        ceil = RULE_L_UP / shape.radius
    h_safe = max(table.band_altitude(floor, ceil) if refract else -np.inf, DEATH_ALTITUDE)
    dx = _f32(step * coarse)
    if shape.is_flat:
        h_top, k_cap, m_abs = np.inf, 0.0, RULE_M_ABS
    else:
        theta = n_coarse * dx / shape.radius
        if theta > RULE_THETA_MAX:
            h_safe = np.inf
        h_top = (RULE_U_EXIT - 1.0) * shape.radius
        k_cap = math.sin(theta) / RULE_TAN_CAP
        m_abs = dx * dx / (4.0 * shape.radius) + RULE_M_ABS
    return ScanRules(tmax.contiguous(), smax.contiguous(), _f32_up(h_safe),
                     _f32_down(h_top), _f32_up(k_cap), _f32_up(m_abs))


def rule_exit(rules: ScanRules, h, v, dx: float, inv_r: float, s):
    """K3's terrain-clear exit (``ray_device.cuh::terrain_clear_exit``) in
    PyTorch, the same float32 operations: (h, v) at a window start, ``s``
    that window's ``smax``; ``inv_r`` 0 on the flat shape."""
    lo = h - (rules.m_abs + RULE_M_EXIT * (h.abs() + v * dx))
    return ((v >= 0.0) & (h >= rules.h_safe) & (h <= rules.h_top)
            & (v * rules.k_cap <= 1.0 + h * inv_r) & (lo > s) & (lo > DEATH_ALTITUDE))


def rule_hull_clear(h0, vdx, h1, v1dx, t):
    """K3's window cull (``ray_device.cuh::hull_clear``) in PyTorch: the
    window's samples, bounded from below by its Bezier control points less
    the rounding margin, all above its terrain maximum ``t`` and above
    DEATH_ALTITUDE. NaN anywhere gives False, as on the card."""
    lo = (torch.minimum(torch.minimum(h0, h0 + vdx * RULE_THIRD),
                        torch.minimum(h1 - v1dx * RULE_THIRD, h1))
          - RULE_M_REL * (h0.abs() + h1.abs() + vdx.abs() + v1dx.abs()))
    return (lo > t) & (lo > DEATH_ALTITUDE)


class _RuleTally(NamedTuple):
    """What the rules did to each pixel of a plain scan run with them
    (``first_window_scan`` / ``_multi_hit_scan`` with ``rules``), [H, W]."""

    exited: torch.Tensor  # bool: stopped by the exit
    marched: torch.Tensor  # int32: windows marched, K3's count
    plain: torch.Tensor  # int32: windows the scan runs without the rules
    skipped: torch.Tensor  # int32: windows marched whose test the hull cleared
    died: torch.Tensor  # bool: stopped by a death in a tested window

    @staticmethod
    def zeros(shape, device) -> "_RuleTally":
        b = torch.zeros(shape, dtype=torch.bool, device=device)
        i = torch.zeros(shape, dtype=torch.int32, device=device)
        return _RuleTally(b, i, i, i, b)

    def window(self, rules: ScanRules, i: int, live, h0, v0, vdx, h1, v1dx, dx: float,
               inv_r: float):
        """Window ``i`` for the pixels ``live`` without the rules: (marched,
        cleared by the hull, the tally after it)."""
        run = live & ~self.exited
        leave = run & rule_exit(rules, h0, v0, dx, inv_r, rules.smax[i])
        go = run & ~leave
        clear = go & rule_hull_clear(h0, vdx, h1, v1dx, rules.tmax[i])
        return go, clear, _RuleTally(self.exited | leave, self.marched + go.int(),
                                     self.plain + live.int(), self.skipped + clear.int(),
                                     self.died)

    def dying(self, dies) -> "_RuleTally":
        return self._replace(died=self.died | dies)


def tilt0_hits_ruled(elev_hw, terr_pad, alt0, *, shape: EarthShape,
                     table: Optional[RefractionTable], straight: bool, step: float,
                     n_seg: int, coarse: int, max_hits: int, emit=None):
    """The plain scan with K3's two rules applied, in PyTorch on any device:
    (key, path length [H, W, K], flags [H, W] int32 as K3 writes them,
    ``_RuleTally``). A pixel the exit stops tests no later window; a window
    the hull clears runs no test and no death check. Where the rules are
    exact, key and path length are ``torch.equal`` to ``tilt0_hits_plain``'s;
    the tally counts the windows each pixel marches with the rules
    (``marched``, K3's work) and without them (``plain``)."""
    coarse = max(1, min(int(coarse), n_seg))
    n_coarse = -(-n_seg // coarse)
    terr_rows = terr_pad.to(torch.float32).t().contiguous()
    rules = scan_rules(terr_rows, coarse=coarse, n_coarse=n_coarse, shape=shape,
                       table=table, straight=straight, step=step)
    scan_kw = dict(shape=shape, table=table, straight=straight, step=step, n_seg=n_seg,
                   coarse=coarse)
    if max_hits == 1:
        best_w, s_h, s_v, s_p, *tally = first_window_scan(
            elev_hw, terr_pad, alt0, emit=emit, rules=rules, **scan_kw)
        key, plh = first_hit_retest(best_w, s_h, s_v, s_p, terr_pad, **scan_kw)
        tally = _RuleTally(*tally)
        stopped = best_w <= n_coarse
    else:
        key, plh, *tally = _multi_hit_scan(elev_hw, terr_pad, alt0, max_hits=max_hits,
                                           emit=emit, rules=rules, **scan_kw)
        tally = _RuleTally(*tally)
        stopped = torch.isfinite(key).sum(-1) == max_hits
    hits = torch.isfinite(key).sum(-1).to(torch.int32)
    done = (stopped | tally.died | tally.exited).to(torch.int32)
    flags = (tally.marched << SCAN_WINDOWS_SHIFT) | (hits << 1) | done
    return key, plh, flags, tally


def tilt0_hits_plain(elev_hw, terr_pad, alt0, *, shape: EarthShape,
                     table: Optional[RefractionTable], straight: bool, step: float,
                     n_seg: int, coarse: int, max_hits: int, emit=None):
    """The tilt-0 scan in plain PyTorch, on any device: (key, path length)
    [H, W, K], K = ``max_hits``; key +inf (path length 0) where there is no
    hit. K = 1: ``first_window_scan`` + ``first_hit_retest``; K > 1:
    ``_multi_hit_scan``. The oracle of K3 (``tilt0_hits_cuda``)."""
    scan_kw = dict(shape=shape, table=table, straight=straight, step=step, n_seg=n_seg,
                   coarse=coarse)
    if max_hits == 1:
        found = first_window_scan(elev_hw, terr_pad, alt0, emit=emit, **scan_kw)
        return first_hit_retest(*found, terr_pad, **scan_kw)
    return _multi_hit_scan(elev_hw, terr_pad, alt0, max_hits=max_hits, emit=emit,
                           **scan_kw)


def tilt0_hits(elev_hw, terr_pad, alt0, *, shape: EarthShape,
               table: Optional[RefractionTable], straight: bool, step: float,
               n_seg: int, coarse: int, max_hits: int, emit=None, plain: bool = False):
    """Each pixel's first ``max_hits`` crossings with its column's terrain:
    (key, path length) [H, W, K] for the pixel elevations ``elev_hw`` [H, W]
    (radians) and ``terr_pad`` [W, n_coarse·C + 1] (zero past the march).

    CUDA tensors launch K3 (``tilt0_hits_cuda``) and raise if it cannot be
    built or launched; CPU tensors, or ``plain`` on any device, run
    ``tilt0_hits_plain``. ``emit`` (``percent_reporter``) receives the
    scan's progress, at the same values either way.
    """
    kw = dict(shape=shape, table=table, straight=straight, step=step, n_seg=n_seg,
              coarse=coarse, max_hits=max_hits, emit=emit)
    with tracing.span("rect.scan"):
        if plain or elev_hw.device.type == "cpu":
            return tilt0_hits_plain(elev_hw, terr_pad, alt0, **kw)
        if elev_hw.device.type != "cuda":
            raise ValueError(f"tilt0_hits: unsupported device {elev_hw.device}")
        key, plh, _ = tilt0_hits_cuda(elev_hw, terr_pad, alt0, **kw)
    return key, plh


def scan_launches(n_coarse: int):
    """K3's launches: (w0, w1) window ranges, one a progress stride of
    ``_window_progress`` (36 for 250 windows)."""
    stride = max(1, n_coarse // 32)
    return [(w0, min(w0 + stride, n_coarse)) for w0 in range(0, n_coarse, stride)]


# K3's per-pixel flags word (csrc/rect_scan.cu): windows run << 9 | hits << 1 | done
SCAN_WINDOWS_SHIFT = 9


def tilt0_hits_cuda(elev_hw, terr_pad, alt0, *, shape: EarthShape,
                    table: Optional[RefractionTable], straight: bool, step: float,
                    n_seg: int, coarse: int, max_hits: int, emit=None):
    """Launch K3 (``csrc/rect_scan.cu``) on the device of ``elev_hw``:
    (key, path length [H, W, K], flags [H, W] int32). ``flags >>
    SCAN_WINDOWS_SHIFT`` is the number of windows each pixel marched before
    it stopped (the scan's work); it marched windows 0 .. that count - 1.

    One launch a progress stride (``scan_launches``), the pixels' state kept
    on the device between launches and ``emit`` called on the host between
    them, with no synchronisation. The start slopes are the plain version's
    (``_scan_start``); l(h) comes from ``table.poly`` when it exists, else
    from the table; ``straight`` or no table marches without refraction.
    The two rules' inputs come from ``scan_rules``.
    """
    dev = elev_hw.device
    h_n, w_n = elev_hw.shape
    _, v0, coarse, n_coarse = _scan_start(alt0, elev_hw, shape, n_seg, coarse)
    v0 = v0.contiguous()
    if terr_pad.shape[0] != w_n or terr_pad.shape[1] < n_coarse * coarse + 1:
        raise ValueError(f"tilt0_hits_cuda: terr_pad {tuple(terr_pad.shape)} does not "
                         f"cover {w_n} columns of {n_coarse * coarse + 1} samples")
    terr_rows = terr_pad.to(torch.float32).t().contiguous()  # [n_coarse·C + 1, W]
    refract = not straight and table is not None
    if refract and table.stacked:
        raise ValueError("tilt0_hits_cuda: the scan takes one table, not a stack")
    if refract and table.poly is not None:
        poly, n_poly = table.poly_rows(), len(table.poly)
    else:
        poly, n_poly = None, 0
    pairs = table.pairs.contiguous() if refract else None
    for t in (terr_rows, poly, pairs):
        if t is not None and t.device != dev:
            raise ValueError("tilt0_hits_cuda: terrain, table and pixels live on "
                             "different devices")
    radius = shape.radius
    basis = _hermite_basis(coarse, dev)
    rules = scan_rules(terr_rows, coarse=coarse, n_coarse=n_coarse, shape=shape,
                       table=table, straight=straight, step=step)
    p_n = h_n * w_n
    key = torch.empty((h_n, w_n, max_hits), dtype=torch.float32, device=dev)
    plh = torch.empty_like(key)
    flags = torch.empty((h_n, w_n), dtype=torch.int32, device=dev)
    if p_n == 0:
        return key, plh, flags
    state = torch.empty((3, p_n), dtype=torch.float32, device=dev)
    fstep = _f32(step)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # the arguments once; a launch sets its windows [w0, w1) (args[9:11])
    args = [
        v0.data_ptr(), h_n, w_n, v0.stride(0), _f32(alt0), terr_rows.data_ptr(),
        terr_rows.stride(0), int(n_seg), int(coarse), 0, 0, _f32(step * coarse),
        ptr(poly), n_poly, ptr(pairs), int(table.values.shape[-1]) if refract else 0,
        table.h0 if refract else 0.0, table.inv_dh if refract else 0.0, int(refract),
        0.0 if radius is None else _f32(1.0 / radius),
        0.0 if radius is None else _f32(radius), 0 if radius is None else 1, fstep,
        _f32(np.float32(fstep) * np.float32(fstep)), basis.data_ptr(), int(max_hits),
        state.data_ptr(), flags.data_ptr(), key.data_ptr(), plh.data_ptr(),
        rules.tmax.data_ptr(), rules.smax.data_ptr(), rules.h_safe, rules.h_top,
        rules.k_cap, rules.m_abs,
    ]
    for w0, w1 in scan_launches(n_coarse):
        args[9:11] = w0, w1
        _kernels.RECT_SCAN.call(dev, *args)
        for w in range(w0, w1):
            _window_progress(emit, w * coarse, coarse, n_coarse)
    return key, plh, flags


def fused_shared_core(pack: TerrainPack, table: Optional[RefractionTable],
                      az_deg: torch.Tensor, alt0, *, cam: tuple,
                      model: EarthModel, shape: EarthShape, straight: bool,
                      step: float, n_terr: int, max_hits: int, lat0: float,
                      lon0: float, coloring, fog_distance: Optional[float],
                      terrain_alpha: float, emit=None,
                      rows: Optional[torch.Tensor] = None, plain: bool = False):
    """The whole tilt-0 Rectilinear frame on the device of ``az_deg`` [W]:
    (image [H, W, 3] u8, hits [H, W, K]). ``cam`` = (width, height, fov).
    ``rows`` (int64 indices on that device) renders only those image rows
    (a row shard, ``parallel.mesh``): image and hits are then [R, W, ...].
    The scan is ``tilt0_hits``: K3 on the card unless ``plain``.

    The pixel elevation grid is derived on the device in float32; it does
    not depend on the view direction, so direction 0 serves.
    """
    elev_hw, terr_pad, stacked, coarse = tilt0_inputs(
        pack, az_deg, cam=cam, model=model, step=step, n_terr=n_terr, lat0=lat0,
        lon0=lon0, rows=rows)
    key, plh = tilt0_hits(elev_hw, terr_pad, alt0, shape=shape, table=table,
                          straight=straight, step=step, n_seg=n_terr - 1, coarse=coarse,
                          max_hits=max_hits, emit=emit, plain=plain)
    hits = column_hits(stacked, key, plh, az_deg.to(torch.float32), model=model,
                       lat0=lat0, lon0=lon0, step=step, terrain_alpha=terrain_alpha)
    return _composite_hits(coloring, fog_distance, hits), hits


def tilt0_inputs(pack: TerrainPack, az_deg: torch.Tensor, *, cam: tuple,
                 model: EarthModel, step: float, n_terr: int, lat0: float, lon0: float,
                 rows: Optional[torch.Tensor] = None):
    """The tilt-0 scan's inputs on the device of ``az_deg`` [W]: (elev_hw
    [H, W] or [R, W] with ``rows``, terr_pad [W, n_coarse·C + 1], the
    columns' elevation and normal stack [W, N, 4], the window length C).

    C is clamped as the scans clamp it: the K = 1 re-expansion and the
    window bookkeeping must use the window length the scan integrated.
    """
    n_seg = n_terr - 1
    coarse = max(1, min(march_coarse(step), n_seg))
    width, height, fov = cam
    elev_hw, _ = camera.rectilinear_ray_params_device(width, height, fov, 0.0, 0.0,
                                                      az_deg.device)
    if rows is not None:
        elev_hw = elev_hw.index_select(0, rows)
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


def auto_chunk_rows(width: int, height: int, n_terr: int) -> int:
    """Image rows a chunk of the tilt-0 object path: RECT_CHUNK_ELEMS over
    the [W, N] march of one row."""
    return int(min(height, max(1, RECT_CHUNK_ELEMS // max(1, width * n_terr))))


def shared_column_core(pack: TerrainPack, table: Optional[RefractionTable],
                       objects: ObjectSet, elev_hw: torch.Tensor, az_deg: torch.Tensor,
                       alt0, *, model: EarthModel, shape: EarthShape, straight: bool,
                       step: float, n_terr: int, max_hits: int, lat0: float,
                       lon0: float, coloring, fog_distance: Optional[float],
                       terrain_alpha: float, chunk_rows: int, emit=None,
                       plain: bool = False):
    """The tilt-0 Rectilinear frame with scene objects, on the device of
    ``az_deg`` [W]: (image [H, W, 3] u8, hits [H, W, K]); ``elev_hw``
    [H, W] the pixels' elevations in radians (the host grid, as float32).

    The terrain scan is shared per column (utils.rs:176-199). Per chunk of
    ``chunk_rows`` image rows: march every ray (``march_rays``: the march
    kernel on the card unless ``plain``), find each ray's crossings against
    its column's terrain (``aligned_crossing_segments``), rebuild the hit
    fields at them, merge the object hits of the chunk's rays, composite.
    ``emit`` receives the share of the chunks done.
    """
    n_seg = n_terr - 1
    height, width = elev_hw.shape
    az = az_deg.to(torch.float32)
    f_step = _f32(step)
    terr_elev, terr_normal = terrain_columns(pack, model, az, lat0, lon0, step, n_terr)
    stacked = torch.cat([terr_elev[..., None], terr_normal], dim=-1)  # [W, N, 4]
    starts = range(0, height, chunk_rows)
    images, parts = [], []
    for i, r0 in enumerate(starts):
        elev = elev_hw[r0:r0 + chunk_rows]
        r_n = elev.shape[0]
        rw = r_n * width
        ray_h, path_len = march_rays(alt0, elev.reshape(-1), step, n_seg, shape, table,
                                     straight, coarse=march_coarse(step),
                                     plain=plain)  # [R·W, n_terr]
        segs = combine.aligned_crossing_segments(
            ray_h.reshape(r_n, width, n_terr), terr_elev, n_seg, max_hits)  # [R, W, K]
        valid = segs < n_seg
        ks = torch.where(valid, segs, 0)
        # the fields at the crossings (utils.rs:108-133), as in the Fast
        # generator's stage 4
        c_lo, c_hi = combine.gather_column_pairs(stacked, ks)  # [R, W, K, 4]
        ks_rays = ks.reshape(rw, max_hits)
        h_lo, h_hi = (x.reshape(r_n, width, max_hits)
                      for x in combine.gather_ray_pairs(ray_h, ks_rays))
        p_lo, p_hi = (x.reshape(r_n, width, max_hits)
                      for x in combine.gather_ray_pairs(path_len, ks_rays))
        d1 = h_lo - c_lo[..., 0]
        d2 = h_hi - c_hi[..., 0]
        denom = d1 - d2
        prop = d1 / torch.where(denom == 0.0, 1.0, denom)  # utils.rs:232
        keys = torch.where(valid, ks.to(torch.float32) + prop, combine.NO_HIT)
        safe_keys = torch.where(valid, keys, 0.0)
        hit = c_lo * (1.0 - prop[..., None]) + c_hi * prop[..., None]
        hit_dlat, hit_dlon = model.geodesic_delta(lat0, lon0, az[None, :, None],
                                                  safe_keys * f_step)

        def rays(x):  # [R, W, K] → [R·W, K]
            return x.reshape(rw, max_hits)

        hits = _terrain_hits(
            rays(valid), rays(keys), rays(hit_dlat), rays(hit_dlon),
            rays(safe_keys * f_step), rays(hit[..., 0]),
            rays(p_lo * (1.0 - prop) + p_hi * prop),
            hit[..., 1:4].reshape(rw, max_hits, 3), terrain_alpha)
        az_rays = az[None, :].expand(r_n, width).reshape(-1)
        obj_hits = object_hits_pixelwise(objects, model, lat0, lon0, step, n_terr,
                                         ray_h, path_len, az_rays)
        hits = merge_hits(hits, obj_hits, max_hits + obj_hits.key.shape[-1])
        images.append(_composite_hits(coloring, fog_distance, hits))
        parts.append(hits)
        if emit is not None:
            emit((i + 1) / len(starts))
    image = torch.cat(images, dim=0).reshape(height, width, 3)
    return image, _frame_hits(parts, height, width)


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
    nb in an empty slot). The oracle of K4 (``culled_capture_cuda``)."""
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


def culled_capture_cuda(elev, alt0, env_hi, env_lo, j_px, *, skip: int,
                        shape: EarthShape, table: Optional[RefractionTable],
                        straight: bool, step: float, blocks: CulledBlocks,
                        count_windows: bool = False):
    """Launch K4 (``csrc/rect_culled.cu``) once on the device of ``elev``:
    ``culled_capture_plain``'s six outputs and, with ``count_windows``,
    windows [P] int32, the windows each pixel marched (all nb ·
    BLOCK_WINDOWS unless its ray died: a pixel stops at the first block
    that starts dead), else None.

    The start slopes are the plain version's (``_scan_start``); l(h) comes
    from ``table.poly`` when it exists, else from the table; ``straight`` or
    no table marches without refraction. The envelope is read in place:
    no [nb, P] copy of it is made. A captured block starts alive, so every
    death flag s_d is false: the wrapper makes it, the kernel does not."""
    dev = elev.device
    p_n = elev.shape[0]
    n_seg, coarse, _, nb, n_march = blocks
    _, v0, coarse, _ = _scan_start(alt0, elev, shape, n_march, coarse)
    v0 = v0.contiguous()
    n_env = env_hi.shape[0]
    if env_hi.shape != (n_env, nb) or env_lo.shape != (n_env, nb) or j_px.shape != (p_n,):
        raise ValueError(f"culled_capture_cuda: envelope {tuple(env_hi.shape)} / "
                         f"{tuple(env_lo.shape)} and rows {tuple(j_px.shape)} do not fit "
                         f"{p_n} pixels of {nb} blocks")
    env_hi = env_hi.to(torch.float32).contiguous()
    env_lo = env_lo.to(torch.float32).contiguous()
    rows = j_px.to(torch.int32).contiguous()
    ode, held = _ray_ode_args("culled_capture_cuda", table, straight, shape, dev)
    for t in (env_hi, env_lo, rows):
        if t.device != dev:
            raise ValueError("culled_capture_cuda: envelope, table and pixels live on "
                             "different devices")
    basis = _hermite_basis(coarse, dev)
    cnt = torch.empty(p_n, dtype=torch.int32, device=dev)
    windows = torch.empty_like(cnt) if count_windows else None
    s_h = torch.empty((p_n, M_CAND), dtype=torch.float32, device=dev)
    s_v = torch.empty_like(s_h)
    s_p = torch.empty_like(s_h)
    s_d = torch.zeros((p_n, M_CAND), dtype=torch.bool, device=dev)
    s_b = torch.empty((p_n, M_CAND), dtype=torch.int32, device=dev)
    if p_n == 0:
        return cnt, s_h, s_v, s_p, s_d, s_b, windows
    fstep = _f32(step)
    _kernels.RECT_CULLED.call(
        dev, v0.data_ptr(), p_n, _f32(alt0), int(n_seg), int(coarse), int(n_march), nb,
        BLOCK_WINDOWS, M_CAND, int(skip), _f32(step * coarse), *ode, fstep,
        _f32(np.float32(fstep) * np.float32(fstep)), basis.data_ptr(), env_hi.data_ptr(),
        env_lo.data_ptr(), rows.data_ptr(), cnt.data_ptr(), s_h.data_ptr(), s_v.data_ptr(),
        s_p.data_ptr(), s_b.data_ptr(), None if windows is None else windows.data_ptr())
    return cnt, s_h, s_v, s_p, s_d, s_b, windows


def _ray_ode_args(who: str, table: Optional[RefractionTable], straight: bool,
                  shape: EarthShape, dev):
    """l(h) and the shape as K4's and K5's entry points take them: (poly,
    n_poly, pairs, n_table, h0, inv_dh, refract, inv_r, radius, spherical),
    and the tensors those pointers point into, to hold until the launch. The
    Chebyshev rows (``table.poly``) when they exist, else the table's pairs;
    ``straight`` or no table marches without refraction."""
    refract = not straight and table is not None
    if refract and table.stacked:
        raise ValueError(f"{who}: the scan takes one table, not a stack")
    if refract and table.poly is not None:
        poly, n_poly = table.poly_rows(), len(table.poly)
    else:
        poly, n_poly = None, 0
    pairs = table.pairs.contiguous() if refract else None
    for t in (poly, pairs):
        if t is not None and t.device != dev:
            raise ValueError(f"{who}: envelope, table and pixels live on different devices")
    radius = shape.radius
    args = (None if poly is None else poly.data_ptr(), n_poly,
            None if pairs is None else pairs.data_ptr(),
            int(table.values.shape[-1]) if refract else 0, table.h0 if refract else 0.0,
            table.inv_dh if refract else 0.0, int(refract),
            0.0 if radius is None else _f32(1.0 / radius),
            0.0 if radius is None else _f32(radius), 0 if radius is None else 1)
    return args, (poly, pairs)


def culled_capture(elev, alt0, env_hi, env_lo, j_px, *, skip: int, shape: EarthShape,
                   table: Optional[RefractionTable], straight: bool, step: float,
                   blocks: CulledBlocks, plain: bool = False):
    """One round's capture scan (``culled_capture_plain``'s six outputs).
    CUDA tensors launch K4 (``culled_capture_cuda``) and raise if it cannot
    be built or launched; CPU tensors, or ``plain`` on any device, run
    ``culled_capture_plain``."""
    kw = dict(skip=skip, shape=shape, table=table, straight=straight, step=step,
              blocks=blocks)
    if plain or elev.device.type == "cpu":
        return culled_capture_plain(elev, alt0, env_hi, env_lo, j_px, **kw)
    if elev.device.type != "cuda":
        raise ValueError(f"culled_capture: unsupported device {elev.device}")
    return culled_capture_cuda(elev, alt0, env_hi, env_lo, j_px, **kw)[:6]


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


# csrc/terrain_device.cuh's GeoForm of each canonical model kind, and GEO_CONSTS
GEO_FORMS = {"FlatDistorted": 0, "AzimuthalEquidistant": 1, "Spherical": 2,
             "ObserverAe": 2, "Ellipsoid": 3}
GEO_CONSTS = 12


def geodesic_form(model: EarthModel, lat0: float):
    """(form, constants [GEO_CONSTS] float32) of ``model.geodesic_delta`` as
    K5 evaluates it (``csrc/terrain_device.cuh``): the form of the model's
    kind, and each host scalar its expressions hold, rounded to float32 as
    PyTorch rounds a scalar operand."""
    m = model._canonical()
    form = GEO_FORMS[m.kind]
    if m.kind == "FlatDistorted":
        consts = [DEGREE_DISTANCE, np.cos(np.deg2rad(lat0))]
    elif m.kind == "AzimuthalEquidistant":
        consts = [DEGREE_DISTANCE, _f32((90.0 - lat0) * DEGREE_DISTANCE)]
    elif form == GEO_FORMS["Spherical"]:
        la0 = np.deg2rad(np.float64(lat0))
        consts = [m.radius, np.sin(la0), np.cos(la0)]
    else:
        a, b = m.a, m.b
        f = (a - b) / a
        u1 = float(np.arctan((1.0 - f) * np.tan(np.deg2rad(np.float64(lat0)))))
        delta1 = np.arctan(f * np.sin(u1) * np.cos(u1) / (1.0 - f * np.cos(u1) ** 2))
        consts = [b, np.sin(u1), np.cos(u1), np.tan(u1), delta1, f,
                  (a * a - b * b) / (b * b), f / 16.0, u1]
    out = np.zeros(GEO_CONSTS, np.float32)
    out[:len(consts)] = np.asarray(consts, np.float64)
    return form, out


def culled_exact_test_cuda(pack: TerrainPack, s_h, s_v, s_p, s_d, s_b, az, key, plh, *,
                           model: EarthModel, shape: EarthShape,
                           table: Optional[RefractionTable], straight: bool, step: float,
                           blocks: CulledBlocks, lat0: float, lon0: float) -> None:
    """Launch K5 (``csrc/rect_exact.cu``) once on the device of ``key``: the
    exact test of slots [P, M_CAND] (``culled_capture``'s) for pixels with
    azimuths ``az`` [P], keeping the nearer hit in ``key`` / ``plh`` [P, 1]
    (updated in place) as ``culled_exact_test`` does. Pixels whose key is
    not +inf are skipped, and a pixel stops at its first crossing: the slots
    hold increasing blocks, as the capture fills them. No [P, M_CAND,
    b_len + 1] tensor is made."""
    dev = key.device
    p_n = key.shape[0]
    n_seg, coarse, b_len, nb, _ = blocks
    slots = (s_h, s_v, s_p, s_d, s_b)
    want = ((torch.float32,) * 3 + (torch.bool, torch.int32))
    if any(s.shape != (p_n, M_CAND) or s.dtype != w for s, w in zip(slots, want)) or \
            az.shape != (p_n,) or key.shape != (p_n, 1) or plh.shape != (p_n, 1) or \
            key.dtype != torch.float32 or plh.dtype != torch.float32:
        raise ValueError(
            f"culled_exact_test_cuda: slots {[tuple(s.shape) for s in slots]}, azimuths "
            f"{tuple(az.shape)} and hits {tuple(key.shape)} / {tuple(plh.shape)} do not fit "
            f"{p_n} pixels of {M_CAND} slots (float32 states, bool deaths, int32 blocks)")
    if not (key.is_contiguous() and plh.is_contiguous()):
        raise ValueError("culled_exact_test_cuda: key and plh are updated in place and "
                         "must be contiguous")
    if any(t.device != dev for t in (*slots, az, plh, pack.tiles, pack.rows_m1,
                                     pack.cols_m1)):
        raise ValueError("culled_exact_test_cuda: slots, azimuths, hits and terrain live "
                         "on different devices")
    if p_n == 0:
        return
    ode, held = _ray_ode_args("culled_exact_test_cuda", table, straight, shape, dev)
    slots = tuple(s.contiguous() for s in slots)
    az = az.to(torch.float32).contiguous()
    tiles = pack.tiles.contiguous()
    if tiles.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"culled_exact_test_cuda: tiles of {tiles.dtype}")
    rows_m1 = pack.rows_m1.contiguous()
    cols_m1 = pack.cols_m1.contiguous()
    form, geo = geodesic_form(model, lat0)
    basis = _hermite_basis(coarse, dev)
    fstep = _f32(step)
    lat0_floor, lon0_floor = math.floor(lat0), math.floor(lon0)
    _kernels.RECT_EXACT.call(
        dev, p_n, M_CAND, nb, int(n_seg), int(coarse), BLOCK_WINDOWS,
        *(s.data_ptr() for s in slots), az.data_ptr(), key.data_ptr(), plh.data_ptr(),
        _f32(step * coarse), fstep, _f32(np.float32(fstep) * np.float32(fstep)),
        _f32(b_len * step), *ode, basis.data_ptr(), tiles.data_ptr(),
        int(tiles.dtype == torch.float32), rows_m1.data_ptr(), cols_m1.data_ptr(),
        int(tiles.shape[1]), pack.n_rows, pack.n_cols, lat0_floor - pack.lat_min,
        lon0_floor - pack.lon_min, _f32(lat0 - lat0_floor), _f32(lon0 - lon0_floor), form,
        geo.ctypes.data)


def culled_test_round(pack: TerrainPack, slots, az_px, key, plh, *, blocks: CulledBlocks,
                      plain: bool = False, **kw):
    """One round's exact test, keeping the nearer hit in ``key`` / ``plh``
    [P, 1] (updated in place). ``slots`` = (s_h, s_v, s_p, s_d, s_b). CUDA
    tensors launch K5 once (``culled_exact_test_cuda``) and raise if it
    cannot be built or launched; CPU tensors, or ``plain`` on any device, run
    ``culled_exact_test`` in pixel chunks of EXACT_TEST_ELEMS.

    While recording, the span carries ``rect.test_slots``: the filled slots
    (block < nb) of the pixels with no hit yet (key +inf), the slots K5
    walks at most."""
    dev = key.device
    with tracing.span("rect.exact_test", device=True) as recording:
        if recording is not None:  # the span is None while the recorder is off
            tracing.count("rect.test_slots", ((slots[4] < blocks.nb)
                                              & (key == combine.NO_HIT)).sum())
        if not plain and dev.type == "cuda":
            culled_exact_test_cuda(pack, *slots, az_px, key, plh, blocks=blocks, **kw)
            return
        if not plain and dev.type != "cpu":
            raise ValueError(f"culled_test_round: unsupported device {dev}")
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
                      terrain_alpha: float, emit=None, plain: bool = False):
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
    2. capture (``culled_capture``): one march a round; a block whose ray
       range meets its envelope range stores its start state (h, h', P,
       death) in the pixel's next free slot of M_CAND. On the card K4, one
       launch a round, unless ``plain``;
    3. exact test (``culled_test_round``): candidate blocks re-integrate
       from those states (``rk4_window``, bitwise the march's values) and
       sample terrain at each pixel's own azimuth only there. On the card
       K5, one launch a round, which walks only the filled slots of pixels
       with no hit yet, unless ``plain``;
    4. rounds: 2-3 repeat on the next M_CAND candidates for pixels with
       candidates left and no hit yet, one host sync per round.

    ``emit`` receives the share of the blocks whose candidates were tested.
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
        with tracing.span("rect.capture"):
            cnt, *slots = culled_capture(inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px,
                                         skip=skip, plain=plain, **scan_kw)
        culled_test_round(pack, slots, inp.az_px, key, plh, model=model, lat0=lat0,
                          lon0=lon0, plain=plain, **scan_kw)
        skip += M_CAND
        rounds += 1
        if emit is not None:
            emit(min(1.0, skip / nb))
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


def pixelwise_hits(pack: TerrainPack, table: Optional[RefractionTable],
                   elev_rad: torch.Tensor, dir_deg: torch.Tensor, alt0, *,
                   model: EarthModel, shape: EarthShape, straight: bool,
                   step: float, n_terr: int, max_hits: int, lat0: float,
                   lon0: float, terrain_alpha: float,
                   objects: Optional[ObjectSet] = None,
                   plain: bool = False) -> HitBuffer:
    """Hits [P, K] for P independent rays (elevation rad [P], azimuth deg
    [P]): the full march, then terrain sampled along each ray's own
    geodesic SEG_CHUNK segments at a time; ``objects``' hits merge in
    (K = max_hits + 2 per object). ``plain`` marches with the plain node
    loop on any device instead of the march kernel."""
    p_n = elev_rad.shape[0]
    n_seg = n_terr - 1
    dev = elev_rad.device
    f_step = _f32(step)
    ray_h, path_len = march_rays(alt0, elev_rad, step, n_seg, shape, table,
                                 straight, coarse=march_coarse(step),
                                 plain=plain)  # [P, n_terr]
    alive = combine.ray_alive_mask(ray_h)  # [P, n_seg]
    dir_col = dir_deg[:, None]

    keys = torch.full((p_n, max_hits), combine.NO_HIT, dtype=torch.float32, device=dev)
    for k0 in range(0, n_seg, SEG_CHUNK):
        c = min(SEG_CHUNK, n_seg - k0)
        dists = (torch.arange(c + 1, dtype=torch.float32, device=dev) + float(k0)) * f_step
        dl, dn = model.geodesic_delta(lat0, lon0, dir_col, dists[None, :])
        te = sample_elevation(pack, dl, dn, lat0, lon0)  # [P, c+1]
        rh = ray_h[:, k0:k0 + c + 1]
        d1 = rh[:, :-1] - te[:, :-1]
        d2 = rh[:, 1:] - te[:, 1:]
        seg_idx = torch.arange(c, dtype=torch.float32, device=dev) + float(k0)
        crossing = (d1 * d2 < 0.0) & alive[:, k0:k0 + c]
        cand = torch.where(crossing, seg_idx + d1 / (d1 - d2), combine.NO_HIT)
        if max_hits == 1:
            keys = torch.minimum(keys, cand.amin(dim=-1, keepdim=True))
        else:
            keys = combine.merge_sorted_k(keys, combine.k_smallest(cand, max_hits),
                                          max_hits)
    plh = combine.gather_ray_field(path_len, torch.where(torch.isfinite(keys), keys, 0.0))
    hits = ray_hits(pack, model, dir_col, keys, plh, lat0=lat0, lon0=lon0, step=step,
                    terrain_alpha=terrain_alpha)
    if objects is None:
        return hits
    obj_hits = object_hits_pixelwise(objects, model, lat0, lon0, step, n_terr, ray_h,
                                     path_len, dir_deg)
    return merge_hits(hits, obj_hits, max_hits + obj_hits.key.shape[-1])


def rectilinear_core(pack, table, elev_rad, dir_deg, alt0, *, model, shape,
                     straight, step, n_terr, max_hits, lat0, lon0, coloring,
                     fog_distance, terrain_alpha, objects=None, plain: bool = False):
    """``pixelwise_hits`` + compositing: (image [P, 3] u8, hits [P, K])."""
    hits = pixelwise_hits(
        pack, table, elev_rad, dir_deg, alt0, model=model, shape=shape,
        straight=straight, step=step, n_terr=n_terr, max_hits=max_hits,
        lat0=lat0, lon0=lon0, terrain_alpha=terrain_alpha, objects=objects,
        plain=plain,
    )
    return _composite_hits(coloring, fog_distance, hits), hits


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


def render_rectilinear(params: Params, terrain: Terrain, device,
                       max_hits: Optional[int] = None, cull: bool = True,
                       plain: bool = False, progress=None,
                       fetch_image: bool = True) -> RenderResult:
    """Full Rectilinear render (rectilinear.rs:24-60) on ``device``.

    tilt 0 takes the fused shared-column path (its scan K3 on a CUDA
    device unless ``plain``), or with scene objects the row-chunked
    shared-column path (``auto_chunk_rows`` rows a chunk); a tilted opaque
    object-free frame (K = 1) the envelope-culled path (its capture scan K4
    on a CUDA device unless ``plain``); anything else, or
    ``cull=False``, the dense pixelwise path. The march of the object chunks
    and of the dense path goes through the march kernel on a CUDA device
    unless ``plain``. The image comes back to the host
    (``base.fetch_flat``), or stays a device tensor with ``fetch_image=False``;
    the hits stay on the device. The angle grids of the result are the host
    f64 ones. ``progress`` (if given) receives monotone whole-percent values
    from the host loops (windows of the tilt-0 scan, row chunks, culled
    rounds, dense chunks), ending at 100.
    """
    with tracing.span("gen.render"):
        device = torch.device(device)
        out = params.output
        frame = params.view.frame
        setup = frame_setup(params, terrain, max_hits)
        alt0, max_hits, kw = float(setup.alt0), setup.max_hits, setup.kw
        h, w = out.height, out.width

        with tracing.span("camera"):
            elev_rad, dir_rad = camera.rectilinear_ray_params(
                w, h, frame.fov, frame.tilt, frame.direction)  # [H, W] f64
        pack, table = setup.pack(device), setup.table(device)
        objects = None
        if params.objects:
            with tracing.span("objects.plan"):
                objects = ObjectSet.build(params, device)
        rounds = None
        emit = percent_reporter(progress)
        if frame.tilt == 0.0:
            with tracing.span("camera"):
                az_host = camera.rectilinear_column_azimuths(w, frame.fov, frame.direction)
            az = torch.from_numpy(az_host.astype(np.float32)).to(device)
            if objects is None:
                image, hits = fused_shared_core(
                    pack, table, az, alt0, cam=(w, h, float(frame.fov)),
                    max_hits=max_hits, emit=emit, plain=plain, **kw)
            else:
                image, hits = shared_column_core(
                    pack, table, objects,
                    torch.from_numpy(elev_rad.astype(np.float32)).to(device), az, alt0,
                    max_hits=max_hits,
                    chunk_rows=auto_chunk_rows(w, h, setup.n_terr), emit=emit,
                    plain=plain, **kw)
        elif max_hits == 1 and cull and objects is None:
            image, hits, rounds = fused_culled_core(
                pack, table, alt0,
                cam=(w, h, float(frame.fov), float(frame.tilt), float(frame.direction)),
                emit=emit, plain=plain, **kw)
            image = image.reshape(h, w, 3)
            hits = _frame_hits([hits], h, w)
        else:
            elev_flat = torch.from_numpy(elev_rad.reshape(-1).astype(np.float32)).to(device)
            dir_flat = torch.from_numpy(
                np.rad2deg(dir_rad).reshape(-1).astype(np.float32)).to(device)
            chunk = PIXEL_ROWS * w
            starts = range(0, h * w, chunk)
            parts = []
            for i, c0 in enumerate(starts):
                parts.append(rectilinear_core(
                    pack, table, elev_flat[c0:c0 + chunk], dir_flat[c0:c0 + chunk], alt0,
                    max_hits=max_hits, objects=objects, plain=plain, **kw))
                emit((i + 1) / len(starts))
            image = torch.cat([p[0] for p in parts], dim=0).reshape(h, w, 3)
            hits = _frame_hits([p[1] for p in parts], h, w)
        emit(1.0)
        return setup.result(image, hits, np.rad2deg(elev_rad), np.rad2deg(dir_rad),
                            fetch_image=fetch_image, culled_rounds=rounds)
