# Frozen copy of atm_raytracer_tpu_torch/generators/interpolating.py (commit f76324c), in its plain form; the benchmark's reference, not the program.
"""InterpolatingRectilinear generator: snapped angular grid + 16-case interp.

Counterpart of ``atm_raytracer_tpu/generators/interpolating.py`` (reference
src/generator/generators/interpolating_rectilinear.rs): a rectilinear camera
whose pixels are snapped to an (elevation, direction) grid with step = 1.5 ×
the minimum per-pixel angular delta (gen_fov_data, :453-522); each output
pixel interpolates its 4 grid corners' trace points with a 16-case presence
match (:183-418).

The reference memoizes grid pixels behind hash maps (:26-108). Here the
needed grid indices form a contiguous range, so the whole grid is computed
densely by the Fast generator's separable machinery (one march per grid row,
one terrain scan per grid column, plain PyTorch here), then the
interpolation runs as masked tensor arithmetic over the output pixels.

Documented tolerance decisions vs the reference (as in the JAX package):
* trace-point grouping (collect_trace_points, :213-243) assigns an entry to
  the group of its first matching earlier entry instead of scanning groups in
  creation order — identical except for degenerate scenes with ≥3 mutually
  step-close groups;
* per-pixel output slots are capped at 2×K_grid (the reference's Vec is
  unbounded).

Scene objects merge into the snapped grid's hits (``fast.separable_hits``
with the objects' windows planned on the grid's azimuths), and the
interpolation carries their kind and RGBA (``has_objects=True``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import Params
from ..models import camera
from ..ops.composite import composite
from ..ops.objects import ObjectSet, object_col_windows
from ..terrain.store import Terrain
from .base import HitBuffer, RenderResult, fetch_flat
from .fast import (
    build_refraction_table,
    core_kwargs,
    device_f32,
    separable_hits,
    terrain_bbox,
)

SCALE = 1.5  # interpolating_rectilinear.rs:454
SEQUENCE = ((0, 0), (0, 1), (1, 0), (1, 1))  # :183


def gen_fov_data(width, height, fov, tilt, direction):
    """(ray_elev [H,W], ray_dir [H,W] radians, min_elev_step, min_dir_step).

    Transcribes gen_fov_data (:453-522): column-wise minimum elevation deltas
    and row-wise direction deltas, clamped below by fov_rad/width/3, times 1.5.
    """
    elev, dirr = camera.rectilinear_ray_params(width, height, fov, tilt, direction)
    # unwrap the atan2 direction about the camera: a view straddling the
    # ±180° seam must not make the snapped grid span ~360° of azimuth
    # (azimuth is periodic, so the corner angles gj·min_ds stay physically
    # identical mod 360°)
    dir_rad = math.radians(direction)
    dirr = dir_rad + np.mod(dirr - dir_rad + np.pi, 2.0 * np.pi) - np.pi
    min_diff = math.radians(fov) / width / 3.0

    dl_e = np.abs(np.diff(elev, axis=0))
    dl_e = np.maximum(dl_e, min_diff)
    min_elev_step = float(dl_e.min()) * SCALE if height > 1 else min_diff * SCALE

    dl_d = np.abs(np.diff(dirr, axis=1))
    dl_d = np.where(dl_d > 2 * np.pi, dl_d - 2 * np.pi, dl_d)
    dl_d = np.maximum(dl_d, min_diff)
    min_dir_step = float(dl_d.min()) * SCALE if width > 1 else min_diff * SCALE

    return elev, dirr, min_elev_step, min_dir_step


# ---------------------------------------------------------------------------
# 16-case interpolation in corner-weight space
# ---------------------------------------------------------------------------
#
# A trace-point group never mixes kinds (collect_trace_points :213-243 groups
# only entries of equal kind), so each reference lerp chain of the 16
# presence cases (interpolating_rectilinear.rs:267-393) is a linear
# combination of the ≤4 corner values: one scalar weight per corner.


def _interp_weights(present: torch.Tensor, rem_e: torch.Tensor, rem_d: torch.Tensor):
    """Per-pixel corner weights for the 16-case presence match.

    present: [4, ...] bool in SEQUENCE order (e00, e01, e10, e11);
    rem_e/rem_d: [...] fractional positions. Returns (ok [...], w [4, ...])
    with w summing to 1 where ok.

    All 16 cases are computed with the JAX package's operands in its order,
    so every weight is its float32 value bit for bit; each pixel's case
    (index p00 + 2·p01 + 4·p10 + 8·p11) is then picked by an exact gather.
    """
    re, rd = rem_e, rem_d
    one = torch.ones_like(re)
    zero = torch.zeros_like(re)
    true = torch.ones_like(re, dtype=torch.bool)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=re.device)
    half = 0.5

    def w4(w00=None, w01=None, w10=None, w11=None):
        return [zero if w is None else w for w in (w00, w01, w10, w11)]

    def two_adjacent(ia, ib, r_elev, r_dir):
        # :339-350 — valid iff r_elev < 0.5; lerp a→b by r_dir
        kw = {ia: 1.0 - r_dir, ib: r_dir}
        return (r_elev < half), w4(**{f"w{k}": v for k, v in kw.items()})

    def two_diagonal(ia, ib, r_elev, r_dir):
        # :352-364
        ok = ~(((r_elev >= half) & (r_dir < half)) | ((r_elev < half) & (r_dir >= half)))
        denom = r_elev * r_dir + (1.0 - r_elev) * (1.0 - r_dir)
        coeff = r_elev * r_dir / torch.maximum(denom, tiny)
        kw = {ia: 1.0 - coeff, ib: coeff}
        return ok, w4(**{f"w{k}": v for k, v in kw.items()})

    def three(ia, ib, ic, r_elev, r_dir):
        # :366-380 — lerp(lerp(a, b, r_dir), c, t), t = r_elev(1−r_dir)/s
        ok = ~((r_elev >= half) & (r_dir >= half))
        s = 1.0 - r_elev + r_elev * (1.0 - r_dir)
        t = r_elev * (1.0 - r_dir) / torch.maximum(s, tiny)
        kw = {ia: (1.0 - r_dir) * (1.0 - t), ib: r_dir * (1.0 - t), ic: t}
        return ok, w4(**{f"w{k}": v for k, v in kw.items()})

    def four():
        # :333 — bilinear
        return true, w4((1.0 - rd) * (1.0 - re), rd * (1.0 - re), (1.0 - rd) * re,
                        rd * re)

    cases = [
        (torch.zeros_like(true), w4()),                          # none
        ((re < half) & (rd < half), w4(w00=one)),                # e00 (:275-281)
        ((re < half) & (rd >= half), w4(w01=one)),               # e01
        two_adjacent("00", "01", re, rd),                        # e00+e01 (:303)
        ((re >= half) & (rd < half), w4(w10=one)),               # e10
        two_adjacent("00", "10", rd, re),                        # e00+e10 (:306)
        two_diagonal("01", "10", re, 1.0 - rd),                  # e01+e10 (:312)
        three("00", "01", "10", re, rd),                         # e00+e01+e10 (:321)
        ((re >= half) & (rd >= half), w4(w11=one)),              # e11
        two_diagonal("00", "11", re, rd),                        # e00+e11 (:309)
        two_adjacent("01", "11", 1.0 - rd, re),                  # e01+e11 (:315)
        three("01", "00", "11", re, 1.0 - rd),                   # e00+e01+e11 (:324)
        two_adjacent("10", "11", 1.0 - re, rd),                  # e10+e11 (:318)
        three("00", "11", "10", 1.0 - re, rd),                   # e00+e10+e11 (:327)
        three("11", "10", "01", 1.0 - re, 1.0 - rd),             # e01+e10+e11 (:330)
        four(),                                                  # all (:333)
    ]
    ok16 = torch.stack([c_ok for c_ok, _ in cases])
    w16 = torch.stack([torch.stack(c_w) for _, c_w in cases])
    p = present.to(torch.int64)
    idx = (p[0] + 2 * p[1] + 4 * p[2] + 8 * p[3])[None]
    ok = ok16.gather(0, idx)[0]
    w = w16.gather(0, idx[None].expand((1, 4) + tuple(idx.shape[1:])))[0]
    return ok, w


def _group_slot_ranks(ent_valid, dist, kind, step_size):
    """Trace-point grouping + slot ranking (collect_trace_points, :213-243).

    Inputs are [E, H, W] entry planes in corner-major creation order; the
    result is each entry's output slot rank (int32): groups (same-kind
    entries within one simulation step of any earlier member, reference
    semantics) ranked ascending by (min member distance, creation gid).

    Three passes of E steps over the [E, H, W] stack, the math of the JAX
    package's loop form; every op is an exact select, min or compare, so
    the ranks equal both of its forms bit for bit.
    """
    e_n = ent_valid.shape[0]
    dev = ent_valid.device
    step = torch.tensor(step_size, dtype=torch.float32, device=dev)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    dist_key = torch.where(ent_valid, dist, inf)
    big_gid = torch.tensor(float(e_n + 1), dtype=torch.float32, device=dev)

    # pass 1 (sequential by construction): entry i joins the min gid over
    # matching earlier entries, else heads a new group
    gid = torch.empty_like(dist_key)
    head = torch.empty_like(ent_valid)
    next_gid = torch.zeros(ent_valid.shape[1:], dtype=torch.float32, device=dev)
    for i in range(e_n):
        v_i, d_i, k_i = ent_valid[i], dist_key[i], kind[i]
        if i == 0:
            best = big_gid.expand_as(d_i)
        else:
            match = (v_i[None] & ent_valid[:i] & (kind[:i] == k_i[None])
                     & ((dist_key[:i] - d_i[None]).abs() < step))
            best = torch.where(match, gid[:i], big_gid).amin(dim=0)
        is_head = v_i & (best >= big_gid)
        gid[i] = torch.where(is_head, next_gid, best)
        head[i] = is_head
        next_gid = next_gid + is_head.to(torch.float32)

    # pass 2: per entry, its group's minimum member distance
    gmd = dist_key
    for j in range(e_n):
        same = ent_valid & ent_valid[j][None] & (gid == gid[j][None])
        gmd = torch.where(same, torch.minimum(gmd, dist_key[j][None]), gmd)

    # pass 3: rank = number of group heads strictly ahead by
    # (min distance, creation gid)
    rank = torch.zeros(ent_valid.shape, dtype=torch.int32, device=dev)
    for j in range(e_n):
        m_j, g_j = gmd[j][None], gid[j][None]
        ahead = head[j][None] & ((m_j < gmd) | ((m_j == gmd) & (g_j < gid)))
        rank = rank + ahead.to(torch.int32)
    return rank


# the interpolated channels, in the order of the stacked entry tensor
_FIELDS = ("dlat", "dlon", "distance", "elevation", "path_length", "nx", "ny",
           "nz", "kind", "cr", "cg", "cb", "ca")


def _interpolate_pixels(grid: HitBuffer, gi, gj, rem_e, rem_d, step_size,
                        k_out: int, has_objects: bool = True) -> HitBuffer:
    """Per-output-pixel corner gather + grouping + interpolation.

    grid: HitBuffer [H', W', K]; gi/gj: [H, W] int32 corner indices into the
    grid; rem_e/rem_d: [H, W] fractional positions. ``has_objects=False``
    gathers only the nine channels that vary on a terrain-only grid and takes
    kind 0, rgb 0 and the grid's alpha as constants: outputs are identical
    either way.

    Grouping is the reference's collect_trace_points (:213-243): entries
    iterate in corner-major creation order (SEQUENCE corners, each corner's
    slots ascending), and each entry joins the first existing group (lowest
    id) containing any member of the same kind within one simulation step,
    else opens a new group. Output slots order groups ascending by their
    minimum distance (the front-to-back order the compositor needs).
    """
    hp, wp, kg = grid.valid.shape
    h_n, w_n = gi.shape
    e_n = 4 * kg  # entries per pixel, corner-major (SEQUENCE), slot ascending
    dev = gi.device

    # -- corner fetch: one gather of a flat [H'·W', K·C] table ---------------
    comp = [grid.valid.to(torch.float32), grid.dlat, grid.dlon, grid.distance,
            grid.elevation, grid.path_length, grid.normal[..., 0],
            grid.normal[..., 1], grid.normal[..., 2]]
    if has_objects:
        comp += [grid.kind.to(torch.float32), grid.rgba[..., 0], grid.rgba[..., 1],
                 grid.rgba[..., 2], grid.rgba[..., 3]]
    n_ch = len(comp)
    table = torch.stack(comp, dim=-1).reshape(hp * wp, kg * n_ch)
    col = gj.clamp(0, wp - 2).to(torch.int64)
    top = gi.clamp(0, hp - 1).to(torch.int64) * wp + col
    bot = (gi + 1).clamp(0, hp - 1).to(torch.int64) * wp + col
    idx = torch.stack([top, top + 1, bot, bot + 1])  # SEQUENCE corners [4, H, W]
    ent = (table.index_select(0, idx.reshape(-1))
           .reshape(4, h_n, w_n, kg, n_ch)
           .permute(4, 0, 3, 1, 2)
           .reshape(n_ch, e_n, h_n, w_n))  # [C, E, H, W], E corner-major
    if not has_objects:
        # a terrain-only grid has kind 0 and rgba [0, 0, 0, alpha] in every
        # slot, valid or not, and invalid entries never reach a group
        zero = torch.zeros((1, e_n, h_n, w_n), dtype=torch.float32, device=dev)
        ca = grid.rgba[0, 0, 0, 3].expand(1, e_n, h_n, w_n)
        ent = torch.cat([ent, zero, zero, zero, zero, ca], dim=0)
    in_grid = (gi >= 0) & (gi + 1 < hp) & (gj >= 0) & (gj + 1 < wp)
    ent_valid = (ent[0] > 0.5) & in_grid[None]
    fields = ent[1:].reshape(len(_FIELDS), 4, kg, h_n, w_n)

    # -- grouping: exact collect_trace_points (:213-243) ---------------------
    rank = _group_slot_ranks(ent_valid, ent[1 + _FIELDS.index("distance")],
                             ent[1 + _FIELDS.index("kind")], step_size)

    # -- per output slot g (the nearest k_out groups): last entry per corner
    #    (match_sequence :245-265) + weight-space interpolation -------------
    kind_i = _FIELDS.index("kind")
    slot_valid, slot_fields = [], []
    for g in range(k_out):
        m4 = (ent_valid & (rank == g)).reshape(4, kg, h_n, w_n)
        present = m4.any(1)  # [4, H, W]
        # one-hot of the last member per corner ("later entries overwrite")
        suffix = m4.flip(1).to(torch.int32).cumsum(1).flip(1)
        onehot = (m4 & (suffix == 1)).to(torch.float32)  # [4, kg, H, W]
        corner = (fields * onehot).sum(2)  # [F, 4, H, W]
        ok, w = _interp_weights(present, rem_e, rem_d)
        part = corner * w
        # the corners summed in SEQUENCE order, as the JAX package's reduce
        out = ((part[:, 0] + part[:, 1]) + part[:, 2]) + part[:, 3]  # [F, H, W]
        # kinds are equal across the group: take any present corner's
        kind = torch.where(present, corner[kind_i], 0.0).amax(0).to(torch.int32)
        slot_valid.append(present.any(0) & ok)
        slot_fields.append((out, kind))

    valid_out = torch.stack(slot_valid, dim=-1)  # [H, W, k_out]
    tp = torch.stack([f for f, _ in slot_fields], dim=-1)  # [F, H, W, k_out]
    tp = dict(zip(_FIELDS, tp))
    step32 = torch.tensor(step_size, dtype=torch.float32, device=dev)
    # key keeps the HitBuffer contract (march position, distance ≈ key·step):
    # the artifact derives viewer distances from it. Groups are emitted
    # ascending by min distance, so the keys ascend too.
    return HitBuffer(
        valid=valid_out,
        key=torch.where(valid_out, tp["distance"] / step32, math.inf),
        dlat=tp["dlat"],
        dlon=tp["dlon"],
        distance=tp["distance"],
        elevation=tp["elevation"],
        path_length=tp["path_length"],
        normal=torch.stack([tp["nx"], tp["ny"], tp["nz"]], dim=-1),
        kind=torch.stack([k for _, k in slot_fields], dim=-1),
        rgba=torch.stack([tp["cr"], tp["cg"], tp["cb"], tp["ca"]], dim=-1),
    )


def grid_coords(cam: tuple, min_es: float, min_ds: float, i_min: int, j_min: int,
                device):
    """Each output pixel's grid cell and position in it, on ``device``:
    (gi, gj [H, W] int32, rem_e, rem_d [H, W] float32), from the float32
    camera twin. ``cam`` = (width, height, fov, tilt, direction).

    The unwrap mirrors ``gen_fov_data``'s host unwrap with float32
    constants in the JAX package's order, and every divisor is a float32
    tensor on the device: the card computes a division by a Python float
    as a product with its float32 reciprocal, which would move floors.
    """
    width, height, fov, tilt, direction = cam
    elev, dirr = camera.rectilinear_ray_params_device(width, height, fov, tilt,
                                                      direction, device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    dir_rad = f32(math.radians(direction))
    pi = f32(math.pi)
    dirr = dir_rad + torch.remainder(dirr - dir_rad + pi, 2.0 * pi) - pi
    ei_f = elev / f32(min_es)
    dj_f = dirr / f32(min_ds)
    gi_abs = torch.floor(ei_f)
    gj_abs = torch.floor(dj_f)
    gi = gi_abs.to(torch.int32) - i_min
    gj = gj_abs.to(torch.int32) - j_min
    return gi, gj, ei_f - gi_abs, dj_f - gj_abs


def grid_hit_depth(max_hits: int, terrain_alpha: float, has_objects: bool) -> int:
    """Terrain hit slots of a snapped-grid point: an opaque object-free
    scene puts at most one trace point in any grid cell, so one grid slot
    serves; the output keeps 2·max_hits so the 4 corners' groups still fit
    (invalid entries never join groups)."""
    return 1 if (not has_objects and terrain_alpha >= 1.0) else max_hits


def interpolating_core(pack, table, grid_elev_deg, grid_az_deg, alt0, *, cam,
                       min_es, min_ds, i_min, j_min, model, shape, straight, step,
                       n_terr, max_hits, lat0, lon0, coloring, fog_distance,
                       terrain_alpha, objects=None, obj_windows=None):
    """The whole Interpolating frame on the device of ``grid_az_deg``:
    (image [H, W, 3] u8, hits [H, W, 2·max_hits]). ``objects`` merge into
    the grid's hits (``obj_windows`` on the grid's columns)."""
    gi, gj, rem_e, rem_d = grid_coords(cam, min_es, min_ds, i_min, j_min,
                                       grid_az_deg.device)
    grid = separable_hits(
        pack, table, grid_elev_deg, grid_az_deg, alt0, model=model, shape=shape,
        straight=straight, step=step, n_terr=n_terr,
        max_hits=grid_hit_depth(max_hits, terrain_alpha, objects is not None),
        lat0=lat0, lon0=lon0, terrain_alpha=terrain_alpha, objects=objects,
        obj_windows=obj_windows,
    )
    hits = _interpolate_pixels(grid, gi, gj, rem_e, rem_d, step, 2 * max_hits,
                               has_objects=objects is not None)
    image = composite(
        coloring, fog_distance, hits.valid, hits.rgba[..., 3], hits.distance,
        hits.elevation, hits.path_length, hits.normal, hits.kind, hits.rgba[..., :3],
    )
    return image, hits


def _camera_grids(width, height, fov, tilt, direction):
    """Camera-only host geometry: snapped-grid extents + output angles.

    f64 numpy (gen_fov_data + the 4-corner bilinear of ResultPixel angles,
    :408-415) that depends on nothing but the camera; computed anew for
    each frame.
    """
    elev, dirr, min_es, min_ds = gen_fov_data(width, height, fov, tilt, direction)
    ei_f = elev / min_es
    dj_f = dirr / min_ds
    gi_abs = np.floor(ei_f).astype(np.int64)
    gj_abs = np.floor(dj_f).astype(np.int64)
    rem_e = ei_f - gi_abs
    rem_d = dj_f - gj_abs
    # widen the grid one cell each way: the device recomputes the pixel
    # angles in float32 (grid_coords), and a boundary pixel's floor may
    # land one cell past the host-f64 extremes
    i_min, i_max = int(gi_abs.min()) - 1, int(gi_abs.max()) + 2
    j_min, j_max = int(gj_abs.min()) - 1, int(gj_abs.max()) + 2
    grid_elev_deg = np.rad2deg(np.arange(i_min, i_max + 1) * min_es)
    grid_az_deg = np.rad2deg(np.arange(j_min, j_max + 1) * min_ds)

    # ResultPixel angles: bilinear of the 4 corner grid angles (:408-415)
    corner_e = (gi_abs[..., None] + np.array([0, 0, 1, 1])) * min_es
    corner_d = (gj_abs[..., None] + np.array([0, 1, 0, 1])) * min_ds
    wts = np.stack(
        [
            (1 - rem_e) * (1 - rem_d),
            (1 - rem_e) * rem_d,
            rem_e * (1 - rem_d),
            rem_e * rem_d,
        ],
        axis=-1,
    )
    elev_out = np.rad2deg((corner_e * wts).sum(-1))
    az_out = camera.wrap_azimuth_deg(np.rad2deg((corner_d * wts).sum(-1)))
    return min_es, min_ds, i_min, j_min, grid_elev_deg, grid_az_deg, elev_out, az_out


def render_interpolating(params: Params, terrain: Terrain, device) -> RenderResult:
    """Full InterpolatingRectilinear render (:110-161) on ``device`` by the
    plain paths. The hit depth is 2 for opaque terrain and 4 for
    translucent (``frame_setup(..., opaque_hits=2)``). The scene's objects
    and their column windows on the grid's azimuths are planned anew for
    each frame: the reference keeps no memo. The image comes back to the
    host; the hits stay on the device; the angle grids are the host f64
    bilinear ones [H, W].
    """
    device = torch.device(device)
    out, frame = params.output, params.view.frame
    pos = params.view.position
    alt0 = pos.abs_altitude(terrain)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    max_hits = 2 if params.terrain_alpha >= 1.0 else 4
    cam = (out.width, out.height, float(frame.fov), float(frame.tilt),
           float(frame.direction))
    (min_es, min_ds, i_min, j_min, grid_elev_deg, grid_az_deg,
     elev_out, az_out) = _camera_grids(*cam)

    pack = terrain.pack(*terrain_bbox(params), device)
    table = build_refraction_table(params, alt0, device)
    objects = ObjectSet.build(params, device)
    obj_windows = None
    if objects is not None:
        obj_windows = object_col_windows(
            objects, params.model, float(pos.latitude), float(pos.longitude),
            np.asarray(grid_az_deg), float(params.simulation_step), n_terr)

    image, hits = interpolating_core(
        pack, table, device_f32(grid_elev_deg, device), device_f32(grid_az_deg, device),
        float(alt0), cam=cam, min_es=float(min_es), min_ds=float(min_ds),
        i_min=i_min, j_min=j_min, max_hits=max_hits, objects=objects,
        obj_windows=obj_windows, **core_kwargs(params, n_terr),
    )
    return RenderResult(
        image=fetch_flat(image).reshape(image.shape),
        hits=hits,
        elevation_deg=elev_out,
        azimuth_deg=az_out,
        observer=(pos.latitude, pos.longitude, alt0),
    )
