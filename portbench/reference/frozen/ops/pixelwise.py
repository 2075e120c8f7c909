# Frozen copy of aligned_crossing_segments (atm_raytracer_tpu_torch/ops/combine.py:296-336) and of object_hits_pixelwise, concat_hits and merge_hits (atm_raytracer_tpu_torch/ops/objects.py:755-898), commit f76324c; the benchmark's reference, not the program.
"""The per-ray stages of the Rectilinear routes with scene objects or
translucent terrain: the crossings of ray rows ALIGNED with terrain
columns (the tilt-0 row chunks), the object hits of P independent rays,
and the merge of two hit buffers. Plain PyTorch on the device of the
inputs; the helpers they call are the frozen modules beside this one, whose
code these functions' origin shares line for line."""

from __future__ import annotations

import dataclasses

import torch

from ..generators.base import HitBuffer
from ..models.earth import EarthModel
from ..physics.ray import _f32
from .combine import (
    NO_HIT,
    NO_HIT_SEG,
    gather_ray_field,
    k_smallest,
    merge_sorted_k,
    ray_alive_mask,
)
from .objects import ObjectSet, _dot, _object_candidates, _rotate, ray_death_index

ALIGNED_CHUNK = 512  # segments a step of aligned_crossing_segments


def aligned_crossing_segments(ray_h: torch.Tensor, terr_elev: torch.Tensor,
                              n_seg: int, max_hits: int = 1) -> torch.Tensor:
    """Crossing segments when ray rows are ALIGNED with terrain columns.

    The Rectilinear generator at tilt 0 has a ray per pixel but an azimuth
    per column (rectilinear.rs:78-100 at pitch 0), so pixel (r, w) tests
    its own ray against column w's terrain: elementwise in w, not the
    [H, W] outer product of ``terrain_crossing_segments``.

    ray_h: [R, W, N+1] altitudes; terr_elev: [W, N_t]. Returns int32
    [R, W, max_hits] ascending, NO_HIT_SEG = no crossing. Runs
    ALIGNED_CHUNK segments at a time; past the march the rays pad with
    −1e9 m and the alive mask with False, the terrain with 0.
    """
    chunk = ALIGNED_CHUNK
    r_n, w_n, n_samp = ray_h.shape
    dev = ray_h.device
    alive = ray_alive_mask(ray_h.reshape(r_n * w_n, n_samp)).reshape(r_n, w_n, n_samp - 1)
    n_chunks = -(-n_seg // chunk)
    pad = n_chunks * chunk + 1 - n_samp
    if pad > 0:
        ray_h = torch.nn.functional.pad(ray_h, (0, pad), value=-1e9)
        alive = torch.nn.functional.pad(alive, (0, pad), value=False)
    tpad = n_chunks * chunk + 1 - terr_elev.shape[1]
    if tpad > 0:
        terr_elev = torch.nn.functional.pad(terr_elev, (0, tpad), value=0.0)
    keys = torch.full((r_n, w_n, max_hits), NO_HIT_SEG, dtype=torch.int32, device=dev)
    for k0 in range(0, n_chunks * chunk, chunk):
        seg_idx = torch.arange(k0, k0 + chunk, dtype=torch.int32, device=dev)
        d1 = ray_h[..., k0:k0 + chunk] - terr_elev[None, :, k0:k0 + chunk]
        d2 = ray_h[..., k0 + 1:k0 + chunk + 1] - terr_elev[None, :, k0 + 1:k0 + chunk + 1]
        crossing = (d1 * d2 < 0.0) & alive[..., k0:k0 + chunk] & (seg_idx < n_seg)
        cand = torch.where(crossing, seg_idx, NO_HIT_SEG)
        if max_hits == 1:
            keys = torch.minimum(keys, cand.amin(dim=-1, keepdim=True))
        else:
            keys = merge_sorted_k(keys, k_smallest(cand, max_hits), max_hits)
    return keys


# -- P independent rays (Rectilinear) -----------------------------------------


def object_hits_pixelwise(objects: ObjectSet, model: EarthModel, lat0: float,
                          lon0: float, step: float, n_terr: int, ray_h, path_len,
                          dir_deg, k_per_object: int = 2) -> HitBuffer:
    """Object hits for P independent rays (the Rectilinear generator).

    ray_h, path_len: [P, n_terr]; dir_deg: [P] each ray's azimuth. Each
    ray owns its geodesic: a coarse distance scan at 4 march steps finds
    where the culling region starts (with a stride·step margin, so a stride
    cannot step over it), then ``seg_window + 2·stride + 2`` segments are
    tested exactly. Returns the per-object hits concatenated along the slot
    axis, unordered ([P, n·k]); the caller's ``merge_hits`` orders them.
    """
    p_n = ray_h.shape[0]
    dev = ray_h.device
    stride = 4
    # the coarse scan can flag up to the margin before the true close
    # region, so the exact window spans the margin on both sides plus the
    # close-region chord
    kw = objects.seg_window + 2 * stride + 2
    f_step = _f32(step)
    dir_col = dir_deg[:, None]
    # the object-independent coarse geodesic: one evaluation for the scene
    n_coarse = -(-n_terr // stride)
    dists_c = (torch.arange(n_coarse, dtype=torch.float32, device=dev) * stride) * f_step
    dl_c, dn_c = model.geodesic_delta(lat0, lon0, dir_col, dists_c[None, :])
    death_idx = ray_death_index(ray_h)  # [P]
    offs = torch.arange(kw + 1, device=dev)
    margin = _f32(stride * step)

    parts = []
    for oi in range(objects.n_objects):
        o_dlat, o_dlon, o_elev = objects.dlat[oi], objects.dlon[oi], objects.elev[oi]
        rel_c = model.enu_rel(dl_c, dn_c, o_elev, o_dlat, o_dlon, o_elev, lat0)
        d2_c = rel_c[..., 0] ** 2 + rel_c[..., 1] ** 2 + rel_c[..., 2] ** 2
        close_c = d2_c < (torch.sqrt(objects.cull_r2[oi]) + margin) ** 2
        del rel_c, d2_c
        first_c = torch.where(close_c.any(dim=1),
                              torch.argmax(close_c.to(torch.uint8), dim=1), n_coarse)
        k_lo = torch.clamp(first_c * stride - stride - 1, 0, max(n_terr - kw - 1, 0))
        k_idx = torch.clamp(k_lo[:, None] + offs[None, :], max=n_terr - 1)  # [P, kw+1]
        dl_w, dn_w = model.geodesic_delta(lat0, lon0, dir_col,
                                          k_idx.to(torch.float32) * f_step)
        rh = ray_h.gather(1, k_idx)  # [P, kw+1]
        p = model.enu_rel(dl_w, dn_w, rh, o_dlat, o_dlon, o_elev, lat0)
        # exact culling at the window points (the terrain-point test at the
        # object's elevation)
        rel_w = model.enu_rel(dl_w, dn_w, o_elev, o_dlat, o_dlon, o_elev, lat0)
        g_close = _dot(rel_w, rel_w) < objects.cull_r2[oi]
        seg_close = g_close[..., :-1] | g_close[..., 1:]
        seg_k = k_idx[:, :-1].to(torch.float32)

        props, normals_loc, rgba, valid = _object_candidates(
            objects, oi, p[..., :-1, :], p[..., 1:, :])
        seg_alive = seg_k <= death_idx[:, None]  # [P, kw]
        valid = valid & (seg_close & seg_alive)[..., None] & (rgba[..., 3] > 0.0)
        keys = torch.where(valid, seg_k[..., None] + torch.clamp(props, 0.0, 0.999999),
                           NO_HIT).reshape(p_n, -1)
        neg_top, top_idx = torch.topk(-keys, k_per_object, dim=-1)
        sel_keys = -neg_top
        flat_n = keys.shape[-1]
        sel_norm_loc = normals_loc.reshape(p_n, flat_n, 3).gather(
            1, top_idx[..., None].expand(-1, -1, 3))
        sel_rgba = rgba.reshape(p_n, flat_n, 4).gather(
            1, top_idx[..., None].expand(-1, -1, 4))
        sel_valid = torch.isfinite(sel_keys)
        sel_norm = torch.stack(
            _rotate([sel_norm_loc[..., c] for c in range(3)], objects.basis[oi]), dim=-1)

        safe = torch.where(sel_valid, sel_keys, 0.0)
        kk = torch.floor(safe)
        pp = safe - kk
        dl1, dn1 = model.geodesic_delta(lat0, lon0, dir_col, kk * f_step)
        dl2, dn2 = model.geodesic_delta(lat0, lon0, dir_col, (kk + 1.0) * f_step)
        parts.append(HitBuffer(
            valid=sel_valid,
            key=sel_keys,
            dlat=dl1 * (1 - pp) + dl2 * pp,
            dlon=dn1 * (1 - pp) + dn2 * pp,
            distance=safe * f_step,
            elevation=gather_ray_field(ray_h, safe),
            path_length=gather_ray_field(path_len, safe),
            normal=sel_norm,
            kind=torch.ones(sel_keys.shape, dtype=torch.int32, device=dev),
            rgba=sel_rgba,
        ))
    return concat_hits(parts)


def concat_hits(parts) -> HitBuffer:
    """Concatenate hit buffers along the slot axis (no ordering)."""
    axis = parts[0].valid.ndim - 1
    return HitBuffer(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts], dim=axis)
        for f in dataclasses.fields(HitBuffer)
    })


def merge_hits(a: HitBuffer, b: HitBuffer, k_out: int) -> HitBuffer:
    """Merge two hit buffers [..., K(, D)] and keep the k_out earliest by key.

    The keys come from successive masked mins (``k_smallest``; inputs need
    not be sorted), and each payload field re-pairs through the equality
    one-hot: the sum over the inputs of value × match, in input order,
    over the match count. Duplicate finite keys average; the +inf slots
    match every invalid input, whose payloads they average (so compare
    merged buffers on their valid slots only).
    """
    def cat(x, y):
        return torch.cat([x, y], dim=a.valid.ndim - 1)

    keys_all = torch.where(cat(a.valid, b.valid), cat(a.key, b.key), NO_HIT)
    skeys = k_smallest(keys_all, k_out)  # [..., k_out]
    oh = (keys_all[..., None, :] == skeys[..., :, None]).to(torch.float32)
    n_all = keys_all.shape[-1]
    matches = oh[..., 0]
    for i in range(1, n_all):
        matches = matches + oh[..., i]
    matches = torch.clamp(matches, min=1.0)

    def pick(x):  # x [..., K_all]
        acc = x[..., None, 0] * oh[..., 0]
        for i in range(1, n_all):
            acc = acc + x[..., None, i] * oh[..., i]
        return acc / matches

    def pick_vec(xa, xb):
        x = cat(xa, xb)
        return torch.stack([pick(x[..., d]) for d in range(x.shape[-1])], dim=-1)

    return HitBuffer(
        valid=torch.isfinite(skeys),
        key=skeys,
        dlat=pick(cat(a.dlat, b.dlat)),
        dlon=pick(cat(a.dlon, b.dlon)),
        distance=pick(cat(a.distance, b.distance)),
        elevation=pick(cat(a.elevation, b.elevation)),
        path_length=pick(cat(a.path_length, b.path_length)),
        normal=pick_vec(a.normal, b.normal),
        kind=torch.round(pick(cat(a.kind, b.kind).to(torch.float32))).to(torch.int32),
        rgba=pick_vec(a.rgba, b.rgba),
    )
