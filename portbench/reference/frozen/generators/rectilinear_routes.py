# Frozen copy of the Rectilinear routes of atm_raytracer_tpu_torch/generators/rectilinear.py (commit f76324c) that the copy of commit 05461a6 beside it lacks; the benchmark's reference, not the program.
"""Rectilinear routes for translucent terrain and scene objects, and the
dispatch among every Rectilinear route (PyTorch, plain paths only).

The port's ``render_rectilinear`` chooses, in this order:

* tilt 0 without objects: the fused shared-column scan. At K = 1 (opaque
  terrain) that is ``rectilinear.render_rectilinear``'s own route, taken
  whole; at K > 1 (translucent terrain) ``_multi_hit_scan``, the
  ``march_scan`` that keeps each pixel's K first crossings
  (``multi_hit_shared_core``);
* tilt 0 with objects: ``shared_column_core``, row chunks of
  ``auto_chunk_rows`` rows marched in full, their crossings against the
  shared column terrain (``aligned_crossing_segments``) merged with the
  chunk's object hits (``object_hits_pixelwise``);
* tilted, opaque terrain without objects (K = 1): the envelope-culled path,
  ``rectilinear.render_rectilinear``'s own route;
* everything else: the dense pixelwise path (``pixelwise_hits``),
  ``PIXEL_ROWS`` image rows at a time.

The port's kernels (K2's march, K3's scan, K4's capture, K5's exact test)
are replaced by the plain versions they are held to: ``march_rays``'s node
loop, ``_multi_hit_scan`` without the scan rules, and the frozen culled path.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import Params
from ..models import camera
from ..models.earth import EarthModel
from ..ops import combine
from ..ops.objects import ObjectSet
from ..ops.pixelwise import aligned_crossing_segments, merge_hits, object_hits_pixelwise
from ..physics.ray import EarthShape, RefractionTable, _f32, march_coarse, march_rays, march_scan
from ..terrain.sample import sample_elevation
from ..terrain.store import Terrain, TerrainPack
from . import rectilinear
from .base import HitBuffer, RenderResult, fetch_flat
from .fast import build_refraction_table, core_kwargs, terrain_bbox, terrain_columns
from .rectilinear import (
    _composite_hits,
    _frame_hits,
    _terrain_hits,
    column_hits,
    ray_hits,
    tilt0_inputs,
)

PIXEL_ROWS = 64  # image rows per chunk of the dense pixelwise path
SEG_CHUNK = 512  # march segments per terrain-sampling chunk of that path
# elements of one row chunk's [R·W, N] march on the tilt-0 object path
# (~4 GB of float32 altitudes): four times the port's 250 000 000. A pixel's
# hits do not depend on the chunk that holds it; the plain march's time is
# set by its launches a chunk, not by its rays, so fewer chunks keep the
# check of a 1080p frame to ~20 s instead of ~60
RECT_CHUNK_ELEMS = 1_000_000_000


# ---------------------------------------------------------------------------
# tilt == 0, K > 1 (rectilinear.py:267-324, without the scan rules)
# ---------------------------------------------------------------------------


def _multi_hit_scan(elev_hw, terr_pad, alt0, *, shape: EarthShape,
                    table: Optional[RefractionTable], straight: bool,
                    step: float, n_seg: int, coarse: int, max_hits: int):
    """K > 1: the first ``max_hits`` crossing keys and path lengths
    ([H, W, K], ascending; +inf = empty slot, path length 0 there)."""
    dev = elev_hw.device
    h_n, w_n = elev_hw.shape

    def consumer(carry, k0, h_f, plen_f, alive):
        key, plh = carry
        c = h_f.shape[-1] - 1
        d = h_f - terr_pad[:, k0:k0 + c + 1]  # [H, W, C+1]
        d1 = d[..., :-1]
        d2 = d[..., 1:]
        seg = torch.arange(k0, k0 + c, dtype=torch.int32, device=dev)
        crossing = (d1 * d2 < 0.0) & alive & (seg < n_seg)
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
        return key, torch.cat([plh, plc], dim=-1).gather(-1, order)

    key0 = torch.full((h_n, w_n, max_hits), combine.NO_HIT, dtype=torch.float32,
                      device=dev)
    return march_scan(alt0, elev_hw, step, n_seg, shape, table, straight,
                      consumer, (key0, torch.zeros_like(key0)), coarse=coarse)


def multi_hit_shared_core(pack: TerrainPack, table: Optional[RefractionTable],
                          az_deg: torch.Tensor, alt0, *, cam: tuple,
                          model: EarthModel, shape: EarthShape, straight: bool,
                          step: float, n_terr: int, max_hits: int, lat0: float,
                          lon0: float, coloring, fog_distance: Optional[float],
                          terrain_alpha: float):
    """``fused_shared_core`` (rectilinear.py:613-637) at K = ``max_hits`` >
    1: (image [H, W, 3] u8, hits [H, W, K]); the scan is ``_multi_hit_scan``."""
    elev_hw, terr_pad, stacked, coarse = tilt0_inputs(
        pack, az_deg, cam=cam, model=model, step=step, n_terr=n_terr, lat0=lat0,
        lon0=lon0)
    key, plh = _multi_hit_scan(elev_hw, terr_pad, alt0, shape=shape, table=table,
                               straight=straight, step=step, n_seg=n_terr - 1,
                               coarse=coarse, max_hits=max_hits)
    hits = column_hits(stacked, key, plh, az_deg.to(torch.float32), model=model,
                       lat0=lat0, lon0=lon0, step=step, terrain_alpha=terrain_alpha)
    return _composite_hits(coloring, fog_distance, hits), hits


# ---------------------------------------------------------------------------
# tilt == 0 with scene objects (rectilinear.py:685-774)
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
                       terrain_alpha: float, chunk_rows: int):
    """The tilt-0 Rectilinear frame with scene objects, on the device of
    ``az_deg`` [W]: (image [H, W, 3] u8, hits [H, W, K]); ``elev_hw``
    [H, W] the pixels' elevations in radians (the host grid, as float32).

    The terrain scan is shared per column (utils.rs:176-199). Per chunk of
    ``chunk_rows`` image rows: march every ray (``march_rays``), find each
    ray's crossings against its column's terrain
    (``aligned_crossing_segments``), rebuild the hit fields at them, merge
    the object hits of the chunk's rays, composite.
    """
    n_seg = n_terr - 1
    height, width = elev_hw.shape
    az = az_deg.to(torch.float32)
    f_step = _f32(step)
    terr_elev, terr_normal = terrain_columns(pack, model, az, lat0, lon0, step, n_terr)
    stacked = torch.cat([terr_elev[..., None], terr_normal], dim=-1)  # [W, N, 4]
    starts = range(0, height, chunk_rows)
    images, parts = [], []
    for r0 in starts:
        elev = elev_hw[r0:r0 + chunk_rows]
        r_n = elev.shape[0]
        rw = r_n * width
        ray_h, path_len = march_rays(alt0, elev.reshape(-1), step, n_seg, shape, table,
                                     straight, coarse=march_coarse(step))  # [R·W, n_terr]
        segs = aligned_crossing_segments(
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
    image = torch.cat(images, dim=0).reshape(height, width, 3)
    return image, _frame_hits(parts, height, width)


# ---------------------------------------------------------------------------
# the dense exact per-pixel program (rectilinear.py:1253-1322)
# ---------------------------------------------------------------------------


def pixelwise_hits(pack: TerrainPack, table: Optional[RefractionTable],
                   elev_rad: torch.Tensor, dir_deg: torch.Tensor, alt0, *,
                   model: EarthModel, shape: EarthShape, straight: bool,
                   step: float, n_terr: int, max_hits: int, lat0: float,
                   lon0: float, terrain_alpha: float,
                   objects: Optional[ObjectSet] = None) -> HitBuffer:
    """Hits [P, K] for P independent rays (elevation rad [P], azimuth deg
    [P]): the full march, then terrain sampled along each ray's own
    geodesic SEG_CHUNK segments at a time; ``objects``' hits merge in
    (K = max_hits + 2 per object)."""
    p_n = elev_rad.shape[0]
    n_seg = n_terr - 1
    dev = elev_rad.device
    f_step = _f32(step)
    ray_h, path_len = march_rays(alt0, elev_rad, step, n_seg, shape, table,
                                 straight, coarse=march_coarse(step))  # [P, n_terr]
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
                     fog_distance, terrain_alpha, objects=None):
    """``pixelwise_hits`` + compositing: (image [P, 3] u8, hits [P, K])."""
    hits = pixelwise_hits(
        pack, table, elev_rad, dir_deg, alt0, model=model, shape=shape,
        straight=straight, step=step, n_terr=n_terr, max_hits=max_hits,
        lat0=lat0, lon0=lon0, terrain_alpha=terrain_alpha, objects=objects,
    )
    return _composite_hits(coloring, fog_distance, hits), hits


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def render_rectilinear(params: Params, terrain: Terrain, device) -> RenderResult:
    """Full Rectilinear render (rectilinear.rs:24-60) on ``device`` by the
    plain paths, routed as the port's ``render_rectilinear``
    (rectilinear.py:1334-1410) routes it. Opaque terrain without objects
    (K = 1) takes ``rectilinear.render_rectilinear`` whole: tilt 0 the fused
    shared-column scan, a tilted frame the envelope-culled path. Otherwise
    the hit depth is K = 4 for translucent terrain and 1 for opaque
    (``frame_setup``), and tilt 0 takes ``multi_hit_shared_core`` without
    objects and ``shared_column_core`` with them; a tilted frame the dense
    pixelwise path. The image comes back to the host; the hits stay on the
    device. The angle grids of the result are the host f64 ones.
    """
    if params.terrain_alpha >= 1.0 and not params.objects:
        return rectilinear.render_rectilinear(params, terrain, device)
    device = torch.device(device)
    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt0 = float(pos.abs_altitude(terrain))
    h, w = out.height, out.width
    max_hits = 1 if params.terrain_alpha >= 1.0 else 4
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    kw = core_kwargs(params, n_terr)

    elev_rad, dir_rad = camera.rectilinear_ray_params(
        w, h, frame.fov, frame.tilt, frame.direction)  # [H, W] f64
    pack = terrain.pack(*terrain_bbox(params), device)
    table = build_refraction_table(params, alt0, device)
    objects = ObjectSet.build(params, device) if params.objects else None
    if frame.tilt == 0.0:
        az = torch.from_numpy(camera.rectilinear_column_azimuths(
            w, frame.fov, frame.direction).astype(np.float32)).to(device)
        if objects is None:
            image, hits = multi_hit_shared_core(
                pack, table, az, alt0, cam=(w, h, float(frame.fov)), max_hits=max_hits,
                **kw)
        else:
            image, hits = shared_column_core(
                pack, table, objects,
                torch.from_numpy(elev_rad.astype(np.float32)).to(device), az, alt0,
                max_hits=max_hits, chunk_rows=auto_chunk_rows(w, h, n_terr), **kw)
    else:
        elev_flat = torch.from_numpy(elev_rad.reshape(-1).astype(np.float32)).to(device)
        dir_flat = torch.from_numpy(
            np.rad2deg(dir_rad).reshape(-1).astype(np.float32)).to(device)
        chunk = PIXEL_ROWS * w
        parts = [rectilinear_core(
            pack, table, elev_flat[c0:c0 + chunk], dir_flat[c0:c0 + chunk], alt0,
            max_hits=max_hits, objects=objects, **kw) for c0 in range(0, h * w, chunk)]
        image = torch.cat([p[0] for p in parts], dim=0).reshape(h, w, 3)
        hits = _frame_hits([p[1] for p in parts], h, w)
    return RenderResult(
        image=fetch_flat(image).reshape(image.shape),
        hits=hits,
        elevation_deg=np.rad2deg(elev_rad),
        azimuth_deg=np.rad2deg(dir_rad),
        observer=(pos.latitude, pos.longitude, alt0),
    )
