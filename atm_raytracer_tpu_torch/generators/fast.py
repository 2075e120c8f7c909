"""Fast generator: the separable path × terrain program (PyTorch).

Counterpart of ``atm_raytracer_tpu/generators/fast.py`` (reference
src/generator/generators/fast.rs): pixel (x, y) maps to azimuth(x) and
elevation(y) independently (fast.rs:111-125), so one path march per row and
one terrain scan per column suffice (fast.rs:27-44), then a W×H combine
(fast.rs:52-92):

  1. march all H row-rays            → ray_h [H, N], path_len [H, N]   (K2)
  2. geodesic + terrain per column   → terr [W, N], normals [W, N, 3]
  3. crossing combine                → segments [H, W, K]              (K1)
  4. field gathers at the segments   → HitBuffer
  5. scene objects, merged into each one's column window (``ops.objects``)
  6. coloring + compositing          → u8 image

Every stage runs on the device of the tensors it is given; the host packs
terrain tiles and builds the refraction table, and the objects' column
windows come back from a float64 scan on the objects' device.
``separable_hits`` and ``fast_core`` also take a sweep's F frames on a
leading axis (``parallel.mesh.render_sweep_sharded``): one march of the
F·H rays, one [F·W, N] terrain scan and one combine over [F, H, W, K].
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..config import Params
from ..models import camera
from ..models.earth import EarthModel
from ..ops import combine
from ..ops.composite import composite
from ..ops.objects import (
    ObjectSet,
    apply_objects_planes,
    hits_to_planes,
    max_window_overlap,
    object_col_windows,
    planes_to_hits,
)
from ..physics.ray import EarthShape, RefractionTable, march_coarse, march_rays
from ..terrain.sample import sample_terrain_data
from ..terrain.store import Terrain, TerrainPack
# terrain_bbox and build_refraction_table are read as fast.* by callers
from .base import (  # noqa: F401
    HitBuffer,
    RenderResult,
    build_refraction_table,
    device_f32,
    fetch_pool,
    frame_setup,
    submit_fetch,
    terrain_bbox,
)


# extra object slots past the terrain's when object windows stack on one
# column (the JAX package's default, generators/fast.py:418)
OBJ_HIT_CAP = 6

# ObjectSet + column windows per Params object: repeat renders of one
# lowered Params skip the geodesic scan and the upload. Keyed by id()
# but guarded by a weakref identity check (CPython reuses freed addresses),
# and a weakref finalizer evicts dead entries. Inner keys: the device, and
# the azimuth grid + march length (the Fast camera and the Interpolating
# snapped grid differ).
_objects_cache: dict = {}


def build_objects_cached(params, az_deg, n_terr: int, device):
    """(ObjectSet on ``device``, column windows) for ``params`` and the
    azimuth grid ``az_deg``; (None, None) without objects."""
    if not params.objects:
        return None, None
    pid = id(params)
    entry = _objects_cache.get(pid)
    if entry is None or entry["ref"]() is not params:
        entry = {
            "ref": weakref.ref(params, lambda r, k=pid: _objects_cache.pop(k, None)),
            "sets": {},
            "wins": {},
        }
        _objects_cache[pid] = entry
    dev = str(torch.device(device))
    with tracing.span("objects.plan"):
        if dev not in entry["sets"]:
            entry["sets"][dev] = ObjectSet.build(params, device)
        objects = entry["sets"][dev]
        az = np.asarray(az_deg)
        key = (az.shape[0], float(az[0]), float(az[-1]), n_terr)
        if key not in entry["wins"]:
            pos = params.view.position
            entry["wins"][key] = object_col_windows(
                objects, params.model, float(pos.latitude), float(pos.longitude), az,
                float(params.simulation_step), n_terr)
    return objects, entry["wins"][key]


def march_rows(table: Optional[RefractionTable], elev_deg: torch.Tensor, alt0,
               *, shape: EarthShape, straight: bool, step: float, n_terr: int,
               plain: bool = False, rays_per_frame: Optional[int] = None):
    """Stage 1, the path cache (gen_path_cache, utils.rs:136-174): ray
    altitudes and path lengths [H, n_terr] at x = k*step; coarse RK4 with
    Hermite dense output (``march_coarse`` steps per node). ``alt0`` is a
    scalar or one altitude a row; a stacked ``table`` gives each run of
    ``rays_per_frame`` rows its own l(h)."""
    return march_rays(
        alt0, torch.deg2rad(elev_deg.to(torch.float32)), step, n_terr - 1,
        shape, table, straight, coarse=march_coarse(step), plain=plain,
        rays_per_frame=rays_per_frame,
    )


def march_frames(table: Optional[RefractionTable], elev_deg: torch.Tensor,
                 alt0: torch.Tensor, *, shape: EarthShape, straight: bool, step: float,
                 n_terr: int, plain: bool = False):
    """Stage 1 for F frames: the rows of ``elev_deg`` ([F, H], or [H] shared
    by the frames) from the altitudes ``alt0`` [F], one march over the F·H
    rays; (ray_h, path_len) [F, H, n_terr]."""
    f_n, h_n = alt0.shape[0], elev_deg.shape[-1]
    alt_rows = alt0.to(torch.float32)[:, None].expand(f_n, h_n).reshape(-1)
    ray_h, path_len = march_rows(
        table, elev_deg.expand(f_n, h_n).reshape(-1), alt_rows, shape=shape,
        straight=straight, step=step, n_terr=n_terr, plain=plain, rays_per_frame=h_n)
    return ray_h.reshape(f_n, h_n, -1), path_len.reshape(f_n, h_n, -1)


def frame_altitudes(alt0, device) -> torch.Tensor:
    """One frame's altitude as a [1] tensor, filled on ``device`` (no copy
    from host memory); a tensor as it is, [1]."""
    if isinstance(alt0, torch.Tensor):
        return alt0.reshape(1)
    return torch.full((1,), float(alt0), dtype=torch.float32, device=device)


def column_geodesic(model: EarthModel, az_deg: torch.Tensor, lat0: float,
                    lon0: float, step: float, n_terr: int):
    """(dlat, dlon) [W, n_terr] degrees along each column's geodesic at
    x = k*step."""
    dists = (torch.arange(n_terr, dtype=torch.float32, device=az_deg.device)
             * float(np.float32(step)))
    return model.geodesic_delta(lat0, lon0, az_deg.to(torch.float32)[:, None],
                                dists[None, :])


def terrain_columns(pack: TerrainPack, model: EarthModel, az_deg: torch.Tensor,
                    lat0: float, lon0: float, step: float, n_terr: int):
    """Stage 2, the terrain cache (utils.rs:176-199): elevation [W, n_terr]
    and unit normal [W, n_terr, 3] along each column's geodesic."""
    dlat, dlon = column_geodesic(model, az_deg, lat0, lon0, step, n_terr)
    return sample_terrain_data(pack, model, dlat, dlon, lat0, lon0)


def separable_hits(pack: TerrainPack, table: Optional[RefractionTable],
                   elev_deg: torch.Tensor, az_deg: torch.Tensor, alt0, *,
                   model: EarthModel, shape: EarthShape, straight: bool,
                   step: float, n_terr: int, max_hits: int, lat0: float,
                   lon0: float, terrain_alpha: float,
                   objects: Optional[ObjectSet] = None, obj_windows=None,
                   plain: bool = False, obj_overlap: Optional[int] = None,
                   march=None) -> HitBuffer:
    """Hits on the separable (elevation-row × azimuth-column) grid.

    Shared by the Fast generator (camera rows and columns) and the
    InterpolatingRectilinear generator (its snapped grid). ``objects``
    (with ``obj_windows``, each object's (col_lo, n_cols); None for the full
    width) merge into the terrain hits, which widen to ``max_hits +
    min(2·overlap, max(cap, 2))`` slots: a ray can only hit objects whose
    window holds its column, so the depth follows the deepest window overlap
    (``obj_overlap`` overrides it: a column shard passes its whole frame's).
    Past ``OBJ_HIT_CAP`` extra slots the deepest hits are dropped, with a
    warning on every call (the reference keeps every trace point,
    utils.rs:241-279).

    A sweep's F frames ride a leading axis: ``az_deg`` [F, W], ``elev_deg``
    [F, H] or the [H] rows all frames share, ``alt0`` [F] (a tensor) and a
    table shared by the frames or stacked one a frame. The march is one call
    over the F·H rays, the terrain one [F·W, N] scan, the combine one call
    over [F, H, W, K]; the hits come back [F, H, W, K]. One frame
    (``az_deg`` [W], a scalar ``alt0``) is the case F = 1, its hits [H, W, K].

    ``plain`` runs the march, the combine and the object pass as their
    plain PyTorch versions on whatever device the tensors are on (the
    kernels' oracle on the card); otherwise CUDA tensors go through the
    kernels. ``march``, the (ray_h, path_len) [F, H, n_terr] of
    ``march_frames`` for these rows, skips the march (the banded render
    marches once for all its bands).
    """
    one_frame = az_deg.ndim == 1
    if one_frame:
        az_deg = az_deg[None]
        alt0 = frame_altitudes(alt0, az_deg.device)
    # flatten the frames' rays and columns, then split them again
    f_n, w_n = az_deg.shape
    if march is None:
        with tracing.span("fast.march"):
            march = march_frames(table, elev_deg, alt0, shape=shape, straight=straight,
                                 step=step, n_terr=n_terr, plain=plain)
    ray_h, path_len = march
    with tracing.span("fast.terrain_columns"):
        dlat, dlon = column_geodesic(model, az_deg.reshape(-1), lat0, lon0, step, n_terr)
        terr_elev, terr_normal = sample_terrain_data(pack, model, dlat, dlon, lat0, lon0)
    dlat, dlon, terr_elev = (x.reshape(f_n, w_n, n_terr) for x in (dlat, dlon, terr_elev))
    terr_normal = terr_normal.reshape(f_n, w_n, n_terr, 3)

    # 3. crossing segments [F, H, W, K]; the fractional hit position is a
    # per-pixel quantity reconstructed below
    n_seg = n_terr - 1
    crossing = (combine.terrain_crossing_segments_plain if plain
                else combine.terrain_crossing_segments)
    with tracing.span("fast.combine", device=True):
        segs = crossing(ray_h, terr_elev, n_seg, max_hits)
    tracing.count("fast.max_hits", max_hits)

    # 4. field gathers (TracingState::interpolate, utils.rs:108-133): both
    # segment ends of the terrain (elevation + normal) and ray (altitude +
    # path length) stacks; the hit's dlat/dlon re-derive per pixel from
    # (column azimuth, key·step) through the same geodesic
    with tracing.span("fast.fields", device=True):
        valid = segs < n_seg
        ks = torch.where(valid, segs, 0)
        stacked = torch.cat([terr_elev[..., None], terr_normal], dim=-1)  # [F, W, N, 4]
        c_lo, c_hi = combine.gather_pairs(stacked, ks, (0, 2))  # [F, H, W, K, 4] ×2
        ray_stack = torch.stack([ray_h, path_len], dim=-1)  # [F, H, N, 2]
        r_lo, r_hi = combine.gather_pairs(ray_stack, ks, (0, 1))
        d1 = r_lo[..., 0] - c_lo[..., 0]
        d2 = r_hi[..., 0] - c_hi[..., 0]
        denom = d1 - d2
        prop = d1 / torch.where(denom == 0.0, torch.ones_like(denom), denom)  # utils.rs:232
        keys = torch.where(valid, ks.to(torch.float32) + prop,
                           torch.full_like(prop, combine.NO_HIT))
        safe_keys = torch.where(valid, keys, torch.zeros_like(keys))

        hit_stack = c_lo * (1.0 - prop[..., None]) + c_hi * prop[..., None]
        hit_plen = r_lo[..., 1] * (1.0 - prop) + r_hi[..., 1] * prop
        hit_dist = safe_keys * float(np.float32(step))  # dist is linear in the key
        hit_dlat, hit_dlon = model.geodesic_delta(
            lat0, lon0, az_deg.to(torch.float32)[..., None, :, None], hit_dist
        )

        rgba = torch.zeros(keys.shape + (4,), dtype=torch.float32, device=keys.device)
        rgba[..., 3] = float(terrain_alpha)
        hits = HitBuffer(
            valid=valid,
            key=keys,
            dlat=hit_dlat,
            dlon=hit_dlon,
            distance=hit_dist,
            elevation=hit_stack[..., 0],
            path_length=hit_plen,
            normal=hit_stack[..., 1:4],
            kind=torch.zeros(keys.shape, dtype=torch.int32, device=keys.device),
            rgba=rgba,
        )
    if objects is not None:  # 5. scene objects
        overlap = (max_window_overlap(obj_windows, objects.n_objects)
                   if obj_overlap is None else obj_overlap)
        if 2 * overlap > max(OBJ_HIT_CAP, 2):
            print(
                f"WARNING: object metadata depth truncated: {overlap} object windows "
                f"overlap one column (needs {2 * overlap} slots) but OBJ_HIT_CAP="
                f"{OBJ_HIT_CAP}; hits beyond the cap are dropped from metadata "
                "(compositing is visually saturated by then)",
                file=sys.stderr,
            )
        k_out = max_hits + min(2 * overlap, max(OBJ_HIT_CAP, 2))
        tracing.count("objects.overlap", overlap)
        tracing.count("objects.k_out", k_out)
        # the pass widens the K terrain slots to k_out, frame by frame
        key, vals = hits_to_planes(hits)
        per_frame = [apply_objects_planes(
            (key[f], vals[:, f]), objects, model, lat0, step, ray_h[f], path_len[f],
            dlat[f], dlon[f], obj_windows, k_out, plain=plain) for f in range(f_n)]
        if f_n == 1:
            key, vals = per_frame[0][0][None], per_frame[0][1][:, None]
        else:
            key = torch.stack([k for k, _ in per_frame])
            vals = torch.stack([v for _, v in per_frame], dim=1)
        hits = planes_to_hits(key, vals)
    tracing.count("fast.slots", hits.valid.numel())
    if one_frame:
        hits = HitBuffer(**{f.name: getattr(hits, f.name)[0]
                            for f in dataclasses.fields(HitBuffer)})
    return hits


def fast_core(pack: TerrainPack, table: Optional[RefractionTable],
              elev_deg: torch.Tensor, az_deg: torch.Tensor, alt0, *,
              model: EarthModel, shape: EarthShape, straight: bool, step: float,
              n_terr: int, max_hits: int, lat0: float, lon0: float, coloring,
              fog_distance: Optional[float], terrain_alpha: float,
              objects: Optional[ObjectSet] = None, obj_windows=None,
              plain: bool = False, obj_overlap: Optional[int] = None,
              light_dir: Optional[torch.Tensor] = None, march=None):
    """The whole Fast pipeline on one device: (image [H, W, 3] u8, hits), or
    a sweep's [F, H, W, 3] with the frames of ``separable_hits``.
    ``light_dir`` (float32 [3], or [F, 3] one a frame) overrides the
    coloring's light (JAX ``fast_core(light_dir=)``); ``march``: see
    ``separable_hits``."""
    hits = separable_hits(
        pack, table, elev_deg, az_deg, alt0, model=model, shape=shape,
        straight=straight, step=step, n_terr=n_terr, max_hits=max_hits,
        lat0=lat0, lon0=lon0, terrain_alpha=terrain_alpha, objects=objects,
        obj_windows=obj_windows, plain=plain, obj_overlap=obj_overlap, march=march,
    )
    if light_dir is not None:  # broadcast over the [H, W, K] of each frame
        light_dir = light_dir.reshape(light_dir.shape[:-1] + (1, 1, 1, 3))
    with tracing.span("composite", device=True):
        image = composite(
            coloring, fog_distance, hits.valid, hits.rgba[..., 3], hits.distance,
            hits.elevation, hits.path_length, hits.normal, hits.kind,
            hits.rgba[..., :3], light_dir,
        )
    return image, hits


def _fast_camera(params: Params):
    """The Fast camera: elevation rows [H] and azimuth columns [W], host f64."""
    out, frame = params.output, params.view.frame
    with tracing.span("camera"):
        elev_deg = camera.fast_ray_elevations(out.width, out.height, frame.fov, frame.tilt)
        az_deg = camera.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)
    return elev_deg, az_deg


def render_fast(params: Params, terrain: Terrain, device,
                max_hits: Optional[int] = None, plain: bool = False,
                fetch_image: bool = True) -> RenderResult:
    """Full Fast-generator render from lowered Params (fast.rs:22-98) on
    ``device``. The image comes back to the host (``base.fetch_flat``), or
    stays a device tensor with ``fetch_image=False``; the hits stay on
    device."""
    with tracing.span("gen.render"):
        device = torch.device(device)
        setup = frame_setup(params, terrain, max_hits)
        elev_deg, az_deg = _fast_camera(params)
        pack, table = setup.pack(device), setup.table(device)
        objects, obj_windows = build_objects_cached(params, az_deg, setup.n_terr, device)

        image, hits = fast_core(
            pack, table, device_f32(elev_deg, device), device_f32(az_deg, device),
            float(setup.alt0), objects=objects, obj_windows=obj_windows, plain=plain,
            max_hits=setup.max_hits, **setup.kw,
        )
        return setup.result(image, hits, elev_deg, camera.wrap_azimuth_deg(az_deg),
                            fetch_image=fetch_image)


def _largest_band_divisor(w: int, bands: int) -> int:
    """The most bands, at most ``bands``, that split ``w`` columns evenly."""
    for b in range(min(bands, w), 0, -1):
        if w % b == 0:
            return b
    return 1


def _stream_bands(pool, pack, table, elev, az, alt0: float, march, b: int, kw: dict):
    """Launch each of ``b`` azimuth bands and submit its image's fetch on
    ``pool``, with no host sync: (band hits, fetched outs, handles), the
    outs valid once their handles have returned."""
    wb = az.shape[0] // b
    band_hits, outs, handles = [], [], []
    with tracing.span("fast.bands"):
        for i in range(b):
            image_b, hits_b = fast_core(pack, table, elev, az[i * wb:(i + 1) * wb], alt0,
                                        march=march, **kw)
            band_hits.append(hits_b)
            o, hs = submit_fetch(pool, (image_b,))
            outs.append(o)
            handles.append(hs)
    return band_hits, outs, handles


def render_fast_streamed(params: Params, terrain: Terrain, device, bands: int = 8,
                         max_hits: Optional[int] = None, progress=None) -> RenderResult:
    """Banded Fast render: march once, combine per column band, stream
    (JAX ``render_fast_streamed``, fast.py:579-728).

    The frame splits into ``_largest_band_divisor(W, bands)`` contiguous
    azimuth bands that share one march (one K2 launch); each band is one
    ``fast_core`` (one K1 launch), and its image leaves raw through
    ``submit_fetch`` as soon as it is enqueued, so its copy runs on the copy
    stream while later bands compute. JAX's frame codec
    (``meta.pack.pack_frame_stream``) is not used: on an H100 its launches
    and its host decode cost far more than the link time it saves
    (PERF.md §6).
    ``progress`` gets one monotone percent a band, ending at 100. The hits
    are concatenated on the device.

    The image and the hits equal ``render_fast``'s: every stage is per
    column, so a band computes its columns as the whole frame does. On the
    card that holds bit for bit at any shape. On the CPU it holds where
    each band keeps its columns' places in PyTorch's vectorized loops (one
    thread; band width × samples and rows × band width × slots multiples
    of the vector width): its atan2 rounds differently in a loop's scalar
    tail (PERF.md §6). Scene objects take ``render_fast``, as JAX's do.
    """
    if params.objects:
        result = render_fast(params, terrain, device, max_hits=max_hits)
        if progress is not None:
            progress(100)
        return result

    with tracing.span("gen.render"):
        device = torch.device(device)
        setup = frame_setup(params, terrain, max_hits)
        elev_deg, az_deg = _fast_camera(params)
        pack, table = setup.pack(device), setup.table(device)
        kw = dict(setup.kw, max_hits=setup.max_hits)
        h, w = params.output.height, params.output.width
        b = _largest_band_divisor(w, max(1, int(bands)))
        wb = w // b
        elev = device_f32(elev_deg, device)
        az = device_f32(az_deg, device)
        with tracing.span("fast.march"):
            march = march_frames(table, elev, frame_altitudes(setup.alt0, device),
                                 shape=kw["shape"], straight=kw["straight"], step=kw["step"],
                                 n_terr=setup.n_terr)

        with fetch_pool() as pool:
            band_hits, outs, handles = _stream_bands(
                pool, pack, table, elev, az, float(setup.alt0), march, b, kw)
            with tracing.span("fetch"):
                for i, hs in enumerate(handles):
                    for handle in hs:
                        handle.result()
                    if progress is not None:
                        progress(int(round(100.0 * (i + 1) / b)))

        hits = HitBuffer(**{f.name: torch.cat([getattr(x, f.name) for x in band_hits], dim=1)
                            for f in dataclasses.fields(HitBuffer)})
        return setup.result(np.concatenate([o[0].reshape(h, wb, 3) for o in outs], axis=1),
                            hits, elev_deg, camera.wrap_azimuth_deg(az_deg), fetch_image=False)
