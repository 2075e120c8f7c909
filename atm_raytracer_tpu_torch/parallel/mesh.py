"""Batched sweeps and the multi-device render modes (PyTorch).

Counterpart of ``atm_raytracer_tpu/parallel/mesh.py``, with its function
names. The JAX module shards one jitted program over a device mesh and lets
XLA insert the collectives; here a mesh is an explicit list of
``torch.device``s (``make_mesh``) that one process addresses in turn. Every
mode is data parallel and needs no communication beyond gathering its
outputs onto the first device (and, for Interpolating, the grid planes onto
every device), so no process group is needed:

* ``render_sweep_sharded`` — F frames (direction, altitude, atmosphere,
  tilt, fov and light per frame) split over the devices; each device's
  frames are one ``fast.fast_core`` call: one K2 launch over their F·H rays
  and one K1 launch over [F, H, W, K].
* ``render_fast_sharded`` — one Fast frame, azimuth columns split (padded
  to a multiple of the device count); every device marches all the rows.
* ``render_rectilinear_sharded`` — tilt 0 without objects: image rows
  through ``rectilinear.fused_shared_core``; otherwise
  ``render_rectilinear_pixelwise_sharded``, the flattened pixels through
  ``rectilinear.rectilinear_core`` a chunk at a time, each chunk split.
* ``render_interpolating_sharded`` — the snapped grid's columns split, the
  grid planes gathered onto every device, then the output rows split.

A list may repeat one device: the split, the padding and the gather then run
on one card (or the CPU). On the card each mode gives its one-device render
bit for bit. On the CPU that holds only where the split keeps each column's
place in PyTorch's vectorized loops (as in the tests' shapes): the CPU's
atan2 rounds differently in a loop's scalar tail, so a column moved into a
tail can move a last bit. ``dryrun_multichip`` runs all six modes at a tiny
size.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, Params
from ..generators import fast as fast_mod
from ..generators import interpolating as interp_mod
from ..generators import rectilinear as rect_mod
from ..generators.base import HitBuffer, RenderResult, device_f32, fetch_flat, frame_setup
from ..models import camera
from ..ops.composite import composite
from ..ops.objects import ObjectSet, max_window_overlap
from ..physics.ray import RefractionTable
from ..terrain.store import Terrain, Tile


def make_mesh(devices: Sequence) -> List[torch.device]:
    """The devices a render is split over, in order; one may repeat. The
    caller names every one: there is no default list."""
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: no devices given")
    return mesh


def _pad_to_multiple(arr: np.ndarray, mult: int):
    """``arr`` continued by 1e-4 steps to a multiple of ``mult``, and its
    length before (the JAX module's padding of the azimuth columns)."""
    w = arr.shape[0]
    pad = (-w) % mult
    if pad:
        arr = np.concatenate([arr, arr[-1] + np.arange(1, pad + 1) * 1e-4])
    return arr, w


def _shards(n: int, n_dev: int):
    """(start, stop) of each device's equal share of n items (n a multiple)."""
    per = n // n_dev
    return [(i * per, (i + 1) * per) for i in range(n_dev)]


def _shard_windows(windows, c0: int, c1: int):
    """Objects' column windows clipped to the columns c0 … c1-1 and made
    local to them; None (no objects) stays None."""
    if windows is None:
        return None
    out = []
    for lo, wn in windows:
        a, b = max(lo, c0), min(lo + wn, c1)
        out.append((a - c0, b - a) if b > a else (0, 0))
    return tuple(out)


def _gather_hits(parts, axis: int, device, stop: Optional[int] = None) -> HitBuffer:
    """HitBuffers concatenated along ``axis`` on ``device``, cut to ``stop``."""
    fields = {}
    for f in dataclasses.fields(HitBuffer):
        x = torch.cat([getattr(p, f.name).to(device) for p in parts], dim=axis)
        fields[f.name] = x if stop is None else x.narrow(axis, 0, stop)
    return HitBuffer(**fields)


def render_fast_sharded(params: Params, terrain: Terrain, mesh: Sequence[torch.device],
                        max_hits: Optional[int] = None) -> RenderResult:
    """Fast render with the azimuth columns split over ``mesh``; the pack,
    the table and the row march on each device. The image comes back to the
    host; the hits are gathered on the first device."""
    out, frame = params.output, params.view.frame
    setup = frame_setup(params, terrain, max_hits)
    elev_deg = camera.fast_ray_elevations(out.width, out.height, frame.fov, frame.tilt)
    az_deg = camera.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)
    az_padded, true_w = _pad_to_multiple(az_deg.astype(np.float32), len(mesh))

    images, parts = [], []
    for dev, (c0, c1) in zip(mesh, _shards(az_padded.shape[0], len(mesh))):
        # windows planned on the frame's own columns, as a one-device render
        objects, windows = fast_mod.build_objects_cached(params, az_deg, setup.n_terr, dev)
        image, hits = fast_mod.fast_core(
            setup.pack(dev), setup.table(dev),
            device_f32(elev_deg, dev), device_f32(az_padded[c0:c1], dev), float(setup.alt0),
            max_hits=setup.max_hits, objects=objects,
            obj_windows=_shard_windows(windows, c0, c1),
            obj_overlap=(None if objects is None
                         else max_window_overlap(windows, objects.n_objects)),
            **setup.kw,
        )
        images.append(image)
        parts.append(hits)
    dev0 = mesh[0]
    image = torch.cat([im.to(dev0) for im in images], dim=1)[:, :true_w]
    return setup.result(image, _gather_hits(parts, 1, dev0, true_w), elev_deg,
                        camera.wrap_azimuth_deg(az_deg))


def render_sweep_sharded(
    params: Params,
    terrain: Terrain,
    mesh: Sequence[torch.device],
    directions_deg: Sequence[float],
    altitudes_m: Optional[Sequence[float]] = None,
    atmospheres: Optional[Sequence] = None,
    tilts_deg: Optional[Sequence[float]] = None,
    fovs_deg: Optional[Sequence[float]] = None,
    max_hits: Optional[int] = None,
    return_hits=False,  # False | True | "valid" (hit masks only)
    fetch_frames: bool = True,
):
    """Batched sweep: F Fast frames over (direction, tilt, fov, altitude,
    atmosphere), split frame-wise over ``mesh`` (padded to a multiple of
    its length by repeating the last frame). A device's frames are one
    ``fast_core`` call: one K2 launch and one K1 launch, whatever F is.

    ``atmospheres``: optional per-frame ``AtmosphereDef``s; their l(h)
    tables, built at the sweep's highest altitude, stack into one [F, n]
    table (cut to the shortest) with no fit, so the march reads a table a
    frame (K2's table stride). ``tilts_deg`` / ``fovs_deg``: optional
    per-frame tilt / field of view; the elevation rows become [F, H].
    Each frame's light comes from the coloring at its own direction.

    Returns images [F, H, W, 3] uint8 (a host array, or with
    ``fetch_frames=False`` a tensor on the first device). With
    ``return_hits=True`` also the frames' HitBuffer ([F, H, W, K] leaves on
    the first device); ``return_hits="valid"`` returns only the hit masks.
    The host arithmetic is the JAX module's, so a frame equals a single
    render of it (with the table built at its altitude).
    """
    out, frame, pos = params.output, params.view.frame, params.view.position
    setup = frame_setup(params, terrain, max_hits)
    n_dev = len(mesh)

    dirs = np.asarray(list(directions_deg), np.float32)
    f = len(dirs)
    if altitudes_m is None:
        alts = np.full(f, setup.alt0, np.float32)
    else:
        alts = np.asarray(list(altitudes_m), np.float32)
        if len(alts) != f:
            raise ValueError("one altitude per frame")
    pad = (-f) % n_dev
    if pad:
        dirs = np.concatenate([dirs, np.repeat(dirs[-1:], pad)])
        alts = np.concatenate([alts, np.repeat(alts[-1:], pad)])

    def _per_frame(vals, name):
        if len(vals) != f:
            raise ValueError(f"one {name} per frame")
        v = np.asarray(list(vals), np.float32)
        return np.concatenate([v, np.repeat(v[-1:], pad)]) if pad else v

    if tilts_deg is None and fovs_deg is None:
        elev_frames = None  # the [H] rows at the params tilt/fov, shared
        elev_deg = camera.fast_ray_elevations(out.width, out.height, frame.fov, frame.tilt)
    else:
        tilts = (np.full(f + pad, frame.tilt, np.float32)
                 if tilts_deg is None else _per_frame(tilts_deg, "tilt"))
        fovs = (np.full(f + pad, frame.fov, np.float32)
                if fovs_deg is None else _per_frame(fovs_deg, "fov"))
        elev_frames = np.stack([
            camera.fast_ray_elevations(out.width, out.height, float(fv), float(t))
            for fv, t in zip(fovs, tilts)
        ]).astype(np.float32)  # [F, H]
    if fovs_deg is None:
        az_rel = camera.fast_ray_azimuths(out.width, out.height, frame.fov, 0.0)
        az_frames = dirs[:, None] + az_rel[None, :].astype(np.float32)  # [F, W]
    else:  # each frame its own azimuth fan
        az_frames = np.stack([
            d + camera.fast_ray_azimuths(out.width, out.height, float(fv), 0.0)
            for d, fv in zip(dirs, fovs)
        ]).astype(np.float32)

    if atmospheres is not None and len(atmospheres) != f:
        raise ValueError("one AtmosphereDef per frame")
    alt_max = float(alts.max())
    # the Shading light is anchored to the view direction (params.rs:252-258)
    lights = []
    for d in dirs:
        col = params.view.coloring.into_coloring(
            dataclasses.replace(frame, direction=float(d)), pos, params.model)
        lights.append(col.light_dir if col.light_dir is not None else (0.0, 0.0, 1.0))
    lights = np.asarray(lights, np.float32)  # [F, 3]
    stacked = None
    if atmospheres is not None:
        # a table per distinct atmosphere, built on the first device and
        # stacked once: the table memo holds one entry an atmosphere,
        # whatever the sweep's length and the device count
        by_def = {a: setup.table(mesh[0], alt_max, a)
                  for a in dict.fromkeys(atmospheres)}
        stacked = RefractionTable.stack(
            [by_def[a] for a in atmospheres] + [by_def[atmospheres[-1]]] * pad)

    images, parts = [], []
    for dev, (f0, f1) in zip(mesh, _shards(f + pad, n_dev)):
        if stacked is None:
            table = setup.table(dev, alt_max)
        else:
            table = dataclasses.replace(stacked, values=stacked.values[f0:f1].to(dev),
                                        pairs=stacked.pairs[f0:f1].to(dev))
        image, hits = fast_mod.fast_core(
            setup.pack(dev), table,
            device_f32(elev_deg if elev_frames is None else elev_frames[f0:f1], dev),
            device_f32(az_frames[f0:f1], dev), device_f32(alts[f0:f1], dev),
            max_hits=setup.max_hits, objects=ObjectSet.build(params, dev),
            light_dir=device_f32(lights[f0:f1], dev), **setup.kw,
        )
        images.append(image)
        parts.append(hits)
    dev0 = mesh[0]
    frames = torch.cat([im.to(dev0) for im in images])[:f]
    if fetch_frames:
        frames = fetch_flat(frames).reshape(frames.shape)
    if not return_hits:
        return frames
    if return_hits == "valid":
        return frames, torch.cat([h.valid.to(dev0) for h in parts])[:f]
    return frames, _gather_hits(parts, 0, dev0, f)


def render_interpolating_sharded(params: Params, terrain: Terrain,
                                 mesh: Sequence[torch.device],
                                 max_hits: Optional[int] = None) -> RenderResult:
    """InterpolatingRectilinear over ``mesh``: the snapped grid's columns
    split (padded by continuing the snapped progression), the grid planes
    gathered onto every device (cut to the grid's own columns), then the
    output rows split for the interpolation and the composite."""
    out, frame = params.output, params.view.frame
    setup = frame_setup(params, terrain, max_hits, opaque_hits=2)
    cam = (out.width, out.height, float(frame.fov), float(frame.tilt),
           float(frame.direction))
    (min_es, min_ds, i_min, j_min, grid_elev_deg, grid_az_deg,
     elev_out, az_out) = interp_mod._camera_grids(*cam)
    n_dev = len(mesh)
    true_wp = grid_az_deg.shape[0]
    padn = (-true_wp) % n_dev
    grid_az_pad = grid_az_deg
    if padn:  # extra columns render, and are dropped before any pixel reads them
        grid_az_pad = np.concatenate([
            grid_az_deg,
            np.rad2deg(np.arange(j_min + true_wp, j_min + true_wp + padn) * min_ds),
        ])
    kw = dict(setup.kw)
    coloring, fog = kw.pop("coloring"), kw.pop("fog_distance")

    grid_parts = []
    has_objects = False
    for dev, (c0, c1) in zip(mesh, _shards(grid_az_pad.shape[0], n_dev)):
        objects, windows = fast_mod.build_objects_cached(params, grid_az_deg,
                                                         setup.n_terr, dev)
        has_objects = objects is not None
        grid_parts.append(fast_mod.separable_hits(
            setup.pack(dev), setup.table(dev),
            device_f32(grid_elev_deg, dev), device_f32(grid_az_pad[c0:c1], dev),
            float(setup.alt0),
            max_hits=interp_mod.grid_hit_depth(setup.max_hits, kw["terrain_alpha"],
                                               has_objects),
            objects=objects, obj_windows=_shard_windows(windows, c0, c1),
            obj_overlap=(None if objects is None
                         else max_window_overlap(windows, objects.n_objects)),
            **kw,
        ))

    rows_per = -(-out.height // n_dev)
    images, parts = [], []
    for i, dev in enumerate(mesh):
        grid = _gather_hits(grid_parts, 1, dev, true_wp)  # the all-gather
        rows = torch.arange(i * rows_per, (i + 1) * rows_per, device=dev).clamp(
            max=out.height - 1)  # padded rows repeat the last
        gi, gj, rem_e, rem_d = (x.index_select(0, rows) for x in interp_mod.grid_coords(
            cam, min_es, min_ds, i_min, j_min, dev))
        hits = interp_mod._interpolate_pixels(grid, gi, gj, rem_e, rem_d, kw["step"],
                                              2 * setup.max_hits, has_objects=has_objects)
        images.append(composite(
            coloring, fog, hits.valid, hits.rgba[..., 3], hits.distance, hits.elevation,
            hits.path_length, hits.normal, hits.kind, hits.rgba[..., :3]))
        parts.append(hits)
    dev0 = mesh[0]
    image = torch.cat([im.to(dev0) for im in images])[: out.height]
    return setup.result(image, _gather_hits(parts, 0, dev0, out.height), elev_out, az_out)


def render_rectilinear_pixelwise_sharded(params: Params, terrain: Terrain,
                                         mesh: Sequence[torch.device],
                                         max_hits: Optional[int] = None) -> RenderResult:
    """Tilted or object Rectilinear: the dense per-pixel program
    (``rectilinear.rectilinear_core``) over the flattened pixels,
    ``rectilinear.PIXEL_ROWS`` image rows a chunk (rounded up to a multiple
    of the device count), each chunk split over ``mesh``. Every ray is independent, so this is the one-device dense
    render (``render_rectilinear(..., cull=False)``) bit for bit."""
    out, frame = params.output, params.view.frame
    setup = frame_setup(params, terrain, max_hits)
    n_dev = len(mesh)
    h, w = out.height, out.width
    elev_rad, dir_rad = camera.rectilinear_ray_params(w, h, frame.fov, frame.tilt,
                                                      frame.direction)  # [H, W]

    p_total = h * w
    chunk = rect_mod.PIXEL_ROWS * w
    chunk += (-chunk) % n_dev  # every device an equal slice
    pad = (-p_total) % chunk
    elev_flat = np.zeros(p_total + pad, np.float32)
    dir_flat = np.zeros(p_total + pad, np.float32)
    elev_flat[:p_total] = elev_rad.reshape(-1)
    dir_flat[:p_total] = np.rad2deg(dir_rad).reshape(-1)

    inputs = [(setup.pack(dev), setup.table(dev), ObjectSet.build(params, dev))
              for dev in mesh]
    images, parts = [], []
    dev0 = mesh[0]
    for c0 in range(0, p_total + pad, chunk):
        for dev, (pack, table, objects), (s0, s1) in zip(mesh, inputs, _shards(chunk, n_dev)):
            image, hits = rect_mod.rectilinear_core(
                pack, table, device_f32(elev_flat[c0 + s0:c0 + s1], dev),
                device_f32(dir_flat[c0 + s0:c0 + s1], dev), float(setup.alt0),
                max_hits=setup.max_hits, objects=objects, **setup.kw)
            images.append(image.to(dev0))
            parts.append(hits.to(dev0))
    image = torch.cat(images)[:p_total].reshape(h, w, 3)
    hits = rect_mod._frame_hits([_gather_hits(parts, 0, dev0, p_total)], h, w)
    return setup.result(image, hits, np.rad2deg(elev_rad), np.rad2deg(dir_rad))


def render_rectilinear_sharded(params: Params, terrain: Terrain,
                               mesh: Sequence[torch.device],
                               max_hits: Optional[int] = None) -> RenderResult:
    """Rectilinear over ``mesh``: at tilt 0 without objects the image ROWS
    split through the fused tilt-0 core (padded to a multiple of the device
    count by repeating the last row; every device scans the shared columns),
    else the dense program over the flattened PIXELS
    (``render_rectilinear_pixelwise_sharded``)."""
    out, frame = params.output, params.view.frame
    if frame.tilt != 0.0 or params.objects:
        return render_rectilinear_pixelwise_sharded(params, terrain, mesh, max_hits)
    setup = frame_setup(params, terrain, max_hits)
    h, w = out.height, out.width
    elev_rad, dir_rad = camera.rectilinear_ray_params(w, h, frame.fov, frame.tilt,
                                                      frame.direction)
    az_col = camera.rectilinear_column_azimuths(w, frame.fov, frame.direction)

    rows_per = -(-h // len(mesh))
    images, parts = [], []
    for i, dev in enumerate(mesh):
        image, hits = rect_mod.fused_shared_core(
            setup.pack(dev), setup.table(dev), device_f32(az_col, dev), float(setup.alt0),
            cam=(w, h, float(frame.fov)), max_hits=setup.max_hits,
            rows=torch.arange(i * rows_per, (i + 1) * rows_per, device=dev).clamp(max=h - 1),
            **setup.kw)
        images.append(image)
        parts.append(hits)
    dev0 = mesh[0]
    image = torch.cat([im.to(dev0) for im in images])[:h]
    return setup.result(image, _gather_hits(parts, 0, dev0, h), np.rad2deg(elev_rad),
                        np.rad2deg(dir_rad))


def _tiny_setup(width=64, height=48, max_distance=5000.0, step=100.0):
    """(params, terrain) of the tiny dry-run scene: one 121-post tile of
    smooth hills, the observer 30 m above it at 49.5/21.5 looking 45°."""
    n = 121
    lats = 49 + np.arange(n) / (n - 1)
    lons = 21 + np.arange(n) / (n - 1)
    la, lo = lats[:, None] - 49.0, lons[None, :] - 21.0
    hills = 300.0 + 250.0 * np.sin(2 * np.pi * la * 3) * np.cos(2 * np.pi * lo * 2)
    terrain = Terrain()
    terrain.add_tile(Tile(49, 21, hills.astype(np.float32)))
    config = Config.from_dict({
        "view": {
            "position": {"latitude": 49.5, "longitude": 21.5,
                         "altitude": {"Relative": 30.0}},
            "frame": {"direction": 45.0, "fov": 20.0, "max_distance": max_distance},
        },
        "simulation_step": step,
        "output": {"width": width, "height": height},
    })
    return config.into_params(terrain), terrain


def dryrun_multichip(n_devices: int, device) -> str:
    """Run the six multi-device modes once on ``n_devices`` entries of
    ``device`` (repeated) at a tiny size, check their shapes and that each
    sees terrain, and print (and return) one ``dryrun_multichip OK`` line.
    Counterpart of the JAX repository's ``__graft_entry__.dryrun_multichip``."""
    mesh = make_mesh([device] * n_devices)
    params, terrain = _tiny_setup()

    def expect(cond, msg):
        if not cond:
            raise AssertionError(f"dryrun_multichip: {msg}")

    result = render_fast_sharded(params, terrain, mesh)
    expect(result.image.shape == (48, 64, 3), f"Fast image {result.image.shape}")
    expect(bool(result.hits.valid.any()), "column-split Fast saw no terrain")
    rect = render_rectilinear_sharded(params, terrain, mesh)
    expect(rect.image.shape == (48, 64, 3), f"Rectilinear image {rect.image.shape}")
    expect(bool(rect.hits.valid.any()), "row-split Rectilinear saw no terrain")
    frames = render_sweep_sharded(params, terrain, mesh,
                                  directions_deg=[0.0, 90.0, 180.0, 270.0])
    expect(frames.shape == (4, 48, 64, 3), f"sweep frames {frames.shape}")
    tilted_frame = dataclasses.replace(params.view.frame, tilt=3.0)
    tilted_params = dataclasses.replace(
        params, view=dataclasses.replace(params.view, frame=tilted_frame))
    tilted = render_rectilinear_sharded(tilted_params, terrain, mesh)
    expect(tilted.image.shape == (48, 64, 3), f"tilted image {tilted.image.shape}")
    expect(bool(tilted.hits.valid.any()), "pixel-split tilted Rectilinear saw no terrain")
    interp = render_interpolating_sharded(params, terrain, mesh)
    expect(interp.image.shape == (48, 64, 3), f"Interpolating image {interp.image.shape}")
    expect(bool(interp.hits.valid.any()), "split Interpolating saw no terrain")
    big_params, _ = _tiny_setup(width=1920, height=1080, max_distance=2000.0)
    big = render_fast_sharded(big_params, terrain, mesh)
    expect(big.image.shape == (1080, 1920, 3), f"production-aspect image {big.image.shape}")
    line = (
        f"dryrun_multichip OK on {n_devices} devices ({mesh[0]}) — modes covered: "
        f"[1] column-split Fast {result.image.shape}, "
        f"[2] row-split fused Rectilinear (tilt 0) {rect.image.shape}, "
        f"[3] frame-split sweep {frames.shape}, "
        f"[4] pixel-split dense tilted Rectilinear {tilted.image.shape}, "
        f"[5] grid-column and row split Interpolating {interp.image.shape}, "
        f"[6] column-split Fast at production aspect {big.image.shape}"
    )
    print(line)
    return line
