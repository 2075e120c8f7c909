#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --fast-wall PACKAGE_ROOT   # one tree's Fast headline wall

The second form times only the Fast headline (median of 20 renders after a
warm-up) with the ``atm_raytracer_tpu_torch`` package found under
PACKAGE_ROOT, e.g. an unpacked parent commit, for comparisons in turns.

Runs from the root of a checkout of this repository, on a machine with one
CUDA GPU, ``nvcc``, ``g++`` and PyTorch built for CUDA, PyYAML and Pillow
(the metadata phase writes the npz artifact's YAML config and a PNG; the
terrain-files phase a ``gen`` config). Imports
nothing of JAX. Phases, each printed as it ends; any failure exits non-zero
before the result line:

1. device   — the card's name, and its power limit from nvidia-smi;
2. build    — the five CUDA kernels (K1, K2, K3, K4, K6) built from
              ``atm_raytracer_tpu_torch/csrc``, one nvcc each, started
              together, with ptxas's registers, spills and shared memory;
2b. terrain files — the headline's 45 tiles of 1201 posts as files: both
              native tile loaders built by g++ (``g++ --version``, the build
              seconds, whether ``zlib.h`` was found, ``os.cpu_count()``); the
              tiles written with the port's writers (the southernmost row as
              GeoTIFF, the rest DTED); ``Terrain.from_folder``, ``preload``
              (the native parse), the stacking and the upload timed apart,
              and the same with the Python parsers (``native=False``), every
              tile equal to its Python parse; the file-backed pack
              ``torch.equal`` to the in-memory terrain's (and its bounds
              equal); the Fast headline from the files through one K1 and one
              K2 launch (counted), bit-equal to the in-memory render; ``gen``
              from the folder in a subprocess, its PNG equal to that render
              and its wall time;
3. kernels  — each kernel against its plain PyTorch version on the card:
              K1 (combine) segments equal on ragged random fans, K = 1 and 4,
              on the path-death and deep-terrain cases, on two fans where
              each branch of the envelope cull fires (ray tiles above, then
              below, the terrain for whole chunks before crossing) and on a
              crossing at a chunk's last segment; K1's envelopes equal to
              ``crossing_envelopes_plain`` (torch.equal) on every case; K2
              (the fused march) for the poly and table l(h), sphere and
              flat: the nodes-only launch within 2e-2 m of the plain loop,
              and on B x N x C of 1 x 3999 x 16, 21 x 200 x 1, 1080 x 3999
              x 16, 1080 x 330 x 16 (a ragged tail) and, once, 540 000 x
              3999 x 16 (past 2^31 elements), and with a 10-segment fit
              (past the registers' 8; rays from its zero-width piece take
              the IEEE-division fallback): its nodes within 2e-2 m, its
              fine h torch.equal to the PyTorch Hermite fill of its own
              nodes, its p within rtol 1e-6 / atol 1e-3 m of that fill's
              path length (the largest difference printed in ulp); what
              the card's PyTorch computes for ``x / w``, w a Python float;
              K3 (the tilt-0 Rectilinear scan) against ``tilt0_hits_plain``
              on the headline scene at 192x108 and 1920x1080, K = 1 and 4,
              for the poly and table l(h) on the sphere, straight rays on
              the sphere, the poly l(h) on the flat Earth and the table of
              an inversion (a duct around the observer) on the sphere: one
              launch a progress stride; valid flags equal on >= 99.99 % of
              pixels, keys within 1e-3 of a step and path lengths within
              rtol 1e-6 / atol 1e-3 m where both hit, the worst pixel and
              any flipped pixel printed; the plain scan with K3's two rules
              applied (``tilt0_hits_ruled``) torch.equal to the plain scan,
              K3's marched pixel-windows against the plain scan's, the tests
              the hull skipped, the pixels that exited, and K3's flags
              against the ruled scan's;
4. goldens  — the three golden Fast scenes, the three golden Interpolating
              scenes (their grids through K1, and K2 where the rays are
              refracted, counted) and the three
              golden Rectilinear scenes, plus the golden scene tilted onto
              the Rectilinear culled path (1 degree, opaque; its capture
              scan through K4, one launch a round, counted) and its
              pixelwise path (-1 degree, translucent; its march goes
              through K2), and the objects golden with each generator (K1
              and K2 once each for Fast and Interpolating, K2 for the
              Rectilinear row chunks, counted; the three tilt-0 Rectilinear
              goldens through K3, one launch a progress stride, counted),
              rendered on the card and with the plain path on the CPU, within
              the verify tolerance;
5. headline — 1920x1080, fov 40, 200 km in 50 m steps, refracted, spherical,
              over 45 synthetic 1201-post tiles: the render goes through both
              kernels (launch counts; K2 once), matches the plain path on the
              card, and is timed (median frame wall of 20 renders after a
              warm-up), with each kernel's time beside its plain version's
              and its bound at the headline shapes; K1's work counted: the
              sign tests the per-pixel scan needs (T_need), the live and
              total chunks, the tests in live chunks, and no first
              crossing in a culled chunk; K2: the march call by CUDA events
              and its kernel alone by the profiler (with the march's other
              device records), the cycles a step by clock64() (fused and
              nodes only) with the CTAs' span by %globaltimer, the
              latencies of single operations (``scripts/k2_clock_probe.py``)
              and the chain floor they give, the bytes bound, the p ulp
              difference, and the rays-per-CTA sweep at 1080, 122 880 and
              21 rays;
6. profile  — a torch.profiler trace of the headline (device busy time,
              idle share, top kernels), stage times by CUDA events and the
              peak device memory;
7. rectilinear — the Rectilinear generator on the headline scene: (a) at
              192x108 on the card against the CPU; (b) at 1920x1080, tilt 0,
              its scan through K3 (36 launches, counted): median frame wall
              of 5 renders after a warm-up, one ``plain=True`` render's wall
              and image (within the verify tolerance), peak device memory,
              device busy time, idle share and record count from a
              torch.profiler trace of one render, the K = 1 keys equal to
              the first keys of a K = 2 render, the profiled render's top
              host-side ops, K3 at the headline's inputs at K = 1 and 4
              against ``tilt0_hits_plain`` and the ruled plain scan (its
              CUDA-event time, its kernel alone by the profiler, the plain
              version's time, its bound on the windows the pixels marched
              and the tests the hull skipped, the plain scan's
              pixel-windows and their bound; at K = 1 each launch's live
              pixels, live warps, pixel-windows and kernel time),
              CUDA-event stage times; (c) at
              tilt 1 degree through the culled path, its capture scan K4:
              K4 against ``culled_capture_plain`` at 192x108 for every one
              of K3's l(h) forms, at skip 0 and M_CAND (count and blocks
              equal on >= 99.99 % of pixels, death flags equal, the slot
              states within rtol 1e-6 / atol 1e-3 m, slope 1e-6; the first
              differing pixel printed); at 1920x1080 the frame counted (one
              K4 and one K5 launch a round), its median wall of 5 after a warm-up
              beside one ``plain=True`` frame (images within the verify
              tolerance, validity equal on >= 99.99 %, keys within 1e-3
              where both hit), peak memory of both, device busy time, idle
              share and the top records of a profiled render, its top
              host-side ops; K4 at the headline's inputs against the plain
              capture (the same contract), by CUDA events, alone by the
              profiler, its host enqueue, the plain capture's time, the
              pixel-windows marched and the bound; K5, the exact test, at
              the headline's inputs round by round against the plain test on
              the same slots (validity equal, keys within 1e-3 of a step,
              path lengths rtol 1e-5), by CUDA events, alone by the
              profiler, its host enqueue, the plain test's time, the slots
              it walks and its bound over them; the stages of a round
              (envelope, capture, exact test, ``ray_hits``, composite, image
              to host) for ``plain=True`` and for K4 and K5; and at 192x108
              the culled keys equal to the dense path's (plain march);
8. metadata — the headline's artifact, npz and reference ``.dat``: saved,
              loaded and re-composited on the card bit for bit, every field
              exact (the render counted through both kernels); the
              compaction on the card equal to the CPU's; ``view --pixel
              --save-image`` on the card; the translucent headline (K = 4)
              as npz; the 8192x2048 / fov 120 / 150 km artifact written and
              read, timed, with the peak device memory; ``output-ray-paths``
              on the card (through K2, counted) against the CPU;
9. interpolating — the InterpolatingRectilinear generator on the headline
              scene: (a) the render through K2 and K1 (one launch each,
              counted) against ``plain=True`` on the card (images within the
              verify tolerance, validity equal on >= 99 % of slots); the
              grid cells of the card's float32 camera against the CPU's
              (<= 0.01 % of pixels differ); the median frame wall of 10
              renders after a warm-up, device busy time and idle share from
              a torch.profiler trace of one render, peak device memory,
              CUDA-event stage times; each kernel at the grid's shapes
              beside its plain version and bound, K1's segments equal to the
              plain ones and K2 (787 rays) held to its phase-3 contract
              (nodes and h within 2e-2 m of the plain march, h torch.equal
              to the Hermite fill of its own nodes, p within rtol 1e-6 /
              atol 1e-3 m); sky/terrain agreement and
              the median first-hit distance gap against the Rectilinear
              tilt-0 render; (b) the translucent headline (alpha 0.65: 16
              entries a pixel, 8 slots), one timed render and its peak
              memory; (c) due south, across the ±180° seam: the grid's
              azimuth span under 3 x fov, one render;
10. objects — the headline scene with 8 objects (four Cylinders, a
              translucent Cylinder, a Cone, two textured Billboards with a
              transparent band) on terrain points the object-free Fast
              headline hits, 3-120 km out, a Cylinder and a Billboard 0.6
              degrees apart: (a) Fast through K1, K2 and K6 (one launch
              each, counted) against ``plain=True`` on the card, every object
              seen, the median frame wall of 10 renders, stage times (K6's
              four kernels by the profiler), peak memory, device busy time
              and idle share; the object pass alone on the card against the
              CPU on the same inputs (validity flips, key and field
              differences); (b) InterpolatingRectilinear the same,
              median of 5; (c) Rectilinear at tilt 0 through the row-chunked
              shared-column path (K2 a chunk, counted): timed renders, peak
              memory, stage times of one chunk, object pixels against the
              Fast render; (d) at 192x108, each generator card against CPU
              (validity flips) and the golden object scene tilted 1 degree
              (the dense path, through K2) card against CPU;
10b. k6    — K6 at the shapes of the benchmark's object cells
              (``portbench/configs/objects_1080p.json``, K = 1, and
              ``translucent_1080p.json``, K = 4 and k_out = 10: 1080p at 45
              degrees, their stored objects): the Fast frame counted (K1, K2,
              K6 once each); K6 against ``apply_objects_planes(plain=True)``
              on the same inputs on the card (validity equal, keys within
              1e-5 of a step, payloads on valid slots within rtol 1e-5 /
              atol 1e-3, payload 0 on invalid slots; whether bit-equal), its
              tables ``torch.equal`` to ``object_column_tables``'; the frame
              against ``plain=True`` (verify tolerance, validity equal on
              >= 99.9 % of slots); K6 by CUDA events (mean of 20) and its
              four kernels by the profiler, the plain pass's and its tables'
              times, the byte bound (key and 13 payloads, k_in slots read and
              k_out written, at 3.35 TB/s) and K6's share of it, the frame
              wall (median of 5) and peak memory;
11. sweep   — the BASELINE sweep (bench.py:405-410): 8 frames of 1280x720,
              fov 45, 100 km in 50 m steps, directions 0..315, through
              ``parallel.mesh.render_sweep_sharded`` on one card: one K2 and
              one K1 launch (counted), the median wall of 5 after a warm-up
              with the frames on the host, frames per second, device busy
              time and idle share, peak memory; every frame equal to
              ``render_fast`` of it; K1's segments and envelopes equal to the
              plain ones and K2 held to the phase-3 contract on the sweep's
              own inputs, both timed beside their bounds; then a sweep with
              every frame its own atmosphere (US-76 and an inversion in
              turn), altitude, tilt and fov: one launch each, K2 reading a
              table a frame, held to the same contract;
12. multi-device — the modes of ``parallel.mesh`` over ``[cuda:0,
              cuda:0]``: Fast and Interpolating at the 1080p headline,
              Rectilinear at 192x108 at tilt 0 and 1 degree, each equal to
              its one-device render, its launches counted; the tilted split
              (the dense path: K2, no K4) beside the one-device culled
              render (K4 a round, counted), hit masks equal;
              ``dryrun_multichip(4, "cuda")``;
13. transfer — (a) ``fetch_flat`` of the Fast headline image and of the
              sweep's frames against ``.cpu()`` and a reused pinned buffer,
              ``_pack_artifact``'s one batched fetch against nine per-field
              copies, medians of 20, every array equal; (b)
              ``render_fast_streamed`` at the headline, bands 8: image and
              hits ``torch.equal`` to ``render_fast``, one K2 and eight K1
              launches (counted), 8 progress lines, no host sync in the band
              loop (``set_sync_debug_mode("error")``), medians of 20 in turns
              with ``render_fast``, device busy, idle share and the ``Memcpy
              DtoH`` time under kernels on another stream from a trace of one
              render; (c) ``pack_frame_compact`` on the headline frame and the
              sweep's 8 frames (bytes, device ms, decode ms, bit-exact, the
              card's payload equal to the CPU's) and ``fetch_viewer_fields``,
              ``_separable`` and ``_delta`` at the headline within the JAX
              tests' tolerances. Phase 2b's ``gen`` takes the banded render
              and prints 8 progress lines.

The verify tolerance (the JAX package's bench.py verify): at most 1 % of
pixels differ by more than 2 counts and at most 5 % differ at all.

Output: the kernels line ``{"kernels": [...]}`` (``launches`` summed over
the counted main-path renders — Fast, Fast from the tile files, the
Rectilinear tilt-0 and tilt-1 headlines, Interpolating, the three object
frames, K6's two frames, the sweep and the banded Fast render — with the
split in
``launches_by_path``; each
kernel's numbers at the Interpolating grid and at the sweep's shapes in
``at_interpolating_grid`` and ``at_sweep``) and, last, the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LAT0, LON0 = 49.5, 21.5
K2_ATOL = 2e-2  # meters: the bound the JAX package holds its Pallas march to
# NVIDIA's H100 SXM data sheet, at the full 700 W: HBM3 rate, float32 peak
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# -- synthetic terrain (the JAX test suite's analytic landscape) -------------

def analytic_hills(lat, lon, base_lat=49.0, base_lon=21.0):
    """Smooth deterministic landscape, meters; works on arrays (degrees)."""
    import numpy as np

    la = np.asarray(lat, np.float64) - base_lat
    lo = np.asarray(lon, np.float64) - base_lon
    return (
        300.0
        + 250.0 * np.sin(2 * np.pi * la * 3.0) * np.cos(2 * np.pi * lo * 2.0)
        + 120.0 * np.sin(2 * np.pi * (la * 7.0 + lo * 5.0))
    )


def tile_grid(lat0: int, lon0: int, n: int):
    """Integer-meter post grid (inclusive edges) over one 1-degree tile."""
    import numpy as np

    lats = lat0 + np.arange(n) / (n - 1)
    lons = lon0 + np.arange(n) / (n - 1)
    return np.round(analytic_hills(lats[:, None], lons[None, :])).astype(np.int16)


def image_tolerance(a, b):
    """(ok, frac_any, frac_big, max) of the verify tolerance on two images."""
    import numpy as np

    pix = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
    frac_any = float((pix > 0).mean())
    frac_big = float((pix > 2).mean())
    return frac_big <= 0.01 and frac_any <= 0.05, frac_any, frac_big, int(pix.max())


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phases -------------------------------------------------------------------

def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    say(f"[device] nvidia-smi: {smi.stdout.strip()}")
    return name


def phase_build():
    """Every kernel built at once (one nvcc each, started together)."""
    from concurrent.futures import ThreadPoolExecutor

    from atm_raytracer_tpu_torch import _kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_kernels.KERNELS)) as pool:
        list(pool.map(lambda k: k.build(), _kernels.KERNELS))
    say(f"[build] {len(_kernels.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for k in _kernels.KERNELS:
        k.function()
        say(f"[build] {k.source}: nvcc {k.build_seconds} s")
        for line in k.build_log.splitlines():
            if "Compiling entry function" in line:  # the instance the lines below are of
                name = line.split("'")[1]
                say(f"[build]   {name}")
            elif "registers" in line or "spill" in line or "smem" in line:
                say(f"[build]   {line.strip()}")


def tile_name(lat: int, lon: int) -> str:
    """The ``N49E021`` name that keys a GeoTIFF tile."""
    return (f"{'N' if lat >= 0 else 'S'}{abs(lat):02d}"
            f"{'E' if lon >= 0 else 'W'}{abs(lon):03d}")


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def timed(fn, *args):
    """(result, seconds) of ``fn(*args)``, ending in a device synchronize."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_terrain_files(dev, terrain, size=(1920, 1080), max_distance=200_000.0):
    """2b. The headline's 45 tiles as files: the native loaders built by
    g++, the tiles written with the port's writers (the southernmost row of
    tiles as GeoTIFF, the rest DTED), ``Terrain.from_folder`` -> ``preload``
    -> ``pack`` on the card timed part by part, the Python parsers'
    ``native=False`` store the same, every tile equal to its Python parse,
    the pack equal to the in-memory terrain's, the Fast headline from the
    files (one K1 and one K2 launch, counted) bit-equal to the in-memory
    render, and ``gen`` from the folder in a subprocess: its PNG equal to
    that render. Returns the file-backed render's launches."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    import yaml
    from PIL import Image

    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.config import Config
    from atm_raytracer_tpu_torch.generators.fast import render_fast, terrain_bbox
    from atm_raytracer_tpu_torch.terrain.dted import write_dted
    from atm_raytracer_tpu_torch.terrain.geotiff import write_geotiff
    from atm_raytracer_tpu_torch.terrain.store import Terrain

    t_phase = time.perf_counter()
    cfg = headline_dict(*size, max_distance)
    params = Config.from_dict(cfg).into_params(None)
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    check(gxx.returncode == 0, f"g++ --version failed: {gxx.stderr.strip()}")
    zlib_h = subprocess.run(["g++", "-x", "c++", "-E", "-o", os.devnull, "-"],
                            input="#include <zlib.h>\n", capture_output=True, text=True,
                            timeout=60).returncode == 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_kernels.LOADERS)) as pool:
        list(pool.map(lambda lib: lib.build(), _kernels.LOADERS))
    build_s = time.perf_counter() - t0
    say(f"[terrain] {gxx.stdout.splitlines()[0]}; zlib.h found: {zlib_h}; "
        f"os.cpu_count() {os.cpu_count()}")
    say(f"[terrain] both loaders in {build_s:.2f} s ("
        + ", ".join(f"{lib.source}: g++ {lib.build_seconds} s" for lib in _kernels.LOADERS)
        + ")")

    box = terrain_bbox(params)
    keys = sorted(terrain.keys)
    south = min(k[0] for k in keys)
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp) / "terrain"
        folder.mkdir()
        t0 = time.perf_counter()
        for la, lo in keys:
            grid = terrain._loaded[(la, lo)].elev.astype(np.int16)
            if la == south:
                write_geotiff(folder / f"{tile_name(la, lo)}.tif", grid[::-1])
            else:
                write_dted(folder / f"{tile_name(la, lo).lower()}.dt2", la, lo, grid)
        n_bytes = sum(f.stat().st_size for f in folder.iterdir())
        n_tif = sum(1 for k in keys if k[0] == south)
        say(f"[terrain] wrote {len(keys)} tiles of 1201 posts ({n_tif} GeoTIFF, "
            f"{len(keys) - n_tif} DTED, {n_bytes} B) in {time.perf_counter() - t0:.2f} s")

        split = {}
        stores = {}
        for use_native in (True, False):
            tag = "native" if use_native else "python"
            t0 = time.perf_counter()
            store, lines = quiet(Terrain.from_folder, folder, use_native)
            scan_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, loaded = quiet(store.preload, sorted(store.keys))
            parse_s = time.perf_counter() - t0
            check(len(store._loaded) == len(keys), f"{tag}: preload loaded "
                  f"{len(store._loaded)} of {len(keys)} tiles")
            check(sum(ln.startswith("Lazy loading terrain file:") for ln in loaded)
                  == len(keys), f"{tag}: {len(loaded)} lines from preload")
            host, stack_s = timed(store.pack, *box, "cpu")
            _, upload_s = timed(lambda: [x.to(dev) for x in (host.tiles, host.rows_m1,
                                                             host.cols_m1)])
            pack, pack_s = timed(store.pack, *box, dev)
            split[tag] = {"scan_s": scan_s, "parse_s": parse_s, "stack_s": stack_s,
                          "upload_s": upload_s, "pack_s": pack_s}
            stores[tag] = (store, pack)
            say(f"[terrain] {tag}: folder scan {scan_s:.4f} s ({lines[-1]}); preload "
                f"{parse_s:.4f} s; stacking (pack on the CPU) {stack_s:.4f} s; upload of "
                f"{host.tiles.numel() * host.tiles.element_size()} B {upload_s:.4f} s; "
                f"pack on {dev} {pack_s:.4f} s")
        native_store, file_pack = stores["native"]
        python_store = stores["python"][0]
        for k in keys:
            check(np.array_equal(native_store._loaded[k].elev, python_store._loaded[k].elev),
                  f"tile {k}: the native loader and the Python parser differ")
        say(f"[terrain] all {len(keys)} native tiles equal to their Python parse")

        mem_pack = terrain.pack(*box, dev)
        for f in ("tiles", "rows_m1", "cols_m1"):
            check(torch.equal(getattr(file_pack, f), getattr(mem_pack, f)),
                  f"file-backed pack {f} differs from the in-memory pack's")
        check((file_pack.grad_bound, file_pack.seam_jump)
              == (mem_pack.grad_bound, mem_pack.seam_jump),
              f"file-backed bounds {(file_pack.grad_bound, file_pack.seam_jump)} vs "
              f"{(mem_pack.grad_bound, mem_pack.seam_jump)}")
        say(f"[terrain] file-backed pack == in-memory pack ({tuple(file_pack.tiles.shape)} "
            f"{file_pack.tiles.dtype}; grad_bound {file_pack.grad_bound}, seam_jump "
            f"{file_pack.seam_jump})")

        want = render_fast(params, terrain, dev).image
        reset_launches()
        got = render_fast(params, native_store, dev).image
        torch.cuda.synchronize()
        launches = kernel_launches()
        check(launches == FAST_LAUNCHES,
              f"file-backed headline: launches {launches}")
        check(np.array_equal(got, want), "file-backed headline image differs from the "
              f"in-memory render ({int((got != want).any(-1).sum())} pixels)")
        say(f"[terrain] file-backed Fast headline == in-memory render (launches {launches})")
        del stores, native_store, python_store, file_pack, host, pack

        cfg["scene"] = {"terrain_folder": str(folder)}
        cfg["output"]["file"] = "out.png"
        (Path(tmp) / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "atm_raytracer_tpu_torch.cli", "gen", "-c", "cfg.yaml"],
            cwd=tmp, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"gen from the folder failed:\n{proc.stderr[-2000:]}")
        out = proc.stdout.splitlines()
        n_lazy = sum(ln.startswith("Lazy loading terrain file:") for ln in out)
        pct = [ln.split(": ", 1)[1] for ln in out if ln.endswith("%...")]
        check(pct == [f"{p}%..." for p in (12, 25, 38, 50, 62, 75, 88, 100)],
              f"gen: progress lines {pct}, want one a band of the banded render")
        for ln in out:
            if not ln.startswith("Lazy loading terrain file:"):
                say(f"[terrain] gen: {ln}")
        png = np.asarray(Image.open(Path(tmp) / "out.png").convert("RGB"))
        check(np.array_equal(png, want), "gen's PNG differs from the in-memory render "
              f"({int((png != want).any(-1).sum())} pixels)")
        say(f"[terrain] gen from the folder: wall {cli_s:.3f} s (a new process: "
            f"imports, CUDA start, scan, preload of {n_lazy} tiles, pack, table, the "
            "banded render, PNG); 8 progress lines; PNG == in-memory render")
    split["cli_gen_s"] = cli_s
    say(f"[terrain] {json.dumps(split)}")
    say(f"[terrain] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def random_fan(rng, h_n, w_n, n_samp, n_terr_samp):
    import numpy as np

    ray = (120.0 + np.linspace(-3.0, 1.0, h_n)[:, None] * np.arange(n_samp)[None, :]
           + rng.normal(0.0, 2.0, (h_n, n_samp)))
    terr = (100.0 + 30.0 * np.sin(np.arange(n_terr_samp) / 5.0)[None, :]
            + rng.uniform(-5.0, 5.0, (w_n, n_terr_samp)))
    return ray.astype(np.float32), terr.astype(np.float32)


def cull_fan(rng, h_n, w_n, n_seg, above, extra=0):
    """Ray tiles far above (``above``) or below the terrain for whole chunks,
    then crossing it near sample 0.55·n_seg: each branch of K1's cull fires."""
    import numpy as np

    k = np.arange(n_seg + 1)[None, :]
    k_x = int(0.55 * n_seg) + 3 * np.arange(h_n)[:, None]
    ramp = np.maximum(k - k_x, 0) * rng.uniform(2.0, 4.0, (h_n, 1))
    ray = ((300.0 - ramp) if above else (-100.0 + ramp)) + rng.normal(0.0, 2.0, ramp.shape)
    _, terr = random_fan(rng, 1, w_n, 1, n_seg + 1 + extra)
    return ray.astype(np.float32), terr


def cull_counts(env):
    """(culled with the rays above, culled with the rays below, live) of the
    (ray tile, terrain tile, chunk) triples of K1's envelopes."""
    ray_lo, ray_hi, terr_lo, terr_hi = env
    above = ray_lo[:, None] > terr_hi[None]
    below = ray_hi[:, None] < terr_lo[None]
    return int(above.sum()), int(below.sum()), int((~(above | below)).sum())


def phase_kernels(dev):
    """K1 and K2 against their plain versions on the card."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.ops import combine
    from atm_raytracer_tpu_torch.physics import ray as R
    from atm_raytracer_tpu_torch.physics.atmosphere import Atmosphere, us_76

    rng = np.random.default_rng(7)
    cases = []
    for h_n, w_n, n_seg, extra in ((37, 45, 300, 0), (9, 70, 129, 17), (130, 33, 1000, 0)):
        ray, terr = random_fan(rng, h_n, w_n, n_seg + 1, n_seg + 1 + extra)
        cases.append((f"fan{h_n}x{w_n}x{n_seg}", ray, terr, n_seg))
    n = 50
    death = np.full((1, n + 1), 10.0, np.float32)
    death[0, 10:] = -2000.0
    death[0, 20:] = 50.0  # resurfaces after death: must not count
    cases.append(("death", death, np.zeros((1, n + 1), np.float32), n))
    deep = np.full((1, n + 1), 10.0, np.float32)
    deep[0, 10:] = -1100.0  # dead above a -1500 m floor: no crossing
    cases.append(("deep", deep, np.full((1, n + 1), -1500.0, np.float32), n))
    # the cull's two branches, and a crossing that only the sample two chunks
    # share reveals (the last segment of chunk 1)
    cases.append(("above then crossing", *cull_fan(rng, 21, 70, 700, True, extra=11), 700))
    cases.append(("below then crossing", *cull_fan(rng, 21, 70, 700, False), 700))
    edge = np.full((21, 701), -100.0, np.float32) + rng.normal(0.0, 2.0, (21, 701)).astype(
        np.float32)
    edge[:, : 2 * combine.CHUNK] += 500.0
    cases.append(("chunk edge", edge, cases[-1][2], 700))
    for name, ray, terr, n_seg in cases:
        rt, tt = torch.from_numpy(ray).to(dev), torch.from_numpy(terr).to(dev)
        env_p = combine.crossing_envelopes_plain(rt, tt, n_seg)
        above, below, live = cull_counts(env_p)
        if name.startswith("above"):
            check(above > 0 and live > 0, f"K1 {name}: the cull above never fired")
        if name.startswith("below"):
            check(below > 0 and live > 0, f"K1 {name}: the cull below never fired")
        for k in (1, 4):
            got, env = combine.crossing_segments_envelopes_cuda(rt, tt, n_seg, k)
            want = combine.terrain_crossing_segments_plain(rt, tt, n_seg, k)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            check(bad == 0, f"K1 {name} K={k}: {bad} segments differ from plain")
            check(all(torch.equal(a, b) for a, b in zip(env, env_p)),
                  f"K1 {name} K={k}: the envelopes differ from crossing_envelopes_plain")
            check(name != "chunk edge" or bool((want[..., 0] == 2 * combine.CHUNK - 1).all()),
                  "K1 chunk edge: a pixel does not cross at the last segment of chunk 1")
            say(f"[kernels] K1 {name} K={k}: equal ({int((want < n_seg).sum())} hits); "
                f"envelopes equal (culled above {above}, below {below}, live {live})")
    check(int(combine.crossing_segments_cuda(
        torch.from_numpy(death).to(dev), torch.zeros((1, n + 1), device=dev), n, 2
    )[0, 0, 1]) == combine.NO_HIT_SEG, "K1 death: a crossing after death counted")

    table = R.RefractionTable.build(Atmosphere(us_76()), 530e-9, h_hi=30000.0,
                                    device=dev)
    check(table.poly is not None, "US-76 should compile to a Chebyshev fit")
    elev = torch.deg2rad(torch.linspace(-0.6, 1.5, 1000, device=dev))
    alt = torch.full_like(elev, 100.0)
    for poly_name, tb in (("poly", table), ("table", dataclasses.replace(table, poly=None))):
        for shape in (R.EarthShape(6_371_000.0), R.FLAT):
            v0 = R.initial_slope(alt, elev, shape)
            hk, vk = R.march_nodes(alt, v0, 800.0, 250, tb, shape.radius)
            hp, vp = R.march_nodes_plain(alt, v0, 800.0, 250, tb, shape.radius)
            torch.cuda.synchronize()
            err = float((hk - hp).abs().max())
            sname = "flat" if shape.is_flat else "sphere"
            check(err <= K2_ATOL, f"K2 {poly_name} {sname}: max |dh| {err} m > {K2_ATOL}")
            say(f"[kernels] K2 nodes only, {poly_name} {sname}: max |dh| {err:.3g} m "
                f"(v {float((vk - vp).abs().max()):.3g})")
            for b, n, c in K2_CASES:
                if b > 100_000 and (poly_name, sname) != ("poly", "sphere"):
                    continue  # the 64-bit offsets once, at the headline's l(h) form
                k2_case(dev, tb, shape, b, n, c, f"{poly_name} {sname}")
    fit = split_fit(table.poly)
    lo = next(lo for lo, hi, _ in fit if lo == hi)
    split = dataclasses.replace(table, poly=fit)
    for shape in (R.EarthShape(6_371_000.0), R.FLAT):
        sname = "flat" if shape.is_flat else "sphere"
        k2_case(dev, split, shape, 1080, 330, 16, f"{len(fit)}-segment fit {sname}")
        k2_case(dev, split, shape, 64, 330, 16,
                f"{len(fit)}-segment fit {sname}, rays from the zero-width piece", alt=lo)
    scalar_division_probe(dev)


def split_fit(poly):
    """A fit of more segments than K2 keeps in registers: each segment of
    ``poly`` cut in three with its coefficients kept, the second segment's
    first piece one sample wide (lo == hi, the zero-width edge piece whose
    division K2 cannot take on its fast path)."""
    out = []
    for i, (lo, hi, c) in enumerate(poly):
        m1, m2 = lo + round((hi - lo) / 3), lo + round(2 * (hi - lo) / 3)
        if i == 1:
            out.append((lo, lo, c))
            lo += 1.0
        out += [(lo, m1 - 1.0, c), (m1, m2 - 1.0, c), (m2, hi, c)]
    return tuple(out)


# K2's cases on the card, with the poly and table l(h), sphere and flat:
# (B rays, N steps, C); the step is 50 m
K2_CASES = (
    (1, 3999, 16),  # one ray at the headline's length: 3999 = 249·16 + 15
    (21, 200, 1),  # the output-ray-paths fan: C = 1, the nodes are the samples
    (1080, 3999, 16),  # the Fast headline
    (1080, 330, 16),  # a ragged tail: 330 = 20·16 + 10
    (540_000, 3999, 16),  # B·(N+1) = 2 160 540 000 > 2^31: 64-bit offsets
)


def ulp_diff(got, want) -> float:
    """Largest |got - want| in units of the float32 spacing at ``want``."""
    import torch

    a = want.abs()
    spacing = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    return float(((got - want).abs() / spacing).max())


def k2_case(dev, tb, shape, b, n, c, tag, step=50.0, alt=100.0):
    """K2's contract on one case: the fused launch's nodes within K2_ATOL of
    ``march_nodes_plain``; its fine h ``torch.equal`` to the PyTorch Hermite
    fill of its own nodes; its p within rtol 1e-6 / atol 1e-3 m of
    ``_finish_march``'s path length of that h. Above 4096 rays the plain
    side runs on the first and last 2048 rays only."""
    import torch

    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.physics import ray as R

    elev = torch.deg2rad(torch.linspace(-0.6, 1.5, b, device=dev) if b > 1
                         else torch.full((1,), 0.05, device=dev))
    alt = torch.full_like(elev, alt)
    v0 = R.initial_slope(alt, elev, shape)
    coarse = max(1, min(c, n))
    n_coarse = -(-n // coarse)
    dx = R._f32(step * coarse)
    before = _kernels.MARCH.launches
    h, p, nh, nv = R.march_cuda(alt, v0, dx, n_coarse, tb, shape.radius,
                                fine=(step, coarse, n), nodes=True)
    check(_kernels.MARCH.launches == before + 1, f"K2 {tag} B={b}: not one launch")
    sel = (torch.arange(b, device=dev) if b <= 4096 else
           torch.cat([torch.arange(2048, device=dev), torch.arange(b - 2048, b, device=dev)]))
    hp_nodes, _ = R.march_nodes_plain(alt[sel], v0[sel], dx, n_coarse, tb, shape.radius)
    fill = R.hermite_fill(nh[:, sel], nv[:, sel], dx, coarse, n)
    h_t, p_t = R._finish_march(fill, step, shape.radius)
    torch.cuda.synchronize()
    node_err = float((nh[:, sel] - hp_nodes).abs().max())
    check(node_err <= K2_ATOL, f"K2 {tag} B={b} N={n} C={c}: nodes {node_err} m from plain")
    check(h.shape == (b, n + 1) and torch.equal(h[sel], h_t),
          f"K2 {tag} B={b} N={n} C={c}: fine h differs from the Hermite fill of its nodes")
    p_ok = torch.allclose(p[sel], p_t, rtol=1e-6, atol=1e-3)
    dp = float((p[sel] - p_t).abs().max())
    ulp = ulp_diff(p[sel], p_t)
    check(p_ok, f"K2 {tag} B={b} N={n} C={c}: p differs by {dp} m ({ulp:.1f} ulp)")
    say(f"[kernels] K2 {tag} B={b} N={n} C={c}: nodes max |dh| {node_err:.3g} m; "
        f"h == Hermite fill of its nodes; p max |dp| {dp:.3g} m = {ulp:.1f} ulp "
        f"(p_N {float(p_t[:, -1].max()):.1f} m)")
    del h, p, nh, nv


def scalar_division_probe(dev):
    """What PyTorch's CUDA true division by a Python scalar computes, beside
    the CPU's: the plain march divides by Python scalars (``_seg_lengths``'
    radius; ``eval_l_poly`` divides by device tensors), the kernels with
    IEEE division."""
    import numpy as np
    import torch

    x = torch.rand(1 << 22, device=dev, generator=torch.Generator(dev).manual_seed(3))
    x = x * 2e5 + 1.0
    for w in (7.3, 6_371_000.0, 9999.0):
        card = x / w
        recip = x * float(np.float32(1.0) / np.float32(w))
        cpu = (x.cpu() / w).to(dev)
        say(f"[kernels] x / {w} on the card: equal to x * fl32(1/w) "
            f"{torch.equal(card, recip)}; equal to the CPU's division "
            f"{torch.equal(card, cpu)} ({int((card != cpu).sum())} of {x.numel()} differ)")


# K3's cases on the card: the l(h) form and the Earth shape of the ray ODE;
# "inversion": the table of INVERSION_ATMOSPHERE, a duct around the observer
K3_FORMS = ("poly sphere", "table sphere", "straight sphere", "poly flat",
            "inversion sphere")
# the frame sizes at which phase 3 holds K3 to its plain version
K3_SIZES = ((192, 108), (1920, 1080))


def inversion_atmosphere():
    """A 200 m layer warming by 0.15 K/m around the headline's observer
    (400 m): it bends rays down harder than the Earth curves, so K3's exit
    rule may not fire below its top (its band starts at ~501 m)."""
    from atm_raytracer_tpu_torch.physics.atmosphere import AtmosphereDef, LinearFunction

    return AtmosphereDef(
        first_temperature_function=LinearFunction(-0.0065),
        next_functions=((300.0, LinearFunction(0.15)), (500.0, LinearFunction(-0.0065))),
        temperature_fixed_point=(0.0, 288.15))


def k3_launches(params) -> int:
    """K3's launches for a tilt-0 frame of ``params``: one a progress stride."""
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    n_seg = int(math.ceil(params.view.frame.max_distance / params.simulation_step)) - 1
    coarse = max(1, min(rect.march_coarse(float(params.simulation_step)), n_seg))
    return len(rect.scan_launches(-(-n_seg // coarse)))


def k3_inputs(dev, terrain, params):
    """The tilt-0 scan's inputs of ``params`` on ``dev``, as
    ``fused_shared_core`` builds them: (alt0, table, az, elev_hw, terr_pad,
    stacked, the scan's step / n_seg / coarse keywords)."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import base
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    out, frame = params.output, params.view.frame
    alt0 = float(params.view.position.abs_altitude(terrain))
    pack = terrain.pack(*base.terrain_bbox(params), dev)
    table = base.build_refraction_table(params, alt0, dev)
    az = torch.from_numpy(rect.camera.rectilinear_column_azimuths(
        out.width, frame.fov, frame.direction).astype(np.float32)).to(dev)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    step = float(params.simulation_step)
    elev_hw, terr_pad, stacked, coarse = rect.tilt0_inputs(
        pack, az, cam=(out.width, out.height, float(frame.fov)), model=params.model,
        step=step, n_terr=n_terr, lat0=LAT0, lon0=LON0)
    return alt0, table, az, elev_hw, terr_pad, stacked, dict(step=step, n_seg=n_terr - 1,
                                                             coarse=coarse)


def k3_form(form: str, table, params, alt0: float) -> dict:
    """The shape, table and straight keywords of one of K3_FORMS."""
    from atm_raytracer_tpu_torch.generators import base
    from atm_raytracer_tpu_torch.generators import rectilinear as rect
    from atm_raytracer_tpu_torch.physics import ray as R

    l_form, shape = form.split()
    if l_form == "inversion":
        table = base.build_refraction_table(params, alt0, table.values.device,
                                            atmosphere_def=inversion_atmosphere())
    return dict(shape=R.FLAT if shape == "flat" else params.model.to_shape(),
                table=dataclasses.replace(table, poly=None) if l_form == "table" else table,
                straight=l_form == "straight")


def k3_check(tag, got, want):
    """K3's contract against ``tilt0_hits_plain`` on the same inputs: the
    valid flags of every slot equal on >= 99.99 % of pixels; where both hold
    a hit, keys within 1e-3 of a step and path lengths within rtol 1e-6 /
    atol 1e-3 m. Prints the worst pixel, and the first pixel whose flags
    differ (the kernel before its two rules read none: with the exact
    rules any is a rule's fault);
    returns the largest key difference."""
    import numpy as np
    import torch

    (key_k, plh_k), (key_p, plh_p) = got, want
    vk, vp = torch.isfinite(key_k), torch.isfinite(key_p)
    n_pix = vk.shape[0] * vk.shape[1]
    flipped = (vk != vp).any(-1)
    flips = int(flipped.sum())
    both = vk & vp
    dk = torch.where(both, (key_k - key_p).abs(), 0.0)
    over = torch.where(both, (plh_k - plh_p).abs() - (1e-3 + 1e-6 * plh_p.abs()), -1.0)
    dk_max, over_max = float(dk.max()), float(over.max())
    at = np.unravel_index(int(dk.argmax()), tuple(dk.shape))
    at_p = np.unravel_index(int(over.argmax()), tuple(over.shape))
    say(f"[kernels] K3 {tag}: valid flags differ on {flips} of {n_pix} pixels; "
        f"{int(both.sum())} hits in both; max |dkey| {dk_max:.3g} at (row, col, slot) "
        f"{tuple(int(i) for i in at)} (K3 {float(key_k[at]):.6f}, plain "
        f"{float(key_p[at]):.6f}); path length worst at {tuple(int(i) for i in at_p)}: "
        f"K3 {float(plh_k[at_p]):.4f} m, plain {float(plh_p[at_p]):.4f} m")
    if flips:
        r, c = (int(i) for i in torch.nonzero(flipped)[0])
        say(f"[kernels] K3 {tag}: first flipped pixel (row, col) ({r}, {c}): K3 keys "
            f"{key_k[r, c].tolist()}, plain {key_p[r, c].tolist()}")
    check(flips <= 1e-4 * n_pix, f"K3 {tag}: valid flags differ on {flips} of {n_pix} pixels")
    check(dk_max <= 1e-3, f"K3 {tag}: keys differ by {dk_max} of a step")
    check(over_max <= 0.0, f"K3 {tag}: a path length is out of rtol 1e-6 / atol 1e-3 m "
          f"(K3 {float(plh_k[at_p])}, plain {float(plh_p[at_p])})")
    return dk_max


def k3_rules_line(tag, flags, ruled, want):
    """The rules' work beside the plain scan's for one case: K3's marched
    pixel-windows (``flags``) against the windows the scan runs without the
    rules (the ruled plain scan's tally), the tests the hull skipped and the
    pixels that exited. Fails unless the ruled plain scan is ``torch.equal``
    to the plain scan ``want`` and K3's flags word is the ruled scan's on
    every pixel (the windows marched, the hits, the stop: a pixel where they
    differ is a rule that K3 and its mirror apply differently, and is
    printed). Returns (marched, plain, skipped, exits)."""
    import torch

    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    key_r, plh_r, flags_r, tally = ruled
    same = torch.equal(key_r, want[0]) and torch.equal(plh_r, want[1])
    marched = int((flags >> rect.SCAN_WINDOWS_SHIFT).sum())
    plain, skipped = int(tally.plain.sum()), int(tally.skipped.sum())
    exits = int(tally.exited.sum())
    differ = flags != flags_r
    n_differ = int(differ.sum())
    first = tuple(int(i) for i in torch.nonzero(differ)[0]) if n_differ else None
    say(f"[kernels] K3 {tag} rules: {marched} pixel-windows marched against the plain "
        f"scan's {plain} ({100.0 * marched / max(plain, 1):.2f} %); tests skipped by the "
        f"hull {skipped}; pixels exited {exits} of {flags.numel()}; ruled plain scan "
        f"torch.equal to the plain scan: {same}; K3 flags differ from the ruled scan's on "
        f"{n_differ} pixels" + (f" (first {first})" if first else ""))
    check(same, f"K3 {tag}: the plain scan with the rules differs from the plain scan")
    if n_differ:
        r, c = first
        say(f"[kernels] K3 {tag}: flags at (row, col) {first}: K3 {int(flags[r, c])}, "
            f"the ruled scan {int(flags_r[r, c])}")
    check(n_differ == 0, f"K3 {tag}: K3's flags differ from the ruled scan's on "
          f"{n_differ} pixels, first {first}")
    return marched, plain, skipped, exits


def phase_k3(dev, terrain, sizes=K3_SIZES):
    """K3 against ``tilt0_hits_plain`` on the card, on the headline scene at
    each of ``sizes``: K = 1 and 4, every one of K3_FORMS, one launch a
    progress stride; beside it the plain scan with K3's rules applied
    (``tilt0_hits_ruled``), ``torch.equal`` to the plain scan, K3's flags
    equal to its flags on every pixel, and the work the rules removed."""
    import torch

    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    for size in sizes:
        params = headline_params(*size)
        alt0, table, _, elev_hw, terr_pad, _, kw = k3_inputs(dev, terrain, params)
        for k in (1, 4):
            for form in K3_FORMS:
                fkw = k3_form(form, table, params, alt0)
                before = _kernels.RECT_SCAN.launches
                key, plh, flags = rect.tilt0_hits_cuda(elev_hw, terr_pad, alt0, max_hits=k,
                                                       **fkw, **kw)
                check(_kernels.RECT_SCAN.launches - before == k3_launches(params),
                      f"K3 {size} K={k} {form}: not one launch a progress stride")
                want = rect.tilt0_hits_plain(elev_hw, terr_pad, alt0, max_hits=k, **fkw, **kw)
                ruled = rect.tilt0_hits_ruled(elev_hw, terr_pad, alt0, max_hits=k, **fkw,
                                              **kw)
                torch.cuda.synchronize()
                tag = f"{size[0]}x{size[1]} K={k} {form}"
                k3_check(tag, (key, plh), want)
                k3_rules_line(tag, flags, ruled, want)
                del key, plh, want, ruled


# operations of a window marched by csrc/rect_scan.cu, counted from the
# source as k2_ops counts (each +, -, *, /, sqrt, min, max, abs, compare,
# select, conversion one): the RK4 step 209, the two slopes times dx 2, the
# exit test 15, the hull test 19
K3_WINDOW = 209 + 2 + 15 + 19


def k3_ops(windows: int, skipped: int, exits: int, retests: int, max_hits: int) -> int:
    """Operations of csrc/rect_scan.cu on the sphere with the Chebyshev
    l(h), for ``windows`` marched of which the hull cleared ``skipped``,
    ``exits`` exit tests that fired (15 each) and ``retests`` re-tests at
    K = 1. A window marched: K3_WINDOW; at K = 1 the quadrature of dP/dx 31
    (four path speeds of 6, the combine 7) and, unless skipped, the window
    test 216 (17 Hermite samples of 7, 17 terrain differences, 16 death and
    16 NaN tests, 16 products with 2 tests each); at K > 1 the samples and
    chords 343 (17 samples 119, 16 chords of 10, 16 double-precision adds
    with their conversions 64) and, unless skipped, the rest of the exact
    test 109 (17 differences, 16 products and 3 tests each 64, 16 death
    tests, the key and path length 12). The exact test of a window 452, once
    a hit at K = 1. With ``skipped`` and ``exits`` 0 and no K3_WINDOW rule
    tests, the count of the kernel before its rules."""
    tested = windows - skipped
    if max_hits == 1:
        return windows * (K3_WINDOW + 31) + tested * 216 + exits * 15 + retests * 452
    return windows * (K3_WINDOW + 343) + tested * 109 + exits * 15


def k3_bound(elev_hw, terr_pad, coarse: int, max_hits: int, flags, skipped: int,
             exits: int):
    """K3's bound on this run's data: v0, the terrain rows, tmax and smax
    read once, keys and path lengths written once, the Hermite basis; the
    operations of ``k3_ops`` for the windows each pixel marched (``flags``),
    ``skipped`` of them without their test, and ``exits``."""
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    h_n, w_n = elev_hw.shape
    n_coarse = (terr_pad.shape[1] - 1) // coarse
    windows = int((flags >> rect.SCAN_WINDOWS_SHIFT).sum())
    hits = int(((flags >> 1) & 0xFF).sum())
    n_bytes = 4 * (h_n * w_n + terr_pad.numel() + 2 * n_coarse * w_n
                   + 2 * h_n * w_n * max_hits + 4 * (coarse + 1))
    n_ops = k3_ops(windows, skipped, exits, hits if max_hits == 1 else 0, max_hits)
    return (*bound(n_bytes, n_ops), n_bytes, n_ops, windows)


def k3_launch_profile(flags, launches, kernel_ms):
    """What each of K3's launches had to do, from ``flags`` (a pixel marches
    windows 0 .. its count - 1): live pixels, live warps (32 adjacent
    columns of one row with any live pixel), pixel-windows, and the
    launch's kernel time from the profiler (``kernel_ms``, in launch order).
    Prints a line a launch; returns the rows."""
    import torch

    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    windows = (flags >> rect.SCAN_WINDOWS_SHIFT).reshape(-1)
    pad = (-windows.numel()) % 32
    warp_max = torch.nn.functional.pad(windows, (0, pad)).reshape(-1, 32).amax(-1)
    rows = []
    for i, (w0, w1) in enumerate(launches):
        live = int((windows > w0).sum())
        warps = int((warp_max > w0).sum())
        work = int((windows - w0).clamp(0, w1 - w0).sum())
        warp_work = int((warp_max - w0).clamp(0, w1 - w0).sum()) * 32
        ms = kernel_ms[i] if i < len(kernel_ms) else float("nan")
        rows.append(dict(w0=w0, w1=w1, live=live, warps=warps, pixel_windows=work,
                         warp_windows=warp_work, ms=ms))
        say(f"[rectilinear] K3 launch {i:2d} windows [{w0:3d}, {w1:3d}): live pixels "
            f"{live}, live warps {warps}, pixel-windows {work}, warp-windows {warp_work} "
            f"(lanes x the warp's longest), kernel {ms:.4f} ms")
    return rows


def golden_config(scene: str) -> dict:
    """The golden Fast scenes of the JAX package's tests/test_golden.py."""
    cfg = {
        "scene": {"terrain_folder": "."},
        "view": {
            "position": {"latitude": LAT0, "longitude": LON0,
                         "altitude": {"Relative": 30.0}},
            "frame": {"direction": 45.0, "fov": 25.0, "max_distance": 25000.0,
                      "tilt": 0.0},
            "coloring": {"Shading": {"water_level": -100.0}},
        },
        "straight_rays": False,
        "simulation_step": 100.0,
        "output": {"width": 64, "height": 48},
    }
    if scene == "translucent":
        cfg["scene"]["terrain_alpha"] = 0.65
        cfg["view"]["fog_distance"] = 15000.0
    elif scene == "flat_straight":
        cfg["earth_shape"] = "FlatDistorted"
        cfg["straight_rays"] = True
        cfg["view"]["coloring"] = {"Simple": {"water_level": -100.0}}
    elif scene == "objects":
        cfg["view"]["frame"].update(direction=0.0, fov=30.0, max_distance=8000.0)
        cfg["simulation_step"] = 50.0
        cfg["scene"]["objects"] = [
            golden_object(700.0, -4.0, {"Cylinder": {"radius": 25.0, "height": 200.0}},
                          {"r": 0.1, "g": 0.2, "b": 0.9, "a": 0.6}),
            golden_object(1200.0, 3.0, {"Cylinder": {"radius": 30.0, "height": 150.0}},
                          {"r": 0.9, "g": 0.1, "b": 0.1}),
            golden_object(2000.0, -1.0, {"Cone": {"radius": 40.0, "height": 120.0}},
                          {"r": 0.1, "g": 0.8, "b": 0.2}),
        ]
    return cfg


def golden_object(dist_m, az_deg, shape, color):
    """An object of the objects golden scene, ``dist_m`` out at ``az_deg``."""
    m_per_deg = 111_194.9  # spherical meters per degree of latitude
    az = math.radians(az_deg)
    return {
        "position": {
            "latitude": LAT0 + dist_m * math.cos(az) / m_per_deg,
            "longitude": LON0 + dist_m * math.sin(az) / m_per_deg
            / math.cos(math.radians(LAT0)),
            "altitude": {"Relative": 0.0},
        },
        "color": color,
        "shape": shape,
    }


def rect_golden_configs():
    """(name, config) of the golden Rectilinear scenes and of the golden
    scene tilted onto the culled and the pixelwise Rectilinear paths."""
    cases = [(f"rectilinear_{s}", golden_config(s))
             for s in ("plain", "translucent", "flat_straight")]
    for name, scene, tilt in (("rectilinear culled, tilt 1", "plain", 1.0),
                              ("rectilinear pixelwise, tilt -1", "translucent", -1.0)):
        cfg = golden_config(scene)
        cfg["view"]["frame"]["tilt"] = tilt
        cases.append((name, cfg))
    return cases


# the launches of one Fast or Interpolating frame (or a sweep): K1 and K2 once;
# a frame with objects also K6 once
FAST_LAUNCHES = {"combine.cu": 1, "march.cu": 1, "rect_scan.cu": 0, "rect_culled.cu": 0,
                 "object_pass.cu": 0, "rect_exact.cu": 0}
OBJECT_LAUNCHES = {**FAST_LAUNCHES, "object_pass.cu": 1}


def kernel_launches():
    from atm_raytracer_tpu_torch import _kernels

    return {k.source: k.launches for k in _kernels.KERNELS}


def reset_launches():
    from atm_raytracer_tpu_torch import _kernels

    for k in _kernels.KERNELS:
        k.launches = 0


def phase_goldens(dev):
    import torch

    from atm_raytracer_tpu_torch.config import Config
    from atm_raytracer_tpu_torch.generators.fast import render_fast
    from atm_raytracer_tpu_torch.generators.interpolating import render_interpolating
    from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear
    from atm_raytracer_tpu_torch.terrain.store import Terrain, Tile

    terrain = Terrain()
    terrain.add_tile(Tile(49, 21, tile_grid(49, 21, 181).astype("float32")))
    for scene in ("plain", "translucent", "flat_straight"):
        params = Config.from_dict(golden_config(scene)).into_params(terrain)
        gpu = render_fast(params, terrain, dev).image
        cpu = render_fast(params, terrain, "cpu").image
        ok, fa, fb, mx = image_tolerance(gpu, cpu)
        check(ok, f"golden fast_{scene}: any={fa:.4f} big={fb:.4f} out of tolerance")
        say(f"[goldens] fast_{scene}: cuda vs cpu plain any={fa:.4f} "
            f"big={fb:.4f} max={mx}")
    for scene in ("plain", "translucent", "flat_straight"):
        cfg = golden_config(scene)
        cfg["output"]["generator"] = "InterpolatingRectilinear"
        params = Config.from_dict(cfg).into_params(terrain)
        reset_launches()
        gpu = render_interpolating(params, terrain, dev)
        torch.cuda.synchronize()
        launches = kernel_launches()
        # straight rays need no march: K2 serves the refracted scenes
        check(launches["combine.cu"] > 0 and (launches["march.cu"] > 0) != params.straight_rays,
              f"golden interpolatingrectilinear_{scene}: launches {launches}")
        cpu = render_interpolating(params, terrain, "cpu")
        ok, fa, fb, mx = image_tolerance(gpu.image, cpu.image)
        check(ok, f"golden interpolatingrectilinear_{scene}: any={fa:.4f} big={fb:.4f} "
              "out of tolerance")
        say(f"[goldens] interpolatingrectilinear_{scene}: cuda vs cpu plain any={fa:.4f} "
            f"big={fb:.4f} max={mx} (launches {launches})")
    for name, cfg in rect_golden_configs():
        params = Config.from_dict(cfg).into_params(terrain)
        reset_launches()
        gpu = render_rectilinear(params, terrain, dev)
        torch.cuda.synchronize()
        launches = kernel_launches()
        cpu = render_rectilinear(params, terrain, "cpu")
        ok, fa, fb, mx = image_tolerance(gpu.image, cpu.image)
        check(ok, f"golden {name}: any={fa:.4f} big={fb:.4f} out of tolerance")
        if "pixelwise" in name:
            check(launches["march.cu"] > 0, f"{name}: the march did not go through K2")
        if params.view.frame.tilt == 0.0:
            want = k3_launches(params)
            check(launches["rect_scan.cu"] == want,
                  f"{name}: {launches['rect_scan.cu']} K3 launches, not {want}")
        want = gpu.culled_rounds if "culled" in name else 0
        check(launches["rect_culled.cu"] == want and (want > 0) == ("culled" in name),
              f"{name}: {launches['rect_culled.cu']} K4 launches, not one a round ({want})")
        check(launches["rect_exact.cu"] == want,
              f"{name}: {launches['rect_exact.cu']} K5 launches, not one a round ({want})")
        say(f"[goldens] {name}: cuda vs cpu plain any={fa:.4f} big={fb:.4f} "
            f"max={mx} (culled rounds {gpu.culled_rounds}, launches {launches})")
    renders = {"Fast": render_fast, "Rectilinear": render_rectilinear,
               "InterpolatingRectilinear": render_interpolating}
    for generator, render in renders.items():
        cfg = golden_config("objects")
        cfg["output"]["generator"] = generator
        params = Config.from_dict(cfg).into_params(terrain)
        reset_launches()
        gpu = render(params, terrain, dev)
        torch.cuda.synchronize()
        launches = kernel_launches()
        if generator == "Rectilinear":
            check(launches["march.cu"] > 0, f"{generator} objects: no K2 launch")
        else:
            check(launches == OBJECT_LAUNCHES,
                  f"{generator} objects: launches {launches}")
        cpu = render(params, terrain, "cpu")
        ok, fa, fb, mx = image_tolerance(gpu.image, cpu.image)
        check(ok, f"golden {generator.lower()}_objects: any={fa:.4f} big={fb:.4f} "
              "out of tolerance")
        flips = int((gpu.hits.valid.cpu() != cpu.hits.valid).sum())
        n_obj = int((gpu.hits.valid & (gpu.hits.kind == 1)).sum())
        check(n_obj > 0, f"golden {generator.lower()}_objects: no object hit on the card")
        say(f"[goldens] {generator.lower()}_objects: cuda vs cpu plain any={fa:.4f} "
            f"big={fb:.4f} max={mx}; valid slots flipped {flips} of "
            f"{gpu.hits.valid.numel()}; object hits {n_obj} (cpu "
            f"{int((cpu.hits.valid & (cpu.hits.kind == 1)).sum())}); launches {launches}")


def headline_terrain(params):
    """45 synthetic 1201-post tiles covering the headline's terrain box."""
    from atm_raytracer_tpu_torch.generators.fast import terrain_bbox
    from atm_raytracer_tpu_torch.terrain.store import Terrain, Tile

    (la0, la1), (lo0, lo1) = terrain_bbox(params)
    terrain = Terrain()
    for la in range(math.floor(la0), math.floor(la1) + 1):
        for lo in range(math.floor(lo0), math.floor(lo1) + 1):
            terrain.add_tile(Tile(la, lo, tile_grid(la, lo, 1201).astype("float32")))
    return terrain


def headline_dict(width=1920, height=1080, max_distance=200_000.0, step=50.0,
                  tilt=0.0, fov=40.0) -> dict:
    return {
        "view": {
            "position": {"latitude": LAT0, "longitude": LON0,
                         "altitude": {"Relative": 100.0}},
            "frame": {"direction": 45.0, "fov": fov, "max_distance": max_distance,
                      "tilt": tilt},
        },
        "simulation_step": step,
        "output": {"width": width, "height": height},
    }


def headline_config(width=1920, height=1080, max_distance=200_000.0, step=50.0,
                    tilt=0.0, fov=40.0):
    from atm_raytracer_tpu_torch.config import Config

    return Config.from_dict(headline_dict(width, height, max_distance, step, tilt, fov))


def headline_params(width=1920, height=1080, max_distance=200_000.0, step=50.0,
                    tilt=0.0):
    return headline_config(width, height, max_distance, step, tilt).into_params(None)


def headline_inputs(params, terrain, dev):
    """The render's device inputs, as ``render_fast`` builds them: positional
    and keyword arguments of ``fast.fast_core``."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import fast

    out, frame, pos = params.output, params.view.frame, params.view.position
    alt0 = float(pos.abs_altitude(terrain))
    elev = fast.camera.fast_ray_elevations(out.width, out.height, frame.fov, frame.tilt)
    az = fast.camera.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)
    args = (
        terrain.pack(*fast.terrain_bbox(params), dev),
        fast.build_refraction_table(params, alt0, dev),
        torch.from_numpy(elev.astype(np.float32)).to(dev),
        torch.from_numpy(az.astype(np.float32)).to(dev),
        alt0,
    )
    kwargs = dict(
        model=params.model, shape=params.model.to_shape(),
        straight=params.straight_rays, step=float(params.simulation_step),
        n_terr=int(math.ceil(frame.max_distance / params.simulation_step)),
        max_hits=1, lat0=float(pos.latitude), lon0=float(pos.longitude),
        coloring=params.coloring, fog_distance=params.view.fog_distance,
        terrain_alpha=float(params.terrain_alpha),
    )
    return args, kwargs


def k1_work(segs, limit, env, n_seg):
    """K1's work at K = 1, counted from its output and its envelopes.

    A pixel's scan needs min(first segment + 1, limit) sign tests (T_need);
    in chunk c it runs clip(need - c·CHUNK, 0, CHUNK) of them. A block
    streams chunk c while one of its pixels still needs a test there; with
    the cull it stages only the live ones. Lane slots count a warp (one ray
    row, 32 columns) as long as its longest lane.
    """
    import torch

    from atm_raytracer_tpu_torch.ops import combine as C

    h_n, w_n = segs.shape[:2]
    th, tw, ch = C.TILE_H, C.TILE_W, C.CHUNK
    n_rt, n_tt, n_c = -(-h_n // th), -(-w_n // tw), -(-n_seg // ch)
    need = torch.zeros((n_rt * th, n_tt * tw), dtype=torch.int32, device=segs.device)
    need[:h_n, :w_n] = torch.minimum(segs[..., 0] + 1, limit.clamp(max=n_seg)[:, None])
    k0 = torch.arange(n_c, dtype=torch.int32, device=segs.device) * ch
    tests = (need[..., None] - k0).clamp(0, ch).reshape(n_rt, th, n_tt, tw, n_c)
    block_tests = tests.sum(dim=(1, 3))  # [n_rt, n_tt, n_c]
    lane_slots = tests.amax(dim=3).sum(dim=1) * tw
    streamed = block_tests > 0
    ray_lo, ray_hi, terr_lo, terr_hi = env
    culled = (ray_lo[:, None] > terr_hi[None]) | (ray_hi[:, None] < terr_lo[None])
    live = streamed & ~culled
    hh, ww = torch.nonzero(segs[..., 0] < n_seg, as_tuple=True)
    return {
        "t_need": int(need.long().sum()), "chunks": n_rt * n_tt * n_c,
        "streamed_uncull": int(streamed.sum()), "live": int(live.sum()),
        "tests": int(block_tests[live].sum()),
        "lane_slots_uncull": int(lane_slots[streamed].sum()),
        "lane_slots": int(lane_slots[live].sum()),
        # exactness: no pixel's first crossing lies in a culled chunk
        "hits_in_culled": int(culled[hh // th, ww // tw, segs[hh, ww, 0].long() // ch].sum()),
    }


def k1_kernels_ms(ray_h, terr, n_seg, reps=20):
    """Device ms of K1's envelope and segment kernels, means of ``reps``
    K = 1 calls, from a torch.profiler trace."""
    from atm_raytracer_tpu_torch.ops import combine

    _, _, by_name = trace_busy_ms(lambda: [combine.crossing_segments_cuda(
        ray_h, terr, n_seg, 1) for _ in range(reps)], "k1")
    env = sum(v for k, v in by_name.items() if "chunk_envelopes" in k) / reps
    seg = sum(v for k, v in by_name.items() if "crossing_segments_kernel" in k) / reps
    check(env > 0 and seg > 0, f"K1's kernels missing from the trace: {list(by_name)}")
    return env, seg


def bound(n_bytes: float, n_ops: float):
    """(ms, what bounds it): the larger of the bytes over the H100's HBM
    rate and the float32 operations over its peak float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_bound(h_n: int, w_n: int, n_seg: int, tests: int, frames: int = 1):
    """K1's bound at K = 1 over ``frames`` frames of [h_n, w_n]: each ray
    and terrain sample read once, the segments and the death limits written
    or read once; the sign tests run (3 operations each) and the envelopes'
    min and max."""
    n_bytes = 4 * frames * ((h_n + w_n) * (n_seg + 1) + h_n * w_n + h_n)
    n_ops = 3 * tests + 2 * frames * (h_n + w_n) * (n_seg + 1)
    return (*bound(n_bytes, n_ops), n_bytes, n_ops)


def k2_bound(n_rays: int, n: int, coarse: int, table):
    """K2's bound for ``n_rays`` rays of ``n`` steps: the altitudes and
    slopes in, the fit rows (or the tables, every frame's) and the Hermite
    basis, the [B, N+1] h and p out; the operations of ``k2_ops``."""
    n_coarse = -(-n // coarse)
    l_floats = 10 * len(table.poly) if table.poly is not None else table.pairs.numel()
    n_bytes = 4 * (2 * n_rays + l_floats + 4 * (coarse + 1) + 2 * n_rays * (n + 1))
    n_ops = k2_ops(n_rays, n_coarse, n + 1, poly=table.poly is not None)
    return (*bound(n_bytes, n_ops), n_bytes, n_ops)


def k2_ops(n_rays: int, n_coarse: int, n_samples: int, poly: bool = True) -> int:
    """Operations of csrc/march.cu on the sphere, counted from the source
    (each +, -, *, /, sqrt, min, max, compare, select, conversion one). A
    step: three eval_l, of 45 with the Chebyshev l(h) (clamp 2, the search
    over the register lows 7 compares + 7 adds, t 6, Clenshaw 1 + 6 x 3, last
    3, the NaN select 1) or 13 with the table (t 2, clamp 2, floor 1,
    conversion 1, min 1, the fraction 2, the lerp 4); four accel of 11, 4 for
    the stage heights of l2 and l4, 12 for the stage slopes and heights, 14
    for the update of h and v: 209 (table: 113). A fine sample: the Hermite
    7, the chord 10, its add to the prefix sum 1: 18."""
    return n_rays * (n_coarse * (209 if poly else 113) + n_samples * 18)


# The critical path of one K2 step (sphere, Chebyshev l(h) with <= 8
# segments), counted from csrc/march.cu, from v to the next step's v: the
# stage height of l2 (2); eval_l: the clamp (2), the sign-bit search and its
# sum (6), the row address (2), a shared load, h - lo (1), the division's
# residual corrections with the segment's precomputed reciprocal (5), t
# (4), Clenshaw (1 + 6 x 3 + 3), the NaN select (1); k2v = l2 x A + G (2),
# k3h (2), k3v from k3h (2 v, x v, + u^2, the correction tail 5, x 1/R, +:
# 10; recip(u) hangs off the path), k4h (2), k4v (10), the v update (3):
# 74 dependent integer or float32 operations, each taken at the measured
# float32 add latency, and one shared load. (The l1 path through k2h is
# shorter.)
K2_CHAIN_STEP = {"fadd": 74, "lds_chase": 1}


def k2_chain_floor_cycles(latency: dict) -> float:
    """Cycles of one step's critical path, from measured latencies."""
    return sum(n * latency[op] for op, n in K2_CHAIN_STEP.items())


def k2_clocks(dev, alt, v0, dx, n_coarse, table, radius, fine=None):
    """A clocked K2 launch, the fused one with ``fine``, else the nodes
    alone: (cycles a step of CTA 0 by clock64(), ms by CUDA events, the
    CTAs' span start to end by %globaltimer in ms, CTA 0's own in ms, the
    latest CTA start in ms after the first)."""
    import torch

    from atm_raytracer_tpu_torch.physics import ray as R

    r = R.default_rays_per_cta(alt.shape[0], dev)
    n_cta = -(-alt.shape[0] // r)
    clocks = torch.zeros(n_coarse + 1 + 2 * n_cta, dtype=torch.int64, device=dev)
    ms = cuda_ms(lambda: R.march_cuda(alt, v0, dx, n_coarse, table, radius, fine=fine,
                                      nodes=fine is None, clocks=clocks), 10)
    c = clocks.cpu()
    cta = c[n_coarse + 1:].reshape(n_cta, 2).double() / 1e6
    return (float(c[n_coarse] - c[0]) / n_coarse, ms, float(cta[:, 1].max() - cta[:, 0].min()),
            float(cta[0, 1] - cta[0, 0]), float(cta[:, 0].max() - cta[:, 0].min()))


def k2_rows_check(table, elev_deg, alt0, shape, step, n_terr, tag, rays_per_frame=None):
    """K2's contract on the main path's call (``march_rows``) at its own
    shapes: the launch's nodes within K2_ATOL of ``march_nodes_plain``, its
    fine h ``torch.equal`` to the PyTorch Hermite fill of its own nodes, its
    p within rtol 1e-6 / atol 1e-3 m of ``_finish_march``'s, and its h
    within K2_ATOL of the plain ``march_rows``. ``alt0`` is a scalar or one
    altitude a ray; a stacked ``table`` (a sweep's) is read with
    ``rays_per_frame``. Returns (march_rows' h, the march inputs, max |dh|
    and |dp| vs plain, max node |dh|, p ulp)."""
    import torch

    from atm_raytracer_tpu_torch.generators import fast
    from atm_raytracer_tpu_torch.physics import ray as R

    radius = shape.radius
    n = n_terr - 1
    coarse = R.march_coarse(step)
    n_coarse = -(-n // coarse)
    dx = R._f32(step * coarse)
    alt = alt0 if isinstance(alt0, torch.Tensor) else torch.full_like(elev_deg, alt0)
    v0 = R.initial_slope(alt, torch.deg2rad(elev_deg), shape)
    fine = (step, coarse, n)
    rows_kw = dict(shape=shape, straight=False, step=step, n_terr=n_terr,
                   rays_per_frame=rays_per_frame)
    h, p = fast.march_rows(table, elev_deg, alt0, **rows_kw)
    hp, pp = fast.march_rows(table, elev_deg, alt0, plain=True, **rows_kw)
    _, _, nh, nv = R.march_cuda(alt, v0, dx, n_coarse, table, radius, fine=fine,
                                rays_per_frame=rays_per_frame)
    nh_p, _ = R.march_nodes_plain(alt, v0, dx, n_coarse, table, radius, rays_per_frame)
    h_t, p_t = R._finish_march(R.hermite_fill(nh, nv, dx, coarse, n), step, radius)
    torch.cuda.synchronize()
    node_err = float((nh - nh_p).abs().max())
    check(node_err <= K2_ATOL, f"K2 {tag}: nodes {node_err} m from plain")
    check(torch.equal(h, h_t), f"K2 {tag}: h differs from the Hermite fill of its nodes")
    p_ulp = ulp_diff(p, p_t)
    check(torch.allclose(p, p_t, rtol=1e-6, atol=1e-3), f"K2 {tag}: p off by {p_ulp} ulp")
    err = float((h - hp).abs().max())
    check(err <= K2_ATOL, f"K2 {tag}: h {err} m from the plain path")
    p_err = float((p - pp).abs().max())
    return h, (alt, v0, dx, n_coarse, coarse, fine), err, p_err, node_err, p_ulp


def k2_headline(dev, table, elev_deg, alt0, shape, step, n_terr):
    """K2 at the Fast headline: the main path's call (``march_rows``) by CUDA
    events, the kernel alone by the profiler, the plain version, the cycles
    a step from clock64(), the rays-per-CTA sweep, the p ulp difference
    against the PyTorch fill, and the bytes bound and the chain floor."""
    import torch

    from atm_raytracer_tpu_torch.generators import fast
    from atm_raytracer_tpu_torch.physics import ray as R

    sys.path.insert(0, str(ROOT / "scripts"))
    import k2_clock_probe

    radius = shape.radius
    n = n_terr - 1
    b = elev_deg.shape[0]

    def rows(plain=False):
        return fast.march_rows(table, elev_deg, alt0, shape=shape, straight=False,
                               step=step, n_terr=n_terr, plain=plain)

    _, (alt, v0, dx, n_coarse, coarse, fine), err, p_err, node_err, p_ulp = k2_rows_check(
        table, elev_deg, alt0, shape, step, n_terr, "headline")

    ms = cuda_ms(rows, 20)
    plain_ms = cuda_ms(lambda: rows(plain=True), 2)
    _, _, by_name = trace_busy_ms(lambda: [rows() for _ in range(20)], "k2")
    device_ms = sum(v for k, v in by_name.items() if "march_kernel" in k) / 20
    check(device_ms > 0, f"K2's kernel missing from the trace: {list(by_name)}")
    others = {k[:60]: round(v / 20, 5) for k, v in by_name.items() if "march_kernel" not in k}

    cyc_fused, clocked_ms, span_ms, cta0_ms, late_ms = k2_clocks(
        dev, alt, v0, dx, n_coarse, table, radius, fine)
    cyc_chain, chain_ms, chain_span_ms, _, _ = k2_clocks(dev, alt, v0, dx, n_coarse, table,
                                                          radius)
    ghz = cyc_fused * n_coarse / (cta0_ms * 1e6)  # CTA 0's cycles over its own time
    lat = k2_clock_probe.measure_latencies(dev)
    floor_cycles = k2_chain_floor_cycles(lat)
    chain_floor_ms = n_coarse * floor_cycles / (ghz * 1e6)

    sweep = {}
    for n_rays, n_s, c in ((b, n, coarse), (64 * 1920, n, coarse), (21, 200, 1)):
        e = torch.deg2rad(torch.linspace(-0.6, 1.5, n_rays, device=dev))
        a = torch.full_like(e, alt0)
        vv = R.initial_slope(a, e, shape)
        nc = -(-n_s // c)
        for r in (4, 8, 16, 32):
            sweep[f"B={n_rays} R={r}"] = cuda_ms(lambda: R.march_cuda(
                a, vv, R._f32(step * c), nc, table, radius, fine=(step, c, n_s),
                nodes=False, rays_per_cta=r), 5 if n_rays > 10_000 else 20)
        sweep[f"B={n_rays} auto R={R.default_rays_per_cta(n_rays, dev)}"] = cuda_ms(lambda: R.march_rays(
            a, e, step, n_s, shape, table, False, coarse=c), 5 if n_rays > 10_000 else 20)

    bound_ms, bound_by, n_bytes, n_ops = k2_bound(b, n, coarse, table)
    say(f"[headline] K2 (march_rows: one launch) {ms:.4f} ms by CUDA events, kernel alone "
        f"{device_ms:.4f} ms (profiler, mean of 20); plain {plain_ms:.3f} ms; {b} rays x "
        f"{n_coarse} steps x {n + 1} samples; max |dh| vs plain {err:.3g} m (nodes "
        f"{node_err:.3g} m), max |dp| {p_err:.3g} m; the march's other device records a "
        f"call (ms): {others}")
    say(f"[headline] K2 p vs the PyTorch path length of its own h: {p_ulp:.1f} ulp at most")
    say(f"[headline] K2 cycles a step (clock64, CTA 0): fused {cyc_fused:.1f}, nodes only "
        f"{cyc_chain:.1f} (launches {clocked_ms:.4f} / {chain_ms:.4f} ms by CUDA events; "
        f"CTAs start to end {span_ms:.4f} / {chain_span_ms:.4f} ms by %globaltimer, CTA 0 "
        f"{cta0_ms:.4f} ms at {ghz:.3f} GHz, the last CTA started {late_ms:.4f} ms after "
        f"the first); "
        f"latencies (cycles) {json.dumps({k: round(v, 2) for k, v in lat.items()})}; "
        f"critical path {K2_CHAIN_STEP} = {floor_cycles:.1f} cycles a step")
    say(f"[headline] K2 bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} B, {n_ops} "
        f"operations): {100.0 * bound_ms / ms:.2f} % of the bound; chain floor "
        f"{chain_floor_ms:.4f} ms ({n_coarse} x {floor_cycles:.1f} cycles at {ghz:.3f} "
        f"GHz): {100.0 * chain_floor_ms / ms:.1f} % of it")
    say(f"[headline] K2 rays-per-CTA sweep (ms, CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sweep.items()))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "chain_floor_ms": chain_floor_ms, "device_ms": device_ms,
            "cycles_per_step": cyc_fused, "p_ulp": p_ulp}


def fast_walls(dev, params, terrain, renders: int) -> float:
    """Median Fast frame wall (s) of ``renders`` renders, each ending in a
    synchronize; the caller has warmed up."""
    import torch

    from atm_raytracer_tpu_torch.generators.fast import render_fast

    walls = []
    for _ in range(renders):
        t0 = time.perf_counter()
        render_fast(params, terrain, dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    q1, med, q3 = statistics.quantiles(walls, n=4)
    say(f"[headline] frame wall over {renders} renders after the warm-up: "
        f"median {med * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, q1 {q1 * 1e3:.3f}, "
        f"q3 {q3 * 1e3:.3f}, max {max(walls) * 1e3:.3f})")
    return med


def phase_headline(dev, params, terrain, renders=20):
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import fast
    from atm_raytracer_tpu_torch.ops import combine
    from atm_raytracer_tpu_torch.physics import ray as R

    out = params.output
    # the main path, counted; this first render is also the warm-up
    reset_launches()
    result = fast.render_fast(params, terrain, dev)
    torch.cuda.synchronize()
    launches = kernel_launches()
    say(f"[headline] launches in one render: {launches}")
    check(launches == FAST_LAUNCHES, f"headline render: launches {launches}, not "
          f"{FAST_LAUNCHES}")

    image = result.image
    hits = result.hits
    check(image.shape == (out.height, out.width, 3), f"image shape {image.shape}")
    valid = hits.valid.cpu().numpy()
    keys = hits.key.cpu().numpy()
    frac_hit = float(valid.mean())
    check(np.isfinite(keys[valid]).all(), "non-finite key on a valid hit")
    check(0.05 < frac_hit < 0.95, f"implausible hit fraction {frac_hit}")
    (args, kw) = headline_inputs(params, terrain, dev)
    n_terr, step = kw["n_terr"], kw["step"]
    check(bool((keys[valid] < n_terr).all()), "hit key past the march")
    say(f"[headline] image {image.shape}, hit fraction {frac_hit:.4f}")

    med = fast_walls(dev, params, terrain, renders)

    # the plain path on the card: same pipeline, plain march + plain combine;
    # a pixel's segment is floor(key) where it holds a hit
    plain = fast.render_fast(params, terrain, dev, plain=True)
    ok, fa, fb, mx = image_tolerance(image, plain.image)
    check(ok, f"headline kernel vs plain image out of tolerance: any={fa} big={fb}")
    say(f"[headline] kernel vs plain image: any={fa:.5f} big={fb:.5f} max={mx}")
    p_valid = plain.hits.valid
    check(torch.equal(hits.valid, p_valid), "kernel path vs plain path: hit masks differ")
    seg_bad = int((torch.floor(hits.key) != torch.floor(plain.hits.key))[p_valid].sum())
    check(seg_bad == 0, f"kernel path vs plain path: {seg_bad} segments differ")
    say(f"[headline] segments: kernel path == plain path ({p_valid.numel()} pixels)")

    # each kernel on the headline's own inputs, against its plain version
    pack, table, elev, az, alt0 = args
    shape = kw["shape"]
    ray_h, _ = fast.march_rows(table, elev, alt0, shape=shape, straight=False,
                               step=step, n_terr=n_terr)
    terr, _ = fast.terrain_columns(pack, params.model, az, LAT0, LON0, step, n_terr)
    n_seg = n_terr - 1
    segs_k, env_k = combine.crossing_segments_envelopes_cuda(ray_h, terr, n_seg, 1)
    segs_p = combine.terrain_crossing_segments_plain(ray_h, terr, n_seg, 1)
    env_p = combine.crossing_envelopes_plain(ray_h, terr, n_seg)
    k1_bad = int((segs_k != segs_p).sum())
    check(k1_bad == 0, f"K1 vs plain on the headline inputs: {k1_bad} differ")
    check(all(torch.equal(a, b) for a, b in zip(env_k, env_p)),
          "K1's envelopes vs crossing_envelopes_plain on the headline inputs differ")
    k1_err = float((segs_k.long() - segs_p.long()).abs().max())
    limit = combine.ray_death_limit(ray_h, n_seg)
    work = k1_work(segs_p, limit, env_p, n_seg)
    check(work["hits_in_culled"] == 0, f"{work['hits_in_culled']} hits in culled chunks")
    say(f"[headline] K1 work: T_need {work['t_need']} sign tests (per-pixel early "
        f"exit); block-chunks {work['chunks']}, streamed without the cull "
        f"{work['streamed_uncull']}, live {work['live']} "
        f"({100.0 * work['live'] / work['streamed_uncull']:.2f} %); tests in live "
        f"chunks {work['tests']} ({work['t_need'] / max(work['tests'], 1):.1f}x fewer); "
        f"lane slots {work['lane_slots']} (without the cull {work['lane_slots_uncull']})")
    k1_bound_ms, k1_bound_by, k1_bytes, k1_ops = k1_bound(
        ray_h.shape[0], terr.shape[0], n_seg, work["tests"])

    k2 = k2_headline(dev, table, elev, alt0, shape, step, n_terr)

    k1_ms = cuda_ms(lambda: combine.crossing_segments_cuda(ray_h, terr, n_seg, 1), 20)
    k1_plain_ms = cuda_ms(
        lambda: combine.terrain_crossing_segments_plain(ray_h, terr, n_seg, 1), 2)
    # the two kernels' own device time, without the wrapper's death limit;
    # with the rays lifted above all terrain every chunk is culled, which
    # leaves the cost of walking the grid
    k1_env_ms, k1_seg_ms = k1_kernels_ms(ray_h, terr, n_seg)
    sky_env_ms, sky_seg_ms = k1_kernels_ms(ray_h + 1e5, terr, n_seg)
    say(f"[headline] K1 kernels alone (profiler, mean of 20): envelopes {k1_env_ms:.4f} ms "
        f"+ segments {k1_seg_ms:.4f} ms; the wrapper by CUDA events {k1_ms:.4f} ms; "
        f"segments with every chunk culled (rays +1e5 m) {sky_seg_ms:.4f} ms")
    say(f"[headline] K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.3f} ms "
        f"([{out.height}, {out.width}] x {n_seg} segments); bound {k1_bound_ms:.4f} ms "
        f"by {k1_bound_by} ({k1_bytes} B, {k1_ops} float32 operations): "
        f"{100.0 * k1_bound_ms / k1_ms:.1f} % of the bound")
    kernels = [
        {"name": "K1 crossing_segments", "route": "cuda",
         "source": "atm_raytracer_tpu_torch/csrc/combine.cu",
         "replaces": "atm_raytracer_tpu/experimental/combine_pallas.py:89",
         "launches": launches["combine.cu"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": None, "tests": work["tests"],
         "device_ms": k1_env_ms + k1_seg_ms},
        {"name": "K2 march_rays", "route": "cuda",
         "source": "atm_raytracer_tpu_torch/csrc/march.cu",
         "replaces": "atm_raytracer_tpu/experimental/march_pallas.py:18",
         "launches": launches["march.cu"], "library_ms": None, **k2},
    ]
    return kernels, med, launches


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# spin kernels that open every profiler trace, ahead of the records it keeps
TRACE_SPACER = 256


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(spans))


def merged(spans):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def phase_profile(dev, params, terrain, wall_s, renders=3, reps=10):
    """Where the headline frame's time goes.

    Device busy time is the union of the device intervals (kernels, copies,
    memsets) of a torch.profiler trace of ``renders`` renders, so overlapping
    or nested records cannot count twice; the idle share is one less the busy
    time over the median frame wall of the headline phase (unprofiled).
    Stage times are CUDA-event means of ``reps`` runs of each stage alone;
    shares are of the stages' own sum. The trace is kept in
    ``chiprun_out/headline_trace.json``.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atm_raytracer_tpu_torch.generators import fast
    from atm_raytracer_tpu_torch.generators.base import fetch_flat
    from atm_raytracer_tpu_torch.ops import combine

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace = out_dir / "headline_trace.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(renders):
            fast.render_fast(params, terrain, dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    check(bool(events), "the profiler recorded no device activity")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
    busy_ms = busy_us(spans) / 1e3 / renders
    sum_ms = sum(e - s for s, e in spans) / 1e3 / renders
    say(f"[profile] {renders} renders, {len(events)} device records: device busy "
        f"{busy_ms:.3f} ms a frame (sum of record durations {sum_ms:.3f} ms), "
        f"profiled wall {prof_wall * 1e3 / renders:.3f} ms a frame")
    say(f"[profile] idle share of the {wall_s * 1e3:.3f} ms median frame wall: "
        f"{1.0 - busy_ms / (wall_s * 1e3):.4f}")
    by_name: dict = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"[profile]   {us / 1e3 / renders:8.3f} ms a frame  {name[:90]}")

    args, kw = headline_inputs(params, terrain, dev)
    pack, table, elev, az, alt0 = args
    n_terr, step = kw["n_terr"], kw["step"]
    ray_h, _ = fast.march_rows(table, elev, alt0, shape=kw["shape"],
                               straight=False, step=step, n_terr=n_terr)
    terr, _ = fast.terrain_columns(pack, params.model, az, LAT0, LON0, step, n_terr)
    hit_kw = {k: v for k, v in kw.items() if k not in ("coloring", "fog_distance")}
    image, _ = fast.fast_core(*args, **kw)
    t = {
        "march (K2: nodes, Hermite fill, path lengths)": cuda_ms(lambda: fast.march_rows(
            table, elev, alt0, shape=kw["shape"], straight=False, step=step,
            n_terr=n_terr), reps),
        "terrain columns": cuda_ms(lambda: fast.terrain_columns(
            pack, params.model, az, LAT0, LON0, step, n_terr), reps),
        "combine (K1)": cuda_ms(lambda: combine.terrain_crossing_segments(
            ray_h, terr, n_terr - 1, 1), reps),
    }
    hits_ms = cuda_ms(lambda: fast.separable_hits(*args, **hit_kw), reps)
    core_ms = cuda_ms(lambda: fast.fast_core(*args, **kw), reps)
    t["gathers + per-hit geodesic (derived)"] = hits_ms - sum(t.values())
    t["composite (derived)"] = core_ms - hits_ms
    t["image to host (fetch_flat)"] = cuda_ms(lambda: fetch_flat(image), reps)
    total = sum(t.values())
    for name, ms in t.items():
        say(f"[profile] stage {name}: {ms:.3f} ms ({100.0 * ms / total:.1f} % of "
            f"the stages' {total:.3f} ms)")
    torch.cuda.reset_peak_memory_stats(dev)
    fast.render_fast(params, terrain, dev)
    say(f"[profile] peak device memory of one render: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")


def hits_agree(a, b):
    """(fraction of pixels whose first-slot validity differs, max |key
    difference| where both are valid) of two renders."""
    va, vb = a.hits.valid[..., 0].cpu(), b.hits.valid[..., 0].cpu()
    both = va & vb
    dk = (a.hits.key[..., 0].cpu() - b.hits.key[..., 0].cpu()).abs()[both]
    return float((va != vb).double().mean()), float(dk.max()) if dk.numel() else 0.0


def trace_busy_ms(fn, name: str):
    """Device busy time (union of the device records of a torch.profiler
    trace of one ``fn()``) in ms, the record count, and ms by record name.
    One Rectilinear frame through the plain scan is ~2·10^5 records."""
    events = trace_events(fn, name)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
    by_name: dict = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    return busy_us(spans) / 1e3, len(events), by_name


def trace_events(fn, name: str, tries: int = 3):
    """The device records (kernels, copies, memsets) of a torch.profiler
    trace of one ``fn()``; the trace file is parsed and deleted. On the card
    a trace loses a prefix of its device records: one more every few
    traces a process takes, and now and then a few hundred. So the trace
    opens with TRACE_SPACER spin kernels, whose
    records are dropped; a trace that kept none of them may have lost some
    of ``fn``'s, and is taken again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace = out_dir / f"{name}_trace.json"
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_SPACER):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        trace.unlink()
        spacer = sum("spin_kernel" in e["name"] for e in events)
        if spacer:
            break
        say(f"[profile] trace {name} (try {attempt + 1} of {tries}) kept none of its "
            f"{TRACE_SPACER} spacer records: taken again")
    check(spacer > 0, f"the profiler lost every spacer record of {tries} traces ({name})")
    events = [e for e in events if "spin_kernel" not in e["name"]]
    check(bool(events), f"the profiler recorded no device activity ({name})")
    return events


def enqueue_ms(fn, reps: int = 10) -> float:
    """Median host milliseconds ``fn()`` takes to return, the device idle
    before each run: what the host spends enqueueing it."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(walls)


def host_top_ops(fn, tag: str, n: int = 12):
    """The host side of one ``fn()``: a torch.profiler trace with CPU and CUDA
    activity, its ops by self CPU time (the top ``n``, with their calls) and
    the CPU time of the whole trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in rows) / 1e3
    say(f"[{tag}] host side of one profiled render: {total:.3f} ms of self CPU time in "
        f"{sum(e.count for e in rows)} op calls, {wall * 1e3:.3f} ms wall under the "
        f"profiler; the top {n} ops by self CPU time:")
    for e in rows[:n]:
        say(f"[{tag}]   {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:5d} calls  "
            f"{e.key[:80]}")


def phase_rect_small(dev, terrain):
    """(a) and the small half of (c): the 192x108 headline on the card
    against the CPU, and the culled path against the dense one."""
    import torch

    from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear

    params = headline_params(192, 108)
    t0 = time.perf_counter()
    gpu = render_rectilinear(params, terrain, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = render_rectilinear(params, terrain, "cpu")
    t2 = time.perf_counter()
    ok, fa, fb, mx = image_tolerance(gpu.image, cpu.image)
    check(ok, f"rectilinear 192x108 cuda vs cpu: any={fa} big={fb} out of tolerance")
    vdiff, dk = hits_agree(gpu, cpu)
    check(vdiff <= 0.01 and dk <= 1e-3,
          f"rectilinear 192x108 cuda vs cpu hits: valid differ {vdiff}, max dkey {dk}")
    say(f"[rectilinear] 192x108 tilt 0: cuda vs cpu any={fa:.5f} big={fb:.5f} "
        f"max={mx}; valid differ {vdiff:.5f}, max |dkey| {dk:.3g} "
        f"(card {t1 - t0:.2f} s with set-up, cpu {t2 - t1:.2f} s)")

    # the cull must drop no crossing: the same hits as the dense path. Keys
    # agree to the rounding of the pixel angles only, since the dense path
    # takes the host f64 angle grid and the culled path derives a float32
    # one on the card (as the JAX package does); the plain march keeps the
    # march kernel's own rounding out of the comparison
    params = headline_params(192, 108, tilt=1.0)
    culled = render_rectilinear(params, terrain, dev)
    dense = render_rectilinear(params, terrain, dev, cull=False, plain=True)
    torch.cuda.synchronize()
    same_valid = torch.equal(culled.hits.valid, dense.hits.valid)
    v = culled.hits.valid
    dk = (culled.hits.key[v] - dense.hits.key[v]).abs()
    dk_max = float(dk.max()) if dk.numel() else 0.0
    check(same_valid and dk_max <= 1e-3,
          f"rectilinear 192x108 tilt 1: culled vs dense masks equal {same_valid}, "
          f"max |dkey| {dk_max}")
    say(f"[rectilinear] 192x108 tilt 1: culled ({culled.culled_rounds} rounds) vs "
        f"dense (plain march): hit masks equal, max |dkey| {dk_max:.3g}, "
        f"{int((dk == 0).sum())} of {int(v.sum())} keys bitwise equal")


def phase_rect_headline(dev, params, terrain, renders=5):
    """(b): the 1920x1080 tilt-0 Rectilinear headline through K3. Returns
    K3's numbers for the kernels line and the launches of the counted
    render."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import base
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    out = params.output
    n_terr = int(math.ceil(params.view.frame.max_distance / params.simulation_step))
    # the Rectilinear main path, counted; this first render is the warm-up
    reset_launches()
    t0 = time.perf_counter()
    result = rect.render_rectilinear(params, terrain, dev)
    torch.cuda.synchronize()
    launches = kernel_launches()
    want = {"combine.cu": 0, "march.cu": 0, "rect_scan.cu": k3_launches(params),
            "rect_culled.cu": 0, "object_pass.cu": 0, "rect_exact.cu": 0}
    check(launches == want, f"rectilinear headline: launches {launches}, not {want}")
    say(f"[rectilinear] first render {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {launches} (K3: one a progress stride)")
    image = result.image
    check(image.shape == (out.height, out.width, 3), f"image shape {image.shape}")
    valid = result.hits.valid.cpu().numpy()
    keys = result.hits.key.cpu().numpy()
    frac_hit = float(valid.mean())
    check(np.isfinite(keys[valid]).all() and bool((keys[valid] < n_terr).all()),
          "a valid hit with a non-finite key or a key past the march")
    check(0.05 < frac_hit < 0.95, f"implausible hit fraction {frac_hit}")
    say(f"[rectilinear] headline {out.width}x{out.height} tilt 0: hit fraction "
        f"{frac_hit:.4f}")

    walls = []
    for _ in range(renders):
        t0 = time.perf_counter()
        rect.render_rectilinear(params, terrain, dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    say(f"[rectilinear] frame wall over {renders} renders after the warm-up: median "
        f"{med * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}; "
        f"all {', '.join(f'{w * 1e3:.3f}' for w in walls)})")

    # the plain path on the card, once: its wall beside K3's, the same image
    t0 = time.perf_counter()
    plain = rect.render_rectilinear(params, terrain, dev, plain=True)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    ok, fa, fb, mx = image_tolerance(image, plain.image)
    vdiff, dk = hits_agree(result, plain)
    check(ok, f"rectilinear headline K3 vs plain=True: any={fa} big={fb} out of tolerance")
    say(f"[rectilinear] plain=True on the card: wall {plain_wall * 1e3:.3f} ms against "
        f"the K3 median {med * 1e3:.3f} ms; images any={fa:.5f} big={fb:.5f} max={mx}; "
        f"valid differ {vdiff:.6f}, max |dkey| {dk:.3g}")
    del plain

    torch.cuda.reset_peak_memory_stats(dev)
    rect.render_rectilinear(params, terrain, dev)
    say(f"[rectilinear] peak device memory of one render: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")

    busy_ms, n_rec, by_name = trace_busy_ms(
        lambda: rect.render_rectilinear(params, terrain, dev), "rect_headline")
    say(f"[rectilinear] device busy {busy_ms:.3f} ms of one profiled render "
        f"({n_rec} device records); idle share of the {med * 1e3:.3f} ms median "
        f"frame wall: {1.0 - busy_ms / (med * 1e3):.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"[rectilinear]   {ms:9.3f} ms  {name[:90]}")
    host_top_ops(lambda: rect.render_rectilinear(params, terrain, dev), "rectilinear")

    # K = 1 against the first slot of K = 2 (tests/test_rectilinear.py:224-229)
    r2 = rect.render_rectilinear(params, terrain, dev, max_hits=2)
    v1, v2 = result.hits.valid[..., 0], r2.hits.valid[..., 0]
    mask_bad = int((v1 != v2).sum())
    both = v1 & v2
    key_bad = int((result.hits.key[..., 0][both] != r2.hits.key[..., 0][both]).sum())
    check(mask_bad == 0 and key_bad == 0,
          f"K = 1 vs K = 2: {mask_bad} masks and {key_bad} keys differ")
    say(f"[rectilinear] K = 1 keys == first keys of K = 2 on all "
        f"{int(both.sum())} hit pixels; masks equal")
    del r2

    # the translucent tilt-0 frame (alpha 0.65: K = 4 through K3), timed
    config = headline_config(out.width, out.height)
    config.scene.terrain_alpha = 0.65
    params_t = config.into_params(None)
    rect.render_rectilinear(params_t, terrain, dev)
    torch.cuda.synchronize()
    reset_launches()
    walls_t = []
    for _ in range(3):
        t0 = time.perf_counter()
        res_t = rect.render_rectilinear(params_t, terrain, dev)
        torch.cuda.synchronize()
        walls_t.append(time.perf_counter() - t0)
    launches_t = kernel_launches()
    check(res_t.hits.valid.shape[-1] == 4 and launches_t["rect_scan.cu"]
          == 3 * k3_launches(params_t), f"translucent tilt 0: K {res_t.hits.valid.shape[-1]}, "
          f"launches {launches_t}")
    translucent_ms = statistics.median(walls_t) * 1e3
    say(f"[rectilinear] translucent (K = 4) tilt-0 frame: median {translucent_ms:.3f} ms of "
        f"3 after a warm-up (all {', '.join(f'{w * 1e3:.3f}' for w in walls_t)}); "
        f"{k3_launches(params_t)} K3 launches a frame")
    del res_t

    # K3 at the headline's inputs, beside its plain version and its bound, at
    # K = 1 (the opaque frame) and K = 4 (the translucent frame)
    alt0, table, az, elev_hw, terr_pad, stacked, kw = k3_inputs(dev, terrain, params)
    launches_k3 = rect.scan_launches(-(-kw["n_seg"] // kw["coarse"]))
    per_k = {}
    for k in (1, 4):
        scan_kw = dict(shape=params.model.to_shape(), table=table, straight=False,
                       max_hits=k, **kw)
        key_k, plh_k, flags = rect.tilt0_hits_cuda(elev_hw, terr_pad, alt0, **scan_kw)
        want = rect.tilt0_hits_plain(elev_hw, terr_pad, alt0, **scan_kw)
        ruled = rect.tilt0_hits_ruled(elev_hw, terr_pad, alt0, **scan_kw)
        torch.cuda.synchronize()
        tag = f"{out.width}x{out.height} headline K={k}"
        err = k3_check(tag, (key_k, plh_k), want)
        marched, plain_windows, skipped, exits = k3_rules_line(tag, flags, ruled, want)
        del want, ruled
        k3_ms = cuda_ms(lambda: rect.tilt0_hits(elev_hw, terr_pad, alt0, **scan_kw), 5)
        events = sorted((e for e in trace_events(lambda: [rect.tilt0_hits(
            elev_hw, terr_pad, alt0, **scan_kw) for _ in range(5)], f"k3_k{k}")
            if "rect_scan_kernel" in e["name"]), key=lambda e: float(e["ts"]))
        check(len(events) == 5 * len(launches_k3),
              f"K3 K={k}: {len(events)} kernel records in the trace of 5 scans, not "
              f"{5 * len(launches_k3)}")
        device_ms = sum(float(e["dur"]) for e in events) / 5e3
        per_launch = [sum(float(events[r * len(launches_k3) + i]["dur"]) for r in range(5))
                      / 5e3 for i in range(len(launches_k3))]
        enqueue = enqueue_ms(lambda: rect.tilt0_hits(elev_hw, terr_pad, alt0, **scan_kw))
        plain_ms = cuda_ms(lambda: rect.tilt0_hits_plain(elev_hw, terr_pad, alt0, **scan_kw),
                           1)
        bound_ms, bound_by, n_bytes, n_ops, windows = k3_bound(
            elev_hw, terr_pad, kw["coarse"], k, flags, skipped, exits)
        hits = int(((flags >> 1) & 0xFF).sum())
        plain_ops = (plain_windows * (209 + 2 + 31 + 216) + hits * 452 if k == 1
                     else plain_windows * (209 + 2 + 452))
        plain_bound_ms, _ = bound(n_bytes, plain_ops)
        say(f"[rectilinear] K3 K={k} (tilt0_hits: {len(launches_k3)} launches) {k3_ms:.4f} "
            f"ms by CUDA events, kernel alone {device_ms:.4f} ms (profiler, mean of 5), "
            f"host enqueue {enqueue:.4f} ms (median of 10); plain "
            f"{plain_ms:.3f} ms; {windows} pixel-windows marched ({skipped} of them without "
            f"their test, {exits} exits) of the plain scan's {plain_windows} (of "
            f"{elev_hw.numel()} x {len(range(0, kw['n_seg'], kw['coarse']))}); bound "
            f"{bound_ms:.4f} ms by {bound_by} ({n_bytes} B, {n_ops} float32 operations): "
            f"{100.0 * bound_ms / k3_ms:.2f} % of the bound; the plain scan's "
            f"pixel-windows would bound it at {plain_bound_ms:.4f} ms ({plain_ops} "
            f"operations, the count without the rules)")
        rows = k3_launch_profile(flags, launches_k3, per_launch) if k == 1 else []
        last = per_launch[len(per_launch) // 2:]
        say(f"[rectilinear] K3 K={k}: the first launch {per_launch[0]:.4f} ms, the later "
            f"half of the launches {sum(last):.4f} ms of {sum(per_launch):.4f}")
        per_k[k] = dict(ms=k3_ms, device_ms=device_ms, enqueue_ms=enqueue,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, max_abs_err=err, pixel_windows=windows,
                        plain_pixel_windows=plain_windows, tests_skipped=skipped,
                        exits=exits, plain_bound_ms=plain_bound_ms,
                        launch_ms=per_launch, launch_live_warps=[r["warps"] for r in rows])
        if k == 1:
            key, plh = key_k, plh_k
        del key_k, plh_k, flags

    # stage times: each stage alone, CUDA-event means
    hit_kw = dict(model=params.model, lat0=LAT0, lon0=LON0, step=kw["step"],
                  terrain_alpha=float(params.terrain_alpha))
    hits = rect.column_hits(stacked, key, plh, az, **hit_kw)
    image_t = rect._composite_hits(params.coloring, params.view.fog_distance, hits)
    t = {
        "terrain columns": cuda_ms(lambda: rect.terrain_columns(
            terrain.pack(*base.terrain_bbox(params), dev), params.model, az, LAT0, LON0,
            kw["step"], n_terr), 3),
        "scan (K3)": per_k[1]["ms"],
        "hit reconstruction": cuda_ms(
            lambda: rect.column_hits(stacked, key, plh, az, **hit_kw), 3),
        "composite": cuda_ms(lambda: rect._composite_hits(
            params.coloring, params.view.fog_distance, hits), 3),
        "image to host": cuda_ms(lambda: image_t.cpu(), 3),
    }
    total = sum(t.values())
    for name, ms in t.items():
        say(f"[rectilinear] stage {name}: {ms:.3f} ms ({100.0 * ms / total:.1f} % "
            f"of the stages' {total:.3f} ms)")
    k1 = per_k[1]
    k3 = {"name": "K3 rect_scan", "route": "cuda",
          "source": "atm_raytracer_tpu_torch/csrc/rect_scan.cu",
          "replaces": "atm_raytracer_tpu/physics/ray.py:422",
          "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
          "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
          "device_ms": k1["device_ms"], "enqueue_ms": k1["enqueue_ms"],
          "pixel_windows": k1["pixel_windows"],
          "plain_pixel_windows": k1["plain_pixel_windows"],
          "tests_skipped": k1["tests_skipped"], "exits": k1["exits"],
          "plain_bound_ms": k1["plain_bound_ms"],
          "k4": {name: v for name, v in per_k[4].items()
                 if name not in ("launch_ms", "launch_live_warps")},
          "frame_wall_ms": med * 1e3, "plain_frame_wall_ms": plain_wall * 1e3,
          "translucent_frame_wall_ms": translucent_ms,
          "busy_ms": busy_ms, "device_records": n_rec}
    return k3, launches


# operations of a window marched by csrc/rect_culled.cu, counted from the
# source as k3_ops counts: the RK4 step 209, the two slopes times dx 2, 17
# Hermite samples of 7 (119), 16 chords of 10 (160), the 16 adds that carry
# them onto the path length (the kernel sums them in double and rounds once:
# its own choice, not counted), the min and max of the samples and the
# block's range 34, 17 NaN and 16 death tests 33
K4_WINDOW = 209 + 2 + 119 + 160 + 16 + 34 + 33
# a block's envelope test (two loads' compares, the NaN and n_seg tests) and
# its slot bookkeeping
K4_BLOCK = 8


def k4_ops(windows: int, blocks: int) -> int:
    """Operations of csrc/rect_culled.cu for ``windows`` pixel-windows
    marched in ``blocks`` pixel-blocks (sphere, Chebyshev l(h))."""
    return windows * K4_WINDOW + blocks * K4_BLOCK


def k4_bound(n_pix: int, env_hi, coarse: int, windows):
    """K4's bound on this run's data: v0 and the pixels' envelope rows read
    once, the envelope [A-1, nb] twice, the count and the M_CAND slots (three
    floats, a flag and a block) written once, the Hermite basis; the
    operations of ``k4_ops`` for the windows each pixel marched (``windows``,
    K4's count of them) and their blocks."""
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    n_windows = int(windows.sum())
    n_blocks = int(((windows + rect.BLOCK_WINDOWS - 1) // rect.BLOCK_WINDOWS).sum())
    n_bytes = (3 * 4 * n_pix + 2 * 4 * env_hi.numel() + 17 * n_pix * rect.M_CAND
               + 16 * (coarse + 1))
    n_ops = k4_ops(n_windows, n_blocks)
    return (*bound(n_bytes, n_ops), n_bytes, n_ops, n_windows)


def k4_check(tag, got, want, nb):
    """K4's contract against ``culled_capture_plain`` on the same inputs:
    count and blocks equal on >= 99.99 % of pixels; there, the death flags
    equal and the captured states within rtol 1e-6 / atol 1e-3 m (slope
    rtol 1e-6 / atol 1e-6). Prints the worst slot and the first pixel that
    differs; returns the largest |dh| of a captured altitude (m)."""
    import torch

    cnt, s_h, s_v, s_p, s_d, s_b = got[:6]
    cnt_p, s_h_p, s_v_p, s_p_p, s_d_p, s_b_p = want
    n_pix = cnt.numel()
    same = (cnt == cnt_p) & (s_b == s_b_p).all(-1)
    n_diff = int((~same).sum())
    flags = int((s_d != s_d_p)[same].sum())
    held = same[:, None] & (s_b < nb)
    worst = {}  # name: (largest |d|, where, K4's value, plain's, largest excess)
    for name, a, b, atol in (("h", s_h, s_h_p, 1e-3), ("v", s_v, s_v_p, 1e-6),
                             ("p", s_p, s_p_p, 1e-3)):
        d = torch.where(held, (a - b).abs(), 0.0)
        over = torch.where(held, d - (atol + 1e-6 * b.abs()), -1.0)
        j = int(d.argmax())
        worst[name] = (float(d.reshape(-1)[j]), divmod(j, a.shape[1]),
                       float(a.reshape(-1)[j]), float(b.reshape(-1)[j]), float(over.max()))
    w_p = worst["p"]
    say(f"[rectilinear] K4 {tag}: count and blocks differ on {n_diff} of {n_pix} pixels; "
        f"{int(cnt_p.sum())} candidates (plain {int(cnt.sum())} K4), {int(held.sum())} "
        f"slots held in both, death flags differ on {flags}; max |dh| "
        f"{worst['h'][0]:.3g} m, |dv| {worst['v'][0]:.3g}, |dp| {w_p[0]:.3g} m at (pixel, "
        f"slot) {w_p[1]}: K4 {w_p[2]:.4f} m, plain {w_p[3]:.4f} m")
    if n_diff:
        i = int(torch.nonzero(~same)[0])
        say(f"[rectilinear] K4 {tag}: first differing pixel {i}: K4 count {int(cnt[i])} "
            f"blocks {s_b[i].tolist()}, plain count {int(cnt_p[i])} blocks "
            f"{s_b_p[i].tolist()}")
    check(n_diff <= 1e-4 * n_pix, f"K4 {tag}: count or blocks differ on {n_diff} of "
          f"{n_pix} pixels")
    check(flags == 0, f"K4 {tag}: death flags differ on {flags} slots")
    for name, w in worst.items():
        check(w[4] <= 0.0, f"K4 {tag}: a captured {name} is out of tolerance (largest "
              f"|d| {w[0]} at {w[1]}: K4 {w[2]}, plain {w[3]})")
    return worst["h"][0]


def cuda_once(fn):
    """(``fn()``, its device milliseconds by CUDA events), one run."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def culled_inputs(dev, terrain, params):
    """The tilted frame's capture inputs on ``dev``, as ``fused_culled_core``
    builds them: (pack, CulledInputs, alt0, table, the scan's keywords)."""
    from atm_raytracer_tpu_torch.generators import base
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    out, frame = params.output, params.view.frame
    alt0 = float(params.view.position.abs_altitude(terrain))
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    step = float(params.simulation_step)
    blocks = rect.culled_blocks(n_terr, step)
    pack = terrain.pack(*base.terrain_bbox(params), dev)
    inp = rect.culled_envelope(
        pack, cam=(out.width, out.height, float(frame.fov), float(frame.tilt),
                   float(frame.direction)),
        model=params.model, step=step, blocks=blocks, lat0=LAT0, lon0=LON0)
    kw = dict(step=step, blocks=blocks)
    return pack, inp, alt0, base.build_refraction_table(params, alt0, dev), kw


def culled_stages(dev, terrain, params, plain_capture_ms, k4_ms, k5_ms):
    """The stages of one round of the tilted frame, CUDA-event means: the
    envelope, the capture (plain and K4, measured by the caller), the exact
    test (plain: ``culled_exact_test`` in its EXACT_TEST_ELEMS chunks; K5,
    measured by the caller), ``ray_hits``, composite and the image to the
    host. Prints the breakdown of the plain path (``plain=True``) and of the
    kernels' (K4 and K5)."""
    import torch

    from atm_raytracer_tpu_torch.generators import rectilinear as rect
    from atm_raytracer_tpu_torch.generators.base import fetch_flat

    out, frame = params.output, params.view.frame
    pack, inp, alt0, table, kw = culled_inputs(dev, terrain, params)
    scan_kw = dict(shape=params.model.to_shape(), table=table, straight=False, **kw)
    cnt, *slots = rect.culled_capture(inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px,
                                      skip=0, **scan_kw)
    p_n = inp.elev.shape[0]
    key = torch.full((p_n, 1), float("inf"), device=dev)
    plh = torch.zeros_like(key)
    test_kw = dict(model=params.model, lat0=LAT0, lon0=LON0, **scan_kw)
    rect.culled_test_round(pack, slots, inp.az_px, key, plh, **test_kw)

    def exact_plain():
        k, p = torch.full_like(key, float("inf")), torch.zeros_like(plh)
        rect.culled_test_round(pack, slots, inp.az_px, k, p, plain=True, **test_kw)

    hit_kw = dict(lat0=LAT0, lon0=LON0, step=kw["step"],
                  terrain_alpha=float(params.terrain_alpha))
    hits = rect.ray_hits(pack, params.model, inp.az_px[:, None], key, plh, **hit_kw)
    image = rect._composite_hits(params.coloring, params.view.fog_distance, hits)
    t = {
        "envelope": cuda_ms(lambda: rect.culled_envelope(
            pack, cam=(out.width, out.height, float(frame.fov), float(frame.tilt),
                       float(frame.direction)), model=params.model, step=kw["step"],
            blocks=kw["blocks"], lat0=LAT0, lon0=LON0), 3),
        "capture": None,
        "exact test": None,
        "ray_hits": cuda_ms(lambda: rect.ray_hits(
            pack, params.model, inp.az_px[:, None], key, plh, **hit_kw), 3),
        "composite": cuda_ms(lambda: rect._composite_hits(
            params.coloring, params.view.fog_distance, hits), 3),
        "image to host": cuda_ms(lambda: fetch_flat(image), 3),
    }
    plain_exact_ms = cuda_ms(exact_plain, 2)
    chunk = max(1, rect.EXACT_TEST_ELEMS // (rect.M_CAND * (kw["blocks"].b_len + 1)))
    n_chunks = -(-p_n // chunk)
    out_t = {}
    for path, capture_ms, exact_ms in (("plain=True", plain_capture_ms, plain_exact_ms),
                                       ("K4 + K5", k4_ms, k5_ms)):
        stages = dict(t, capture=capture_ms)
        stages["exact test"] = exact_ms
        total = sum(stages.values())
        say(f"[rectilinear] tilt-1 stages of one round, {path} (CUDA events; the plain "
            f"exact test in {n_chunks} chunks): " + ", ".join(
                f"{name} {ms:.3f} ms ({100.0 * ms / total:.1f} %)"
                for name, ms in stages.items()) + f"; sum {total:.3f} ms")
        out_t[path] = stages
    return out_t


# operations of K5 (csrc/rect_exact.cu), counted from the source, a math
# library call (sinf, asinf, atan2f, ...) as K5_CALL float32 operations: a
# fine sample on the sphere's geodesic 31 and four calls, its terrain sample
# 32, its Hermite sample, chord, path length, difference and tests 26; a
# window's RK4 step 209, its two slopes times dx 2 and its sample 0 7; a
# slot's sample 0 (geodesic, terrain, difference) and its distance 70
K5_CALL = 20
K5_SAMPLE = 31 + 4 * K5_CALL + 32 + 26
K5_WINDOW = 209 + 2 + 7
K5_SLOT = 70 + 4 * K5_CALL


def k5_work(slots, key_before, key_after, blocks):
    """(pixels, slots, segments, windows) K5 walks in a round: the filled
    slots of the pixels without a hit at its start (and those pixels), each
    to its block's end or the march's, but the slot of a pixel's first
    crossing to that segment, and none after it (a ray's death, which stops
    a slot sooner, is left out: the count is not below K5's)."""
    import torch

    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    s_b = slots[4].to(torch.int64)
    unhit = torch.isinf(key_before)  # [P, 1]
    hit = unhit & torch.isfinite(key_after)
    seg = torch.where(hit, key_after, 0.0).floor().to(torch.int64)
    hb = torch.where(hit, seg // blocks.b_len, blocks.nb)  # the crossing's block
    walked = unhit & (s_b < blocks.nb) & (s_b <= hb)
    full = (blocks.n_seg - s_b * blocks.b_len).clamp(max=blocks.b_len)
    segs = torch.where(s_b == hb, seg - s_b * blocks.b_len + 1, full).clamp(min=0)
    segs = torch.where(walked, segs, 0)
    windows = torch.where(walked, (segs + blocks.coarse - 1) // blocks.coarse, 0)
    assert int(windows.max()) <= rect.BLOCK_WINDOWS
    return (int(walked.any(-1).sum()), int(walked.sum()), int(segs.sum()),
            int(windows.sum()))


def k5_check(tag, got, want):
    """K5's contract against the plain test on the same inputs: validity
    equal on every pixel; where both hit, keys within 1e-3 of a step and
    path lengths within rtol 1e-5. Returns the largest |dkey| (steps)."""
    import torch

    (key, plh), (key_p, plh_p) = got, want
    v, vp = torch.isfinite(key), torch.isfinite(key_p)
    n_diff = int((v != vp).sum())
    both = v & vp
    dk = float((key - key_p).abs()[both].max()) if both.any() else 0.0
    rel = float(((plh - plh_p).abs() / plh_p.abs().clamp(min=1e-30))[both].max()) \
        if both.any() else 0.0
    say(f"[rectilinear] K5 {tag}: validity differs on {n_diff} of {v.numel()} pixels "
        f"({int(v.sum())} hits), max |dkey| {dk:.3g} steps, max path-length rel. "
        f"difference {rel:.3g}")
    check(n_diff == 0 and dk <= 1e-3 and rel <= 1e-5,
          f"K5 {tag}: validity differs on {n_diff} pixels, max |dkey| {dk}, rel {rel}")
    return dk


def phase_k5(dev, terrain, params):
    """K5 at the tilted headline's inputs, round by round through the frame's
    rounds (the capture by K4): against the plain test on the same slots,
    timed by CUDA events beside it, alone by the profiler, with its host
    enqueue, the slots it walks against the P·M_CAND slots the plain test
    integrates, and its bound over the slots walked."""
    import torch

    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    pack, inp, alt0, table, kw = culled_inputs(dev, terrain, params)
    blocks = kw["blocks"]
    scan_kw = dict(shape=params.model.to_shape(), table=table, straight=False, **kw)
    test_kw = dict(model=params.model, lat0=LAT0, lon0=LON0, **scan_kw)
    args = (inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px)
    p_n = inp.elev.shape[0]
    key = torch.full((p_n, 1), float("inf"), device=dev)
    plh = torch.zeros_like(key)
    rounds = []
    skip = 0
    while True:
        cnt, *slots = rect.culled_capture(*args, skip=skip, **scan_kw)
        before = key.clone(), plh.clone()
        n = _kernels.RECT_EXACT.launches
        rect.culled_test_round(pack, slots, inp.az_px, key, plh, **test_kw)
        check(_kernels.RECT_EXACT.launches == n + 1, "K5: not one launch a round")
        want = [t.clone() for t in before]
        _, plain_ms = cuda_once(lambda: rect.culled_test_round(
            pack, slots, inp.az_px, *want, plain=True, **test_kw))
        err = k5_check(f"headline round {len(rounds) + 1} (skip {skip})", (key, plh), want)

        def k5():
            k, p = before[0].clone(), before[1].clone()
            rect.culled_test_round(pack, slots, inp.az_px, k, p, **test_kw)

        ms = cuda_ms(k5, 5)
        events = [e for e in trace_events(lambda: [k5() for _ in range(5)], "k5")
                  if "rect_exact_kernel" in e["name"]]
        check(len(events) == 5, f"K5: {len(events)} kernel records in the trace of 5 tests")
        device_ms = sum(float(e["dur"]) for e in events) / 5e3
        n_pix, n_slots, n_segs, n_windows = k5_work(slots, before[0], key, blocks)
        n_ops = n_slots * K5_SLOT + n_segs * K5_SAMPLE + n_windows * K5_WINDOW
        # the slots, azimuths, keys and path lengths read once and the keys
        # and path lengths written once; the terrain's taps are left out
        # (the tiles a round samples are far fewer than its taps, from cache)
        n_bytes = p_n * (17 * rect.M_CAND + 4 + 2 * 8)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        rounds.append({"skip": skip, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                       "enqueue_ms": enqueue_ms(k5), "max_abs_err": err,
                       "pixels_walking": n_pix, "slots_walked": n_slots, "segments": n_segs,
                       "plain_slots": p_n * rect.M_CAND, "bound_ms": bound_ms,
                       "bound_by": bound_by, "ops": n_ops, "bytes": n_bytes})
        say(f"[rectilinear] K5 round {len(rounds)}: {ms:.4f} ms by CUDA events, kernel "
            f"alone {device_ms:.4f} ms (profiler, mean of 5); plain test {plain_ms:.3f} ms; "
            f"{n_slots} slots walked by {n_pix} pixels ({n_segs} segments) of the plain "
            f"test's "
            f"{p_n * rect.M_CAND}; bound {bound_ms:.4f} ms by {bound_by} ({n_ops} float32 "
            f"operations, a library call as {K5_CALL}): {100.0 * bound_ms / device_ms:.2f} % "
            f"of the bound")
        skip += rect.M_CAND
        if skip >= blocks.nb or not bool((torch.isinf(key[:, 0]) & (cnt > skip)).any()):
            break
    total = {k: sum(r[k] for r in rounds) for k in ("ms", "device_ms", "plain_ms", "ops",
                                                   "bytes", "slots_walked", "segments")}
    total["bound_ms"], bound_by = bound(total["bytes"], total["ops"])
    say(f"[rectilinear] K5 over the frame's {len(rounds)} rounds: {total['ms']:.4f} ms "
        f"(kernel alone {total['device_ms']:.4f}), plain test {total['plain_ms']:.3f} ms, "
        f"{total['slots_walked']} slots walked, bound {total['bound_ms']:.4f} ms: "
        f"{100.0 * total['bound_ms'] / total['device_ms']:.2f} %")
    return {"name": "K5 rect_exact", "route": "cuda",
            "source": "atm_raytracer_tpu_torch/csrc/rect_exact.cu",
            "replaces": "atm_raytracer_tpu/generators/rectilinear.py:748",
            "max_abs_err": max(r["max_abs_err"] for r in rounds), "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": bound_by, "library_ms": None, "device_ms": total["device_ms"],
            "slots_walked": total["slots_walked"], "segments": total["segments"],
            "plain_slots": p_n * rect.M_CAND * len(rounds), "rounds": rounds}


def phase_rect_culled(dev, terrain, renders=5):
    """(c): the tilt-1 headline through the culled path, its capture scan
    K4: the frame counted (one K4 launch a round), timed and held to one
    ``plain=True`` frame; K4 against ``culled_capture_plain`` at 192x108 for
    every one of K3_FORMS and at the headline, timed beside the plain
    capture and its bound; the stages of a round before and after. Returns
    K4's numbers for the kernels line and the launches of the counted
    render."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    # K4 alone at 192x108, every l(h) form and shape, at skip 0 and M_CAND
    small = headline_params(192, 108, tilt=1.0)
    _, inp, alt0, table, kw = culled_inputs(dev, terrain, small)
    nb = kw["blocks"].nb
    for form in K3_FORMS:
        fkw = k3_form(form, table, small, alt0)
        for skip in (0, rect.M_CAND):
            args = (inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px)
            before = _kernels.RECT_CULLED.launches
            got = rect.culled_capture_cuda(*args, skip=skip, **fkw, **kw)
            check(_kernels.RECT_CULLED.launches == before + 1, "K4: not one launch a call")
            want = rect.culled_capture_plain(*args, skip=skip, **fkw, **kw)
            torch.cuda.synchronize()
            k4_check(f"192x108 tilt 1 {form} skip {skip}", got, want, nb)

    params = headline_params(tilt=1.0)
    out = params.output
    n_terr = int(math.ceil(params.view.frame.max_distance / params.simulation_step))

    def render(**kw):
        return rect.render_rectilinear(params, terrain, dev, **kw)

    # the tilted Rectilinear main path, counted; this first render is the warm-up
    reset_launches()
    t0 = time.perf_counter()
    warm = render()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = kernel_launches()
    want_l = {"combine.cu": 0, "march.cu": 0, "rect_scan.cu": 0,
              "rect_culled.cu": warm.culled_rounds, "object_pass.cu": 0,
              "rect_exact.cu": warm.culled_rounds}
    check(launches == want_l, f"tilted headline: launches {launches}, not {want_l}")
    valid = warm.hits.valid.cpu().numpy()
    keys = warm.hits.key.cpu().numpy()
    frac_hit = float(valid.mean())
    check(warm.image.shape == (out.height, out.width, 3), f"image shape {warm.image.shape}")
    check(np.isfinite(keys[valid]).all() and bool((keys[valid] < n_terr).all()),
          "tilted headline: a valid hit with a non-finite key or a key past the march")
    check(0.05 < frac_hit < 0.95, f"culled headline: implausible hit fraction {frac_hit}")
    say(f"[rectilinear] headline tilt 1 (culled): first render {first * 1e3:.3f} ms, "
        f"{warm.culled_rounds} rounds, hit fraction {frac_hit:.4f}; kernel launches "
        f"{launches} (K4 and K5: one each a round)")

    walls = []
    for _ in range(renders):
        t0 = time.perf_counter()
        result = render()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    check(torch.equal(result.hits.key, warm.hits.key), "culled path: two renders differ")
    say(f"[rectilinear] tilt-1 frame wall over {renders} renders after the warm-up: "
        f"median {med * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max "
        f"{max(walls) * 1e3:.3f}; all {', '.join(f'{w * 1e3:.3f}' for w in walls)})")

    # the plain path on the card, once: its wall and peak beside K4's, the same frame
    before = kernel_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    plain = render(plain=True)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check(kernel_launches() == before, "plain=True launched a kernel")
    ok, fa, fb, mx = image_tolerance(result.image, plain.image)
    v_k, v_p = result.hits.valid[..., 0], plain.hits.valid[..., 0]
    vdiff = int((v_k != v_p).sum())
    both = v_k & v_p
    dk = float((result.hits.key[..., 0][both] - plain.hits.key[..., 0][both]).abs().max())
    check(ok, f"tilted headline K4 vs plain=True: any={fa} big={fb} out of tolerance")
    check(vdiff <= 1e-4 * v_k.numel() and dk <= 1e-3,
          f"tilted headline K4 vs plain=True: validity differs on {vdiff} pixels, max "
          f"|dkey| {dk}")
    say(f"[rectilinear] tilt 1 plain=True on the card: wall {plain_wall * 1e3:.3f} ms "
        f"({plain.culled_rounds} rounds) against the K4 median {med * 1e3:.3f} ms; images "
        f"any={fa:.5f} big={fb:.5f} max={mx}; validity differs on {vdiff} of "
        f"{v_k.numel()} pixels, max |dkey| {dk:.3g}; peak device memory {plain_peak:.1f} MiB")
    del plain

    torch.cuda.reset_peak_memory_stats(dev)
    render()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    say(f"[rectilinear] tilt-1 peak device memory of one render through K4: {peak:.1f} MiB "
        f"(plain=True {plain_peak:.1f} MiB)")
    busy_ms, n_rec, by_name = trace_busy_ms(render, "rect_tilted")
    say(f"[rectilinear] tilt 1: device busy {busy_ms:.3f} ms of one profiled render "
        f"({n_rec} device records); idle share of the {med * 1e3:.3f} ms median frame "
        f"wall: {1.0 - busy_ms / (med * 1e3):.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"[rectilinear]   {ms:9.3f} ms  {name[:90]}")
    host_top_ops(render, "rectilinear tilted")

    # K4 at the headline's inputs, beside the plain capture and its bound
    _, inp, alt0, table, kw = culled_inputs(dev, terrain, params)
    blocks = kw["blocks"]
    scan_kw = dict(shape=params.model.to_shape(), table=table, straight=False, skip=0, **kw)
    args = (inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px)
    got = rect.culled_capture_cuda(*args, count_windows=True, **scan_kw)
    want, plain_ms = cuda_once(lambda: rect.culled_capture_plain(*args, **scan_kw))
    err = k4_check(f"{out.width}x{out.height} headline tilt 1", got, want, blocks.nb)
    del want
    windows = got[6]
    k4_ms = cuda_ms(lambda: rect.culled_capture(*args, **scan_kw), 5)
    before = _kernels.RECT_CULLED.launches
    events = [e for e in trace_events(lambda: [rect.culled_capture(*args, **scan_kw)
                                               for _ in range(5)], "k4")
              if "rect_culled_kernel" in e["name"]]
    traced = _kernels.RECT_CULLED.launches - before
    check(traced == 5 and len(events) == traced, f"K4: {len(events)} kernel records in "
          f"the trace of 5 captures ({traced} launches)")
    device_ms = sum(float(e["dur"]) for e in events) / 5e3
    enqueue = enqueue_ms(lambda: rect.culled_capture(*args, **scan_kw))
    bound_ms, bound_by, n_bytes, n_ops, n_windows = k4_bound(
        inp.elev.shape[0], inp.env_hi, blocks.coarse, windows)
    n_coarse = blocks.n_march // blocks.coarse
    plain_windows = inp.elev.shape[0] * n_coarse
    plain_bound_ms, _ = bound(n_bytes, k4_ops(plain_windows, inp.elev.shape[0] * blocks.nb))
    stopped = int((windows < n_coarse).sum())
    say(f"[rectilinear] K4 (culled_capture: 1 launch a round) {k4_ms:.4f} ms by CUDA "
        f"events, kernel alone {device_ms:.4f} ms (profiler, mean of 5), host enqueue "
        f"{enqueue:.4f} ms (median of 10); plain capture {plain_ms:.3f} ms; {n_windows} "
        f"pixel-windows marched of the plain capture's {plain_windows} ({stopped} pixels "
        f"stopped dead at a block's start); bound {bound_ms:.4f} ms by {bound_by} "
        f"({n_bytes} B, {n_ops} float32 operations): {100.0 * bound_ms / k4_ms:.2f} % of "
        f"the bound; the plain capture's pixel-windows would bound it at "
        f"{plain_bound_ms:.4f} ms")
    k5 = phase_k5(dev, terrain, params)
    stages = culled_stages(dev, terrain, params, plain_ms, k4_ms, k5["rounds"][0]["ms"])
    k4 = {"name": "K4 rect_culled", "route": "cuda",
          "source": "atm_raytracer_tpu_torch/csrc/rect_culled.cu",
          "replaces": "atm_raytracer_tpu/generators/rectilinear.py:699",
          "max_abs_err": err, "ms": k4_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "library_ms": None, "device_ms": device_ms,
          "enqueue_ms": enqueue, "pixel_windows": n_windows,
          "plain_pixel_windows": plain_windows, "plain_bound_ms": plain_bound_ms,
          "frame_wall_ms": med * 1e3, "plain_frame_wall_ms": plain_wall * 1e3,
          "rounds": warm.culled_rounds, "peak_mib": peak, "plain_peak_mib": plain_peak,
          "busy_ms": busy_ms, "device_records": n_rec, "stages_ms": stages}
    return k4, k5, launches


def hits_equal_on_valid(got, want, fields) -> None:
    """Equal masks, and each field bitwise equal on the valid slots (host)."""
    import torch

    check(torch.equal(got.valid, want.valid), "artifact: hit masks differ")
    v = want.valid
    for f in fields:
        check(torch.equal(getattr(got, f)[v], getattr(want, f)[v]),
              f"artifact: field {f} differs on the valid slots")


ALL_FIELDS = ("key", "dlat", "dlon", "distance", "elevation", "path_length",
              "normal", "kind", "rgba")


def artifact_round_trip(tag, config, result, dev, tmp, fmt):
    """Save, load and re-composite on the card; the image must be the
    render's bit for bit and every stored field exact. Returns the path."""
    from atm_raytracer_tpu_torch.meta.serialize import load_metadata, save_metadata
    from atm_raytracer_tpu_torch.meta.viewer import _render_from_metadata

    path = Path(tmp) / f"{tag}.{'npz' if fmt == 'native' else 'dat'}"
    t0 = time.perf_counter()
    save_metadata(path, config, result, fmt=fmt)
    t1 = time.perf_counter()
    config2, loaded = load_metadata(path)
    t2 = time.perf_counter()
    image = _render_from_metadata(config2, loaded, dev)
    t3 = time.perf_counter()
    bad = int((image != result.image).any(axis=-1).sum())
    check(bad == 0, f"{tag} {fmt}: the re-composite differs from the render in {bad} pixels")
    # the .dat stores the distance and not the key (meta/bincode.py)
    fields = ALL_FIELDS if fmt == "native" else tuple(f for f in ALL_FIELDS if f != "key")
    hits_equal_on_valid(loaded.hits, result.hits.to("cpu"), fields)
    say(f"[metadata] {tag} {fmt}: {int(loaded.hits.valid.sum())} valid slots, "
        f"{path.stat().st_size} bytes, save {t1 - t0:.3f} s, load {t2 - t1:.3f} s, "
        f"re-composite on the card {(t3 - t2) * 1e3:.3f} ms: image bit-exact, "
        f"fields exact on the valid slots")
    return path


def phase_metadata(dev, terrain, size=(1920, 1080), big=(8192, 2048)):
    """8. metadata and tools: the artifact, ``view`` and ``output-ray-paths``
    of the headline scene; the compaction on the card against the CPU; the
    artifact at the size users write it (the JAX package's 8192x2048,
    fov 120, 150 km metadata configuration)."""
    import argparse
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from atm_raytracer_tpu_torch import cli
    from atm_raytracer_tpu_torch.generators.fast import render_fast
    from atm_raytracer_tpu_torch.meta.serialize import (
        PACKED_FIELDS, _pack_artifact, load_metadata, save_metadata,
    )
    from atm_raytracer_tpu_torch.tools import ray_path

    t_phase = time.perf_counter()
    config = headline_config(*size)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the gen path with --output-meta, counted, and both formats
        reset_launches()
        result = render_fast(config.into_params(terrain), terrain, dev)
        torch.cuda.synchronize()
        launches = kernel_launches()
        check(launches == FAST_LAUNCHES,
              f"metadata: the render's launches {launches}, not {FAST_LAUNCHES}")
        say(f"[metadata] {size[0]}x{size[1]} headline render: launches {launches}")
        npz = artifact_round_trip("headline", config, result, dev, tmp, "native")
        artifact_round_trip("headline", config, result, dev, tmp, "reference")

        # (b) the compaction on the card against the same hits on the CPU
        t0 = time.perf_counter()
        bits, count, seg = _pack_artifact(result.hits)
        took = time.perf_counter() - t0
        bits_c, count_c, seg_c = _pack_artifact(result.hits.to("cpu"))
        check(np.array_equal(bits, bits_c) and count == count_c,
              "compaction: card and CPU bit words or counts differ")
        for name in PACKED_FIELDS:
            check(np.array_equal(seg[name], seg_c[name]),
                  f"compaction: card and CPU segment {name} differ")
        say(f"[metadata] compaction on the card == CPU: {count} slots, "
            f"{bits.size} words, {took * 1e3:.3f} ms with the copies to the host")

        # (f) view --pixel / --save-image on the npz of (a), on the card
        y, x = (int(v) for v in np.argwhere(result.hits.valid[..., 0].cpu().numpy())[-1])
        png = Path(tmp) / "view.png"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["view", str(npz), "--pixel", str(x), str(y),
                           "--device", str(dev), "--save-image", str(png)])
        text = out.getvalue()
        check(rc == 0 and "Trace point 0 (terrain)" in text,
              f"view --pixel {x} {y}: rc {rc}, output {text!r}")
        from PIL import Image

        saved = np.asarray(Image.open(png).convert("RGB"))
        check(np.array_equal(saved, result.image), "view --save-image: not the render")
        say(f"[metadata] view --pixel {x} {y} --save-image: "
            + " | ".join(text.strip().splitlines()[-3:]))

        # (c) the translucent headline, K = 4, npz only
        config.scene.terrain_alpha = 0.65
        result = render_fast(config.into_params(terrain), terrain, dev)
        check(result.hits.valid.shape[-1] == 4, "translucent: K should be 4")
        artifact_round_trip("translucent K=4", config, result, dev, tmp, "native")
        del result

        # (d) the size users write artifacts at
        config = headline_config(*big, max_distance=150_000.0, fov=120.0)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = render_fast(config.into_params(terrain), terrain, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path = Path(tmp) / "big.npz"
        save_metadata(path, config, result)
        t2 = time.perf_counter()
        _, loaded = load_metadata(path)
        t3 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        hits_equal_on_valid(loaded.hits, result.hits.to("cpu"), ("key", "elevation"))
        say(f"[metadata] {big[0]}x{big[1]} fov 120 150 km: render {t1 - t0:.3f} s (first "
            f"at this size, with set-up), {int(loaded.hits.valid.sum())} valid slots, "
            f"npz {path.stat().st_size} bytes, save {t2 - t1:.3f} s, load "
            f"{t3 - t2:.3f} s, peak device memory {peak:.1f} MiB")
        del result, loaded

        # (e) output-ray-paths: the fan marches through K2 on the card; the
        # heights are compared unrounded, the printed table only smoked
        cfg_path = Path(tmp) / "headline.json"  # JSON is YAML
        cfg_path.write_text(json.dumps(headline_config().to_dict()))
        reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["output-ray-paths", str(cfg_path), "--device", str(dev)])
        rows = out.getvalue().splitlines()
        k2 = kernel_launches()["march.cu"]
        check(rc == 0 and k2 > 0 and len(rows[0].split()) == 22,
              f"output-ray-paths: rc {rc}, K2 launches {k2}, first row {rows[0]!r}")
        say(f"[metadata] output-ray-paths CLI on the card: {len(rows)} rows, "
            f"K2 launches {k2}")
        for name, extra in (("defaults", {}), ("100 km", {"cutoff": 100_000.0,
                                                          "output_step": 1000.0})):
            args = argparse.Namespace(
                input=str(cfg_path), height=2.0, min_ang=-1.0, max_ang=1.0,
                angle_step=0.1, ray_step=50.0, cutoff=10_000.0, output_step=50.0)
            for k, v in extra.items():
                setattr(args, k, v)
            reset_launches()
            xs, gpu = ray_path.fan_heights(args, dev)
            k2 = kernel_launches()["march.cu"]
            xs_c, cpu = ray_path.fan_heights(args, torch.device("cpu"))
            k2_cpu = kernel_launches()["march.cu"] - k2
            check(k2 > 0 and k2_cpu == 0, f"output-ray-paths {name}: K2 launches "
                  f"{k2} on the card, {k2_cpu} on the CPU")
            err = float(np.abs(gpu - cpu).max())
            check(np.array_equal(xs, xs_c) and gpu.shape == cpu.shape and err <= K2_ATOL,
                  f"output-ray-paths {name}: card vs CPU max |dh| {err} m")
            say(f"[metadata] output-ray-paths {name}: {gpu.shape[1]} rows x "
                f"{gpu.shape[0]} rays, K2 launches {k2}, card vs CPU max |dh| "
                f"{err:.6g} m")
    say(f"[metadata] phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_interpolating(dev, terrain, size=(1920, 1080), max_distance=200_000.0,
                        renders=10):
    """9. the InterpolatingRectilinear generator on the headline scene: the
    snapped grid through K2 and K1, the per-pixel interpolation after it.
    Returns (launches of the counted render, each kernel's numbers at the
    grid's shapes)."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import fast
    from atm_raytracer_tpu_torch.generators import interpolating as interp
    from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear
    from atm_raytracer_tpu_torch.ops import combine
    from atm_raytracer_tpu_torch.ops.composite import composite
    from atm_raytracer_tpu_torch.physics.ray import march_coarse

    params = headline_config(*size, max_distance=max_distance).into_params(terrain)
    out, frame, pos = params.output, params.view.frame, params.view.position
    cam = (out.width, out.height, float(frame.fov), float(frame.tilt),
           float(frame.direction))
    (min_es, min_ds, i_min, j_min, grid_e, grid_a, _, _) = interp._camera_grids(*cam)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    step = float(params.simulation_step)

    # (a) the main path, counted; this first render is also the warm-up
    reset_launches()
    t0 = time.perf_counter()
    result = interp.render_interpolating(params, terrain, dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = kernel_launches()
    say(f"[interpolating] {out.width}x{out.height}: snapped grid {grid_e.size} x "
        f"{grid_a.size}; first render {first * 1e3:.3f} ms; launches {launches}")
    check(launches == FAST_LAUNCHES,
          f"interpolating headline: not one launch of K1 and K2: {launches}")
    hits = result.hits
    check(result.image.shape == (out.height, out.width, 3), f"image {result.image.shape}")
    check(hits.valid.shape == (out.height, out.width, 4), f"hits {hits.valid.shape}")
    v = hits.valid
    check(bool(torch.isfinite(hits.key[v]).all()) and bool((hits.key[v] < n_terr).all()),
          "interpolating: a valid hit with a non-finite key or a key past the march")
    frac_hit = float(v[..., 0].double().mean())
    check(0.05 < frac_hit < 0.95, f"interpolating: implausible hit fraction {frac_hit}")

    plain = interp.render_interpolating(params, terrain, dev, plain=True)
    ok, fa, fb, mx = image_tolerance(result.image, plain.image)
    same = float((plain.hits.valid == v).double().mean())
    check(ok and same >= 0.99, f"interpolating kernels vs plain: any={fa} big={fb}, "
          f"valid equal on {same} of the slots")
    say(f"[interpolating] kernels vs plain (card): any={fa:.5f} big={fb:.5f} max={mx}; "
        f"valid equal on {100.0 * same:.4f} % of slots; hit fraction {frac_hit:.4f}")

    # the grid cells on the card against the CPU's; the divisors are float32
    # tensors on the device (a Python float divides by its reciprocal there)
    args = (cam, float(min_es), float(min_ds), i_min, j_min)
    gi, gj, rem_e, rem_d = interp.grid_coords(*args, dev)
    gi_c, gj_c, _, _ = interp.grid_coords(*args, "cpu")
    flips = int(((gi.cpu() != gi_c) | (gj.cpu() != gj_c)).sum())
    n_px = out.width * out.height
    elev, _ = interp.camera.rectilinear_ray_params_device(*cam, dev)
    by_recip = int((torch.floor(elev / float(min_es)) != torch.floor(
        elev / torch.tensor(min_es, dtype=torch.float32, device=dev))).sum())
    check(flips <= 1e-4 * n_px, f"interpolating: {flips} grid cells differ card vs CPU")
    check(int(gi.min()) >= 0 and int(gi.max()) + 1 < grid_e.size and int(gj.min()) >= 0
          and int(gj.max()) + 1 < grid_a.size, "interpolating: a cell outside the grid")
    say(f"[interpolating] grid cells card vs CPU: {flips} of {n_px} pixels differ "
        f"({100.0 * flips / n_px:.5f} %); elevation floors moved by dividing by the "
        f"Python float instead: {by_recip}")

    walls = []
    for _ in range(renders):
        t0 = time.perf_counter()
        interp.render_interpolating(params, terrain, dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    q1, med, q3 = statistics.quantiles(walls, n=4)
    say(f"[interpolating] frame wall over {renders} renders after the warm-up: median "
        f"{med * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, q1 {q1 * 1e3:.3f}, q3 "
        f"{q3 * 1e3:.3f}, max {max(walls) * 1e3:.3f})")
    busy_ms, n_rec, by_name = trace_busy_ms(
        lambda: interp.render_interpolating(params, terrain, dev), "interp_headline")
    say(f"[interpolating] device busy {busy_ms:.3f} ms of one profiled render "
        f"({n_rec} device records); idle share of the {med * 1e3:.3f} ms median frame "
        f"wall: {1.0 - busy_ms / (med * 1e3):.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"[interpolating]   {ms:9.3f} ms  {name[:90]}")
    torch.cuda.reset_peak_memory_stats(dev)
    interp.render_interpolating(params, terrain, dev)
    say(f"[interpolating] peak device memory of one render: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")

    # stage times: each stage alone, CUDA-event means
    alt0 = float(pos.abs_altitude(terrain))
    pack = terrain.pack(*fast.terrain_bbox(params), dev)
    table = fast.build_refraction_table(params, alt0, dev)
    ge = torch.from_numpy(grid_e.astype(np.float32)).to(dev)
    ga = torch.from_numpy(grid_a.astype(np.float32)).to(dev)
    kw = dict(model=params.model, shape=params.model.to_shape(), straight=False, step=step,
              n_terr=n_terr, max_hits=1, lat0=LAT0, lon0=LON0, terrain_alpha=1.0)
    march_kw = dict(shape=kw["shape"], straight=False, step=step, n_terr=n_terr)
    # K2 held to its phase-3 contract at the grid's 787 rays (99 CTAs of 8,
    # the last one ragged)
    ray_h, _, k2_err, k2_p_err, k2_node_err, k2_p_ulp = k2_rows_check(
        table, ge, alt0, kw["shape"], step, n_terr, "interpolating grid")
    say(f"[interpolating] K2 at {ge.shape[0]} rays vs plain: h max |dh| {k2_err:.3g} m, "
        f"nodes max |dh| {k2_node_err:.3g} m (limit {K2_ATOL}); h == Hermite fill of its "
        f"nodes; p max |dp| {k2_p_err:.3g} m vs plain, {k2_p_ulp:.1f} ulp vs the path "
        f"length of its own h")
    terr, _ = fast.terrain_columns(pack, params.model, ga, LAT0, LON0, step, n_terr)
    grid = fast.separable_hits(pack, table, ge, ga, alt0, **kw)
    ihits = interp._interpolate_pixels(grid, gi, gj, rem_e, rem_d, step, 4,
                                       has_objects=False)
    coloring, fog = params.coloring, params.view.fog_distance

    def comp():
        return composite(coloring, fog, ihits.valid, ihits.rgba[..., 3], ihits.distance,
                         ihits.elevation, ihits.path_length, ihits.normal, ihits.kind,
                         ihits.rgba[..., :3])

    image = comp()
    t = {
        "grid indices": cuda_ms(lambda: interp.grid_coords(*args, dev), 10),
        "grid march (K2)": cuda_ms(lambda: fast.march_rows(table, ge, alt0, **march_kw), 10),
        "grid terrain columns": cuda_ms(lambda: fast.terrain_columns(
            pack, params.model, ga, LAT0, LON0, step, n_terr), 10),
    }
    grid_ms = cuda_ms(lambda: fast.separable_hits(pack, table, ge, ga, alt0, **kw), 10)
    t["grid combine (K1) and gathers (derived)"] = (
        grid_ms - t["grid march (K2)"] - t["grid terrain columns"])
    t["interpolation"] = cuda_ms(lambda: interp._interpolate_pixels(
        grid, gi, gj, rem_e, rem_d, step, 4, has_objects=False), 10)
    t["composite"] = cuda_ms(comp, 10)
    t["image to host"] = cuda_ms(lambda: image.cpu(), 10)
    total = sum(t.values())
    for name, ms in t.items():
        say(f"[interpolating] stage {name}: {ms:.3f} ms ({100.0 * ms / total:.1f} % of "
            f"the stages' {total:.3f} ms)")

    # each kernel at the grid's shapes, beside its plain version and bound
    n_seg = n_terr - 1
    segs_k = combine.terrain_crossing_segments(ray_h, terr, n_seg, 1)
    segs_p = combine.terrain_crossing_segments_plain(ray_h, terr, n_seg, 1)
    check(torch.equal(segs_k, segs_p), "K1 vs plain on the interpolating grid differ")
    env_p = combine.crossing_envelopes_plain(ray_h, terr, n_seg)
    work = k1_work(segs_p, combine.ray_death_limit(ray_h, n_seg), env_p, n_seg)
    k1_b, k1_by, k1_bytes, k1_ops = k1_bound(ray_h.shape[0], terr.shape[0], n_seg,
                                             work["tests"])
    k1_ms = cuda_ms(lambda: combine.terrain_crossing_segments(ray_h, terr, n_seg, 1), 20)
    k1_plain = cuda_ms(lambda: combine.terrain_crossing_segments_plain(
        ray_h, terr, n_seg, 1), 2)
    k2_b, k2_by, k2_bytes, k2_ops_n = k2_bound(ge.shape[0], n_seg, march_coarse(step),
                                               table)
    k2_ms = t["grid march (K2)"]
    k2_plain = cuda_ms(lambda: fast.march_rows(table, ge, alt0, plain=True, **march_kw), 1)
    say(f"[interpolating] K1 at [{ray_h.shape[0]}, {terr.shape[0]}] x {n_seg}: {k1_ms:.4f} ms "
        f"vs plain {k1_plain:.3f} ms; tests in live chunks {work['tests']} of T_need "
        f"{work['t_need']}; bound {k1_b:.4f} ms by {k1_by} ({k1_bytes} B, {k1_ops} "
        f"operations): {100.0 * k1_b / k1_ms:.1f} % of the bound")
    say(f"[interpolating] K2 at {ge.shape[0]} rays x {n_seg} steps: {k2_ms:.4f} ms vs "
        f"plain {k2_plain:.3f} ms; bound {k2_b:.4f} ms by {k2_by} ({k2_bytes} B, "
        f"{k2_ops_n} operations): {100.0 * k2_b / k2_ms:.1f} % of the bound")

    # against the exact pinhole: the reference's own oracle
    rect = render_rectilinear(params, terrain, dev)
    agree = float((v.any(-1) == rect.hits.valid.any(-1)).double().mean())
    both = v[..., 0] & rect.hits.valid[..., 0]
    gap = float((hits.distance[..., 0] - rect.hits.distance[..., 0]).abs()[both].median())
    check(agree > 0.9, f"interpolating vs rectilinear: sky/terrain agree on {agree}")
    say(f"[interpolating] vs the Rectilinear tilt-0 render: sky/terrain agree on "
        f"{100.0 * agree:.3f} % of pixels; median first-hit distance gap {gap:.3f} m")
    del result, plain, rect, grid, ihits

    # (b) the translucent headline: E = 16 entries, 8 output slots
    config = headline_config(*size, max_distance=max_distance)
    config.scene.terrain_alpha = 0.65
    params_t = config.into_params(terrain)
    t0 = time.perf_counter()
    warm = interp.render_interpolating(params_t, terrain, dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trans = interp.render_interpolating(params_t, terrain, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(trans.hits.valid.shape[-1] == 8 and torch.equal(trans.hits.valid, warm.hits.valid),
          "translucent interpolating: 8 slots expected, and two renders alike")
    say(f"[interpolating] translucent (alpha 0.65, grid K = 4, 8 slots): wall "
        f"{wall * 1e3:.3f} ms after a {first * 1e3:.3f} ms first render; peak device "
        f"memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB; slots holding "
        f"a hit {[int(x) for x in trans.hits.valid.sum((0, 1)).tolist()]}")
    del warm, trans

    # (c) due south: the view straddles the ±180° seam
    config = headline_config(*size, max_distance=max_distance)
    config.view.frame.direction = 180.0
    params_s = config.into_params(terrain)
    grid_as = interp._camera_grids(out.width, out.height, float(frame.fov),
                                   float(frame.tilt), 180.0)[5]
    span = float(grid_as.max() - grid_as.min())
    check(span < 3.0 * frame.fov, f"due south: the grid spans {span} degrees of azimuth")
    t0 = time.perf_counter()
    south = interp.render_interpolating(params_s, terrain, dev)
    torch.cuda.synchronize()
    frac_s = float(south.hits.valid[..., 0].double().mean())
    check(0.05 < frac_s < 0.95, f"due south: implausible hit fraction {frac_s}")
    say(f"[interpolating] due south: grid {grid_as.size} columns spanning {span:.4f} "
        f"degrees (< 3 x fov); render {(time.perf_counter() - t0) * 1e3:.3f} ms, hit "
        f"fraction {frac_s:.4f}")
    grid_numbers = {
        "combine.cu": {"shape": f"[{ray_h.shape[0]}, {terr.shape[0]}] x {n_seg}",
                       "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_b,
                       "bound_by": k1_by, "tests": work["tests"]},
        "march.cu": {"shape": f"{ge.shape[0]} rays x {n_seg}", "ms": k2_ms,
                     "plain_ms": k2_plain, "bound_ms": k2_b, "bound_by": k2_by,
                     "max_abs_err": k2_err},
    }
    return launches, grid_numbers


# The 8 objects of the object headline: (a band of columns as shares of the
# width, a distance as a share of the farthest first hit in the frame,
# shape, color). Each stands on the terrain point of its band that the
# object-free Fast headline hits nearest that distance. The synthetic hills
# hide everything past ~47 km (and past ~14 km outside the left seventh of
# the frame), so the objects stand 3-45 km out. The bands keep the column
# windows apart, but for the second and the third object: a Cylinder and a
# Billboard under 0.9 degrees apart, whose windows overlap.
HEADLINE_OBJECTS = (
    ((0.55, 0.58), 0.064, {"Cylinder": {"radius": 50.0, "height": 150.0}},
     {"r": 0.9, "g": 0.1, "b": 0.1}),
    ((0.207, 0.213), 0.17, {"Cylinder": {"radius": 80.0, "height": 250.0}},
     {"r": 0.1, "g": 0.2, "b": 0.9}),
    ((0.222, 0.228), 0.255, "Billboard", {"r": 1.0, "g": 1.0, "b": 1.0}),
    ((0.08, 0.12), 0.53, {"Cylinder": {"radius": 120.0, "height": 300.0}},
     {"r": 0.9, "g": 0.8, "b": 0.1}),
    ((0.33, 0.36), 0.21, {"Cylinder": {"radius": 100.0, "height": 300.0}},
     {"r": 0.1, "g": 0.8, "b": 0.8, "a": 0.5}),
    ((0.8, 0.84), 0.29, {"Cone": {"radius": 150.0, "height": 300.0}},
     {"r": 0.1, "g": 0.8, "b": 0.2}),
    ((0.95, 0.98), 0.28, "Billboard", {"r": 1.0, "g": 1.0, "b": 1.0}),
    ((0.0, 0.05), 0.96, {"Cylinder": {"radius": 200.0, "height": 400.0}},
     {"r": 0.8, "g": 0.1, "b": 0.8}),
)


def write_texture(path) -> None:
    """A 64x64 RGBA checker with a fully transparent band (rows 24-39):
    texels of alpha 0 never count as hits (utils.rs:258-259)."""
    import numpy as np
    from PIL import Image

    yy, xx = np.mgrid[0:64, 0:64]
    check_ = ((xx // 8 + yy // 8) % 2).astype(bool)
    rgba = np.zeros((64, 64, 4), np.uint8)
    rgba[..., 0] = np.where(check_, 230, 30)
    rgba[..., 1] = 120
    rgba[..., 2] = np.where(check_, 30, 230)
    rgba[..., 3] = 255
    rgba[24:40, :, 3] = 0
    Image.fromarray(rgba, "RGBA").save(path)


def object_headline(terrain, dev, size, max_distance, texture):
    """The object headline's Config, and per object its column, hit
    distance (m) and culling radius (m): HEADLINE_OBJECTS on the terrain
    points the object-free Fast headline hits."""
    import numpy as np

    from atm_raytracer_tpu_torch.config import ConfObject
    from atm_raytracer_tpu_torch.generators.fast import render_fast

    config = headline_config(*size, max_distance=max_distance)
    step = config.simulation_step
    free = render_fast(config.into_params(terrain), terrain, dev).hits
    valid = free.valid[..., 0].cpu().numpy()
    dist, dlat, dlon = (getattr(free, f)[..., 0].cpu().numpy()
                        for f in ("distance", "dlat", "dlon"))
    d_far = float(dist[valid].max())
    objs, cols_, dists, culls = [], [], [], []
    for (c0, c1), d_share, shape, color in HEADLINE_OBJECTS:
        cols = slice(int(c0 * size[0]), max(int(c1 * size[0]), int(c0 * size[0]) + 1))
        gap = np.where(valid[:, cols], np.abs(dist[:, cols] - d_share * d_far), np.inf)
        check(np.isfinite(gap).any(), f"object headline: no terrain hit in columns {cols}")
        r, c = np.unravel_index(int(np.argmin(gap)), gap.shape)
        col = cols.start + int(c)
        if shape == "Billboard":
            shape = {"Billboard": {"width": 150.0, "height": 250.0,
                                   "texture_path": str(texture)}}
            radius = 150.0
        else:
            radius = next(iter(shape.values()))["radius"]
        objs.append(ConfObject.from_config({
            "position": {"latitude": LAT0 + float(dlat[r, col]),
                         "longitude": LON0 + float(dlon[r, col]),
                         "altitude": {"Relative": 0.0}},
            "shape": shape, "color": color}))
        cols_.append(col)
        dists.append(float(dist[r, col]))
        culls.append(math.sqrt(2.0) * (radius + step))
    config.scene.objects = objs
    return config, cols_, dists, culls


def objects_seen(hits, wins, dists, culls, step):
    """Per object, the valid object slots in its column window whose
    distance lies within its culling radius (plus two steps) of its own."""
    v = hits.valid & (hits.kind == 1)
    seen = []
    for (lo, wn), di, ci in zip(wins, dists, culls):
        d = hits.distance[:, lo:lo + wn][v[:, lo:lo + wn]]
        seen.append(int(((d - di).abs() <= ci + 2.0 * step).sum()))
    return seen


def timed_walls(render, renders):
    """(median, all) frame walls in s of ``renders`` renders, each ending in
    a synchronize."""
    import torch

    walls = []
    for _ in range(renders):
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def phase_objects(dev, terrain, size=(1920, 1080), max_distance=200_000.0,
                  fast_renders=10, interp_renders=5, rect_renders=2,
                  small=(192, 108)):
    """10. scene objects on the headline scene. Returns the launches of the
    three counted object renders, by path."""
    import tempfile

    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import fast
    from atm_raytracer_tpu_torch.generators import interpolating as interp
    from atm_raytracer_tpu_torch.generators import rectilinear as rect
    from atm_raytracer_tpu_torch.ops import objects as O
    from atm_raytracer_tpu_torch.physics.ray import march_coarse, march_rays

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        texture = Path(tmp) / "billboard.png"
        write_texture(texture)
        config, cols, dists, culls = object_headline(terrain, dev, size, max_distance,
                                                     texture)
        params = config.into_params(terrain)
        small_params = dataclasses.replace(config, output=dataclasses.replace(
            config.output, width=small[0], height=small[1])).into_params(terrain)
    out, frame = params.output, params.view.frame
    step = float(params.simulation_step)
    n_terr = int(math.ceil(frame.max_distance / step))
    say(f"[objects] {out.width}x{out.height}: 8 objects at (column, km) "
        + ", ".join(f"({c}, {d / 1e3:.2f})" for c, d in zip(cols, dists)))

    # (a) Fast: the main path, counted; this first render is the warm-up
    reset_launches()
    t0 = time.perf_counter()
    res = fast.render_fast(params, terrain, dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches["objects_fast"] = kernel_launches()
    check(launches["objects_fast"] == OBJECT_LAUNCHES,
          f"objects fast: launches {launches['objects_fast']}")
    az = fast.camera.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)
    objects, wins = fast.build_objects_cached(params, az, n_terr, dev)
    overlap = O.max_window_overlap(wins, objects.n_objects)
    seen = objects_seen(res.hits, wins, dists, culls, step)
    check(all(n > 0 for n in seen), f"objects fast: an object is not seen: {seen}")
    say(f"[objects] fast: first render {first * 1e3:.3f} ms; launches "
        f"{launches['objects_fast']}; K = {res.hits.valid.shape[-1]} (window overlap "
        f"{overlap}, seg_window {objects.seg_window}); windows {list(wins)}; object "
        f"pixels seen per object {seen}")
    plain = fast.render_fast(params, terrain, dev, plain=True)
    ok, fa, fb, mx = image_tolerance(res.image, plain.image)
    same = float((plain.hits.valid == res.hits.valid).double().mean())
    check(ok and same >= 0.999, f"objects fast kernels vs plain: any={fa} big={fb}, "
          f"valid equal on {same} of the slots")
    say(f"[objects] fast kernels vs plain (card): any={fa:.5f} big={fb:.5f} max={mx}; "
        f"valid equal on {100.0 * same:.4f} % of slots")
    del plain
    med, walls = timed_walls(lambda: fast.render_fast(params, terrain, dev), fast_renders)
    say(f"[objects] fast frame wall over {fast_renders} renders after the warm-up: median "
        f"{med * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f})")
    busy_ms, n_rec, by_name = trace_busy_ms(
        lambda: fast.render_fast(params, terrain, dev), "objects_fast")
    say(f"[objects] fast device busy {busy_ms:.3f} ms of one profiled render ({n_rec} "
        f"device records); idle share of the median wall: {1.0 - busy_ms / (med * 1e3):.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"[objects]   {ms:9.3f} ms  {name[:90]}")
    torch.cuda.reset_peak_memory_stats(dev)
    fast.render_fast(params, terrain, dev)
    say(f"[objects] fast peak device memory of one render: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")

    # stage times: each alone, CUDA-event means
    args, kw = headline_inputs(params, terrain, dev)
    kw["fog_distance"] = params.view.fog_distance
    hit_kw = {k: v for k, v in kw.items() if k not in ("coloring", "fog_distance")}
    obj_kw = dict(objects=objects, obj_windows=wins)
    pack, table, elev, az_t, alt0 = args
    ray_h, path_len = fast.march_rows(table, elev, alt0, shape=kw["shape"], straight=False,
                                      step=step, n_terr=n_terr)
    dlat, dlon = fast.column_geodesic(params.model, az_t, LAT0, LON0, step, n_terr)
    terr_hits = fast.separable_hits(*args, **hit_kw)
    k_out = 1 + min(2 * overlap, max(fast.OBJ_HIT_CAP, 2))
    planes = O.hits_to_planes(terr_hits)
    obj_args = (objects, params.model, LAT0, step, ray_h, path_len, dlat, dlon, wins,
                k_out)
    t = {"terrain hits (K2, columns, K1, gathers)": cuda_ms(
        lambda: fast.separable_hits(*args, **hit_kw), 5)}
    all_ms = cuda_ms(lambda: fast.separable_hits(*args, **hit_kw, **obj_kw), 5)
    t["object pass: 8 objects (apply_objects_planes)"] = cuda_ms(
        lambda: O.apply_objects_planes(planes, *obj_args), 5)
    t["object pass: planes in and out (derived)"] = (
        all_ms - t["terrain hits (K2, columns, K1, gathers)"]
        - t["object pass: 8 objects (apply_objects_planes)"])
    image, _ = fast.fast_core(*args, **kw, **obj_kw)
    t["composite (derived)"] = cuda_ms(lambda: fast.fast_core(*args, **kw, **obj_kw), 5) - all_ms
    t["image to host"] = cuda_ms(lambda: image.cpu(), 5)
    total = sum(t.values())
    for name, ms in t.items():
        say(f"[objects] fast stage {name}: {ms:.3f} ms ({100.0 * ms / total:.1f} % of the "
            f"stages' {total:.3f} ms)")
    for name, ms in k6_kernels_ms(lambda: O.apply_objects_planes(planes, *obj_args)).items():
        say(f"[objects]   K6 {name}: {ms:.4f} ms (profiler, mean of 10)")

    # the object pass on the card against the CPU, on the same inputs
    cpu_objects = O.ObjectSet.build(params, "cpu")
    t0 = time.perf_counter()
    key_c, vals_c = O.apply_objects_planes(
        tuple(x.cpu() for x in planes), cpu_objects, params.model, LAT0, step,
        ray_h.cpu(), path_len.cpu(), dlat.cpu(), dlon.cpu(), wins, k_out)
    cpu_s = time.perf_counter() - t0
    key_g, vals_g = (x.cpu() for x in O.apply_objects_planes(planes, *obj_args))
    vg, vc = torch.isfinite(key_g), torch.isfinite(key_c)
    flips = int((vg != vc).sum())
    both = vg & vc
    dk = float((key_g - key_c).abs()[both].max())
    dv = float((vals_g - vals_c).abs()[:, both].max())
    check(flips <= 1e-4 * vg.numel(), f"objects: {flips} validity flips card vs CPU")
    say(f"[objects] object pass card vs CPU on the same inputs: validity flips {flips} of "
        f"{vg.numel()} slots ({int(vg.sum())} valid); max |dkey| {dk:.3g} step, max "
        f"|dfield| {dv:.3g}; the CPU took {cpu_s:.2f} s")
    del planes, key_c, vals_c, key_g, vals_g, terr_hits

    # (b) InterpolatingRectilinear, counted
    reset_launches()
    res_i = interp.render_interpolating(params, terrain, dev)
    torch.cuda.synchronize()
    launches["objects_interpolating"] = kernel_launches()
    check(launches["objects_interpolating"] == OBJECT_LAUNCHES,
          f"objects interpolating: launches {launches['objects_interpolating']}")
    # the pinhole generators' columns have their own azimuths
    az_col = rect.camera.rectilinear_column_azimuths(out.width, frame.fov, frame.direction)
    pin_wins = O.object_col_windows(objects, params.model, LAT0, LON0, az_col, step, n_terr)
    seen_i = objects_seen(res_i.hits, pin_wins, dists, culls, step)
    check(all(n > 0 for n in seen_i), f"objects interpolating: not every object seen: {seen_i}")
    plain = interp.render_interpolating(params, terrain, dev, plain=True)
    ok, fa, fb, mx = image_tolerance(res_i.image, plain.image)
    same = float((plain.hits.valid == res_i.hits.valid).double().mean())
    check(ok and same >= 0.999, f"objects interpolating kernels vs plain: any={fa} "
          f"big={fb}, valid equal on {same}")
    say(f"[objects] interpolating: launches {launches['objects_interpolating']}; object "
        f"pixels seen per object {seen_i}; kernels vs plain (card): any={fa:.5f} "
        f"big={fb:.5f} max={mx}, valid equal on {100.0 * same:.4f} % of slots")
    del plain
    med_i, walls = timed_walls(lambda: interp.render_interpolating(params, terrain, dev),
                               interp_renders)
    say(f"[objects] interpolating frame wall over {interp_renders} renders: median "
        f"{med_i * 1e3:.3f} ms (all {', '.join(f'{w * 1e3:.3f}' for w in walls)})")
    busy_ms, n_rec, _ = trace_busy_ms(
        lambda: interp.render_interpolating(params, terrain, dev), "objects_interp")
    say(f"[objects] interpolating device busy {busy_ms:.3f} ms ({n_rec} records); idle "
        f"share {1.0 - busy_ms / (med_i * 1e3):.4f}")
    torch.cuda.reset_peak_memory_stats(dev)
    interp.render_interpolating(params, terrain, dev)
    say(f"[objects] interpolating peak device memory: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    del res_i

    # (c) Rectilinear at tilt 0: the row-chunked shared-column path, counted
    rows = rect.auto_chunk_rows(out.width, out.height, n_terr)
    n_chunks = -(-out.height // rows)
    reset_launches()
    t0 = time.perf_counter()
    res_r = rect.render_rectilinear(params, terrain, dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches["objects_rectilinear"] = kernel_launches()
    check(launches["objects_rectilinear"]["march.cu"] == n_chunks,
          f"objects rectilinear: launches {launches['objects_rectilinear']}, {n_chunks} chunks")
    seen_r = objects_seen(res_r.hits, pin_wins, dists, culls, step)
    check(all(n > 0 for n in seen_r), f"objects rectilinear: not every object seen: {seen_r}")
    obj_f = (res.hits.valid & (res.hits.kind == 1)).any(-1)
    obj_r = (res_r.hits.valid & (res_r.hits.kind == 1)).any(-1)
    agree = float((obj_f == obj_r).double().mean())
    jacc = float((obj_f & obj_r).sum()) / max(1, int((obj_f | obj_r).sum()))
    say(f"[objects] rectilinear tilt 0: {n_chunks} chunks of {rows} rows; first render "
        f"{first * 1e3:.3f} ms; launches {launches['objects_rectilinear']}; K = "
        f"{res_r.hits.valid.shape[-1]}; object pixels seen per object {seen_r}; object "
        f"pixels vs the Fast render: agree on {100.0 * agree:.3f} % of pixels, "
        f"intersection over union {jacc:.4f}")
    del res_r
    med_r, walls = timed_walls(lambda: rect.render_rectilinear(params, terrain, dev),
                               rect_renders - 1)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rect.render_rectilinear(params, terrain, dev)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    say(f"[objects] rectilinear frame walls after the warm-up: "
        f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    # one chunk's stages, CUDA-event means of 2
    elev_hw = torch.from_numpy(rect.camera.rectilinear_ray_params(
        out.width, out.height, frame.fov, 0.0, frame.direction)[0][:rows]
        .astype(np.float32)).to(dev)
    az_col = torch.from_numpy(az_col.astype(np.float32)).to(dev)
    r_objects = O.ObjectSet.build(params, dev)
    shape = params.model.to_shape()
    ray_c, plen_c = march_rays(alt0, elev_hw.reshape(-1), step, n_terr - 1, shape, table,
                               False, coarse=march_coarse(step))
    terr_c, _ = fast.terrain_columns(pack, params.model, az_col, LAT0, LON0, step, n_terr)
    az_rays = az_col[None, :].expand(rows, out.width).reshape(-1)
    rkw = {k: v for k, v in kw.items() if k not in ("max_hits",)}
    chunk_ms = cuda_ms(lambda: rect.shared_column_core(
        pack, table, r_objects, elev_hw, az_col, alt0, max_hits=1, chunk_rows=rows,
        **rkw), 2)
    t = {
        "march (K2)": cuda_ms(lambda: march_rays(
            alt0, elev_hw.reshape(-1), step, n_terr - 1, shape, table, False,
            coarse=march_coarse(step)), 2),
        "aligned_crossing_segments": cuda_ms(lambda: rect.combine.aligned_crossing_segments(
            ray_c.reshape(rows, out.width, n_terr), terr_c, n_terr - 1, 1), 2),
        "object_hits_pixelwise (8 objects)": cuda_ms(lambda: O.object_hits_pixelwise(
            r_objects, params.model, LAT0, LON0, step, n_terr, ray_c, plen_c, az_rays), 2),
    }
    t["terrain columns, fields, merge_hits, composite (derived)"] = chunk_ms - sum(t.values())
    for name, ms in t.items():
        say(f"[objects] rectilinear chunk stage {name}: {ms:.3f} ms ({100.0 * ms / chunk_ms:.1f}"
            f" % of the chunk's {chunk_ms:.3f} ms; x {n_chunks} chunks a frame)")
    del ray_c, plen_c

    # (d) small frames, card against CPU: validity flips; the tilted golden
    # object scene takes the dense path, whose march goes through K2
    from atm_raytracer_tpu_torch.config import Config

    tilted = golden_config("objects")
    tilted["view"]["frame"]["tilt"] = 1.0
    tilted["output"].update(width=small[0], height=small[1], generator="Rectilinear")
    cases = [(f"object headline {small[0]}x{small[1]} {g}", small_params, r)
             for g, r in (("Fast", fast.render_fast), ("Rectilinear", rect.render_rectilinear),
                          ("InterpolatingRectilinear", interp.render_interpolating))]
    cases.append((f"golden objects tilted 1 degree {small[0]}x{small[1]} (dense)",
                  Config.from_dict(tilted).into_params(terrain), rect.render_rectilinear))
    for name, p_, render in cases:
        reset_launches()
        gpu = render(p_, terrain, dev)
        torch.cuda.synchronize()
        k = kernel_launches()
        cpu = render(p_, terrain, "cpu")
        ok, fa, fb, mx = image_tolerance(gpu.image, cpu.image)
        flips = int((gpu.hits.valid.cpu() != cpu.hits.valid).sum())
        n_obj = int((gpu.hits.valid & (gpu.hits.kind == 1)).sum())
        check(ok, f"{name}: card vs CPU any={fa} big={fb}")
        check(k["march.cu"] > 0 and n_obj > 0, f"{name}: launches {k}, object hits {n_obj}")
        if "dense" in name:
            check(gpu.culled_rounds is None, f"{name}: took the culled path")
        say(f"[objects] {name}: card vs CPU any={fa:.5f} big={fb:.5f} max={mx}; valid "
            f"slots flipped {flips} of {gpu.hits.valid.numel()}; object hits {n_obj} (CPU "
            f"{int((cpu.hits.valid & (cpu.hits.kind == 1)).sum())}); launches {k}")
    say(f"[objects] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# K6's shapes: the benchmark's two object cells (portbench/configs), one
# 1080p frame each at 45 degrees with its stored objects
K6_SCENES = ("objects_1080p", "translucent_1080p")
K6_KERNELS = ("cull_scan_kernel", "window_tables_kernel", "widen_kernel",
              "object_pass_kernel")


def k6_kernels_ms(fn, reps: int = 10) -> dict:
    """Device ms of each of K6's four kernels, means over ``reps`` calls of
    ``fn`` (one K6 launch each), from a torch.profiler trace."""
    _, _, by_name = trace_busy_ms(lambda: [fn() for _ in range(reps)], "k6")
    out = {k: sum(v for n, v in by_name.items() if k in n) / reps for k in K6_KERNELS}
    check(all(v > 0 for v in out.values()), f"K6's kernels missing from the trace: {out}")
    return out


def k6_scene(dev, name: str, tmp):
    """(terrain, params) of the benchmark's configuration ``name`` looking at
    45 degrees, with the objects it stores."""
    from portbench import harness, scene

    config = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    keys, tiles = scene.make_tiles(config, dev)
    program = harness.Program()
    terrain = scene.build_terrain(program.Terrain, program.Tile, keys, tiles)
    texture = Path(tmp) / "checker64.png"
    scene.write_texture(texture)
    objects = harness.scene_objects(config, keys, tiles, texture, dev)
    return terrain, program.lower(scene.frame_dict(config["scene"], 45.0, 0.0, "Fast",
                                                   objects), terrain)


def pass_inputs(params, terrain, dev):
    """One Fast render of ``params`` and the arguments ``separable_hits``
    handed the object pass in it: (planes, objects, model, lat0, step,
    ray_h, path_len, dlat, dlon, windows, k_out)."""
    from atm_raytracer_tpu_torch.generators import fast

    seen = []
    real = fast.apply_objects_planes

    def keep(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    fast.apply_objects_planes = keep
    try:
        res = fast.render_fast(params, terrain, dev)
    finally:
        fast.apply_objects_planes = real
    check(len(seen) == 1, f"a Fast frame ran the object pass {len(seen)} times")
    return res, seen[0]


def k6_contract(tag: str, got, want):
    """K6's planes against the plain pass's, at the card tests' bar: validity
    equal, keys within 1e-5 of a step, every payload on valid slots within
    rtol 1e-5 / atol 1e-3, payload 0 on invalid slots. Returns (max |dkey|,
    max |dpayload| on valid slots, valid slots, object hits)."""
    from atm_raytracer_tpu_torch.ops import objects as O

    (gk, gv), (wk, wv) = got, want
    valid = wk.isfinite()
    flips = int((gk.isfinite() != valid).sum())
    check(flips == 0, f"{tag}: K6 and the plain pass differ in validity on {flips} slots")
    dk = float((gk - wk)[valid].abs().max())
    check(dk <= 1e-5, f"{tag}: K6's keys {dk} steps off the plain pass's")
    for c, nm in enumerate(O.PLANE_CHANNELS):
        g, w = gv[c][valid], wv[c][valid]
        bad = int((~((g - w).abs() <= 1e-3 + 1e-5 * w.abs())).sum())
        check(bad == 0, f"{tag}: K6's {nm} outside rtol 1e-5 / atol 1e-3 of the plain "
              f"pass's on {bad} valid slots")
    check(not gv[:, ~valid].any(), f"{tag}: K6 wrote a payload on an invalid slot")
    dv = float((gv - wv)[:, valid].abs().max())
    kind = O.PLANE_CHANNELS.index("kind")
    return dk, dv, int(valid.sum()), int((wv[kind][valid] > 0.5).sum())


def phase_k6(dev, renders: int = 5):
    """10b. K6 at the shapes of the benchmark's object cells. Returns its
    entry of the kernels line and the launches of its two counted frames."""
    import tempfile

    import torch

    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.generators import fast
    from atm_raytracer_tpu_torch.ops import objects as O

    t_phase = time.perf_counter()
    launches, by_scene = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        scenes = [(name, *k6_scene(dev, name, tmp)) for name in K6_SCENES]
    for name, terrain, params in scenes:
        tag = f"[k6] {name}"
        reset_launches()
        res, args = pass_inputs(params, terrain, dev)
        torch.cuda.synchronize()
        path = f"k6_{name}"
        launches[path] = kernel_launches()
        check(launches[path] == OBJECT_LAUNCHES, f"{tag}: launches {launches[path]}")
        planes, objects, model, lat0, step, ray_h, path_len, dlat, dlon, wins, k_out = args
        h_n, w_n, k_in = planes[0].shape
        # K6 against the plain pass, on the card and on the pass's own inputs
        before = _kernels.OBJECT_PASS.launches
        kept = []
        got = O.object_pass_cuda(*args, tables_out=kept)
        want = O.apply_objects_planes(*args, plain=True)
        check(_kernels.OBJECT_PASS.launches == before + 1,
              f"{tag}: K6 launched {_kernels.OBJECT_PASS.launches - before} times")
        dk, dv, n_valid, n_obj = k6_contract(name, got, want)
        bit_equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        check(n_obj > 0, f"{tag}: no object hit")
        plain_tables = O.object_column_tables(objects, model, lat0, dlat, dlon, wins)
        tables_equal = kept[0].windows == plain_tables.windows and all(
            torch.equal(getattr(kept[0], f), getattr(plain_tables, f))
            for f in ("k_lo", "seg_close", "terms"))
        check(tables_equal, f"{tag}: K6's tables differ from object_column_tables'")
        say(f"{tag}: [{h_n}, {w_n}] x {k_in} -> {k_out} slots, {objects.n_objects} objects "
            f"over {plain_tables.k_lo.shape[0]} window columns (seg_window "
            f"{objects.seg_window}): K6 vs plain on the card: validity equal, max |dkey| "
            f"{dk:.3g} step, max |dpayload| {dv:.3g} on {n_valid} valid slots ({n_obj} "
            f"object hits), bit-equal {bit_equal}; tables equal to object_column_tables")
        del got, want, kept, plain_tables
        # the frame, kernels against plain=True
        plain = fast.render_fast(params, terrain, dev, plain=True)
        ok, fa, fb, mx = image_tolerance(res.image, plain.image)
        same = float((plain.hits.valid == res.hits.valid).double().mean())
        check(ok and same >= 0.999, f"{tag}: frame kernels vs plain any={fa} big={fb}, "
              f"valid equal on {same}")
        del plain, res
        # times: the whole pass by CUDA events, its kernels by the profiler
        ms = cuda_ms(lambda: O.apply_objects_planes(*args), 20)
        kernels_ms = k6_kernels_ms(lambda: O.apply_objects_planes(*args))
        plain_ms = cuda_ms(lambda: O.apply_objects_planes(*args, plain=True), 3)
        plain_tables_ms = cuda_ms(lambda: O.object_column_tables(
            objects, model, lat0, dlat, dlon, wins), 5)
        # the bound: the planes read and written once, key and 13 payloads
        n_bytes = 4 * (1 + len(O.PLANE_CHANNELS)) * h_n * w_n * (k_in + k_out)
        bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
        med, walls = timed_walls(lambda: fast.render_fast(params, terrain, dev), renders)
        torch.cuda.reset_peak_memory_stats(dev)
        fast.render_fast(params, terrain, dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        say(f"{tag}: K6 {ms:.4f} ms (CUDA events, mean of 20; kernels "
            + ", ".join(f"{k} {v:.4f}" for k, v in kernels_ms.items())
            + f" ms by the profiler); plain pass {plain_ms:.3f} ms, its tables "
            f"{plain_tables_ms:.3f} ms; bound {bound_ms:.4f} ms by bytes ({n_bytes} B): "
            f"{100.0 * bound_ms / ms:.2f} % of the bound; frame wall median of {renders} "
            f"{med * 1e3:.3f} ms (frame kernels vs plain any={fa:.5f} big={fb:.5f} "
            f"max={mx}, valid equal on {100.0 * same:.4f} % of slots); peak device memory "
            f"{peak:.1f} MiB")
        by_scene[name] = {
            "shape": [h_n, w_n], "k_in": k_in, "k_out": k_out,
            "objects": objects.n_objects, "max_key_err": dk, "max_payload_err": dv,
            "max_abs_err": max(dk, dv), "bit_equal": bit_equal, "ms": ms,
            "kernels_ms": kernels_ms, "plain_ms": plain_ms,
            "plain_tables_ms": plain_tables_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bytes": n_bytes, "frame_wall_ms": med * 1e3, "peak_mib": peak}
    main = by_scene["translucent_1080p"]
    k6 = {"name": "K6 object_pass", "route": "cuda",
          "source": "atm_raytracer_tpu_torch/csrc/object_pass.cu",
          "replaces": "atm_raytracer_tpu/ops/objects.py:810",
          "max_abs_err": max(r["max_abs_err"] for r in by_scene.values()),
          "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
          "bound_by": "bytes", "library_ms": None, "by_scene": by_scene}
    say(f"[k6] phase wall {time.perf_counter() - t_phase:.1f} s")
    return k6, launches


# The BASELINE sweep (bench.py:405-410): 8 frames of 1280x720, fov 45, 100 km
# in 50 m steps, directions 0 ... 315 degrees, from the headline's observer
SWEEP_DIRS = tuple(45.0 * i for i in range(8))
SWEEP_SIZE = (1280, 720)
SWEEP_DISTANCE = 100_000.0


def sweep_config(direction=45.0):
    config = headline_config(*SWEEP_SIZE, max_distance=SWEEP_DISTANCE, fov=45.0)
    config.view.frame.direction = direction
    return config


def phase_sweep(dev, terrain, renders=5):
    """11. the batched sweep: one K2 and one K1 launch for 8 frames, the
    wall, the device's idle share, the peak memory, each frame against its
    single render, both kernels at the sweep's shapes against their plain
    versions and bounds; then a sweep with every frame its own atmosphere,
    altitude, tilt and fov (K2 reading a table a frame). Returns (the
    counted sweep's launches, each kernel's numbers at the sweep's shapes)."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import fast
    from atm_raytracer_tpu_torch.models import camera
    from atm_raytracer_tpu_torch.ops import combine
    from atm_raytracer_tpu_torch.parallel import mesh as M
    from atm_raytracer_tpu_torch.physics import ray as R
    from atm_raytracer_tpu_torch.physics.atmosphere import AtmosphereDef, LinearFunction, us_76

    t_phase = time.perf_counter()
    params = sweep_config().into_params(terrain)
    out, frame, pos = params.output, params.view.frame, params.view.position
    w_n, h_n, f_n = out.width, out.height, len(SWEEP_DIRS)
    one = M.make_mesh([dev])

    def sweep(**kw):
        frames = M.render_sweep_sharded(params, terrain, one, SWEEP_DIRS, **kw)
        torch.cuda.synchronize()
        return frames

    # (a) the main path, counted; this first sweep is also the warm-up
    reset_launches()
    t0 = time.perf_counter()
    frames = sweep()
    first = time.perf_counter() - t0
    launches = kernel_launches()
    check(launches == FAST_LAUNCHES,
          f"sweep: launches {launches}, want one of each kernel for {f_n} frames")
    check(frames.shape == (f_n, h_n, w_n, 3), f"sweep frames {frames.shape}")
    walls = []
    for _ in range(renders):
        t0 = time.perf_counter()
        sweep()
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    say(f"[sweep] {f_n} frames of {w_n}x{h_n}, fov 45, {SWEEP_DISTANCE / 1e3:.0f} km in 50 m "
        f"steps, directions {SWEEP_DIRS[0]:.0f}..{SWEEP_DIRS[-1]:.0f}: launches {launches}; "
        f"first sweep {first:.3f} s; wall median {med * 1e3:.3f} ms of {renders} (min "
        f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}), frames on the host: "
        f"{f_n / med:.2f} frames/s")
    busy_ms, n_rec, by_name = trace_busy_ms(sweep, "sweep")
    say(f"[sweep] device busy {busy_ms:.3f} ms a sweep ({n_rec} device records, one "
        f"sweep traced); idle share of the median wall {1.0 - busy_ms / (med * 1e3):.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"[sweep]   {ms:9.3f} ms  {name[:90]}")
    torch.cuda.reset_peak_memory_stats(dev)
    sweep()
    say(f"[sweep] peak device memory of one sweep: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")

    # every frame against render_fast of that frame on the card
    moved = []
    for f, d in enumerate(SWEEP_DIRS):
        single = fast.render_fast(sweep_config(d).into_params(terrain), terrain, dev).image
        moved.append(int((frames[f] != single).any(-1).sum()))
    check(sum(moved) == 0, f"sweep frames vs single renders: pixels moved {moved}")
    say(f"[sweep] each frame vs render_fast of it on the card: pixels moved {moved}")

    # both kernels on the sweep's own inputs, as separable_hits builds them
    alt0 = float(pos.abs_altitude(terrain))
    step, n_terr = float(params.simulation_step), int(math.ceil(SWEEP_DISTANCE / 50.0))
    n_seg = n_terr - 1
    shape = params.model.to_shape()
    table = fast.build_refraction_table(params, alt0, dev)
    pack = terrain.pack(*fast.terrain_bbox(params), dev)
    elev = camera.fast_ray_elevations(w_n, h_n, frame.fov, frame.tilt).astype(np.float32)
    az_rel = camera.fast_ray_azimuths(w_n, h_n, frame.fov, 0.0).astype(np.float32)
    az = np.float32(SWEEP_DIRS)[:, None] + az_rel[None, :]
    elev_rows = torch.from_numpy(np.tile(elev, f_n)).to(dev)
    alt_rows = torch.full_like(elev_rows, alt0)
    ray_h, _, k2_err, k2_p_err, k2_node_err, k2_p_ulp = k2_rows_check(
        table, elev_rows, alt_rows, shape, step, n_terr, "sweep", rays_per_frame=h_n)
    ray3 = ray_h.reshape(f_n, h_n, n_terr)
    terr3 = fast.terrain_columns(pack, params.model, torch.from_numpy(az.reshape(-1)).to(dev),
                                 LAT0, LON0, step, n_terr)[0].reshape(f_n, w_n, n_terr)
    segs_k, env_k = combine.crossing_segments_envelopes_cuda(ray3, terr3, n_seg, 1)
    segs_p = combine.terrain_crossing_segments_plain(ray3, terr3, n_seg, 1)
    env_p = combine.crossing_envelopes_plain(ray3, terr3, n_seg)
    check(torch.equal(segs_k, segs_p), "sweep: K1's segments differ from the plain ones")
    check(all(torch.equal(a, b) for a, b in zip(env_k, env_p)),
          "sweep: K1's envelopes differ from crossing_envelopes_plain")
    limit = combine.ray_death_limit(ray3, n_seg)
    tests = sum(k1_work(segs_p[f], limit[f], tuple(e[f] for e in env_p), n_seg)["tests"]
                for f in range(f_n))
    k1_ms = cuda_ms(lambda: combine.crossing_segments_cuda(ray3, terr3, n_seg, 1), 10)
    k1_plain = cuda_ms(lambda: combine.terrain_crossing_segments_plain(
        ray3, terr3, n_seg, 1), 1)
    k1_b, k1_by, k1_bytes, k1_ops = k1_bound(h_n, w_n, n_seg, tests, frames=f_n)
    rows_kw = dict(shape=shape, straight=False, step=step, n_terr=n_terr, rays_per_frame=h_n)
    k2_ms = cuda_ms(lambda: fast.march_rows(table, elev_rows, alt_rows, **rows_kw), 10)
    k2_plain = cuda_ms(lambda: fast.march_rows(table, elev_rows, alt_rows, plain=True,
                                               **rows_kw), 1)
    k2_b, k2_by, k2_bytes, k2_ops_n = k2_bound(f_n * h_n, n_seg, R.march_coarse(step), table)
    say(f"[sweep] K1 (one launch over [{f_n}, {h_n}, {w_n}] x {n_seg}): segments and "
        f"envelopes equal to plain ({int((segs_p < n_seg).sum())} hits); {k1_ms:.4f} ms vs "
        f"plain {k1_plain:.3f} ms; tests in live chunks {tests}; bound {k1_b:.4f} ms by "
        f"{k1_by} ({k1_bytes} B, {k1_ops} operations): {100.0 * k1_b / k1_ms:.1f} % of the "
        f"bound")
    say(f"[sweep] K2 (one launch, {f_n * h_n} rays x {n_seg} steps, shared fit): {k2_ms:.4f} "
        f"ms vs plain {k2_plain:.3f} ms; h max |dh| {k2_err:.3g} m, nodes {k2_node_err:.3g} "
        f"m (limit {K2_ATOL}), h == Hermite fill of its nodes, p {k2_p_err:.3g} m vs plain "
        f"and {k2_p_ulp:.1f} ulp vs its own h; bound {k2_b:.4f} ms by {k2_by} ({k2_bytes} B, "
        f"{k2_ops_n} operations): {100.0 * k2_b / k2_ms:.1f} % of the bound")
    del ray_h, ray3, terr3, segs_k, segs_p, env_k, env_p

    # (b) every frame its own atmosphere, altitude, tilt and fov: US-76 and
    # tests/test_parallel.py:129-136's inversion in turn, +0 ... +700 m,
    # -2 ... +2 degrees, fov 20 ... 45
    inversion = AtmosphereDef(first_temperature_function=LinearFunction(0.02),
                              temperature_fixed_point=(0.0, 283.15))
    atms = [us_76(), inversion] * (f_n // 2)
    alts = [alt0 + 100.0 * i for i in range(f_n)]
    tilts = [float(x) for x in np.linspace(-2.0, 2.0, f_n)]
    fovs = [float(x) for x in np.linspace(20.0, 45.0, f_n)]
    varied = dict(altitudes_m=alts, atmospheres=atms, tilts_deg=tilts, fovs_deg=fovs)
    reset_launches()
    t0 = time.perf_counter()
    frames_v = sweep(**varied)
    first_v = time.perf_counter() - t0
    launches_v = kernel_launches()
    check(launches_v == FAST_LAUNCHES,
          f"varied sweep: launches {launches_v}, want one of each kernel")
    t0 = time.perf_counter()
    again = sweep(**varied)
    wall_v = time.perf_counter() - t0
    check(np.array_equal(again, frames_v), "varied sweep: two runs differ")
    check(all((frames_v[f] != frames_v[f + 1]).any() for f in range(f_n - 1)),
          "varied sweep: neighbouring frames alike")
    alt_max = float(np.float32(alts).max())
    tables = [fast.build_refraction_table(params, alt_max, dev, a) for a in atms]
    stacked = R.RefractionTable.stack(tables)
    elev_v = np.stack([camera.fast_ray_elevations(w_n, h_n, fv, t) for fv, t in
                       zip(np.float32(fovs), np.float32(tilts))]).astype(np.float32)
    alt_v = torch.from_numpy(np.repeat(np.float32(alts), h_n)).to(dev)
    _, _, v_err, v_p_err, v_node_err, v_ulp = k2_rows_check(
        stacked, torch.from_numpy(elev_v.reshape(-1)).to(dev), alt_v, shape, step, n_terr,
        "per-frame tables", rays_per_frame=h_n)
    v_ms = cuda_ms(lambda: fast.march_rows(stacked, torch.from_numpy(elev_v.reshape(-1)).to(
        dev), alt_v, **rows_kw), 10)
    v_b, v_by, _, _ = k2_bound(f_n * h_n, n_seg, R.march_coarse(step), stacked)
    say(f"[sweep] varied (atmospheres alternating US-76 and an inversion, +0..+"
        f"{alts[-1] - alt0:.0f} m, tilt {tilts[0]:.1f}..{tilts[-1]:.1f}, fov "
        f"{fovs[0]:.0f}..{fovs[-1]:.0f}): launches {launches_v}; wall {wall_v * 1e3:.3f} ms "
        f"after a {first_v:.3f} s first sweep; K2 reading {stacked.values.shape[0]} tables of "
        f"{stacked.values.shape[1]} by stride: {v_ms:.4f} ms (bound {v_b:.4f} ms by {v_by}), "
        f"h max |dh| {v_err:.3g} m vs plain, nodes {v_node_err:.3g} m, h == Hermite fill of "
        f"its nodes, p {v_p_err:.3g} m and {v_ulp:.1f} ulp")
    say(f"[sweep] phase wall {time.perf_counter() - t_phase:.1f} s")
    at_sweep = {
        "combine.cu": {"shape": f"[{f_n}, {h_n}, {w_n}] x {n_seg}", "ms": k1_ms,
                       "plain_ms": k1_plain, "bound_ms": k1_b, "bound_by": k1_by,
                       "tests": tests},
        "march.cu": {"shape": f"{f_n * h_n} rays x {n_seg}", "ms": k2_ms, "plain_ms": k2_plain,
                     "bound_ms": k2_b, "bound_by": k2_by, "max_abs_err": k2_err,
                     "per_frame_tables_ms": v_ms, "per_frame_tables_bound_ms": v_b},
        "wall_ms": med * 1e3, "frames_per_s": f_n / med, "busy_ms": busy_ms,
    }
    return launches, at_sweep


def phase_multi_device(dev, terrain, params, small=(192, 108), small_distance=200_000.0):
    """12. the multi-device modes over ``[dev, dev]``: each equal to its
    one-device render (image, hit mask, keys): Fast and Interpolating at the
    1080p headline (``params``), Rectilinear at ``small`` at tilt 0 (rows
    split) and 1 degree (pixels split; the one-device dense render), then
    ``dryrun_multichip(4, dev)``."""
    import torch

    from atm_raytracer_tpu_torch.generators.fast import render_fast
    from atm_raytracer_tpu_torch.generators.interpolating import render_interpolating
    from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear
    from atm_raytracer_tpu_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    two = M.make_mesh([dev, dev])
    small_params = {t: headline_params(*small, max_distance=small_distance, tilt=t)
                    for t in (0.0, 1.0)}
    size = f"{params.output.width}x{params.output.height}"
    cases = [
        (f"Fast {size}", M.render_fast_sharded, render_fast, params),
        (f"Interpolating {size}", M.render_interpolating_sharded, render_interpolating,
         params),
        (f"Rectilinear {small[0]}x{small[1]} tilt 0 (rows split)",
         M.render_rectilinear_sharded, render_rectilinear, small_params[0.0]),
        (f"Rectilinear {small[0]}x{small[1]} tilt 1 (pixels split)",
         M.render_rectilinear_sharded,
         lambda p, t, d: render_rectilinear(p, t, d, cull=False), small_params[1.0]),
    ]
    for name, split, single, p in cases:
        reset_launches()
        t0 = time.perf_counter()
        got = split(p, terrain, two)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        launches = kernel_launches()
        want = single(p, terrain, dev)
        moved = int((got.image != want.image).any(-1).sum())
        check(moved == 0 and torch.equal(got.hits.valid, want.hits.valid)
              and torch.equal(got.hits.key, want.hits.key),
              f"{name} over [{dev}, {dev}]: {moved} pixels moved vs one device, or hits differ")
        say(f"[multi-device] {name} over [{dev}, {dev}]: equal to the one-device render "
            f"(image, hit mask, keys; {int(got.hits.valid.sum())} hits) in {took:.3f} s; "
            f"launches {launches}")
        if "pixels split" in name:
            # the split takes the dense path (K2, never K4); the one-device
            # frame's default path is the culled one, its capture K4
            check(launches["rect_culled.cu"] == 0 and launches["march.cu"] > 0,
                  f"{name}: launches {launches}")
            reset_launches()
            culled = render_rectilinear(p, terrain, dev)
            torch.cuda.synchronize()
            k4 = kernel_launches()["rect_culled.cu"]
            v = culled.hits.valid
            dk = float((culled.hits.key[v] - got.hits.key[v]).abs().max()) if v.any() else 0.0
            check(k4 == culled.culled_rounds and torch.equal(v, got.hits.valid)
                  and dk <= 1e-3, f"{name}: the one-device culled render ({k4} K4 launches, "
                  f"{culled.culled_rounds} rounds) against the split: masks equal "
                  f"{torch.equal(v, got.hits.valid)}, max |dkey| {dk}")
            say(f"[multi-device] {name}: the one-device culled render through K4 ({k4} "
                f"launches, one a round) has the split's hit mask, max |dkey| {dk:.3g}")
    del got, want
    M.dryrun_multichip(4, dev)  # prints its line
    say(f"[multi-device] phase wall {time.perf_counter() - t_phase:.1f} s")




def host_ms(fn, reps: int = 20):
    """(median, min, max) host milliseconds of ``fn()`` ending in a
    synchronize, over ``reps`` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), min(walls), max(walls)


def per_field_artifact(hits):
    """The artifact compaction as it was before the batched fetch: one
    ``.cpu()`` a field (and one for the words), each a sync."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.meta.serialize import PACKED_FIELDS

    vflat = hits.valid.reshape(-1)
    p = vflat.shape[0]
    idx = torch.nonzero(vflat).squeeze(1)
    words = torch.nn.functional.pad(vflat.to(torch.int64), (0, (-p) % 32))
    pow2 = torch.pow(2, torch.arange(32, dtype=torch.int64, device=vflat.device))
    bits = (words.reshape(-1, 32) * pow2).sum(dim=1)
    segments = {}
    for name in PACKED_FIELDS:
        x = getattr(hits, name)
        segments[name] = x.reshape((p,) + x.shape[hits.valid.ndim:]).index_select(
            0, idx).cpu().numpy()
    segments["kind"] = segments["kind"].astype(np.uint8)
    return bits.cpu().numpy().astype(np.uint32), int(idx.shape[0]), segments


def frame_codec(tag, valid, image, sky, reps=10):
    """``pack_frame_compact`` of one frame, or of F frames on a leading axis,
    on the card: the bytes shipped against raw, device ms, the fetch, the
    host decode ms, a bit-exact reconstruction and the CPU's pack of the
    same inputs equal. Returns the numbers."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import base
    from atm_raytracer_tpu_torch.meta import pack as P

    frames = image if image.ndim == 4 else image[None]
    valids = valid if valid.ndim == 4 else valid[None]
    f_n, h, w = frames.shape[0], frames.shape[1], frames.shape[2]

    def ship():
        bits, img_n, img_ei, img_ev, counts = P.pack_frame_compact(valids, frames)
        cts = counts.tolist()  # the one sync: the counts
        segs = [bits]
        for f in range(f_n):
            n_px, *nes = cts[f]
            for c in range(3):
                segs += [img_n[f, c, :(n_px + 1) // 2], img_ei[f, c, :nes[c]],
                         img_ev[f, c, :nes[c]]]
        return cts, base.fetch_flat_many(segs)

    def decode(cts, outs):
        words = outs[0].reshape(f_n, -1)
        return [P.unpack_frame_compact(
            words[f], [tuple(outs[1 + 9 * f + 3 * c: 4 + 9 * f + 3 * c]) for c in range(3)],
            sky, h, w, cts[f][0]) for f in range(f_n)]

    device_ms = cuda_ms(lambda: P.pack_frame_compact(valids, frames), reps)
    cts, outs = ship()
    decoded = decode(cts, outs)
    want = frames.cpu().numpy()
    check(all(np.array_equal(d, want[f]) for f, d in enumerate(decoded)),
          f"{tag}: the compact frame codec did not reconstruct the frame bit for bit")
    card = P.pack_frame_compact(valids, frames)
    cpu = P.pack_frame_compact(valids.cpu(), frames.cpu())
    for name, a, b in zip(("bits", "img_n", "img_ei", "img_ev", "counts"), card, cpu):
        check(torch.equal(a.cpu(), b), f"{tag}: the card's {name} differs from the CPU's pack")
    decode_walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode(cts, outs)
        decode_walls.append((time.perf_counter() - t0) * 1e3)
    route_ms = host_ms(lambda: decode(*ship()), 20)[0]
    raw_ms = host_ms(lambda: base.fetch_flat(frames), 20)[0]
    shipped = sum(int(o.nbytes) for o in outs)
    raw = int(frames.numel())
    n_px = sum(c[0] for c in cts)
    numbers = {"frames": f_n, "hit_px": n_px, "bytes_shipped": shipped, "bytes_raw": raw,
               "device_ms": device_ms, "decode_ms": statistics.median(decode_walls),
               "codec_route_ms": route_ms, "raw_fetch_ms": raw_ms,
               "exceptions": sum(sum(c[1:]) for c in cts)}
    say(f"[transfer] codec {tag}: {f_n} frame(s) of {w}x{h}, {n_px} hit pixels; "
        f"{shipped} B shipped against {raw} B raw ({shipped / raw:.3f}); pack "
        f"{device_ms:.3f} ms on the device (CUDA events, mean of {reps}); host decode "
        f"{numbers['decode_ms']:.3f} ms (median of 5); pack + counts + fetch + decode "
        f"{route_ms:.3f} ms against the raw fetch_flat {raw_ms:.3f} ms (medians of 20); "
        f"{numbers['exceptions']} exceptions; bit-exact; the card's payload == the CPU's")
    return numbers


def phase_transfer(dev, terrain, params):
    """13. the transfer group: (a) ``fetch_flat`` of the Fast headline image
    and of the sweep's frames against ``.cpu()``, and ``_pack_artifact``'s
    one batched fetch against the per-field copies; (b)
    ``render_fast_streamed`` at the 1080p headline, bands 8: equal to
    ``render_fast``, one K2 and eight K1 launches, 8 progress lines, no
    host sync in the band loop (``torch.cuda.set_sync_debug_mode("error")``),
    the median wall of 20 beside ``render_fast``'s in turns, device busy,
    idle share and the ``Memcpy DtoH`` time that overlaps kernels on
    another stream from a profiler trace of one render; (c) the codecs:
    ``pack_frame_compact`` on the headline frame and on the sweep's 8
    frames, ``fetch_viewer_fields``, ``_separable`` and ``_delta`` at the
    headline. Returns the launches of the counted streamed render."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import base, fast
    from atm_raytracer_tpu_torch.meta import pack as P
    from atm_raytracer_tpu_torch.meta.serialize import PACKED_FIELDS, _pack_artifact
    from atm_raytracer_tpu_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    summary = {}
    # (a) the fetches
    r = fast.render_fast(params, terrain, dev, fetch_image=False)
    img = r.image
    frames, sweep_valid = M.render_sweep_sharded(
        sweep_config().into_params(terrain), terrain, [dev], SWEEP_DIRS,
        return_hits="valid", fetch_frames=False)
    torch.cuda.synchronize()
    for tag, t in (("headline image", img), ("sweep frames", frames)):
        check(np.array_equal(base.fetch_flat(t), t.cpu().reshape(-1).numpy()),
              f"fetch_flat of the {tag} differs from .cpu()")
        buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)

        def reused(t=t, buf=buf):
            buf.copy_(t.reshape(-1), non_blocking=True)
            torch.cuda.current_stream().synchronize()
            return buf.numpy().copy()

        pinned, pageable, reuse = (host_ms(fn) for fn in (
            lambda t=t: base.fetch_flat(t), lambda t=t: t.cpu(), reused))
        n_bytes = t.numel() * t.element_size()
        summary[tag] = {"bytes": n_bytes, "fetch_flat_ms": pinned[0], "cpu_ms": pageable[0],
                        "reused_pinned_copy_out_ms": reuse[0]}
        say(f"[transfer] {tag}, {n_bytes} B: fetch_flat (a pinned buffer a call) median "
            f"{pinned[0]:.3f} ms (min {pinned[1]:.3f}, max {pinned[2]:.3f}); .cpu() "
            f"(pageable) {pageable[0]:.3f} ms (min {pageable[1]:.3f}, max {pageable[2]:.3f}); "
            f"one reused pinned buffer copied out {reuse[0]:.3f} ms; medians of 20; "
            f"{n_bytes / pinned[0] / 1e6:.2f} GB/s pinned; bytes equal")
    bits, n, seg = _pack_artifact(r.hits)
    bits_o, n_o, seg_o = per_field_artifact(r.hits)
    check(np.array_equal(bits, bits_o) and n == n_o and all(
        np.array_equal(seg[k], seg_o[k]) and seg[k].dtype == seg_o[k].dtype
        for k in PACKED_FIELDS), "_pack_artifact differs from the per-field copies")
    many = host_ms(lambda: _pack_artifact(r.hits))
    each = host_ms(lambda: per_field_artifact(r.hits))
    summary["artifact"] = {"slots": n, "fetch_flat_many_ms": many[0], "per_field_ms": each[0]}
    say(f"[transfer] artifact compaction, {n} slots: one fetch_flat_many {many[0]:.3f} ms "
        f"against 9 per-field .cpu() {each[0]:.3f} ms (medians of 20); every array equal")

    # (b) the banded render
    plain = fast.render_fast(params, terrain, dev)
    hit_fields = [f.name for f in dataclasses.fields(plain.hits)]
    real_bands = fast._stream_bands

    def no_sync(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_bands(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    lines = []
    torch.cuda.synchronize()
    reset_launches()
    fast._stream_bands = no_sync
    try:
        got = fast.render_fast_streamed(params, terrain, dev, bands=8, progress=lines.append)
    except RuntimeError as e:
        check(False, f"streamed: the band loop synced: {e}")
    finally:
        fast._stream_bands = real_bands
    torch.cuda.synchronize()
    launches = kernel_launches()
    check(launches == {"combine.cu": 8, "march.cu": 1, "rect_scan.cu": 0,
                       "rect_culled.cu": 0, "object_pass.cu": 0, "rect_exact.cu": 0},
          f"streamed: launches {launches}, want 8 K1 and 1 K2")
    check(lines == [12, 25, 38, 50, 62, 75, 88, 100], f"streamed: progress {lines}")
    check(np.array_equal(got.image, plain.image),
          f"streamed: image differs from render_fast "
          f"({int((got.image != plain.image).any(-1).sum())} pixels)")
    for f in hit_fields:
        check(torch.equal(getattr(got.hits, f), getattr(plain.hits, f)),
              f"streamed: hits.{f} differs from render_fast")
    say(f"[transfer] streamed {params.output.width}x{params.output.height}, bands 8: "
        f"launches {launches}; progress {lines}; no sync in the band loop; image and all "
        f"{len(hit_fields)} hit fields torch.equal to render_fast")

    runs = {"render_fast": lambda: fast.render_fast(params, terrain, dev),
            "streamed": lambda: fast.render_fast_streamed(params, terrain, dev)}
    walls = {k: [] for k in runs}
    for fn in runs.values():
        fn()
    for i in range(20):  # in turns, the order rotating
        names = list(runs)[i % len(runs):] + list(runs)[:i % len(runs)]
        for k in names:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[k]()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    for k, ws in walls.items():
        med = statistics.median(ws)
        events = trace_events(runs[k], "transfer")
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
        busy = busy_us(spans) / 1e3
        kernels = [(e, (float(e["ts"]), float(e["ts"]) + float(e["dur"]))) for e in events
                   if e.get("cat") == "kernel"]
        copies = [(e, (float(e["ts"]), float(e["ts"]) + float(e["dur"]))) for e in events
                  if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]]
        dtoh = sum(b - a for _, (a, b) in copies) / 1e3
        overlap = 0.0
        for e, (a, b) in copies:
            stream = e.get("args", {}).get("stream")
            for s0, s1 in merged([sp for k_e, sp in kernels
                                  if k_e.get("args", {}).get("stream") != stream]):
                overlap += max(0.0, min(b, s1) - max(a, s0))
        streams = (sorted({str(e.get("args", {}).get("stream")) for e, _ in kernels}),
                   sorted({str(e.get("args", {}).get("stream")) for e, _ in copies}))
        summary[k] = {"wall_ms": med, "busy_ms": busy, "idle": 1.0 - busy / med,
                      "dtoh_ms": dtoh, "dtoh_overlapping_kernels_ms": overlap / 1e3,
                      "records": len(events)}
        say(f"[transfer] {k}: wall median {med:.3f} ms of 20 (min {min(ws):.3f}, max "
            f"{max(ws):.3f}); one render traced: device busy {busy:.3f} ms, idle share "
            f"{1.0 - busy / med:.4f}, Memcpy DtoH {dtoh:.3f} ms in {len(copies)} records, "
            f"{overlap / 1e3:.3f} ms of it under kernels on another stream (kernel "
            f"streams {streams[0]}, DtoH streams {streams[1]})")

    # (c) the codecs
    sky = P.frame_base_rgb(params.coloring, params.view.fog_distance)
    summary["codec headline"] = frame_codec("headline", plain.hits.valid, img, sky)
    summary["codec sweep"] = frame_codec("sweep", sweep_valid, frames, sky)
    step = float(params.simulation_step)
    hits = r.hits
    host = {f: getattr(hits, f).cpu().numpy() for f in ("key", "dlat", "dlon", "elevation")}
    valid = np.isfinite(host["key"])
    rng = {f: float(host[f][valid].max() - host[f][valid].min()) for f in host}

    vf = P.fetch_viewer_fields(hits, step)
    check(np.array_equal(vf.valid, valid) and np.array_equal(vf.key, host["key"]),
          "fetch_viewer_fields: valid or key differ")
    for f, levels_bits in (("dlat", 22), ("dlon", 22), ("elevation", 15)):
        err = float(np.abs(getattr(vf, f)[valid] - host[f][valid]).max())
        check(err <= max(rng[f], 1e-30 if levels_bits == 22 else 1.0) * 2.0 ** -levels_bits,
              f"fetch_viewer_fields: {f} off by {err}")
    sep, (img_h,) = P.fetch_viewer_fields_separable(r, params.model, step, co_fetch=(img,))
    check(np.array_equal(img_h, plain.image.reshape(-1)), "co-fetched image differs")
    check(np.array_equal(sep.valid, valid) and np.array_equal(sep.key[valid],
                                                              host["key"][valid]),
          "fetch_viewer_fields_separable: valid or key differ")
    check(float(np.abs(sep.elevation[valid] - host["elevation"][valid]).max())
          <= max(rng["elevation"], 1.0) * 2.0 ** -15, "separable: elevation out of band")
    sep_err = max(float(np.abs(getattr(sep, f)[valid] - host[f][valid].astype(np.float64))
                        .max()) for f in ("dlat", "dlon"))
    check(sep_err < 1.5e-6, f"separable: derived lat/lon off by {sep_err} degrees")
    v3, frame3, stats = P.fetch_viewer_fields_delta(r, params.model, step, sky)
    check(np.array_equal(frame3, plain.image), "fetch_viewer_fields_delta: image differs")
    check(np.array_equal(v3.valid, valid) and np.array_equal(v3.elevation, sep.elevation),
          "delta: valid or elevation differ from the separable pack")
    key_err = float(np.abs(v3.key[valid] - sep.key[valid]).max())
    ll_err = max(float(np.abs(getattr(v3, f)[valid] - getattr(sep, f)[valid]).max())
                 for f in ("dlat", "dlon"))
    check(key_err <= 0.5 / P._KEY_QUANT + 1e-5 and ll_err < 2.8e-6,
          f"delta: key off by {key_err}, lat/lon by {ll_err}")
    times = {k: host_ms(fn, 5)[0] for k, fn in (
        ("dense", lambda: P.fetch_viewer_fields(hits, step)),
        ("separable", lambda: P.fetch_viewer_fields_separable(r, params.model, step)),
        ("delta", lambda: P.fetch_viewer_fields_delta(r, params.model, step, sky)))}
    summary["viewer"] = {"slots": int(valid.size), "valid": int(valid.sum()),
                         "dense_bytes": vf.nbytes, "separable_bytes": sep.nbytes,
                         "delta_bytes": stats["staged_bytes"], **{f"{k}_ms": v for k, v
                                                                  in times.items()}}
    say(f"[transfer] viewer fields at the headline ({valid.size} slots, {int(valid.sum())} "
        f"valid): dense {vf.nbytes} B {times['dense']:.3f} ms; separable {sep.nbytes} B "
        f"{times['separable']:.3f} ms, lat/lon within {sep_err:.2e} deg; delta "
        f"{stats['staged_bytes']} B with the frame {times['delta']:.3f} ms ({stats['n_exceptions']}"
        f" exceptions), key within {key_err:.2e} steps, image equal (medians of 5, "
        f"each with its pack, sync and decode); the JAX tests' tolerances hold")
    say(f"[transfer] {json.dumps(summary)}")
    wall = time.perf_counter() - t_phase
    say(f"[transfer] phase wall {wall:.1f} s")
    return launches


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        say("FAIL: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this check needs a GPU")
        return 1
    wall_only = argv[:1] == ["--fast-wall"]
    if argv and not (wall_only and len(argv) == 2):
        say("usage: chip_smoke.py [--fast-wall PACKAGE_ROOT]")
        return 2
    pkg_root = Path(argv[1]).resolve() if wall_only else ROOT
    sys.path.insert(0, str(pkg_root))
    try:
        import atm_raytracer_tpu_torch
    except ImportError as e:
        say(f"FAIL: no atm_raytracer_tpu_torch package in {pkg_root} ({e})")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    if wall_only:  # the parent comparison: one tree's Fast headline wall
        say(f"[fast-wall] package {Path(atm_raytracer_tpu_torch.__file__).parent}")
        phase_device()
        params = headline_params()
        terrain = headline_terrain(params)
        from atm_raytracer_tpu_torch.generators.fast import render_fast

        render_fast(params, terrain, dev)
        torch.cuda.synchronize()
        fast_walls(dev, params, terrain, 20)
        return 0
    try:
        name = phase_device()
        phase_build()
        params = headline_params()
        t0 = time.perf_counter()
        terrain = headline_terrain(params)
        say(f"[headline] {len(terrain._loaded)} tiles of 1201 posts built in "
            f"{time.perf_counter() - t0:.1f} s")
        files_launches = phase_terrain_files(dev, terrain)
        phase_kernels(dev)
        phase_k3(dev, terrain)
        phase_goldens(dev)
        kernels, wall_s, fast_launches = phase_headline(dev, params, terrain)
        phase_profile(dev, params, terrain, wall_s)
        phase_rect_small(dev, terrain)
        k3, rect_launches = phase_rect_headline(dev, params, terrain)
        kernels.append(k3)
        k4, k5, tilted_launches = phase_rect_culled(dev, terrain)
        kernels += [k4, k5]
        phase_metadata(dev, terrain)
        interp_launches, at_grid = phase_interpolating(dev, terrain)
        obj_launches = phase_objects(dev, terrain)
        k6, k6_launches = phase_k6(dev)
        kernels.append(k6)
        sweep_launches, at_sweep = phase_sweep(dev, terrain)
        phase_multi_device(dev, terrain, params)
        streamed_launches = phase_transfer(dev, terrain, params)
        for k in kernels:  # the launches of every counted main-path render
            src = Path(k["source"]).name
            k["launches_by_path"] = {"fast": fast_launches[src],
                                     "fast_from_files": files_launches[src],
                                     "rectilinear": rect_launches[src],
                                     "rectilinear_tilted": tilted_launches[src],
                                     "interpolating": interp_launches[src],
                                     **{path: n[src] for path, n in obj_launches.items()},
                                     **{path: n[src] for path, n in k6_launches.items()},
                                     "sweep": sweep_launches[src],
                                     "fast_streamed": streamed_launches[src]}
            k["launches"] = sum(k["launches_by_path"].values())
            k["at_interpolating_grid"] = at_grid.get(src)
            k["at_sweep"] = at_sweep.get(src)
    except SmokeFailure as e:
        say(f"FAIL: {e}")
        return 1
    check_jax = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    if check_jax:
        say(f"FAIL: jax was imported: {check_jax[:3]}")
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
