#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --fast-wall PACKAGE_ROOT   # one tree's Fast headline wall

The second form times only the Fast headline (median of 20 renders after a
warm-up) with the ``atm_raytracer_tpu_torch`` package found under
PACKAGE_ROOT, e.g. an unpacked parent commit, for comparisons in turns.

Runs from the root of a checkout of this repository, on a machine with one
CUDA GPU, ``nvcc`` and PyTorch built for CUDA, PyYAML and Pillow (the
metadata phase writes the npz artifact's YAML config and a PNG). Imports
nothing of JAX. Phases, each printed as it ends; any failure exits non-zero
before the result line:

1. device   — the card's name, and its power limit from nvidia-smi;
2. build    — both CUDA kernels built from ``atm_raytracer_tpu_torch/csrc``;
3. kernels  — each kernel against its plain PyTorch version on the card:
              K1 (combine) segments equal on ragged random fans, K = 1 and 4,
              on the path-death and deep-terrain cases, on two fans where
              each branch of the envelope cull fires (ray tiles above, then
              below, the terrain for whole chunks before crossing) and on a
              crossing at a chunk's last segment; K1's envelopes equal to
              ``crossing_envelopes_plain`` (torch.equal) on every case; K2
              (march) nodes within 2e-2 m for the poly and table l(h),
              sphere and flat;
4. goldens  — the three golden Fast scenes and the three golden Rectilinear
              scenes, plus the golden scene tilted onto the Rectilinear
              culled path (1 degree, opaque) and its pixelwise path (-1
              degree, translucent; its march goes through K2), rendered on
              the card and with the plain path on the CPU, within the
              verify tolerance;
5. headline — 1920x1080, fov 40, 200 km in 50 m steps, refracted, spherical,
              over 45 synthetic 1201-post tiles: the render goes through both
              kernels (launch counts), matches the plain path on the card,
              and is timed (median frame wall of 20 renders after a
              warm-up), with each kernel's time beside its plain version's
              and its bound at the headline shapes; K1's work counted: the
              sign tests the per-pixel scan needs (T_need), the live and
              total chunks, the tests in live chunks, and no first
              crossing in a culled chunk;
6. profile  — a torch.profiler trace of the headline (device busy time,
              idle share, top kernels), stage times by CUDA events and the
              peak device memory;
7. rectilinear — the Rectilinear generator (no kernel of its own yet) on
              the headline scene: (a) at 192x108 on the card against the
              CPU; (b) at 1920x1080, tilt 0: median frame wall of 5 renders
              after a warm-up, peak device memory, device busy time and idle
              share from a torch.profiler trace of one render, CUDA-event
              stage times, and the K = 1 keys equal to the first keys of a
              K = 2 render; (c) at tilt 1 degree through the culled path:
              one timed render after a warm-up with its round count, and at
              192x108 the culled keys equal to the dense path's (plain
              march);
8. metadata — the headline's artifact, npz and reference ``.dat``: saved,
              loaded and re-composited on the card bit for bit, every field
              exact (the render counted through both kernels); the
              compaction on the card equal to the CPU's; ``view --pixel
              --save-image`` on the card; the translucent headline (K = 4)
              as npz; the 8192x2048 / fov 120 / 150 km artifact written and
              read, timed, with the peak device memory; ``output-ray-paths``
              on the card (through K2, counted) against the CPU.

The verify tolerance (the JAX package's bench.py verify): at most 1 % of
pixels differ by more than 2 counts and at most 5 % differ at all.

Output: the kernels line ``{"kernels": [...]}`` and, last, the result line
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
    from atm_raytracer_tpu_torch import _kernels

    for k in _kernels.KERNELS:
        t0 = time.perf_counter()
        k.function()
        took = time.perf_counter() - t0
        say(f"[build] {k.source}: {took:.2f} s (nvcc {k.build_seconds} s)")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"[build]   {line.strip()}")


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
            say(f"[kernels] K2 {poly_name} {sname}: max |dh| {err:.3g} m "
                f"(v {float((vk - vp).abs().max()):.3g})")


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
    return cfg


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
        say(f"[goldens] {name}: cuda vs cpu plain any={fa:.4f} big={fb:.4f} "
            f"max={mx} (culled rounds {gpu.culled_rounds}, launches {launches})")


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


def headline_config(width=1920, height=1080, max_distance=200_000.0, step=50.0,
                    tilt=0.0, fov=40.0):
    from atm_raytracer_tpu_torch.config import Config

    return Config.from_dict({
        "view": {
            "position": {"latitude": LAT0, "longitude": LON0,
                         "altitude": {"Relative": 100.0}},
            "frame": {"direction": 45.0, "fov": fov, "max_distance": max_distance,
                      "tilt": tilt},
        },
        "simulation_step": step,
        "output": {"width": width, "height": height},
    })


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


def k2_ops(n_rays: int, n_coarse: int, n_poly: int) -> int:
    """Float32 operations of csrc/march.cu's loop with the Chebyshev l(h),
    counted from the source (each +, -, *, /, min, max, compare one): an
    eval_l is 35 + 3·n_poly (clamp 2, segment search 3 a segment, t 6,
    Clenshaw 6 x 4, last step 3); a step is three eval_l, four accel of 11,
    4 for the stage heights of l2 and l4, 12 for the stage slopes and
    heights, 14 for the update of h and v."""
    return n_rays * n_coarse * (3 * (35 + 3 * n_poly) + 4 * 11 + 4 + 12 + 14)


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
    for src, count in launches.items():
        check(count > 0, f"{src}: no launch in the headline render")

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
    h_n, w_n = ray_h.shape[0], terr.shape[0]
    k1_bytes = 4 * ((h_n + w_n) * (n_seg + 1) + h_n * w_n + h_n)
    k1_ops = 3 * work["tests"] + 2 * (h_n + w_n) * (n_seg + 1)  # tests; envelope min, max
    k1_bound_ms, k1_bound_by = bound(k1_bytes, k1_ops)

    coarse = R.march_coarse(step)
    n_coarse = -(-(n_terr - 1) // coarse)
    dx = float(step * coarse)
    alt = torch.full_like(elev, alt0)
    v0 = R.initial_slope(alt, torch.deg2rad(elev), shape)
    hk, _ = R.march_nodes(alt, v0, dx, n_coarse, table, shape.radius)
    hp, _ = R.march_nodes_plain(alt, v0, dx, n_coarse, table, shape.radius)
    k2_err = float((hk - hp).abs().max())
    check(k2_err <= K2_ATOL, f"K2 headline nodes differ by {k2_err} m")

    k1_ms = cuda_ms(lambda: combine.crossing_segments_cuda(ray_h, terr, n_seg, 1), 20)
    k1_plain_ms = cuda_ms(
        lambda: combine.terrain_crossing_segments_plain(ray_h, terr, n_seg, 1), 2)
    k2_ms = cuda_ms(lambda: R.march_nodes(alt, v0, dx, n_coarse, table, shape.radius), 20)
    k2_plain_ms = cuda_ms(
        lambda: R.march_nodes_plain(alt, v0, dx, n_coarse, table, shape.radius), 2)
    # the two kernels' own device time, without the wrapper's death limit;
    # with the rays lifted above all terrain every chunk is culled, which
    # leaves the cost of walking the grid
    k1_env_ms, k1_seg_ms = k1_kernels_ms(ray_h, terr, n_seg)
    sky_env_ms, sky_seg_ms = k1_kernels_ms(ray_h + 1e5, terr, n_seg)
    say(f"[headline] K1 kernels alone (profiler, mean of 20): envelopes {k1_env_ms:.4f} ms "
        f"+ segments {k1_seg_ms:.4f} ms; the wrapper by CUDA events {k1_ms:.4f} ms; "
        f"segments with every chunk culled (rays +1e5 m) {sky_seg_ms:.4f} ms")
    n_poly = len(table.poly)
    k2_bytes = 4 * (2 * h_n + 10 * n_poly + 2 * h_n * (n_coarse + 1))
    k2_bound_ms, k2_bound_by = bound(k2_bytes, k2_ops(h_n, n_coarse, n_poly))
    say(f"[headline] K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.3f} ms "
        f"([{out.height}, {out.width}] x {n_seg} segments); bound {k1_bound_ms:.4f} ms "
        f"by {k1_bound_by} ({k1_bytes} B, {k1_ops} float32 operations): "
        f"{100.0 * k1_bound_ms / k1_ms:.1f} % of the bound")
    say(f"[headline] K2 {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms "
        f"({out.height} rays x {n_coarse} steps, {n_poly} Chebyshev segments, max |dh| "
        f"{k2_err:.3g} m); bound {k2_bound_ms:.4f} ms by {k2_bound_by} ({k2_bytes} B, "
        f"{k2_ops(h_n, n_coarse, n_poly)} float32 operations): "
        f"{100.0 * k2_bound_ms / k2_ms:.2f} % of the bound")
    kernels = [
        {"name": "K1 crossing_segments", "route": "cuda",
         "source": "atm_raytracer_tpu_torch/csrc/combine.cu",
         "replaces": "atm_raytracer_tpu/experimental/combine_pallas.py:89",
         "launches": launches["combine.cu"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": None, "tests": work["tests"],
         "device_ms": k1_env_ms + k1_seg_ms},
        {"name": "K2 march_nodes", "route": "cuda",
         "source": "atm_raytracer_tpu_torch/csrc/march.cu",
         "replaces": "atm_raytracer_tpu/experimental/march_pallas.py:18",
         "launches": launches["march.cu"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": None},
    ]
    return kernels, med


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + ((cur_e - cur_s) if cur_e is not None else 0.0)


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
        "march (K2 + Hermite + cumsum)": cuda_ms(lambda: fast.march_rows(
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
    t["image to host"] = cuda_ms(lambda: image.cpu(), reps)
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
    The trace file is parsed and deleted: one Rectilinear frame is ~2·10^5
    records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace = out_dir / f"{name}_trace.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    trace.unlink()
    check(bool(events), f"the profiler recorded no device activity ({name})")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
    by_name: dict = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    return busy_us(spans) / 1e3, len(events), by_name


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
    """(b): the 1920x1080 tilt-0 Rectilinear headline."""
    import numpy as np
    import torch

    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    out = params.output
    n_terr = int(math.ceil(params.view.frame.max_distance / params.simulation_step))
    # the Rectilinear main path, counted; this first render is the warm-up
    reset_launches()
    t0 = time.perf_counter()
    result = rect.render_rectilinear(params, terrain, dev)
    torch.cuda.synchronize()
    say(f"[rectilinear] first render {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {kernel_launches()} (the tilt-0 path has no kernel of its own yet)")
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

    # stage times: each stage alone, CUDA-event means
    pack = terrain.pack(*rect.terrain_bbox(params), dev)
    alt0 = float(params.view.position.abs_altitude(terrain))
    table = rect.build_refraction_table(params, alt0, dev)
    az = torch.from_numpy(rect.camera.rectilinear_column_azimuths(
        out.width, params.view.frame.fov, params.view.frame.direction
    ).astype(np.float32)).to(dev)
    step = float(params.simulation_step)
    coarse = rect.march_coarse(step)
    scan_kw = dict(shape=params.model.to_shape(), table=table, straight=False,
                   step=step, n_seg=n_terr - 1, coarse=coarse)
    elev_hw, _ = rect.camera.rectilinear_ray_params_device(
        out.width, out.height, params.view.frame.fov, 0.0, 0.0, dev)
    terr, normal = rect.terrain_columns(pack, params.model, az, LAT0, LON0, step, n_terr)
    n_pad = -(-(n_terr - 1) // coarse) * coarse + 1 - n_terr
    terr_pad = torch.nn.functional.pad(terr, (0, n_pad))
    stacked = torch.cat([terr[..., None], normal], dim=-1)
    found = rect.first_window_scan(elev_hw, terr_pad, alt0, **scan_kw)
    key, plh = rect.first_hit_retest(*found, terr_pad, **scan_kw)
    hit_kw = dict(model=params.model, lat0=LAT0, lon0=LON0, step=step,
                  terrain_alpha=float(params.terrain_alpha))
    hits = rect.column_hits(stacked, key, plh, az, **hit_kw)
    image_t = rect._composite_hits(params.coloring, params.view.fog_distance, hits)
    t = {
        "terrain columns": cuda_ms(lambda: rect.terrain_columns(
            pack, params.model, az, LAT0, LON0, step, n_terr), 3),
        "scan (march_scan_light + window test)": cuda_ms(
            lambda: rect.first_window_scan(elev_hw, terr_pad, alt0, **scan_kw), 1),
        "post-scan re-expansion + exact test": cuda_ms(
            lambda: rect.first_hit_retest(*found, terr_pad, **scan_kw), 3),
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
    return med


def phase_rect_culled(dev, terrain):
    """(c): the tilt-1 headline through the culled path."""
    import torch

    from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear

    params = headline_params(tilt=1.0)
    t0 = time.perf_counter()
    warm = render_rectilinear(params, terrain, dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    result = render_rectilinear(params, terrain, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(torch.equal(result.hits.key, warm.hits.key), "culled path: two renders differ")
    frac_hit = float(result.hits.valid.double().mean())
    check(0.05 < frac_hit < 0.95, f"culled headline: implausible hit fraction {frac_hit}")
    say(f"[rectilinear] headline tilt 1 (culled): wall {wall * 1e3:.3f} ms after a "
        f"{first * 1e3:.3f} ms warm-up, {result.culled_rounds} rounds, hit fraction "
        f"{frac_hit:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")


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
        check(all(n > 0 for n in launches.values()),
              f"metadata: the render missed a kernel: {launches}")
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
        phase_kernels(dev)
        phase_goldens(dev)
        params = headline_params()
        t0 = time.perf_counter()
        terrain = headline_terrain(params)
        say(f"[headline] {len(terrain._loaded)} tiles of 1201 posts built in "
            f"{time.perf_counter() - t0:.1f} s")
        kernels, wall_s = phase_headline(dev, params, terrain)
        phase_profile(dev, params, terrain, wall_s)
        phase_rect_small(dev, terrain)
        phase_rect_headline(dev, params, terrain)
        phase_rect_culled(dev, terrain)
        phase_metadata(dev, terrain)
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
