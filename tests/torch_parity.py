"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; state
crosses from the JAX package through ``atm_raytracer_tpu_torch.interop``.
"""

import math

import numpy as np
import pytest

M_PER_DEG = 111_194.9  # tests/fixtures.py: spherical meters per degree


def objects_golden_config(generator="Fast", tilt=0.0):
    """The objects golden scene of tests/test_golden.py as a config dict,
    without JAX (the card tests import no JAX): three objects 0.7-2 km
    north of 49.5/21.5 over the terrain folder ".". ``tilt`` tilts it."""
    def obj(dist_m, az_deg, shape, color):
        az = math.radians(az_deg)
        return {
            "position": {
                "latitude": 49.5 + dist_m * float(np.cos(az)) / M_PER_DEG,
                "longitude": 21.5 + dist_m * float(np.sin(az)) / M_PER_DEG
                / float(np.cos(np.radians(49.5))),
                "altitude": {"Relative": 0.0},
            },
            "color": color,
            "shape": shape,
        }

    return {
        "scene": {"terrain_folder": ".", "objects": [
            obj(700.0, -4.0, {"Cylinder": {"radius": 25.0, "height": 200.0}},
                {"r": 0.1, "g": 0.2, "b": 0.9, "a": 0.6}),
            obj(1200.0, 3.0, {"Cylinder": {"radius": 30.0, "height": 150.0}},
                {"r": 0.9, "g": 0.1, "b": 0.1}),
            obj(2000.0, -1.0, {"Cone": {"radius": 40.0, "height": 120.0}},
                {"r": 0.1, "g": 0.8, "b": 0.2}),
        ]},
        "view": {
            "position": {"latitude": 49.5, "longitude": 21.5, "altitude": {"Relative": 30.0}},
            "frame": {"direction": 0.0, "fov": 30.0, "max_distance": 8000.0, "tilt": tilt},
            "coloring": {"Shading": {"water_level": -100.0}},
        },
        "straight_rays": False,
        "simulation_step": 50.0,
        "output": {"width": 64, "height": 48, "file": "out.png", "generator": generator},
    }


def parallel_config(terrain_folder=".", **frame):
    """The scene of tests/test_parallel.py (72x40, fov 18, 8 km in 100 m
    steps, 25 m over 49.5/21.5 looking 30 degrees) as a config dict, with
    ``frame`` overriding view.frame keys."""
    return {
        "scene": {"terrain_folder": str(terrain_folder)},
        "view": {
            "position": {"latitude": 49.5, "longitude": 21.5,
                         "altitude": {"Relative": 25.0}},
            "frame": {"direction": 30.0, "fov": 18.0, "max_distance": 8000.0, **frame},
        },
        "simulation_step": 100.0,
        "output": {"width": 72, "height": 40},
    }


def parallel_object(dist_m, color, shape):
    """An object ``dist_m`` out at azimuth 30 degrees from the parallel
    scene's observer, on the ground."""
    az = math.radians(30.0)
    return {
        "position": {
            "latitude": 49.5 + dist_m / M_PER_DEG * math.cos(az),
            "longitude": 21.5 + dist_m / M_PER_DEG * math.sin(az)
            / math.cos(math.radians(49.5)),
            "altitude": {"Relative": 0.0},
        },
        "color": color,
        "shape": shape,
    }


# the earth models whose geodesics plan the objects' column windows: one of
# each calculator (sphere, Vincenty, the two flat ones, the AE projection)
WINDOW_SHAPES = {
    "Spherical": {"Spherical": {"radius": 6_371_000.0}},
    "Wgs84": "Wgs84",
    "FlatDistorted": "FlatDistorted",
    "AzimuthalEquidistant": "AzimuthalEquidistant",
    "ObserverAe": {"ObserverAe": {"proj_radius": 6_371_000.0}},
}

# the Fast grids of the window tests: a small one, and the benchmark's
# 1080p grid over 200 km in 50 m steps ([1920, 2000] geodesic points, two
# chunks of objects), where a column's distance comes closest to its limit
WINDOW_GRIDS = {
    "64_columns": {},
    "1080p": {"width": 1920, "max_distance": 200_000.0, "step": 50.0},
}

# the seeded objects' roles, by index in ``seeded_objects_config``'s list
SEEDED_PAIR, SEEDED_BEHIND, SEEDED_BEYOND = (4, 5), 6, 7


def seeded_objects_config(shape, seed, width=64, max_distance=25_000.0, step=100.0):
    """A Fast scene of 8 seeded objects placed along ``shape``'s own
    geodesics, every altitude absolute (no terrain needed to lower it):
    four in view; two on one bearing at 30 % and 60 % of ``max_distance``,
    whose column windows overlap (``SEEDED_PAIR``); one behind the camera
    (``SEEDED_BEHIND``) and one past ``max_distance`` on the view's centre
    bearing (``SEEDED_BEYOND``), both out of view."""
    from atm_raytracer_tpu_torch.models.earth import EarthModel

    model = EarthModel.from_config(shape)
    rng = np.random.default_rng(seed)
    direction, fov = 45.0, 30.0
    half = fov / 2.0 - 2.0
    pair_az = float(rng.uniform(direction - half, direction + half))
    placed = [(float(rng.uniform(direction - half, direction + half)),
               float(rng.uniform(0.1, 0.8)) * max_distance) for _ in range(4)]
    placed += [(pair_az, 0.3 * max_distance), (pair_az, 0.6 * max_distance),
               (direction + 180.0, 0.2 * max_distance), (direction, 1.6 * max_distance)]
    objects = []
    for i, (az, dist) in enumerate(placed):
        lat, lon = model.coords_at_dist_host(49.5, 21.5, az, dist)
        radius = float(rng.uniform(20.0, 80.0))
        kind = "Cylinder" if i % 2 == 0 else "Cone"
        objects.append({
            "position": {"latitude": float(lat), "longitude": float(lon),
                         "altitude": {"Absolute": 200.0}},
            "color": {"r": 0.9, "g": 0.1, "b": 0.1},
            "shape": {kind: {"radius": radius, "height": 150.0}},
        })
    return {
        "scene": {"terrain_folder": ".", "objects": objects},
        "earth_shape": shape,
        "view": {
            "position": {"latitude": 49.5, "longitude": 21.5, "altitude": {"Absolute": 300.0}},
            "frame": {"direction": direction, "fov": fov, "max_distance": max_distance,
                      "tilt": 0.0},
            "coloring": {"Shading": {"water_level": -100.0}},
        },
        "straight_rays": False,
        "simulation_step": step,
        "output": {"width": width, "height": 48, "file": "out.png", "generator": "Fast"},
    }


def fast_window_args(params):
    """(lat0, lon0, azimuths, step, n_terr): the arguments after the model
    that ``object_col_windows`` takes for ``params``' Fast grid."""
    from atm_raytracer_tpu_torch.models import camera

    out, frame, pos = params.output, params.view.frame, params.view.position
    az = camera.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    return (float(pos.latitude), float(pos.longitude), az, float(params.simulation_step),
            n_terr)


def verify_tolerance(a, b):
    """The on-chip verify tolerance of bench.py:548-551 on two u8 images:
    (ok, fraction of pixels that moved at all, fraction moved > 2 counts)."""
    pix = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max(axis=-1)
    frac_any = float((pix > 0).mean())
    frac_big = float((pix > 2).mean())
    return frac_big <= 0.01 and frac_any <= 0.05, frac_any, frac_big


def cull_fan(seed, h_n, w_n, n_seg, above, extra=0):
    """A combine fan whose ray tiles lie far above (``above``) or far below
    the terrain for whole chunks, then cross it near sample 0.55·n_seg, each
    row a little later: each branch of K1's envelope cull fires. The terrain
    may run ``extra`` samples past the rays."""
    rng = np.random.default_rng(seed)
    k = np.arange(n_seg + 1)[None, :]
    k_x = int(0.55 * n_seg) + 3 * np.arange(h_n)[:, None]
    ramp = np.maximum(k - k_x, 0) * rng.uniform(2.0, 4.0, (h_n, 1))
    ray = ((300.0 - ramp) if above else (-100.0 + ramp)) + rng.normal(0.0, 2.0, ramp.shape)
    n_t = n_seg + 1 + extra
    terr = (100.0 + 30.0 * np.sin(np.arange(n_t) / 5.0)[None, :]
            + rng.uniform(-5.0, 5.0, (w_n, n_t)))
    return ray.astype(np.float32), terr.astype(np.float32)


def split_fit(poly):
    """A fit of more segments than the march kernel keeps in registers: each
    segment of ``poly`` cut in three with its coefficients kept, the second
    segment's first piece one sample wide (lo == hi, the zero-width edge
    piece whose division the kernel cannot take on its fast path)."""
    out = []
    for i, (lo, hi, c) in enumerate(poly):
        m1, m2 = lo + round((hi - lo) / 3), lo + round(2 * (hi - lo) / 3)
        if i == 1:
            out.append((lo, lo, c))
            lo += 1.0
        out += [(lo, m1 - 1.0, c), (m1, m2 - 1.0, c), (m2, hi, c)]
    return tuple(out)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    return torch.device("cuda")
