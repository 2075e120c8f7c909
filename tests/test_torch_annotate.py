"""Parity of the PyTorch port's annotation overlays with the JAX package:
the ``fast_plain_annotated`` golden from the port's CPU render, and the
overlays drawn by both packages on one image (ticks, vertical ticks, the
eye-level line, the flat-Earth horizon), on separable and per-pixel angle
grids.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_golden as G  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.render.annotate import annotate_image as j_annotate  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators.fast import render_fast  # noqa: E402
from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear  # noqa: E402
from atm_raytracer_tpu_torch.render import annotate as A  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402
from torch_parity import verify_tolerance  # noqa: E402

ANNOTATED_OUTPUT = {  # tests/test_golden.py::test_golden_annotated
    "width": 160, "height": 100,
    "ticks": [
        {"Multiple": {"bias": 0.0, "step": 10.0, "size": 10, "labelled": True}},
        {"Multiple": {"bias": 0.0, "step": 2.0, "size": 5, "labelled": False}},
    ],
    "vertical_ticks": [
        {"Multiple": {"bias": 0.0, "step": 2.0, "size": 10, "labelled": True}},
    ],
    "show_eye_level": True,
}


@pytest.fixture(scope="module")
def terrain_dir(tmp_path_factory):
    return make_terrain_folder(tmp_path_factory.mktemp("torch_annotate"),
                               tiles=((49, 21),), n=181)


def _params(cfg, terrain_dir):
    tt = TTerrain.from_folder(terrain_dir)
    jt = JTerrain.from_folder(terrain_dir)
    return (TConfig.from_dict(cfg).into_params(tt), tt,
            JConfig.from_dict(cfg).into_params(jt))


def test_fast_plain_annotated_golden(terrain_dir):
    from PIL import Image

    cfg = G._base_config()
    cfg["scene"]["terrain_folder"] = str(terrain_dir)
    cfg["output"].update(ANNOTATED_OUTPUT)
    params, terrain, _ = _params(cfg, terrain_dir)
    result = render_fast(params, terrain, "cpu")
    img = A.annotate_image(result.image, params, result.elevation_deg,
                           result.azimuth_deg, result.observer[2])
    golden = np.asarray(Image.open(G.GOLDEN_DIR / "fast_plain_annotated.png").convert("RGB"))
    ok, frac_any, frac_big = verify_tolerance(img, golden)
    assert ok, (frac_any, frac_big)
    np.testing.assert_array_equal(img, golden)  # bit-exact on the CPU


OVERLAYS = {
    "golden_ticks": ({}, ANNOTATED_OUTPUT),
    "single_ticks": ({}, {
        "ticks": [{"Single": {"azimuth": 40.0, "size": 12, "labelled": True}},
                  {"Single": {"azimuth": 50.25, "size": 6, "labelled": True}},
                  {"Single": {"azimuth": 40.0, "size": 4, "labelled": False}}],
        "vertical_ticks": [{"Single": {"elevation": -2.5, "size": 8, "labelled": True}},
                           {"Multiple": {"bias": 0.5, "step": 3.0, "size": 5,
                                         "labelled": False}}],
    }),
    "wrap_north": ({"view": {"frame": {"direction": 2.0, "fov": 30.0,
                                       "max_distance": 25000.0}}}, {
        "ticks": [{"Multiple": {"bias": 0.0, "step": 5.0, "size": 7, "labelled": True}},
                  {"Single": {"azimuth": -5.0, "size": 9, "labelled": True}}],
        "show_eye_level": True,
    }),
    "flat_horizon": ({"earth_shape": "FlatDistorted"}, {
        "show_flat_horizon": True, "show_eye_level": True,
        "vertical_ticks": [{"Multiple": {"bias": 0.0, "step": 1.0, "size": 6,
                                         "labelled": True}}],
    }),
}


@pytest.mark.parametrize("generator", ["Fast", "Rectilinear"])
@pytest.mark.parametrize("case", list(OVERLAYS))
def test_overlays_match_jax(case, generator, terrain_dir):
    """Both packages draw on the same image with the same angle grids: the
    same pixels (Rectilinear gives per-pixel [H, W] grids)."""
    over, output = OVERLAYS[case]
    cfg = G._base_config(**over)
    cfg["scene"]["terrain_folder"] = str(terrain_dir)
    cfg["output"].update(output)
    cfg["output"]["generator"] = generator
    params, terrain, jparams = _params(cfg, terrain_dir)
    render = render_fast if generator == "Fast" else render_rectilinear
    result = render(params, terrain, "cpu")
    args = (result.elevation_deg, result.azimuth_deg, result.observer[2])
    got = A.annotate_image(result.image, params, *args)
    want = j_annotate(result.image, jparams, *args)
    np.testing.assert_array_equal(got, want)
    assert (got != result.image).any()
    if case == "flat_horizon":  # drawn: flat shape, refraction on
        assert (got == A.FLAT_HORIZON_COLOR).all(-1).any()
        assert (got == A.EYE_LEVEL_COLOR).all(-1).any()


def test_flat_horizon_needs_flat_refracted_scene(terrain_dir):
    """No flat-horizon line on a sphere or with straight rays (mod.rs:416-431)."""
    for over in ({}, {"earth_shape": "FlatDistorted", "straight_rays": True}):
        cfg = G._base_config(**over)
        cfg["scene"]["terrain_folder"] = str(terrain_dir)
        cfg["output"]["show_flat_horizon"] = True
        params, terrain, _ = _params(cfg, terrain_dir)
        result = render_fast(params, terrain, "cpu")
        img = A.annotate_image(result.image, params, result.elevation_deg,
                               result.azimuth_deg, result.observer[2])
        np.testing.assert_array_equal(img, result.image)


@pytest.mark.parametrize("x,want", [(1.0, 0), (2.5, 1), (0.125, 3), (1 / 3, 10)])
def test_num_decimals(x, want):
    assert A.num_decimals(x) == want
