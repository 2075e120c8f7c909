"""Parity of the PyTorch port's Rectilinear generator with the JAX package.

Camera grids, the RK4 window pieces and both fused scans take the same
inputs (numpy, from a seed) in both packages; the three golden Rectilinear
scenes and the golden scene tilted onto the culled and the pixelwise paths
render on the CPU with the port's plain path and must sit within the verify
tolerance (bench.py:548-551) of the JAX render and of the committed PNG,
with the hit fields within the bounds below. The rest holds the port's own
invariants: the K = 1 re-expansion reproduces the scan's fine samples
bitwise, the culled path finds the dense path's hits, and the multi-hit
slots agree with the single-hit render.
"""

import copy
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_golden as G  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators.rectilinear import render_rectilinear as j_render  # noqa: E402
from atm_raytracer_tpu.models import camera as JC  # noqa: E402
from atm_raytracer_tpu.physics import ray as JR  # noqa: E402
from atm_raytracer_tpu.physics.atmosphere import Atmosphere, us_76  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu.terrain.store import Tile as JTile  # noqa: E402
from atm_raytracer_tpu_torch import interop  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear as t_render  # noqa: E402
from atm_raytracer_tpu_torch.models import camera as TC  # noqa: E402
from atm_raytracer_tpu_torch.physics import ray as TR  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Tile as TTile  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402
from torch_parity import verify_tolerance  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
R = 6_371_000.0
RECT_SCENES = ("plain", "translucent", "flat_straight")
# the golden scene tilted onto the other two Rectilinear paths
TILTED = {"culled": ("plain", 2.0), "pixelwise": ("translucent", -1.0)}


# -- camera -----------------------------------------------------------------

CAMERAS = [(64, 48, 25.0, 0.0, 45.0), (33, 20, 40.0, 2.0, 200.0),
           (16, 12, 25.0, -2.0, -170.0)]


@pytest.mark.parametrize("cam", CAMERAS, ids=lambda c: f"tilt{c[3]}_dir{c[4]}")
def test_camera_host_grids_match_jax(cam):
    w, h, fov, tilt, direction = cam
    te, td = TC.rectilinear_ray_params(w, h, fov, tilt, direction)
    je, jd = JC.rectilinear_ray_params(w, h, fov, tilt, direction)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-12)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-12)
    assert not te.flags.writeable  # memoized: shared with later callers
    np.testing.assert_allclose(TC.rectilinear_column_azimuths(w, fov, direction),
                               JC.rectilinear_column_azimuths(w, fov, direction),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("cam", CAMERAS, ids=lambda c: f"tilt{c[3]}_dir{c[4]}")
def test_camera_device_twin_within_four_ulp(cam):
    """The float32 twin against the JAX package's: the same algebra on the
    same float32 constants, but XLA's and torch's asin/atan2 each round
    within ~2 ulp of the exact value, on either side, so they agree within
    4 ulp (3 measured); both within 1e-6 rad of the host f64 grid."""
    w, h, fov, tilt, direction = cam
    je, jd = JC.rectilinear_ray_params_device(w, h, fov, tilt, direction)
    te, td = TC.rectilinear_ray_params_device(w, h, fov, tilt, direction, "cpu")
    he, hd = TC.rectilinear_ray_params(w, h, fov, tilt, direction)
    for t, j, host in ((te, je, he), (td, jd, hd)):
        assert t.dtype == torch.float32 and t.shape == (h, w)
        j = np.asarray(j, np.float32)
        ulp = np.spacing(np.abs(j))
        assert (np.abs(t.numpy() - j) <= 4 * ulp).all()
        np.testing.assert_allclose(t.numpy(), host, rtol=0, atol=1e-6)


# -- the RK4 window and the fused scans ---------------------------------------

@pytest.fixture(scope="module")
def tables():
    jt = JR.RefractionTable.build(Atmosphere(us_76()), 530e-9)
    tt = interop.table_from_arrays(
        np.asarray(jt.h0), np.asarray(jt.inv_dh), np.asarray(jt.values), jt.poly, "cpu"
    )
    return jt, tt


def _rays(seed, n=7):
    rng = np.random.default_rng(seed)
    h = rng.uniform(20.0, 400.0, n).astype(np.float32)
    v = rng.uniform(-0.02, 0.02, n).astype(np.float32)
    p = rng.uniform(0.0, 5000.0, n).astype(np.float32)
    return h, v, p


@pytest.mark.parametrize("straight", [False, True])
@pytest.mark.parametrize("sphere", [True, False])
def test_rk4_step_quad_and_window_match_jax(tables, sphere, straight):
    jt, tt = tables
    radius = R if sphere else None
    h, v, p = _rays(1)
    th, tv, tp = (torch.from_numpy(x) for x in (h, v, p))
    jh, jv, jp = JR._rk4_step_quad(jnp.asarray(h), jnp.asarray(v), jnp.asarray(p),
                                   jnp.float32(800.0), jt, radius, straight)
    qh, qv, qp = TR._rk4_step_quad(th, tv, tp, 800.0, None if straight else tt, radius)
    np.testing.assert_allclose(qh.numpy(), np.asarray(jh), rtol=0, atol=1e-3)
    np.testing.assert_allclose(qv.numpy(), np.asarray(jv), rtol=0, atol=1e-7)
    np.testing.assert_allclose(qp.numpy(), np.asarray(jp), rtol=0, atol=1e-3)

    jout = JR.rk4_window(jnp.asarray(h), jnp.asarray(v), jnp.asarray(p), 50.0, 16,
                         jt, straight, radius)
    tout = TR.rk4_window(th, tv, tp, 50.0, 16, tt, straight, radius)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-3)
    # the (h, h') of both step forms are the same values
    assert torch.equal(tout[2], qh) and torch.equal(tout[3], qv)


def _scan_rays():
    # shallow rays plus two that plunge below DEATH_ALTITUDE mid-march
    return np.deg2rad(np.array([-0.3, -0.05, 0.0, 0.2, -12.0, -25.0])).astype(np.float32)


def test_march_scan_light_nodes_match_jax(tables):
    jt, tt = tables
    elev = _scan_rays()
    n_steps, coarse, step = 300, 16, 50.0
    n_coarse = -(-n_steps // coarse)
    coeffs = JR.hermite_coeffs(coarse)
    dxw = jnp.float32(step * coarse)

    def j_consumer(carry, k0, nodes, alive0):
        h0, v0, h1, v1, p0 = nodes
        i = k0 // coarse
        carry = tuple(c.at[i].set(x) for c, x in zip(carry, (h0, v0, p0, alive0)))
        win = [JR.hermite_plane(h0, v0 * dxw, h1, v1 * dxw, coeffs, j)
               for j in range(coarse)]
        return carry, jnp.min(jnp.stack(win), axis=0)

    z = jnp.zeros((n_coarse, elev.size), jnp.float32)
    j_out = jax.jit(lambda e: JR.march_scan_light(
        100.0, e, step, n_steps, JR.EarthShape(R), jt, False, j_consumer,
        (z, z, z, jnp.zeros((n_coarse, elev.size), bool)), coarse=coarse,
        pass_nodes=True))(jnp.asarray(elev))

    seen = []
    tcoeffs = TR.hermite_coeffs(coarse)

    def t_consumer(carry, k0, nodes, alive0):
        h0, v0, h1, v1, p0 = nodes
        seen.append((k0, h0, v0, p0, alive0))
        win = [TR.hermite_plane(h0, v0 * float(dxw), h1, v1 * float(dxw), tcoeffs, j)
               for j in range(coarse)]
        return carry, torch.stack(win).amin(0)

    TR.march_scan_light(100.0, torch.from_numpy(elev), step, n_steps,
                        TR.EarthShape(R), tt, False, t_consumer, None, coarse=coarse)
    assert [s[0] for s in seen] == [i * coarse for i in range(n_coarse)]
    for f, atol in ((1, 1e-3), (2, 1e-6), (3, 1e-3)):
        got = torch.stack([s[f] for s in seen]).numpy()
        np.testing.assert_allclose(got, np.asarray(j_out[f - 1]), rtol=0, atol=atol)
    alive = torch.stack([s[4] for s in seen]).numpy()
    np.testing.assert_array_equal(alive, np.asarray(j_out[3]))
    assert not alive[-1, -1]  # the steepest ray died


def test_march_scan_windows_match_jax(tables):
    jt, tt = tables
    elev = _scan_rays()
    n_steps, coarse, step = 300, 16, 50.0
    n_coarse = -(-n_steps // coarse)
    b = elev.size

    def j_consumer(carry, k0, h_f, plen_f, alive, v):
        i = k0 // coarse
        return tuple(c.at[i].set(x) for c, x in zip(carry, (h_f, plen_f, alive, v)))

    init = (jnp.zeros((n_coarse, b, coarse + 1)), jnp.zeros((n_coarse, b, coarse + 1)),
            jnp.zeros((n_coarse, b, coarse), bool), jnp.zeros((n_coarse, b)))
    j_out = jax.jit(lambda e: JR.march_scan(
        100.0, e, step, n_steps, JR.EarthShape(R), jt, False, j_consumer, init,
        coarse=coarse, with_slope=True))(jnp.asarray(elev))

    seen = []
    TR.march_scan(100.0, torch.from_numpy(elev), step, n_steps, TR.EarthShape(R), tt,
                  False, lambda c, k0, *xs: seen.append(xs), None, coarse=coarse,
                  with_slope=True)
    assert len(seen) == n_coarse
    for f, atol in ((0, 1e-3), (1, 1e-3), (3, 1e-6)):
        got = torch.stack([s[f] for s in seen]).numpy()
        np.testing.assert_allclose(got, np.asarray(j_out[f]), rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(torch.stack([s[2] for s in seen]).numpy(),
                                  np.asarray(j_out[2]))


def test_hermite_plane_bitwise_equals_window():
    rng = np.random.default_rng(3)
    h, v, h1, v1 = (torch.from_numpy(rng.uniform(-50.0, 900.0, (5, 9)).astype(np.float32))
                    for _ in range(4))
    v, v1 = v * 1e-4, v1 * 1e-4
    coarse, dxw = 16, 800.0
    cube = TR.hermite_window(h, v, h1, v1, dxw, coarse)
    coeffs = TR.hermite_coeffs(coarse)
    for j in range(coarse + 1):
        assert torch.equal(TR.hermite_plane(h, v * dxw, h1, v1 * dxw, coeffs, j),
                           cube[..., j])


def test_first_hit_reexpansion_is_bitwise_the_scan(tables):
    """The K = 1 post-scan re-expansion from a captured window-start state
    reproduces the scan-time fine planes and window-end nodes exactly."""
    _, tt = tables
    coarse, step = 16, 50.0
    dxw = TR._f32(step * coarse)
    coeffs = TR.hermite_coeffs(coarse)
    elev = torch.from_numpy(_scan_rays()[:4]).reshape(2, 2)  # [H, W] state
    windows = []

    def consumer(carry, k0, nodes, alive0):
        h0, v0, h1, v1, p0 = nodes
        planes = [TR.hermite_plane(h0, v0 * dxw, h1, v1 * dxw, coeffs, j)
                  for j in range(coarse + 1)]
        windows.append((h0, v0, p0, h1, v1, planes))
        return carry, torch.stack(planes[:-1]).amin(0)

    TR.march_scan_light(100.0, elev, step, 160, TR.EarthShape(R), tt, False, consumer,
                        None, coarse=coarse)
    for h0, v0, p0, h1, v1, planes in windows:
        _, _, h1w, v1w = TR.rk4_window(h0, v0, p0, step, coarse, tt, False, R)
        assert torch.equal(h1w, h1) and torch.equal(v1w, v1)
        for j in range(coarse + 1):
            assert torch.equal(TR.hermite_plane(h0, v0 * dxw, h1w, v1w * dxw, coeffs, j),
                               planes[j])


# -- terrain bounds of the culled path ------------------------------------------

def test_cull_bounds_match_jax(tmp_path):
    """grad_bound and seam_jump on a 2×2 box with one tile missing (a seam
    against the 0.0 fallback) and one tile of another resolution."""
    make_terrain_folder(tmp_path, tiles=((49, 21), (50, 21)), n=61)
    make_terrain_folder(tmp_path, tiles=((49, 22),), n=41)
    jt, tt = JTerrain.from_folder(tmp_path), TTerrain.from_folder(tmp_path)
    box = ((48.7, 51.2), (20.6, 23.1))
    jp, tp = jt.pack(*box), tt.pack(*box, "cpu")
    assert tp.grad_bound == jp.grad_bound and tp.grad_bound > 0.0
    assert tp.seam_jump == jp.seam_jump and tp.seam_jump > 0.0
    rng = np.random.default_rng(4)
    for la, lo in ((49, 21), (49, 22)):
        grid = rng.uniform(0.0, 900.0, (21, 21)).astype(np.float32)
        jt.add_tile(JTile(la, lo, grid))
        tt.add_tile(TTile(la, lo, grid))
    box = ((49.1, 49.9), (21.1, 22.9))
    jp, tp = jt.pack(*box), tt.pack(*box, "cpu")
    assert (tp.grad_bound, tp.seam_jump) == (jp.grad_bound, jp.seam_jump)


# -- renders -------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rect_golden")
    return make_terrain_folder(d, tiles=((49, 21),), n=181)


@pytest.fixture(scope="module")
def terrains(golden_dir):
    return JTerrain.from_folder(golden_dir), TTerrain.from_folder(golden_dir)


def _golden_config(scene, golden_dir, tilt=0.0):
    cfg = G._base_config(**copy.deepcopy(G.SCENES[scene]))
    cfg["scene"]["terrain_folder"] = str(golden_dir)
    cfg["output"]["generator"] = "Rectilinear"
    cfg["view"]["frame"]["tilt"] = tilt
    return cfg


def _renders(cfg, terrains, **kw):
    jt, tt = terrains
    jres = j_render(JConfig.from_dict(cfg).into_params(jt), jt)
    tres = t_render(TConfig.from_dict(cfg).into_params(tt), tt, "cpu", **kw)
    return jres, tres


def _assert_hits_close(tres, jres):
    """Validity differs on ≤ 1 % of pixels; where both hit: key within 1e-3,
    elevation within 0.05 m, path length within 1e-5 relative + 0.05 m."""
    jv = np.asarray(jres.hits.valid)
    tv = tres.hits.valid.numpy()
    assert tv.shape == jv.shape
    assert (jv != tv).mean() <= 0.01
    both = jv & tv
    assert both.any()
    for field, rtol, atol in (("key", 0, 1e-3), ("elevation", 0, 0.05),
                              ("path_length", 1e-5, 0.05)):
        np.testing.assert_allclose(getattr(tres.hits, field).numpy()[both],
                                   np.asarray(getattr(jres.hits, field))[both],
                                   rtol=rtol, atol=atol, err_msg=field)


def _golden(name):
    from PIL import Image

    return np.asarray(Image.open(G.GOLDEN_DIR / f"{name}.png").convert("RGB"))


@pytest.mark.parametrize("scene", RECT_SCENES)
def test_golden_scene_matches_jax_and_golden(scene, golden_dir, terrains):
    jres, tres = _renders(_golden_config(scene, golden_dir), terrains)
    assert tres.image.shape == jres.image.shape and tres.image.dtype == np.uint8
    for other in (np.asarray(jres.image), _golden(f"rectilinear_{scene}")):
        ok, frac_any, frac_big = verify_tolerance(tres.image, other)
        assert ok, (scene, frac_any, frac_big)
    _assert_hits_close(tres, jres)
    # the result's angle grids are the host f64 ones
    np.testing.assert_array_equal(tres.elevation_deg, jres.elevation_deg)
    np.testing.assert_array_equal(tres.azimuth_deg, jres.azimuth_deg)
    assert tres.culled_rounds is None


@pytest.mark.parametrize("path", list(TILTED))
def test_tilted_scene_matches_jax(path, golden_dir, terrains):
    scene, tilt = TILTED[path]
    jres, tres = _renders(_golden_config(scene, golden_dir, tilt), terrains)
    ok, frac_any, frac_big = verify_tolerance(tres.image, np.asarray(jres.image))
    assert ok, (path, frac_any, frac_big)
    _assert_hits_close(tres, jres)
    assert (tres.culled_rounds is not None) == (path == "culled")


def test_culled_finds_the_dense_hits(golden_dir, terrains):
    """The envelope cull drops no crossing: the same hit mask as the dense
    per-pixel path, and keys equal up to the rounding of the pixel angles
    (the dense path takes the host f64 grid, the culled path its float32
    twin, as in the JAX package)."""
    _, tt = terrains
    params = TConfig.from_dict(_golden_config("plain", golden_dir, 2.0)).into_params(tt)
    culled = t_render(params, tt, "cpu")
    dense = t_render(params, tt, "cpu", cull=False)
    assert culled.culled_rounds >= 1 and dense.culled_rounds is None
    assert torch.equal(culled.hits.valid, dense.hits.valid)
    v = culled.hits.valid
    assert v.any()
    dk = (culled.hits.key[v] - dense.hits.key[v]).abs()
    assert float(dk.max()) <= 1e-3
    assert float((dk == 0).double().mean()) > 0.5


# -- analogs of tests/test_rectilinear.py --------------------------------------

def small_scene_setup(folder):
    """The small tilt-0 scene: its one-tile terrain folder written into
    ``folder`` and its config dict (48x32, fov 6, 12 km in 50 m steps)."""
    make_terrain_folder(folder, tiles=((49, 21),), n=241)
    return {
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Relative": 40.0}},
                 "frame": {"direction": 50.0, "fov": 6.0, "max_distance": 12000.0,
                           "tilt": 0.0}},
        "simulation_step": 50.0,
        "output": {"width": 48, "height": 32},
    }


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rect_small")
    cfg = small_scene_setup(d)
    terrain = TTerrain.from_folder(d)
    return terrain, TConfig.from_dict(cfg).into_params(terrain)


def _first_slots_agree(r1, r2):
    v1 = r1.hits.valid[..., 0].numpy()
    v2 = r2.hits.valid[..., 0].numpy()
    np.testing.assert_array_equal(v1, v2)
    both = v1 & v2
    np.testing.assert_allclose(r1.hits.key[..., 0].numpy()[both],
                               r2.hits.key[..., 0].numpy()[both], rtol=1e-6)
    return v1


def test_death_segment_still_tested():
    """The segment STARTING at a ray's first sub-−1000 m sample is still
    tested (utils.rs:159-171): terrain at −1040 m under steep rays puts the
    crossing inside exactly that segment; K = 1 and K = 2 agree."""
    terrain = TTerrain()
    terrain.add_tile(TTile(49, 21, np.full((121, 121), -1040, np.int16)))
    params = TConfig.from_dict({
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Absolute": 100.0}},
                 "frame": {"direction": 45.0, "fov": 160.0, "max_distance": 20_000.0}},
        "simulation_step": 50.0,
        "output": {"width": 24, "height": 31},
    }).into_params(terrain)
    r1 = t_render(params, terrain, "cpu", max_hits=1)
    v1 = _first_slots_agree(r1, t_render(params, terrain, "cpu", max_hits=2))
    assert v1.any(), "steep rays into -1040 m terrain must hit"


def test_fused_multi_hit_slots(small_scene):
    """K > 1 on the fused path: ascending keys per pixel, +inf in empty
    slots, and slot 0 equal to the single-hit render."""
    terrain, params = small_scene
    r = t_render(params, terrain, "cpu", max_hits=3)
    valid = r.hits.valid.numpy()
    key = r.hits.key.numpy()
    assert valid.shape == (32, 48, 3)
    assert valid[..., 0].any() and valid[..., 1].any()
    both = valid[..., 0] & valid[..., 1]
    assert (key[..., 1][both] > key[..., 0][both]).all()
    assert np.isinf(key[~valid]).all()
    assert (r.hits.path_length.numpy()[~valid] == 0.0).all()
    r1 = t_render(params, terrain, "cpu", max_hits=1)
    np.testing.assert_allclose(r1.hits.distance[..., 0].numpy(),
                               r.hits.distance[..., 0].numpy(), atol=1e-3)


def test_short_march_below_one_coarse_window():
    """max_distance below one coarse window (n_seg = 9 < 16): the scans
    clamp the window, and the K = 1 re-test must clamp alike."""
    terrain = TTerrain()
    terrain.add_tile(TTile(49, 21, np.zeros((121, 121), np.int16)))
    cfg = {
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Absolute": 60.0}},
                 "frame": {"direction": 45.0, "fov": 140.0, "max_distance": 500.0}},
        "simulation_step": 50.0,
        "output": {"width": 16, "height": 21},
    }
    params = TConfig.from_dict(cfg).into_params(terrain)
    r1 = t_render(params, terrain, "cpu", max_hits=1)
    v1 = _first_slots_agree(r1, t_render(params, terrain, "cpu", max_hits=2))
    assert v1.any(), "steep rays must hit inside the short march"
    cfg["view"]["frame"]["tilt"] = -2.0  # the culled path's clamped blocks
    rt = t_render(TConfig.from_dict(cfg).into_params(terrain), terrain, "cpu")
    assert rt.culled_rounds >= 1 and rt.hits.valid.any()


# -- entry points --------------------------------------------------------------

def test_cli_gen_rectilinear_writes_golden_png(tmp_path, golden_dir):
    import yaml

    cfg = _golden_config("plain", golden_dir)
    cfg["output"]["generator"] = "Fast"  # the flag below overrides it
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "atm_raytracer_tpu_torch.cli", "gen", "-c", "cfg.yaml",
         "--generator", "Rectilinear", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "Generating (Rectilinear) on cpu" in proc.stdout
    from PIL import Image

    img = np.asarray(Image.open(tmp_path / "out.png").convert("RGB"))
    ok, frac_any, frac_big = verify_tolerance(img, _golden("rectilinear_plain"))
    assert ok, (frac_any, frac_big)


PERCENT_LINE = r"^\d+\.\d{3}: (\d+)%\.\.\.$"  # the JAX CLI's phase() line


def _percent_lines(stdout):
    import re

    return [int(m.group(1)) for m in
            (re.match(PERCENT_LINE, ln) for ln in stdout.splitlines()) if m]


def test_cli_gen_rectilinear_prints_progress_like_jax(tmp_path, golden_dir):
    """``gen --generator Rectilinear`` prints monotone whole-percent lines
    ending at 100, in the JAX CLI's format and at its percents."""
    import yaml

    cfg = _golden_config("plain", golden_dir)
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    outs = []
    for pkg, extra in (("atm_raytracer_tpu", []),
                       ("atm_raytracer_tpu_torch", ["--device", "cpu"])):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", "gen", "-c", "cfg.yaml", *extra],
            cwd=tmp_path, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
                 "ATM_RAYTRACER_PLATFORM": "cpu"},
        )
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    pct = _percent_lines(outs[1])
    assert len(pct) > 1 and pct[-1] == 100
    assert all(a < b for a, b in zip(pct, pct[1:]))
    assert sum("%..." in ln for ln in outs[1].splitlines()) == len(pct)
    assert pct == sorted(set(_percent_lines(outs[0])))


@pytest.mark.parametrize("path", ["culled", "dense", "multi_hit"])
def test_rectilinear_progress_is_monotone_to_100(path, golden_dir, terrains):
    _, tt = terrains
    cfg = _golden_config("plain", golden_dir, tilt=0.0 if path == "multi_hit" else 1.0)
    if path == "dense":
        cfg["output"]["height"] = 130  # three chunks of PIXEL_ROWS rows
    got = []
    res = t_render(TConfig.from_dict(cfg).into_params(tt), tt, "cpu",
                   cull=path != "dense", max_hits=2 if path == "multi_hit" else None,
                   progress=got.append)
    assert (res.culled_rounds is not None) == (path == "culled")
    assert got[-1] == 100 and all(a < b for a, b in zip(got, got[1:]))
    assert len(got) > 1


def test_render_rectilinear_refuses_objects(golden_dir, terrains, monkeypatch):
    """Scene objects render on both object paths: tilt 0 (row chunks over
    the shared column terrain; with the chunk budget cut to two rows the
    chunks' seams are crossed) and tilted (the dense path, never the culled
    one). Each returns object hits (kind 1) on valid slots, K = 1 + 2 per
    object, and the chunked frame equals the one-chunk frame."""
    from atm_raytracer_tpu_torch.generators import rectilinear as TRect

    _, tt = terrains
    cfg = _golden_config("objects", golden_dir)
    params = TConfig.from_dict(cfg).into_params(tt)
    one = t_render(params, tt, "cpu")
    n_terr = int(math.ceil(params.view.frame.max_distance / params.simulation_step))
    monkeypatch.setattr(TRect, "RECT_CHUNK_ELEMS", 2 * params.output.width * n_terr)
    assert TRect.auto_chunk_rows(params.output.width, params.output.height, n_terr) == 2
    chunked = t_render(params, tt, "cpu")
    monkeypatch.undo()
    np.testing.assert_array_equal(chunked.image, one.image)
    assert torch.equal(chunked.hits.key, one.hits.key)
    tilted = t_render(TConfig.from_dict(_golden_config("objects", golden_dir, tilt=1.0))
                      .into_params(tt), tt, "cpu")
    assert tilted.culled_rounds is None
    for res in (one, tilted):
        v, kind = res.hits.valid, res.hits.kind
        assert v.shape[-1] == 1 + 2 * len(params.objects)
        obj = v & (kind == 1)
        assert int(obj.sum()) > 100
        assert bool((res.hits.rgba[..., 3][obj] > 0).all())
        assert bool((kind[v] <= 1).all())
