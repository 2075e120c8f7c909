"""Parity of the PyTorch port's InterpolatingRectilinear generator with the
JAX package.

The host geometry (``gen_fov_data``, ``_camera_grids``) must equal the JAX
package's exactly. The device pieces take the same numpy inputs from a seed
in both packages: the 16-case weights, the grouping ranks (against both JAX
forms) and the per-pixel interpolation equal the JAX functions run op by op
bit for bit; under ``jax.jit`` XLA's CPU backend contracts products and sums
into fused multiply-adds, which moves the weights of the two diagonal cases
by a few ulp and the interpolated fields by tens of ulp where corner terms
cancel, so the jitted functions are held to float32 bounds.
The three golden Interpolating scenes render on the CPU with the port's plain
path within the verify tolerance (bench.py:548-551) of the JAX render and of
the committed PNG; they are not bit-exact (1-count moves on 1-5 % of pixels).
A witness pins down where those moves come from: fed the JAX package's own
grid cells, the port renders the translucent golden bit for bit as the JAX
render run op by op. The oracles of tests/test_interpolating.py run against
the port's own Rectilinear render.

Run with ``-s`` to see the measured figures (ulps, floor flips, pixels
moved) that the assertions bound.
"""

import copy
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_golden as G  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators import interpolating as J  # noqa: E402
from atm_raytracer_tpu.generators.base import HitBuffer as JHitBuffer  # noqa: E402
from atm_raytracer_tpu.models import camera as JC  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import cli, interop  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import interpolating as T  # noqa: E402
from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402
from torch_parity import verify_tolerance  # noqa: E402

SCENES = ("plain", "translucent", "flat_straight")
# (width, height, fov, tilt, direction)
CAMERAS = {
    "golden": (64, 48, 25.0, 0.0, 45.0),
    "headline": (1920, 1080, 40.0, 0.0, 45.0),
    "due_south": (1920, 1080, 40.0, 0.0, 180.0),
    "tilted": (33, 20, 40.0, 2.0, 200.0),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The file's CPU time is bounded on one thread; the thread count of
    other modules' tests is left as it was."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ulp(got, want) -> float:
    """Largest |got - want| over the finite ``want``, in float32 ulp at ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    fin = np.isfinite(want)
    d = np.abs(got[fin] - want[fin]) / np.spacing(np.abs(want[fin]))
    return float(d.max()) if d.size else 0.0


def pixels_moved(a, b):
    """(share of pixels that differ in any channel, largest difference in counts)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)
    return float((d > 0).mean()), int(d.max())


# -- host geometry ---------------------------------------------------------------

@pytest.mark.parametrize("cam", list(CAMERAS))
def test_fov_data_and_camera_grids_equal_jax(cam):
    args = CAMERAS[cam]
    for got, want in zip(T.gen_fov_data(*args), J.gen_fov_data(*args)):
        assert np.array_equal(got, want)
    got, want = T._camera_grids(*args), J._camera_grids(*args)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[6].shape == got[7].shape == args[1::-1]  # [H, W] output angles
    if cam == "headline":  # the snapped grid, rows × columns
        assert (got[4].size, got[5].size) == (787, 1394)


# -- the 16-case weights -------------------------------------------------------------

def _weight_inputs(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    present = rng.random((4, h, w)) < 0.6
    re = rng.random((h, w)).astype(np.float32)
    rd = rng.random((h, w)).astype(np.float32)
    re[::5] = 0.5  # the cases' half-way edges
    rd[:, ::7] = 0.5
    re[3] = 0.0
    return present, re, rd


def test_interp_weights_bit_equal_jax():
    present, re, rd = _weight_inputs(0)
    codes = present.astype(int).T @ np.array([1, 2, 4, 8])
    assert len(np.unique(codes)) == 16  # every presence case occurs
    tok, tw = T._interp_weights(*(torch.from_numpy(x) for x in (present, re, rd)))
    jargs = tuple(jnp.asarray(x) for x in (present, re, rd))
    jok, jw = J._interp_weights(*jargs)
    assert torch.equal(tok, torch.from_numpy(np.asarray(jok)))
    assert torch.equal(tw, torch.from_numpy(np.asarray(jw)))
    # jitted, XLA fuses (1 − a)(1 − b) + ab into an FMA: only the diagonal
    # cases (e01+e10, e00+e11) move, by a few ulp
    jok, jw = jax.jit(J._interp_weights)(*jargs)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    diff = np.abs(tw.numpy() - np.asarray(jw)).max(axis=0)
    diagonal = np.isin(codes.T, (6, 9))
    print(f"\n[weights] jitted JAX vs the port: {ulp(tw.numpy(), jw):.1f} ulp at most, "
          f"in cases {sorted({int(c) for c in codes.T[diff > 0]})}")
    assert (diff[~diagonal] == 0).all() and diff.max() <= 1e-6


# -- grouping ------------------------------------------------------------------------

@pytest.mark.parametrize("e_n,h,w,step", [(4, 5, 6, 50.0), (8, 4, 4, 100.0),
                                          (16, 3, 7, 50.0), (32, 2, 5, 25.0)])
def test_group_slot_ranks_equal_both_jax_forms(e_n, h, w, step):
    """The entry soups of tests/test_interpolating.py::test_group_ranks_loop_parity:
    step-close clusters, interleaved kinds and invalid ballast."""
    rng = np.random.default_rng(7 + e_n)
    valid = rng.random((e_n, h, w)) < 0.6
    dist = (rng.integers(0, 4, (e_n, h, w)) * (3.0 * step)
            + rng.random((e_n, h, w)) * 1.8 * step).astype(np.float32)
    kind = rng.integers(0, 3, (e_n, h, w)).astype(np.float32)
    got = T._group_slot_ranks(torch.from_numpy(valid), torch.from_numpy(dist),
                              torch.from_numpy(kind), step)
    assert got.dtype == torch.int32
    jargs = (jnp.asarray(valid), jnp.asarray(dist), jnp.asarray(kind), step)
    for form in (J._group_slot_ranks_unrolled, J._group_slot_ranks_loop):
        np.testing.assert_array_equal(got.numpy(), np.asarray(form(*jargs)),
                                      err_msg=form.__name__)
    assert int(got[torch.from_numpy(valid)].max()) > 0  # groups really merge and rank


# -- the per-pixel interpolation --------------------------------------------------------

def _random_grid(seed, hp, wp, kg, step, objects):
    """A [hp, wp, kg] hit grid: sorted step-clustered distances, random
    validity and fields; kinds and colors random with objects, else the
    terrain-only constants."""
    rng = np.random.default_rng(seed)
    sh = (hp, wp, kg)
    dist = (np.sort(rng.integers(0, 6, sh), axis=-1) * 2.0 * step
            + rng.random(sh) * 1.5 * step + 500.0).astype(np.float32)

    def uni(lo, hi, shape=sh):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    if objects:
        kind = rng.integers(0, 2, sh).astype(np.int32)
        rgba = uni(0.0, 1.0, sh + (4,))
    else:
        kind = np.zeros(sh, np.int32)
        rgba = np.broadcast_to(np.array([0, 0, 0, 0.65], np.float32), sh + (4,)).copy()
    return dict(valid=rng.random(sh) < 0.7, key=dist / np.float32(step), dlat=uni(-0.1, 0.1),
                dlon=uni(-0.1, 0.1), distance=dist, elevation=uni(-50.0, 900.0),
                path_length=dist * np.float32(1.0001), normal=uni(-1.0, 1.0, sh + (3,)),
                kind=kind, rgba=rgba)


HIT_FIELDS = ("key", "dlat", "dlon", "distance", "elevation", "path_length", "normal",
              "rgba")


def _pixel_inputs(kg, has_objects, hp=9, wp=11, step=50.0):
    grid = _random_grid(3, hp, wp, kg, step, has_objects)
    rng = np.random.default_rng(5)
    gi = rng.integers(-1, hp, (23, 29)).astype(np.int32)  # off-grid cells too
    gj = rng.integers(-1, wp, (23, 29)).astype(np.int32)
    re = rng.random((23, 29)).astype(np.float32)
    rd = rng.random((23, 29)).astype(np.float32)
    re[::4] = 0.5
    got = T._interpolate_pixels(interop.hits_from_arrays(**grid, device="cpu"),
                                *(torch.from_numpy(x) for x in (gi, gj, re, rd)),
                                step, 2 * kg, has_objects)
    jgrid = JHitBuffer(**{k: jnp.asarray(v) for k, v in grid.items()})
    return got, (jgrid, *(jnp.asarray(x) for x in (gi, gj, re, rd)), step, 2 * kg,
                 has_objects)


@pytest.mark.parametrize("has_objects", [False, True], ids=["terrain", "objects"])
def test_interpolate_pixels_matches_jax(has_objects):
    """Two slots a grid cell (8 entries a pixel): valid, kind and every
    field equal to the JAX function run op by op."""
    got, jargs = _pixel_inputs(2, has_objects)
    want = J._interpolate_pixels(*jargs)
    assert got.valid.shape == (23, 29, 4) and bool(got.valid[..., 1].any())
    for f in ("valid", "kind") + HIT_FIELDS:
        assert torch.equal(getattr(got, f), torch.from_numpy(np.asarray(getattr(want, f)))), f


def test_interpolate_pixels_within_float32_of_jitted_jax():
    """The opaque render's layout (one slot a grid cell) against the jitted
    JAX function: valid and kind equal, the fields within the FMA
    contractions' rounding, relative to each field's scale."""
    got, jargs = _pixel_inputs(1, False)
    want = jax.jit(J._interpolate_pixels, static_argnums=(5, 6, 7))(*jargs)
    for f in ("valid", "kind"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    print("\n[fields] jitted JAX vs the port, ulp at most: " + ", ".join(
        f"{f} {ulp(getattr(got, f).numpy(), getattr(want, f)):.0f}" for f in HIT_FIELDS))
    for f in HIT_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        scale = np.abs(w[fin]).max()
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=4e-7 * scale, err_msg=f)


def test_grouping_kind_interleave_does_not_split():
    """tests/test_interpolating.py's object / terrain / object interleave
    within one step: 2 groups, not 3 (collect_trace_points matches same-kind
    entries only)."""
    kg = 3
    sh = (2, 2, kg)
    dist = np.broadcast_to(np.array([1000.0, 1020.0, 1040.0], np.float32), sh)
    grid = interop.hits_from_arrays(
        valid=np.ones(sh, bool), key=dist / 50.0, dlat=np.full(sh, 0.01),
        dlon=np.full(sh, 0.01), distance=dist, elevation=np.full(sh, 100.0),
        path_length=dist, normal=np.broadcast_to(np.array([0.0, 0.0, 1.0]), sh + (3,)),
        kind=np.broadcast_to(np.array([1, 0, 1]), sh), rgba=np.ones(sh + (4,)), device="cpu",
    )
    zero = torch.zeros((1, 1), dtype=torch.int32)
    half = torch.full((1, 1), 0.5)
    out = T._interpolate_pixels(grid, zero, zero, half, half, 50.0, 2 * kg)
    valid = out.valid[0, 0]
    assert int(valid.sum()) == 2
    # slot 0 = the object group (min distance 1000; the last member per
    # corner is at 1040), slot 1 = the terrain group at 1020
    assert out.kind[0, 0][valid].tolist() == [1, 0]
    np.testing.assert_allclose(out.distance[0, 0][valid].numpy(), [1040.0, 1020.0], atol=1e-3)


# -- the device grid indices ---------------------------------------------------------

def _jax_grid_coords(cam, min_es, min_ds, i_min, j_min):
    """The JAX package's per-pixel grid coordinates, op by op as
    interpolating_core computes them (atm_raytracer_tpu/generators/
    interpolating.py:478-494)."""
    width, height, fov, tilt, direction = cam
    elev, dirr = JC.rectilinear_ray_params_device(width, height, fov, tilt, direction)
    dir_rad = jnp.float32(math.radians(direction))
    pi = jnp.float32(math.pi)
    dirr = dir_rad + jnp.mod(dirr - dir_rad + pi, 2.0 * pi) - pi
    ei_f = elev / jnp.float32(min_es)
    dj_f = dirr / jnp.float32(min_ds)
    gi_abs = jnp.floor(ei_f)
    gj_abs = jnp.floor(dj_f)
    return (gi_abs.astype(jnp.int32) - i_min, gj_abs.astype(jnp.int32) - j_min,
            ei_f - gi_abs, dj_f - gj_abs)


@pytest.mark.parametrize("cam", ["golden", "headline", "due_south"])
def test_grid_coords_match_jax(cam):
    """The float32 camera twins agree within 4 ulp, not bitwise, so a few
    floors flip at 1080p (12 of 2 073 600 measured) and the positions in
    the cells differ by the twins' rounding; no floor flips at the golden
    size. Every cell stays inside the widened grid."""
    args = CAMERAS[cam]
    min_es, min_ds, i_min, j_min, grid_e, grid_a = T._camera_grids(*args)[:6]
    got = T.grid_coords(args, float(min_es), float(min_ds), i_min, j_min, "cpu")
    want = _jax_grid_coords(args, float(min_es), float(min_ds), i_min, j_min)
    n = args[0] * args[1]
    limit = 0 if cam == "golden" else 1e-5 * n
    flips = [int((g.numpy() != np.asarray(w)).sum()) for g, w in zip(got[:2], want[:2])]
    print(f"\n[cells] {cam}: gi differs from JAX's in {flips[0]}, gj in {flips[1]} of {n} "
          f"pixels")
    for g, f in zip(got[:2], flips):
        assert g.dtype == torch.int32
        assert f <= limit
    same = (got[0].numpy() == np.asarray(want[0])) & (got[1].numpy() == np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):  # the twins' ulps, in cell units
        np.testing.assert_allclose(g.numpy()[same], np.asarray(w)[same], rtol=0, atol=1e-3)
    gi, gj = got[:2]
    assert int(gi.min()) >= 0 and int(gi.max()) + 1 < grid_e.size
    assert int(gj.min()) >= 0 and int(gj.max()) + 1 < grid_a.size


# -- renders ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_interp_golden")
    return make_terrain_folder(d, tiles=((49, 21),), n=181)


def _golden_config(scene, golden_dir):
    cfg = G._base_config(**copy.deepcopy(G.SCENES[scene]))
    cfg["scene"]["terrain_folder"] = str(golden_dir)
    cfg["output"]["generator"] = "InterpolatingRectilinear"
    return cfg


def _golden_png(scene):
    from PIL import Image

    path = G.GOLDEN_DIR / f"interpolatingrectilinear_{scene}.png"
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("scene", SCENES)
def test_golden_scene_matches_jax_and_golden(scene, golden_dir):
    cfg = _golden_config(scene, golden_dir)
    jt, tt = JTerrain.from_folder(golden_dir), TTerrain.from_folder(golden_dir)
    jres = J.render_interpolating(JConfig.from_dict(cfg).into_params(jt), jt)
    tres = T.render_interpolating(TConfig.from_dict(cfg).into_params(tt), tt, "cpu")
    assert tres.image.shape == jres.image.shape and tres.image.dtype == np.uint8
    for name, other in (("JAX", np.asarray(jres.image)), ("PNG", _golden_png(scene))):
        frac, most = pixels_moved(tres.image, other)
        print(f"\n[golden] {scene} vs the {name}: {100.0 * frac:.2f} % of pixels moved, "
              f"by {most} counts at most")
        ok, frac_any, frac_big = verify_tolerance(tres.image, other)
        assert ok, (scene, frac_any, frac_big)
    np.testing.assert_array_equal(tres.elevation_deg, jres.elevation_deg)
    np.testing.assert_array_equal(tres.azimuth_deg, jres.azimuth_deg)
    np.testing.assert_allclose(tres.observer, jres.observer)
    jv = np.asarray(jres.hits.valid)
    tv = tres.hits.valid.numpy()
    assert tv.shape == jv.shape == (48, 64, 4 if scene != "translucent" else 8)
    assert (jv != tv).mean() <= 0.01
    both = jv & tv
    np.testing.assert_allclose(tres.hits.key.numpy()[both],
                               np.asarray(jres.hits.key)[both], atol=1e-3)
    np.testing.assert_allclose(tres.hits.elevation.numpy()[both],
                               np.asarray(jres.hits.elevation)[both], atol=0.05)


def test_translucent_golden_equals_jax_op_by_op_given_its_cells(golden_dir, monkeypatch):
    """Where the translucent golden's moved pixels come from. Against the
    JAX render run op by op (``jax.disable_jit``), the port fed the JAX
    package's own grid cells renders bit for bit: the grid (its last-ulp
    differences included), the grouping, the weights, the interpolation and
    the composite add nothing. With its own cells the port moves ~2 % of the
    pixels: the camera twins' asin/atan2 differ by a few ulp, and so do the
    positions in the cells. Against the jitted JAX render, XLA's
    contractions add the rest."""
    cfg = _golden_config("translucent", golden_dir)
    jt, tt = JTerrain.from_folder(golden_dir), TTerrain.from_folder(golden_dir)
    with jax.disable_jit():
        want = np.asarray(J.render_interpolating(JConfig.from_dict(cfg).into_params(jt),
                                                 jt).image)
    params = TConfig.from_dict(cfg).into_params(tt)
    own = T.render_interpolating(params, tt, "cpu").image

    def jax_cells(cam, min_es, min_ds, i_min, j_min, device):
        with jax.disable_jit():
            cells = _jax_grid_coords(cam, min_es, min_ds, i_min, j_min)
        return tuple(torch.from_numpy(np.array(c)).to(device) for c in cells)

    monkeypatch.setattr(T, "grid_coords", jax_cells)
    fed = T.render_interpolating(params, tt, "cpu").image
    frac, most = pixels_moved(own, want)
    print(f"\n[witness] translucent vs JAX op by op: with JAX's cells "
          f"{100.0 * pixels_moved(fed, want)[0]:.2f} % of pixels moved; with the "
          f"port's own {100.0 * frac:.2f} %, by {most} counts at most")
    np.testing.assert_array_equal(fed, want)
    ok, frac_any, frac_big = verify_tolerance(own, want)
    assert ok and frac < 0.03, (frac_any, frac_big)


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """The scene of tests/test_interpolating.py."""
    d = tmp_path_factory.mktemp("torch_interp_small")
    make_terrain_folder(d, tiles=((49, 21),), n=241)
    config = TConfig.from_dict({
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Relative": 40.0}},
                 "frame": {"direction": 50.0, "fov": 8.0, "max_distance": 10000.0}},
        "simulation_step": 50.0,
        "output": {"width": 40, "height": 28},
    })
    terrain = TTerrain.from_folder(d)
    return config, terrain


def _close_to_rectilinear(interp, rect):
    """The reference's oracle: a faster, slightly less exact Rectilinear."""
    agree = interp.hits.valid.any(-1) == rect.hits.valid.any(-1)
    assert float(agree.double().mean()) > 0.93
    both = interp.hits.valid[..., 0] & rect.hits.valid[..., 0]
    assert bool(both.any())
    dd = (interp.hits.distance[..., 0] - rect.hits.distance[..., 0]).abs()[both]
    assert float(dd.median()) < 150.0
    return interp.image, rect.image


def test_interpolating_close_to_rectilinear(small_scene):
    config, terrain = small_scene
    params = config.into_params(terrain)
    seen = []
    interp = T.render_interpolating(params, terrain, "cpu", progress=seen.append)
    assert seen == [100]  # one launch sequence: the final percent only
    rect = render_rectilinear(params, terrain, "cpu")
    a, b = _close_to_rectilinear(interp, rect)
    diff = np.abs(a.astype(int) - b.astype(int)).max(-1)
    assert (diff <= 8).mean() > 0.9


def test_interpolating_angles_bilinear(small_scene):
    config, terrain = small_scene
    params = config.into_params(terrain)
    res = T.render_interpolating(params, terrain, "cpu")
    out, frame = params.output, params.view.frame
    elev, dirr, min_es, min_ds = T.gen_fov_data(out.width, out.height, frame.fov,
                                                frame.tilt, frame.direction)
    # the interpolated angles approximate the true camera angles to within
    # one grid cell
    assert np.abs(np.deg2rad(res.elevation_deg) - elev).max() < min_es * 1.01
    assert np.abs(np.deg2rad(res.azimuth_deg) - dirr).max() < min_ds * 1.01


def test_key_is_march_position(small_scene):
    """HitBuffer.key keeps the contract key = distance/step: the artifact
    derives the viewer's distances from it."""
    config, terrain = small_scene
    params = config.into_params(terrain)
    hits = T.render_interpolating(params, terrain, "cpu").hits
    valid = hits.valid
    assert bool(valid.any())
    err = (hits.key[valid] * params.simulation_step - hits.distance[valid]).abs()
    assert float(err.max()) < 1.0
    assert bool(torch.isinf(hits.key[~valid]).all())


def test_due_south_seam_grid_is_narrow(small_scene):
    """A view across the ±180° atan2 seam keeps a grid as wide as the fov,
    and still renders close to the Rectilinear frame."""
    config, terrain = small_scene
    d = config.to_dict()
    d["view"]["frame"]["direction"] = 180.0
    params = TConfig.from_dict(d).into_params(terrain)
    out, frame = params.output, params.view.frame
    grid_az_deg = T._camera_grids(out.width, out.height, float(frame.fov),
                                  float(frame.tilt), float(frame.direction))[5]
    assert float(grid_az_deg.max() - grid_az_deg.min()) < 3.0 * frame.fov
    _close_to_rectilinear(T.render_interpolating(params, terrain, "cpu"),
                          render_rectilinear(params, terrain, "cpu"))


def test_render_interpolating_refuses_objects(golden_dir):
    """Scene objects render: the snapped grid carries them (max_hits grid
    slots, windows planned on the grid's azimuths) and the interpolation
    returns object hits (kind 1) on valid slots of its 2·max_hits."""
    cfg = _golden_config("objects", golden_dir)
    tt = TTerrain.from_folder(golden_dir)
    res = T.render_interpolating(TConfig.from_dict(cfg).into_params(tt), tt, "cpu")
    v, kind = res.hits.valid, res.hits.kind
    assert v.shape == (48, 64, 4)
    obj = v & (kind == 1)
    assert int(obj.sum()) > 100
    assert bool((res.hits.rgba[..., 3][obj] > 0).all())
    ok, frac_any, frac_big = verify_tolerance(res.image, _golden_png("objects"))
    assert ok, (frac_any, frac_big)


# -- the CLI: gen --output-meta, then view ------------------------------------------------

@pytest.mark.parametrize("fmt,name", [("native", "m.npz"), ("reference", "m.dat")])
def test_cli_output_meta_round_trip(fmt, name, golden_dir, tmp_path, monkeypatch, capsys):
    """``gen --generator InterpolatingRectilinear --output-meta`` in both
    formats; ``view --pixel`` prints the hit's distance and the re-composite
    is the written image."""
    import yaml
    from PIL import Image

    from atm_raytracer_tpu_torch.meta.serialize import load_metadata

    cfg = _golden_config("translucent", golden_dir)
    cfg["output"]["generator"] = "Fast"  # the flag below overrides it
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["gen", "-c", "cfg.yaml", "--generator", "InterpolatingRectilinear",
                     "--device", "cpu", "--output-meta", name, "--meta-format", fmt]) == 0
    assert "Generating (InterpolatingRectilinear) on cpu" in capsys.readouterr().out
    tt = TTerrain.from_folder(golden_dir)
    hits = T.render_interpolating(TConfig.from_dict(cfg).into_params(tt), tt, "cpu").hits
    _, meta = load_metadata(tmp_path / name)
    assert meta.elevation_deg.shape == (48, 64) and hits.valid.shape == (48, 64, 8)
    # the .dat keeps each pixel's trace points in slot order, without gaps
    v, mv = hits.valid, meta.hits.valid
    assert torch.equal(mv.sum(-1), v.sum(-1))
    if fmt == "native":  # the npz stores the key: distance = key·step again
        assert torch.equal(mv, v)
        torch.testing.assert_close(meta.hits.distance[mv], hits.distance[v], rtol=1e-6, atol=0)
    else:  # the .dat stores the distance
        assert torch.equal(meta.hits.distance[mv], hits.distance[v])
    y, x = (int(c) for c in torch.nonzero(v[..., 0] & v[..., 1])[0])  # two hits
    assert cli.main(["view", name, "--pixel", str(x), str(y), "--device", "cpu",
                     "--save-image", "view.png"]) == 0
    text = capsys.readouterr().out
    for k in (0, 1):
        line = next(ln for ln in text.splitlines() if ln.startswith(f"Trace point {k}"))
        km = float(line.split("distance ")[1].split(" km")[0])
        assert abs(km - float(hits.distance[y, x, k]) / 1000.0) <= 5e-4 + 1e-9
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "view.png")),
                                  np.asarray(Image.open(tmp_path / "out.png")))
    ok, frac_any, frac_big = verify_tolerance(np.asarray(Image.open(tmp_path / "out.png")),
                                              _golden_png("translucent"))
    assert ok, (frac_any, frac_big)
