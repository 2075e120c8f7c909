"""Parity of the PyTorch port's scene objects (``ops/objects.py``) with the
JAX package: the host planning bit for bit, the ENU frame and the three
intersection primitives on seeded inputs, the merges, the Fast object pass
and the per-pixel object hits on the objects golden scene, fed the JAX
package's own march and terrain columns.

The renders (the three ``_objects`` goldens, the reference-style scene,
the ``.dat`` bytes and the depth warning) are in
``tests/test_torch_objects_render.py``. Add ``-s`` to see the figures the
assertions bound.
"""

import copy
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_golden as G  # noqa: E402
import test_reference_config as RC  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators import fast as JF  # noqa: E402
from atm_raytracer_tpu.models import camera as JCAM  # noqa: E402
from atm_raytracer_tpu.models.earth import EarthModel as JEarth  # noqa: E402
from atm_raytracer_tpu.ops import combine as JC, objects as JO  # noqa: E402
from atm_raytracer_tpu.physics.ray import march_coarse, march_rays  # noqa: E402
from atm_raytracer_tpu.terrain.sample import sample_terrain_data  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import interop  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import fast as TF  # noqa: E402
from atm_raytracer_tpu_torch.generators.base import HitBuffer  # noqa: E402
from atm_raytracer_tpu_torch.models.earth import EarthModel as TEarth  # noqa: E402
from atm_raytracer_tpu_torch.ops import objects as TO  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    SEEDED_BEHIND,
    SEEDED_BEYOND,
    SEEDED_PAIR,
    WINDOW_GRIDS,
    WINDOW_SHAPES,
    cuda_device,
    fast_window_args,
    seeded_objects_config,
)

LAT0, LON0 = G.LAT0, G.LON0
HIT_FIELDS = ("dlat", "dlon", "distance", "elevation", "path_length", "normal", "rgba")


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    return make_terrain_folder(tmp_path_factory.mktemp("torch_obj_golden"),
                               tiles=((49, 21),), n=181)


@pytest.fixture(scope="module")
def reference_scene(tmp_path_factory):
    """The reference-style YAML scene (tests/test_reference_config.py): a
    textured Billboard, a Cylinder and a translucent Frustum over
    translucent terrain. Returns the config dict and the terrain folder."""
    import yaml
    from PIL import Image

    tmp = tmp_path_factory.mktemp("torch_obj_reference")
    terr_sub = tmp / "terrain"
    terr_sub.mkdir()
    terrain_dir = make_terrain_folder(terr_sub, tiles=((49, 21),), n=241)
    tex = tmp / "texture.png"
    arr = np.zeros((8, 8, 4), np.uint8)
    arr[..., 1] = 200
    arr[..., 3] = 255
    arr[2:4, :, 3] = 0  # a fully transparent band: the alpha > 0 rule
    Image.fromarray(arr).save(tex)
    text = RC.REFERENCE_STYLE_CONFIG.format(terrain=terrain_dir, texture=tex,
                                            out=tmp / "out.png", meta=tmp / "out.dat")
    return yaml.safe_load(text), terrain_dir


def _golden_cfg(golden_dir):
    cfg = G._base_config(**copy.deepcopy(G.SCENES["objects"]))
    cfg["scene"]["terrain_folder"] = str(golden_dir)
    return cfg


def _both(cfg, terrain_dir):
    """(JAX params, JAX terrain, port params, port terrain) of a config."""
    jt = JTerrain.from_folder(terrain_dir)
    tt = TTerrain.from_folder(terrain_dir)
    return (JConfig.from_dict(cfg).into_params(jt), jt,
            TConfig.from_dict(cfg).into_params(tt), tt)


def _port_objects(jset):
    """The JAX ObjectSet carried across (interop), on the CPU."""
    arrays = [np.asarray(x) for x in jset.tree_flatten()[0]]
    return interop.objects_from_arrays(*arrays, seg_window=jset.seg_window,
                                       host_meta=jset.host_meta, device="cpu")


# -- host parts: bit for bit ---------------------------------------------------


@pytest.mark.parametrize("scene", ["golden", "reference"])
def test_host_planning_equals_jax(scene, golden_dir, reference_scene):
    """ObjectSet.build's arrays, the column windows and the window overlap
    equal the JAX package's bit for bit, and the port's Fast render has the
    slot budget JAX plans from them."""
    if scene == "golden":
        cfg, terrain_dir = _golden_cfg(golden_dir), golden_dir
    else:
        cfg, terrain_dir = reference_scene
    jp, _, tp, tt = _both(cfg, terrain_dir)
    jset = JO.ObjectSet.build(jp)
    tset = TO.ObjectSet.build(tp, "cpu")
    children = jset.tree_flatten()[0]
    assert len(children) == len(TO.ARRAY_FIELDS)
    for name, want in zip(TO.ARRAY_FIELDS, children):
        got = getattr(tset, name)
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert (tset.n_objects, tset.seg_window, tset.kinds_static, tset.host_meta) == (
        jset.n_objects, jset.seg_window, jset.kinds_static, jset.host_meta)

    out, frame = jp.output, jp.view.frame
    az = JCAM.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)
    n_terr = int(math.ceil(frame.max_distance / jp.simulation_step))
    args = (LAT0, LON0, az, float(jp.simulation_step), n_terr)
    j_wins = JO.object_col_windows(jset, jp.model, *args)
    t_wins = TO.object_col_windows(tset, tp.model, *args)
    assert t_wins == j_wins and any(n for _, n in t_wins)
    # the memoized planning on the Fast grid equals both
    _, cached = TF.build_objects_cached(tp, az, n_terr, "cpu")
    assert cached == j_wins
    overlap = TO.max_window_overlap(t_wins, tset.n_objects)
    assert overlap == JO.max_window_overlap(j_wins, jset.n_objects)
    for wins in (None, ((0, 10), (5, 10), (8, 2)), ((0, 10), (3, 0), (10, 10))):
        assert TO.max_window_overlap(wins, 3) == JO.max_window_overlap(wins, 3)
    max_hits = 1 if jp.terrain_alpha >= 1.0 else 4
    k_out = max_hits + min(2 * JO.max_window_overlap(j_wins, jset.n_objects),
                           max(TF.OBJ_HIT_CAP, 2))
    assert TF.render_fast(tp, tt, "cpu").hits.valid.shape[-1] == k_out
    print(f"\n[{scene}] seg_window {tset.seg_window}, windows {t_wins}, overlap "
          f"{overlap}, k_out {k_out}")


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("grid", list(WINDOW_GRIDS))
@pytest.mark.parametrize("shape", list(WINDOW_SHAPES))
def test_col_windows_equal_jax_for_each_model(shape, grid, device, request):
    """The port's column windows, scanned as float64 tensors on ``device``,
    equal the JAX package's numpy scan on seeded objects of every
    geodesic calculator: the two out of view get none, the pair on one
    bearing overlaps, and the deepest overlap is the same."""
    if device == "cuda":
        device = request.getfixturevalue("cuda_device")
    cfg = seeded_objects_config(WINDOW_SHAPES[shape], seed=19, **WINDOW_GRIDS[grid])
    jp = JConfig.from_dict(cfg).into_params(None)
    tp = TConfig.from_dict(cfg).into_params(None)
    jset, tset = JO.ObjectSet.build(jp), TO.ObjectSet.build(tp, device)
    args = fast_window_args(tp)
    j_wins = JO.object_col_windows(jset, jp.model, *args)
    t_wins = TO.object_col_windows(tset, tp.model, *args)
    assert t_wins == j_wins
    assert t_wins[SEEDED_BEHIND] == t_wins[SEEDED_BEYOND] == (0, 0)
    (lo_a, n_a), (lo_b, n_b) = (t_wins[i] for i in SEEDED_PAIR)
    assert n_a and n_b and lo_a < lo_b + n_b and lo_b < lo_a + n_a
    overlap = TO.max_window_overlap(t_wins, tset.n_objects)
    assert overlap == JO.max_window_overlap(j_wins, jset.n_objects) >= 2


# -- the ENU frame -------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    {"Spherical": {"radius": 6_371_000.0}},
    "Wgs84",
    "FlatDistorted",
    "AzimuthalEquidistant",
])
def test_enu_rel_matches_jax(shape):
    """Seeded points around seeded objects: each component within 4 float32
    ulps of its largest magnitude, and within 1e-3 m inside a culling
    radius (500 m)."""
    rng = np.random.default_rng(7)
    model_cfg = shape
    jm, tm = JEarth.from_config(model_cfg), TEarth.from_config(model_cfg)
    n_obj, n_pt = 6, 4000
    o_dlat = rng.uniform(-0.5, 0.5, n_obj).astype(np.float32)
    o_dlon = rng.uniform(-0.5, 0.5, n_obj).astype(np.float32)
    o_elev = rng.uniform(0.0, 2500.0, n_obj).astype(np.float32)
    worst_ulp, worst_m = 0.0, 0.0
    for i in range(n_obj):
        # points within ~3 km of the object, a tenth of them within 500 m
        spread = np.where(rng.random(n_pt) < 0.1, 0.004, 0.03)
        p_dlat = (o_dlat[i] + rng.uniform(-1, 1, n_pt) * spread).astype(np.float32)
        p_dlon = (o_dlon[i] + rng.uniform(-1, 1, n_pt) * spread).astype(np.float32)
        p_elev = rng.uniform(-500.0, 4000.0, n_pt).astype(np.float32)
        want = np.asarray(jm.enu_rel(jnp.asarray(p_dlat), jnp.asarray(p_dlon),
                                     jnp.asarray(p_elev), jnp.float32(o_dlat[i]),
                                     jnp.float32(o_dlon[i]), jnp.float32(o_elev[i]), LAT0))
        got = tm.enu_rel(torch.from_numpy(p_dlat), torch.from_numpy(p_dlon),
                         torch.from_numpy(p_elev), torch.tensor(o_dlat[i]),
                         torch.tensor(o_dlon[i]), torch.tensor(o_elev[i]), LAT0).numpy()
        assert got.shape == want.shape == (n_pt, 3)
        diff = np.abs(got.astype(np.float64) - want)
        for c in range(3):
            ulp = float(np.spacing(np.abs(want[:, c]).max().astype(np.float32)))
            worst_ulp = max(worst_ulp, float(diff[:, c].max()) / ulp)
        near = np.linalg.norm(want.astype(np.float64), axis=-1) < 500.0
        assert near.any()
        worst_m = max(worst_m, float(diff[near].max()))
    print(f"\n[enu_rel {shape}] worst {worst_ulp:.2f} ulp of a component's magnitude; "
          f"inside 500 m {worst_m:.3g} m")
    assert worst_ulp <= 4.0
    assert worst_m <= 1e-3


# -- the intersection primitives -----------------------------------------------


def _segments(rng, n, reach, height):
    """Seeded segments in an object frame: starts around the object, 50 m
    long, mostly near-horizontal (march rays), some steep."""
    p1 = np.stack([rng.uniform(-reach, reach, n), rng.uniform(-reach, reach, n),
                   rng.uniform(-0.3 * height, 1.3 * height, n)], -1)
    az = rng.uniform(0, 2 * np.pi, n)
    el = np.where(rng.random(n) < 0.8, rng.normal(0, 0.05, n), rng.uniform(-1.4, 1.4, n))
    d = 50.0 * np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    # aim half the segments at the axis, so plenty of them hit
    aim = rng.random(n) < 0.5
    to_axis = -p1[:, :2] / np.maximum(np.linalg.norm(p1[:, :2], axis=-1, keepdims=True), 1e-9)
    d[aim, :2] = 50.0 * np.cos(el[aim])[:, None] * to_axis[aim]
    return p1.astype(np.float32), (p1 + d).astype(np.float32)


def _f32(x):
    return torch.tensor(np.float32(x))


@pytest.mark.parametrize("r1,r2,height", [(30.0, 30.0, 150.0), (40.0, 0.0, 120.0),
                                          (25.0, 10.0, 55.0)],
                         ids=["cylinder", "cone", "frustum"])
def test_frustum_hits_match_jax(r1, r2, height):
    rng = np.random.default_rng(11)
    p1, p2 = _segments(rng, 20000, 3 * max(r1, r2), height)
    jp, jn, jv = (np.asarray(x) for x in JO._frustum_hits(
        jnp.asarray(p1), jnp.asarray(p2), jnp.float32(r1), jnp.float32(r2),
        jnp.float32(height)))
    tp, tn, tv = (x.numpy() for x in TO._frustum_hits(
        torch.from_numpy(p1), torch.from_numpy(p2), _f32(r1), _f32(r2), _f32(height)))
    assert tp.shape == jp.shape and tn.shape == jn.shape and tv.shape == jv.shape
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 1000
    dp = float(np.abs(tp[jv] - jp[jv]).max())
    dn = float(np.abs(tn[jv] - jn[jv]).max())
    print(f"\n[frustum {r1}/{r2}/{height}] {int(jv.sum())} valid sub-hits; max |dprop| "
          f"{dp:.3g}, max |dnormal| {dn:.3g}")
    assert dp <= 2e-6 and dn <= 2e-6


def test_billboard_and_texture_match_jax():
    rng = np.random.default_rng(13)
    width, height = 60.0, 80.0
    p1, p2 = _segments(rng, 20000, 100.0, height)
    jr = [np.asarray(x) for x in JO._billboard_hit(
        jnp.asarray(p1), jnp.asarray(p2), jnp.float32(width), jnp.float32(height))]
    tr = [x.numpy() for x in TO._billboard_hit(
        torch.from_numpy(p1), torch.from_numpy(p2), _f32(width), _f32(height))]
    ok = jr[4]
    np.testing.assert_array_equal(tr[4], ok)
    assert ok.sum() > 1000
    worst = [float(np.abs(t[ok] - j[ok]).max()) for t, j in zip(tr[:4], jr[:4])]
    print(f"\n[billboard] {int(ok.sum())} hits; max |d| prop {worst[0]:.3g}, normal "
          f"{worst[1]:.3g}, u {worst[2]:.3g}, v {worst[3]:.3g}")
    assert max(worst) <= 2e-6

    # two textures of different sizes in one atlas, sampled at the hits' (u, v)
    tex = [rng.random((8, 8, 4)).astype(np.float32), rng.random((5, 7, 4)).astype(np.float32)]
    atlas = np.zeros((2, 8, 8, 4), np.float32)
    atlas[0], atlas[1, :5, :7] = tex[0], tex[1]
    hw = np.asarray([[8, 8], [5, 7]], np.float32)
    u, v = jr[2][ok], jr[3][ok]
    for t_id in (0, 1):
        want = np.asarray(JO._sample_texture(jnp.asarray(atlas), jnp.asarray(hw),
                                             jnp.int32(t_id), jnp.asarray(u), jnp.asarray(v)))
        got = TO._sample_texture(torch.from_numpy(atlas), torch.from_numpy(hw),
                                 torch.tensor(t_id, dtype=torch.int32),
                                 torch.from_numpy(u), torch.from_numpy(v)).numpy()
        d = float(np.abs(got - want).max())
        print(f"[texture {t_id}] max |drgba| {d:.3g} over {u.size} samples")
        assert d <= 1e-6


# -- the merges ----------------------------------------------------------------


def _random_hits(rng, shape, k):
    """A seeded [..., K] hit buffer as numpy fields; keys drawn from a small
    pool, so that equal keys occur."""
    valid = rng.random(shape + (k,)) < 0.6
    pool = np.arange(0, 40, 0.5, dtype=np.float32)
    key = np.where(valid, rng.choice(pool, shape + (k,)), np.inf).astype(np.float32)
    f = {
        "valid": valid, "key": key,
        **{nm: rng.normal(0, 100, shape + (k,)).astype(np.float32)
           for nm in ("dlat", "dlon", "distance", "elevation", "path_length")},
        "normal": rng.normal(0, 1, shape + (k, 3)).astype(np.float32),
        "kind": rng.integers(0, 2, shape + (k,)).astype(np.int32),
        "rgba": rng.random(shape + (k, 4)).astype(np.float32),
    }
    return f


def _planes_of(f, k_out):
    """The JAX plane dict and the port plane pair of the same hits."""
    hb = HitBuffer(**{n: torch.from_numpy(np.asarray(x)) for n, x in f.items()})
    key, vals = TO._pad_planes(TO.hits_to_planes(hb), k_out)
    planes = {"key": [jnp.asarray(key[..., s].numpy()) for s in range(k_out)]}
    for c, nm in enumerate(TO.PLANE_CHANNELS):
        planes[nm] = [jnp.asarray(vals[c, ..., s].numpy()) for s in range(k_out)]
    return planes, (key, vals)


def test_merge_planes_and_merge_hits_match_jax():
    """Keys bit-equal; payloads bit-equal where one key matches (equal keys
    average in both packages, in their own summation order)."""
    rng = np.random.default_rng(5)
    shape = (24, 40)
    a = _random_hits(rng, shape, 3)
    b = _random_hits(rng, shape, 4)
    k_out = 5
    ja, ta = _planes_of(a, k_out)
    jb, tb = _planes_of(b, 4)
    want = JO._merge_planes(ja, jb, k_out)
    got_key, got_vals = TO._merge_planes(ta, tb, k_out)
    want_key = np.stack([np.asarray(p) for p in want["key"]], -1)
    np.testing.assert_array_equal(got_key.numpy(), want_key)
    all_keys = np.concatenate([ta[0].numpy(), tb[0].numpy()], -1)
    n_match = (all_keys[..., None, :] == want_key[..., :, None]).sum(-1)
    one = n_match == 1
    assert one.mean() > 0.3 and (n_match > 1).any()
    for c, nm in enumerate(TO.PLANE_CHANNELS):
        w = np.stack([np.asarray(p) for p in want[nm]], -1)
        np.testing.assert_array_equal(got_vals[c].numpy()[one], w[one], err_msg=nm)
        np.testing.assert_allclose(got_vals[c].numpy(), w, rtol=1e-6, atol=1e-5,
                                   err_msg=nm)

    # merge_hits on [P, K] buffers, as the Rectilinear paths call it
    a = _random_hits(rng, (500,), 2)
    b = _random_hits(rng, (500,), 6)
    from atm_raytracer_tpu.generators.base import HitBuffer as JHB

    want = JO.merge_hits(JHB(**{n: jnp.asarray(x) for n, x in a.items()}),
                         JHB(**{n: jnp.asarray(x) for n, x in b.items()}), 8)
    got = TO.merge_hits(HitBuffer(**{n: torch.from_numpy(x) for n, x in a.items()}),
                        HitBuffer(**{n: torch.from_numpy(x) for n, x in b.items()}), 8)
    np.testing.assert_array_equal(got.key.numpy(), np.asarray(want.key))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    keys_all = np.where(np.concatenate([a["valid"], b["valid"]], -1),
                        np.concatenate([a["key"], b["key"]], -1), np.inf)
    one = (keys_all[:, None, :] == np.asarray(want.key)[:, :, None]).sum(-1) == 1
    one &= np.asarray(want.valid)
    assert one.sum() > 500
    for nm in HIT_FIELDS + ("kind",):
        np.testing.assert_array_equal(getattr(got, nm).numpy()[one],
                                      np.asarray(getattr(want, nm))[one], err_msg=nm)


# -- the object passes on the objects golden scene ------------------------------


@pytest.fixture(scope="module")
def golden_pass(golden_dir):
    """The JAX package's own march and terrain columns of the objects golden
    scene (Fast camera), its ObjectSet and windows, and terrain hits of K =
    2 slots with seeded payloads (zero where invalid)."""
    cfg = _golden_cfg(golden_dir)
    jp, jt, _, _ = _both(cfg, golden_dir)
    out, frame = jp.output, jp.view.frame
    alt0 = jp.view.position.abs_altitude(jt)
    elev = JCAM.fast_ray_elevations(out.width, out.height, frame.fov, frame.tilt)
    az = JCAM.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)
    step = float(jp.simulation_step)
    n_terr = int(math.ceil(frame.max_distance / step))
    jset, wins = JF.build_objects_cached(jp, az, n_terr)
    table = JF.build_refraction_table(jp, alt0)
    ray_h, path_len = march_rays(float(alt0), jnp.deg2rad(jnp.asarray(elev, jnp.float32)),
                                 step, n_terr - 1, jp.model.to_shape(), table, False,
                                 coarse=march_coarse(step))
    dists = jnp.arange(n_terr, dtype=jnp.float32) * jnp.float32(step)
    dlat, dlon = jp.model.geodesic_delta(LAT0, LON0, jnp.asarray(az, jnp.float32)[:, None],
                                         dists[None, :])
    pack = jt.pack(*JF.terrain_bbox(jp))
    terr, _ = sample_terrain_data(pack, jp.model, dlat, dlon, LAT0, LON0)
    segs = np.asarray(JC.terrain_crossing_segments(ray_h, terr, n_terr - 1, 2))
    rng = np.random.default_rng(3)
    valid = segs < n_terr - 1
    f = _random_hits(rng, valid.shape[:2], 2)
    f["valid"] = valid
    f["key"] = np.where(valid, segs.astype(np.float32) + 0.25, np.inf).astype(np.float32)
    f["kind"] = np.zeros_like(f["kind"])
    return dict(jp=jp, jset=jset, wins=wins, step=step, n_terr=n_terr, az=az,
                ray_h=ray_h, path_len=path_len, dlat=dlat, dlon=dlon, hits=f)


def test_fast_object_pass_matches_jax(golden_pass):
    """``apply_objects_planes`` against the JAX package's (both fed the JAX
    march and terrain columns): validity equal, keys within 1e-5 of a step,
    fields on valid slots within rtol 1e-5 / atol 1e-3 m, invalid slots
    zero."""
    g = golden_pass
    jset, wins, n_obj = g["jset"], g["wins"], g["jset"].n_objects
    k_out = 2 + min(2 * JO.max_window_overlap(wins, n_obj), max(TF.OBJ_HIT_CAP, 2))
    jplanes, tplanes = _planes_of(g["hits"], k_out)
    model = g["jp"].model
    want = jax.jit(lambda p: JO.apply_objects_planes(
        p, jset, model, LAT0, LON0, g["step"], g["ray_h"], g["path_len"], g["dlat"],
        g["dlon"], wins, k_out))(jplanes)
    t = {n: torch.from_numpy(np.asarray(g[n])) for n in ("ray_h", "path_len", "dlat", "dlon")}
    key, vals = TO.apply_objects_planes(
        tplanes, _port_objects(jset), TEarth.from_config(model.to_config()), LAT0,
        g["step"], t["ray_h"], t["path_len"], t["dlat"], t["dlon"], wins, k_out)
    want_key = np.stack([np.asarray(p) for p in want["key"]], -1)
    got_key = key.numpy()
    jv, tv = np.isfinite(want_key), np.isfinite(got_key)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > np.isfinite(tplanes[0].numpy()).sum()  # the objects added hits
    kind_c = TO.PLANE_CHANNELS.index("kind")
    n_obj_hits = int((vals[kind_c].numpy()[tv] > 0.5).sum())
    assert n_obj_hits > 100
    dk = float(np.abs(got_key[tv] - want_key[tv]).max())
    worst = 0.0
    for c, nm in enumerate(TO.PLANE_CHANNELS):
        w = np.stack([np.asarray(p) for p in want[nm]], -1)
        gv = vals[c].numpy()
        np.testing.assert_allclose(gv[tv], w[tv], rtol=1e-5, atol=1e-3, err_msg=nm)
        worst = max(worst, float(np.abs(gv[tv] - w[tv]).max()))
        assert not gv[~tv].any(), f"{nm}: payload on an invalid slot"
    print(f"\n[fast object pass] {int(tv.sum())} valid slots ({n_obj_hits} object hits) "
          f"of {tv.size}; max |dkey| {dk:.3g} step, max |dfield| {worst:.3g}")
    assert dk <= 1e-5


def test_the_pass_on_cpu_tensors_is_the_plain_pass(golden_pass):
    """``apply_objects_planes`` on CPU tensors, with and without ``plain``,
    returns exactly what ``apply_objects_planes_plain`` returns, and
    launches no kernel."""
    from atm_raytracer_tpu_torch import _kernels

    g = golden_pass
    wins, k_out = g["wins"], 9
    _, tplanes = _planes_of(g["hits"], 2)
    t = {n: torch.from_numpy(np.asarray(g[n])) for n in ("ray_h", "path_len", "dlat", "dlon")}
    args = (tplanes, _port_objects(g["jset"]), TEarth.from_config(g["jp"].model.to_config()),
            LAT0, g["step"], t["ray_h"], t["path_len"], t["dlat"], t["dlon"], wins, k_out)
    before = _kernels.OBJECT_PASS.launches
    want = TO.apply_objects_planes_plain(*args)
    for got in (TO.apply_objects_planes(*args), TO.apply_objects_planes(*args, plain=True)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[0].shape[-1] == k_out and _kernels.OBJECT_PASS.launches == before
    assert int((want[1][TO.PLANE_CHANNELS.index("kind")] > 0.5).sum()) > 100


@pytest.mark.parametrize("shape", list(WINDOW_SHAPES))
def test_column_tables_give_enu_rel(shape):
    """K6's per-column prologue (``object_column_tables``) on a seeded scene
    of each earth family: at every window column of every object in view,
    its terms finish (``enu_from_terms``) to ``EarthModel.enu_rel`` of the
    window's points at several ray altitudes, within 1e-3 m; its first
    window step and segment close flags are the plain pass's culling."""
    cfg = seeded_objects_config(WINDOW_SHAPES[shape], seed=23)
    params = TConfig.from_dict(cfg).into_params(None)
    model = params.model
    lat0, lon0, az, step, n_terr = fast_window_args(params)
    objects = TO.ObjectSet.build(params, "cpu")
    wins = TO.object_col_windows(objects, model, lat0, lon0, az, step, n_terr)
    dlat, dlon = TF.column_geodesic(model, torch.tensor(az, dtype=torch.float32), lat0, lon0,
                                    step, n_terr)
    tables = TO.object_column_tables(objects, model, lat0, dlat, dlon, wins)
    kw = objects.seg_window
    assert tables.terms.shape == (kw + 1, 3, sum(n for _, n in wins))
    worst, n_in_view = 0.0, 0
    for oi, (lo, wn, off) in enumerate(tables.windows):
        assert (lo, wn) == wins[oi]
        if not wn:
            continue
        n_in_view += 1
        cols = slice(off, off + wn)
        o = (objects.dlat[oi], objects.dlon[oi], objects.elev[oi])
        # the plain pass's culling over the window's columns
        rel = model.enu_rel(dlat[lo:lo + wn], dlon[lo:lo + wn], o[2], *o, lat0)
        close = TO._dot(rel, rel) < objects.cull_r2[oi]
        first = torch.where(close.any(dim=1), torch.argmax(close.to(torch.uint8), dim=1),
                            n_terr)
        assert torch.equal(tables.k_lo[cols].long(),
                           torch.clamp(first - 1, 0, max(n_terr - kw - 1, 0)))
        k_idx = torch.clamp(tables.k_lo[cols, None].long() + torch.arange(kw + 1),
                            max=n_terr - 1)
        g_close = close.gather(1, k_idx)
        assert torch.equal(tables.seg_close[:, cols].T.bool(),
                           g_close[:, :-1] | g_close[:, 1:])
        terms = tuple(tables.terms[:, d, cols].T for d in range(3))
        for alt in (-40.0, 0.0, 180.0, 950.0, 4000.0):
            h = torch.full(k_idx.shape, alt) + 0.01 * k_idx
            got = model.enu_from_terms(terms, h, o[2])
            want = model.enu_rel(dlat[lo:lo + wn].gather(1, k_idx),
                                 dlon[lo:lo + wn].gather(1, k_idx), h, *o, lat0)
            worst = max(worst, float((got - want).abs().max()))
    print(f"\n[column tables] {shape}: {n_in_view} objects in view, max |d enu| {worst:.3g} m")
    assert n_in_view >= 4 and worst <= 1e-3


def test_object_hits_pixelwise_match_jax(golden_pass):
    """``object_hits_pixelwise`` on the golden rays (each pixel row's ray at
    its column's azimuth): validity equal, keys within 1e-5 of a step,
    fields within rtol 1e-5 / atol 1e-3 m on the valid slots. Slots are
    compared after sorting by key: ``top_k`` and ``torch.topk`` need not
    order ties (and the +inf slots) alike, whose payload is junk in both."""
    g = golden_pass
    jset = g["jset"]
    # 1536 rays: row r of the Fast march at the azimuth of column c
    h_n, w_n = g["ray_h"].shape[0], g["az"].shape[0]
    rr, cc = np.meshgrid(np.arange(h_n), np.arange(0, w_n, 2), indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    ray_h = np.asarray(g["ray_h"])[rr]
    path_len = np.asarray(g["path_len"])[rr]
    az = np.asarray(g["az"], np.float32)[cc]
    model = g["jp"].model
    want = jax.jit(lambda rh, pl, a: JO.object_hits_pixelwise(
        jset, model, LAT0, LON0, g["step"], g["n_terr"], rh, pl, a))(
        jnp.asarray(ray_h), jnp.asarray(path_len), jnp.asarray(az))
    got = TO.object_hits_pixelwise(
        _port_objects(jset), TEarth.from_config(model.to_config()), LAT0, LON0,
        g["step"], g["n_terr"], torch.from_numpy(ray_h), torch.from_numpy(path_len),
        torch.from_numpy(az))
    jk, tk = np.asarray(want.key), got.key.numpy()
    assert tk.shape == jk.shape == (rr.size, 2 * jset.n_objects)
    jo, to = np.argsort(jk, -1, kind="stable"), np.argsort(tk, -1, kind="stable")

    def srt(x, order):
        x = np.asarray(x)
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
        return np.take_along_axis(x, idx, axis=1)

    jv, tv = srt(want.valid, jo), srt(got.valid, to)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 50
    dk = float(np.abs(srt(tk, to)[tv] - srt(jk, jo)[tv]).max())
    worst = 0.0
    for nm in HIT_FIELDS:
        a, b = srt(getattr(got, nm), to)[tv], srt(getattr(want, nm), jo)[tv]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3, err_msg=nm)
        worst = max(worst, float(np.abs(a - b).max()))
    assert (srt(got.kind, to)[tv] == 1).all()
    print(f"\n[object_hits_pixelwise] {int(tv.sum())} valid of {tv.size} slots; max "
          f"|dkey| {dk:.3g} step, max |dfield| {worst:.3g}")
    assert dk <= 1e-5
