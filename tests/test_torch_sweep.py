"""The port's batched sweep (``parallel.mesh.render_sweep_sharded``) against
the JAX package's, and against its own one-frame renders.

The scene is tests/test_parallel.py's (72x40, 8 km in 100 m steps). The JAX
sweeps run once per module on conftest's 8-device CPU mesh. A sweep frame
must equal the port's single render of that frame bit for bit (with the
table built at its altitude), and sit within the on-chip verify tolerance
of the JAX sweep's frame; ``-s`` prints the pixels moved.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.parallel import mesh as JM  # noqa: E402
from atm_raytracer_tpu.physics import atmosphere as JA  # noqa: E402
from atm_raytracer_tpu.physics import ray as JR  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import interop  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators.fast import render_fast  # noqa: E402
from atm_raytracer_tpu_torch.ops import combine as TC  # noqa: E402
from atm_raytracer_tpu_torch.ops.composite import composite  # noqa: E402
from atm_raytracer_tpu_torch.parallel import mesh as TM  # noqa: E402
from atm_raytracer_tpu_torch.physics import atmosphere as TA  # noqa: E402
from atm_raytracer_tpu_torch.physics import ray as TR  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402
from torch_parity import parallel_config, parallel_object, verify_tolerance  # noqa: E402

DIRS = [0.0, 45.0, 90.0, 135.0, 180.0]
CPU = TM.make_mesh(["cpu"])


def _strong(mod):  # an inversion: bends rays down (tests/test_parallel.py:129-136)
    return mod.AtmosphereDef(first_temperature_function=mod.LinearFunction(0.02),
                             temperature_fixed_point=(0.0, 283.15))


def _weak(mod):  # convective
    return mod.AtmosphereDef(first_temperature_function=mod.LinearFunction(-0.03),
                             temperature_fixed_point=(0.0, 293.15))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sweep")
    make_terrain_folder(d, tiles=((49, 21),), n=241)
    jt, tt = JTerrain.from_folder(d), TTerrain.from_folder(d)

    def params(cfg):
        return JConfig.from_dict(cfg).into_params(jt), TConfig.from_dict(cfg).into_params(tt)

    return {"dir": d, "jt": jt, "tt": tt, "params": params,
            "cfg": parallel_config(d)}


def _single(scene, cfg):
    return render_fast(scene["params"](cfg)[1], scene["tt"], "cpu")


def _frame_cfg(scene, **frame):
    cfg = copy.deepcopy(scene["cfg"])
    cfg["view"]["frame"].update(frame)
    return cfg


@pytest.fixture(scope="module")
def jax_sweep(scene):
    """The JAX sweep of DIRS with its hits (numpy)."""
    jp, _ = scene["params"](scene["cfg"])
    frames, hits = JM.render_sweep_sharded(jp, scene["jt"], JM.make_mesh(), DIRS,
                                           return_hits=True)
    return np.asarray(frames), np.asarray(hits.valid)


def _moved(a, b):
    return int((np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1) > 0).sum())


def test_sweep_matches_jax_and_single_renders(scene, jax_sweep):
    _, tp = scene["params"](scene["cfg"])
    frames, hits = TM.render_sweep_sharded(tp, scene["tt"], CPU, DIRS, return_hits=True)
    j_frames, j_valid = jax_sweep
    assert frames.shape == j_frames.shape == (5, 40, 72, 3) and frames.dtype == np.uint8
    for f, d in enumerate(DIRS):
        ok, frac_any, frac_big = verify_tolerance(frames[f], j_frames[f])
        print(f"frame {f} ({d} deg): {_moved(frames[f], j_frames[f])} pixels moved vs JAX")
        assert ok, (d, frac_any, frac_big)
        # a shared-table sweep frame is the single render of that direction
        single = _single(scene, _frame_cfg(scene, direction=d))
        np.testing.assert_array_equal(frames[f], single.image)
        for name in ("valid", "key", "distance", "elevation", "normal"):
            assert torch.equal(getattr(hits, name)[f], getattr(single.hits, name)), name
    agree = float((hits.valid.numpy() == j_valid).mean())
    print(f"hit slots agreeing with JAX: {agree}")
    assert agree >= 0.999


@pytest.mark.parametrize("vary", ["altitudes", "tilts", "fovs"])
def test_sweep_per_frame_camera_equals_single_render(vary, scene):
    """Per-frame altitude, tilt and fov: the varied frame equals a single
    render of it (the table of an altitude sweep is built at its top, so
    the elevated frame is the one a single render reproduces)."""
    jp, tp = scene["params"](scene["cfg"])
    alt0 = tp.view.position.abs_altitude(scene["tt"])
    d0 = 30.0
    kw, cfg = {
        "altitudes": ({"altitudes_m": [alt0, alt0 + 90.0]}, None),
        "tilts": ({"tilts_deg": [0.0, 6.0]}, _frame_cfg(scene, tilt=6.0)),
        "fovs": ({"fovs_deg": [18.0, 7.0]}, _frame_cfg(scene, fov=7.0)),
    }[vary]
    if cfg is None:
        cfg = copy.deepcopy(scene["cfg"])
        cfg["view"]["position"]["altitude"] = {"Absolute": float(alt0 + 90.0)}
    frames = TM.render_sweep_sharded(tp, scene["tt"], CPU, [d0, d0], **kw)
    assert (frames[0] != frames[1]).any(), "the varied frame must differ"
    np.testing.assert_array_equal(frames[1], _single(scene, cfg).image)
    j_frames = np.asarray(JM.render_sweep_sharded(jp, scene["jt"], JM.make_mesh(), [d0, d0],
                                                  **kw))
    ok, frac_any, frac_big = verify_tolerance(frames, j_frames)
    print(f"{vary}: {_moved(frames, j_frames)} pixels moved vs JAX")
    assert ok, (frac_any, frac_big)


def test_sweep_per_frame_atmospheres_matches_jax(scene):
    """Per-frame atmospheres stack into one table a frame (K2's table
    stride); the frames differ and match JAX's sweep."""
    jp, tp = scene["params"](scene["cfg"])
    d0 = 30.0
    frames = TM.render_sweep_sharded(tp, scene["tt"], CPU, [d0, d0],
                                     atmospheres=[_strong(TA), _weak(TA)])
    j_frames = np.asarray(JM.render_sweep_sharded(jp, scene["jt"], JM.make_mesh(), [d0, d0],
                                                  atmospheres=[_strong(JA), _weak(JA)]))
    assert (frames[0] != frames[1]).any(), "different profiles must differ"
    for f in range(2):
        ok, frac_any, frac_big = verify_tolerance(frames[f], j_frames[f])
        print(f"atmosphere frame {f}: {_moved(frames[f], j_frames[f])} pixels moved vs JAX")
        assert ok, (f, frac_any, frac_big)


def test_sweep_valid_mode_and_device_frames(scene, jax_sweep):
    """``return_hits="valid"`` gives the masks alone and ``fetch_frames=False``
    leaves the frames a tensor on the device, equal to the fetched ones."""
    _, tp = scene["params"](scene["cfg"])
    frames_d, valid = TM.render_sweep_sharded(tp, scene["tt"], CPU, DIRS,
                                              return_hits="valid", fetch_frames=False)
    assert isinstance(frames_d, torch.Tensor) and valid.dtype == torch.bool
    frames_h = TM.render_sweep_sharded(tp, scene["tt"], CPU, DIRS)
    np.testing.assert_array_equal(frames_d.numpy(), frames_h)
    assert float((valid.numpy() == jax_sweep[1]).mean()) >= 0.999


def test_sweep_with_objects_matches_jax(scene):
    """Objects follow JAX's sweep: the full width, no column windows."""
    cfg = copy.deepcopy(scene["cfg"])
    cfg["scene"]["terrain_alpha"] = 0.8
    cfg["scene"]["objects"] = [parallel_object(
        900.0, {"r": 1.0, "g": 0.2, "b": 0.1, "a": 0.9},
        {"Cylinder": {"radius": 25.0, "height": 150.0}})]
    jp, tp = scene["params"](cfg)
    dirs = [30.0, 20.0]
    frames, hits = TM.render_sweep_sharded(tp, scene["tt"], CPU, dirs, return_hits=True)
    j_frames, j_hits = JM.render_sweep_sharded(jp, scene["jt"], JM.make_mesh(), dirs,
                                               return_hits=True)
    assert bool((hits.valid & (hits.kind == 1)).any()), "no object hits"
    assert hits.valid.shape == tuple(np.asarray(j_hits.valid).shape)
    ok, frac_any, frac_big = verify_tolerance(frames, np.asarray(j_frames))
    print(f"objects: {_moved(frames, np.asarray(j_frames))} pixels moved vs JAX")
    assert ok, (frac_any, frac_big)
    assert float((hits.valid.numpy() == np.asarray(j_hits.valid)).mean()) >= 0.999


@pytest.mark.parametrize("atmospheres", [False, True], ids=["shared", "per_frame"])
def test_sweep_launches_each_kernel_once(atmospheres, scene, monkeypatch):
    """Eight frames: one combine call over [8, H, W, K] and one march over
    the 8·H rays, the stacked table read with H rays a frame (the kernels'
    plain versions stand in for the launches, counted as they would be)."""
    from atm_raytracer_tpu_torch import _kernels

    calls = {"combine": [], "march": []}
    plain_combine, plain_march = TC.terrain_crossing_segments, TR.march_nodes_plain

    def combine(ray_h, terr, n_seg, max_hits=1):
        calls["combine"].append(tuple(ray_h.shape))
        _kernels.COMBINE.launches += 1
        return plain_combine(ray_h, terr, n_seg, max_hits)

    def march(alt, v0, dx, n_coarse, table, radius, rays_per_frame=None):
        calls["march"].append((alt.shape[0], table.stacked, rays_per_frame))
        _kernels.MARCH.launches += 1
        return plain_march(alt, v0, dx, n_coarse, table, radius, rays_per_frame)

    monkeypatch.setattr(TC, "terrain_crossing_segments", combine)
    monkeypatch.setattr(TR, "march_nodes_plain", march)
    monkeypatch.setattr(_kernels.COMBINE, "launches", 0)
    monkeypatch.setattr(_kernels.MARCH, "launches", 0)
    _, tp = scene["params"](scene["cfg"])
    kw = {"atmospheres": [_strong(TA), _weak(TA)] * 4} if atmospheres else {}
    frames = TM.render_sweep_sharded(tp, scene["tt"], CPU, [45.0 * i for i in range(8)], **kw)
    assert frames.shape == (8, 40, 72, 3)
    assert (_kernels.COMBINE.launches, _kernels.MARCH.launches) == (1, 1)
    assert calls["combine"] == [(8, 40, 80)]
    assert calls["march"] == [(8 * 40, atmospheres, 40)]


def test_frame_batched_combine_plain_equals_frames():
    """K1's plain path with a frame axis is F one-frame calls, envelopes too."""
    rng = np.random.default_rng(3)
    f_n, h_n, w_n, n_seg = 3, 41, 37, 300
    ray = (120.0 + np.linspace(-3.0, 1.0, h_n)[None, :, None] * np.arange(n_seg + 1)
           + rng.normal(0.0, 2.0, (f_n, h_n, n_seg + 1))).astype(np.float32)
    terr = (100.0 + 30.0 * np.sin(np.arange(n_seg + 6) / 5.0)
            + rng.uniform(-5.0, 5.0, (f_n, w_n, n_seg + 6))).astype(np.float32)
    ray[1, :, 150:] = -2000.0  # frame 1 dies halfway
    r, t = torch.from_numpy(ray), torch.from_numpy(terr)
    for k in (1, 3):
        got = TC.terrain_crossing_segments(r, t, n_seg, k)
        assert got.shape == (f_n, h_n, w_n, k)
        for f in range(f_n):
            assert torch.equal(got[f], TC.terrain_crossing_segments(r[f], t[f], n_seg, k))
    env = TC.crossing_envelopes_plain(r, t, n_seg)
    assert [e.shape for e in env] == [(f_n, 6, 3)] * 2 + [(f_n, 2, 3)] * 2
    for f in range(f_n):
        for a, b in zip(env, TC.crossing_envelopes_plain(r[f], t[f], n_seg)):
            assert torch.equal(a[f], b)
    assert torch.equal(TC.ray_death_limit(r, n_seg)[1], TC.ray_death_limit(r[1], n_seg))
    with pytest.raises(ValueError, match="frame axis"):
        TC.terrain_crossing_segments(r, t[:2], n_seg, 1)


def test_strided_march_plain_equals_frames_and_jax():
    """K2's plain path with a stacked table (JAX's sweep table, carried by
    ``interop.sweep_table_from_arrays``) is one march a frame, and each
    frame stays within 2e-2 m of the JAX march on that frame's table."""
    import jax.numpy as jnp

    tables = [JR.RefractionTable.build(JA.Atmosphere(a), 530e-9, h_hi=h_hi)
              for a, h_hi in ((_strong(JA), 12000.0), (_weak(JA), 12500.0))]
    n_min = min(int(t.values.shape[0]) for t in tables)
    stacked = interop.sweep_table_from_arrays(
        tables[0].h0, tables[0].inv_dh,
        np.stack([np.asarray(t.values)[:n_min] for t in tables]),
        np.stack([np.asarray(t.pairs)[:n_min - 1] for t in tables]), "cpu")
    assert stacked.stacked and stacked.values.shape == (2, n_min)
    h_n, step, n = 33, 50.0, 330
    elev = np.deg2rad(np.linspace(-0.5, 1.0, h_n)).astype(np.float32)
    alts = np.repeat(np.float32([100.0, 400.0]), h_n)
    shape = TR.EarthShape(6_371_000.0)
    h, p = TR.march_rays(torch.from_numpy(alts), torch.from_numpy(np.tile(elev, 2)), step, n,
                         shape, stacked, False, coarse=16, rays_per_frame=h_n)
    for f, jt in enumerate(tables):
        one = interop.table_from_arrays(jt.h0, jt.inv_dh, np.asarray(jt.values)[:n_min], None,
                                        "cpu")
        hf, pf = TR.march_rays(float(alts[f * h_n]), torch.from_numpy(elev), step, n, shape,
                               one, False, coarse=16)
        assert torch.equal(h[f * h_n:(f + 1) * h_n], hf)
        assert torch.equal(p[f * h_n:(f + 1) * h_n], pf)
        jt_table = dataclasses.replace(jt, poly=None)
        jh, _ = JR.march_rays(float(alts[f * h_n]), jnp.asarray(elev), step, n,
                              JR.EarthShape(6_371_000.0), jt_table, False, coarse=16)
        err = float(np.abs(np.asarray(jh) - hf.numpy()).max())
        print(f"frame {f}: max |dh| vs JAX {err:.3g} m")
        assert err <= 2e-2
    with pytest.raises(ValueError, match="rays_per_frame"):
        TR.march_rays(torch.from_numpy(alts), torch.from_numpy(np.tile(elev, 2)), step, n,
                      shape, stacked, False, coarse=16)


def test_composite_light_override():
    """A [3] light equal to the coloring's changes nothing; a light a frame
    broadcasts over the frame's pixels."""
    cfg = parallel_config()
    params = TConfig.from_dict(cfg).into_params(None)
    rng = np.random.default_rng(5)
    shape = (2, 6, 7, 1)
    normal = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=shape + (3,)).astype(np.float32)), dim=-1)
    fields = dict(valid=torch.ones(shape, dtype=torch.bool),
                  alpha=torch.ones(shape), distance=torch.full(shape, 900.0),
                  elevation=torch.full(shape, 300.0), path_length=torch.full(shape, 900.0),
                  normal=normal, kind=torch.zeros(shape, dtype=torch.int32),
                  rgb=torch.zeros(shape + (3,)))
    c = params.coloring
    base = composite(c, None, *fields.values())
    same = composite(c, None, *fields.values(),
                     torch.tensor(c.light_dir, dtype=torch.float32))
    assert torch.equal(base, same)
    lights = torch.tensor([c.light_dir, (0.0, 0.0, 1.0)], dtype=torch.float32)
    per = composite(c, None, *fields.values(), lights[:, None, None, None, :])
    assert torch.equal(per[0], base[0]) and not torch.equal(per[1], base[1])
