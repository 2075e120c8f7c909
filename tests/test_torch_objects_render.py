"""Scene-object renders from the PyTorch port on the CPU, against the JAX
package and the committed goldens: the three ``_objects`` goldens, the
reference-style YAML scene (textured Billboard, Cylinder, translucent
Frustum over translucent terrain) rendered by both packages, ``gen`` with
each generator writing both artifact formats and ``view --pixel`` reading
them, the ``.dat`` bytes against the JAX writer's, and the object-depth
warning on every call. Add ``-s`` to see the pixels moved.
"""

import copy
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_golden as G  # noqa: E402
import test_reference_config as RC  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators import render_fast as j_render_fast  # noqa: E402
from atm_raytracer_tpu.generators.base import HitBuffer as JHitBuffer  # noqa: E402
from atm_raytracer_tpu.generators.base import RenderResult as JRenderResult  # noqa: E402
from atm_raytracer_tpu.meta import serialize as JS  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import cli  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import fast  # noqa: E402
from atm_raytracer_tpu_torch.generators.fast import render_fast  # noqa: E402
from atm_raytracer_tpu_torch.generators.interpolating import render_interpolating  # noqa: E402
from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear  # noqa: E402
from atm_raytracer_tpu_torch.meta import serialize as TS  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import M_PER_DEG, make_terrain_folder  # noqa: E402
from torch_parity import verify_tolerance  # noqa: E402

RENDER = {"Fast": render_fast, "Rectilinear": render_rectilinear,
          "InterpolatingRectilinear": render_interpolating}
FIELDS = ("valid", "key", "dlat", "dlon", "distance", "elevation", "path_length",
          "normal", "kind", "rgba")


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    return make_terrain_folder(tmp_path_factory.mktemp("torch_obj_render"),
                               tiles=((49, 21),), n=181)


def _objects_cfg(golden_dir, generator="Fast"):
    cfg = G._base_config(**copy.deepcopy(G.SCENES["objects"]))
    cfg["scene"]["terrain_folder"] = str(golden_dir)
    cfg["output"]["generator"] = generator
    return cfg


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("generator", list(RENDER))
def test_objects_golden_from_port(generator, golden_dir):
    """The port renders the golden object scene with each generator within
    the verify tolerance of the committed PNG."""
    tt = TTerrain.from_folder(golden_dir)
    params = TConfig.from_dict(_objects_cfg(golden_dir, generator)).into_params(tt)
    res = RENDER[generator](params, tt, "cpu")
    golden = _png(G.GOLDEN_DIR / f"{generator.lower()}_objects.png")
    ok, frac_any, frac_big = verify_tolerance(res.image, golden)
    moved = int((np.abs(res.image.astype(np.int16) - golden).max(-1) > 0).sum())
    print(f"\n[{generator.lower()}_objects] {moved} of {golden.shape[0] * golden.shape[1]} "
          f"pixels moved (any {frac_any:.4f}, > 2 counts {frac_big:.4f})")
    assert ok, (frac_any, frac_big)
    assert bool((res.hits.valid & (res.hits.kind == 1)).any())


def test_reference_style_scene_matches_jax(tmp_path):
    """The reference-style YAML scene (tests/test_reference_config.py),
    rendered by both packages: images within the verify tolerance, the same
    slot count, object hits in both, and the valid masks agreeing."""
    import yaml
    from PIL import Image

    terr_sub = tmp_path / "terrain"
    terr_sub.mkdir()
    terrain_dir = make_terrain_folder(terr_sub, tiles=((49, 21),), n=241)
    tex = tmp_path / "texture.png"
    arr = np.zeros((8, 8, 4), np.uint8)
    arr[..., 1] = 200
    arr[..., 3] = 255
    arr[2:4, :, 3] = 0  # a fully transparent band
    Image.fromarray(arr).save(tex)
    cfg = yaml.safe_load(RC.REFERENCE_STYLE_CONFIG.format(
        terrain=terrain_dir, texture=tex, out=tmp_path / "out.png",
        meta=tmp_path / "out.dat"))
    jt = JTerrain.from_folder(terrain_dir)
    jres = j_render_fast(JConfig.from_dict(cfg).into_params(jt), jt)
    tt = TTerrain.from_folder(terrain_dir)
    tres = render_fast(TConfig.from_dict(cfg).into_params(tt), tt, "cpu")
    ok, frac_any, frac_big = verify_tolerance(tres.image, np.asarray(jres.image))
    jv, tv = np.asarray(jres.hits.valid), tres.hits.valid.numpy()
    jk, tk = np.asarray(jres.hits.kind), tres.hits.kind.numpy()
    print(f"\n[reference-style] any {frac_any:.4f}, > 2 counts {frac_big:.4f}; valid "
          f"slots differ {int((jv != tv).sum())} of {jv.size}; object hits port "
          f"{int((tv & (tk == 1)).sum())}, JAX {int((jv & (jk == 1)).sum())}")
    assert ok, (frac_any, frac_big)
    assert tv.shape == jv.shape
    assert (tv & (tk == 1)).any() and (jv & (jk == 1)).any()
    assert (tv != jv).mean() <= 0.01


@pytest.mark.parametrize("generator", list(RENDER))
def test_cli_gen_objects_both_artifacts_and_view(generator, golden_dir, tmp_path,
                                                 monkeypatch, capsys):
    """``gen`` renders the objects golden with each generator and writes
    the npz and the ``.dat`` artifact; ``view --pixel`` prints an object
    trace point from each, and both re-composite to the PNG ``gen`` wrote."""
    import yaml

    from atm_raytracer_tpu_torch.meta.serialize import load_metadata
    from atm_raytracer_tpu_torch.meta.viewer import _render_from_metadata

    cfg = _objects_cfg(golden_dir, generator)
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    for fmt, name in (("native", "m.npz"), ("reference", "m.dat")):
        assert cli.main(["gen", "-c", "cfg.yaml", "--device", "cpu", "--output-meta", name,
                         "--meta-format", fmt]) == 0
        img = _png(tmp_path / "out.png")
        ok, frac_any, frac_big = verify_tolerance(
            img, _png(G.GOLDEN_DIR / f"{generator.lower()}_objects.png"))
        assert ok, (frac_any, frac_big)
        config, res = load_metadata(tmp_path / name)
        assert len(config.scene.objects) == 3
        np.testing.assert_array_equal(_render_from_metadata(config, res, "cpu"), img)
        obj = (res.hits.valid & (res.hits.kind == 1)).any(-1).numpy()
        y, x = (int(i) for i in np.argwhere(obj)[0])
        capsys.readouterr()
        assert cli.main(["view", name, "--pixel", str(x), str(y), "--device", "cpu"]) == 0
        assert "(object)" in capsys.readouterr().out


def test_dat_bytes_of_objects_golden_equal_jax(golden_dir, tmp_path):
    """The port's ``.dat`` of the objects golden equals the JAX writer's
    bytes on the same hits, each Relative object at its absolute
    elevation on the terrain."""
    tt = TTerrain.from_folder(golden_dir)
    jt = JTerrain.from_folder(golden_dir)
    cfg = _objects_cfg(golden_dir)
    tconfig, jconfig = TConfig.from_dict(cfg), JConfig.from_dict(cfg)
    res = render_fast(tconfig.into_params(tt), tt, "cpu")
    TS.save_metadata(tmp_path / "port.dat", tconfig, res, fmt="reference", terrain=tt)
    jres = JRenderResult(
        image=res.image,
        hits=JHitBuffer(**{f: getattr(res.hits, f).numpy() for f in FIELDS}),
        elevation_deg=res.elevation_deg, azimuth_deg=res.azimuth_deg,
        observer=res.observer)
    JS.save_metadata(tmp_path / "jax.dat", jconfig, jres, fmt="reference", terrain=jt)
    got, want = (tmp_path / "port.dat").read_bytes(), (tmp_path / "jax.dat").read_bytes()
    print(f"\n[.dat] {len(got)} B; K = {res.hits.valid.shape[-1]}")
    assert got == want
    params = TS.reference_params_dict(tconfig, tt)
    assert all(o["position"]["elev"] > 0.0 for o in params["scene"]["objects"])


def test_depth_truncation_warns_on_every_call(golden_dir, capsys, monkeypatch):
    """Four translucent cylinders on one azimuth need 8 object slots: with
    the default cap of 6 every render prints the truncation warning (two
    calls of one Params, the second from the memoized objects); a cap of 8
    (``fast.OBJ_HIT_CAP``, read at every call) keeps the deeper hits and
    stays silent, and the capped frame is the front of the full one."""
    lat0, lon0 = G.LAT0, G.LON0
    cfg = _objects_cfg(golden_dir)
    cfg["view"]["position"]["altitude"] = {"Relative": 20.0}
    cfg["view"]["frame"] = {"direction": 0.0, "fov": 10.0, "max_distance": 5000.0}
    cfg["simulation_step"] = 25.0
    cfg["scene"]["terrain_alpha"] = 1.0
    cfg["scene"]["objects"] = [{
        "position": {"latitude": lat0 + (400.0 + 200.0 * i) / M_PER_DEG, "longitude": lon0,
                     "altitude": {"Relative": 0.0}},
        "color": {"r": 0.8, "g": 0.2, "b": 0.2, "a": 0.5},
        "shape": {"Cylinder": {"radius": 30.0, "height": 120.0}},
    } for i in range(4)]
    tt = TTerrain.from_folder(golden_dir)
    params = TConfig.from_dict(cfg).into_params(tt)
    capped = []
    for _ in range(2):
        capsys.readouterr()
        capped.append(render_fast(params, tt, "cpu"))
        err = capsys.readouterr().err
        assert "WARNING: object metadata depth truncated: 4 object windows" in err, err
    monkeypatch.setattr(fast, "OBJ_HIT_CAP", 8)
    full = render_fast(params, tt, "cpu")
    assert "truncated" not in capsys.readouterr().err
    vc, vf = capped[0].hits.valid, full.hits.valid
    kc = vc.shape[-1]
    assert kc == 1 + 6 and vf.shape[-1] == 1 + 8
    assert int(vc.sum(-1).max()) == kc and int(vf.sum(-1).max()) > kc
    assert torch.equal(vc, vf[..., :kc])
    assert torch.equal(capped[0].hits.key[vc], full.hits.key[..., :kc][vc])
    assert torch.equal(capped[1].hits.key, capped[0].hits.key)
    assert math.isfinite(float(full.hits.key[vf].max()))


def test_card_tests_objects_scene_is_the_golden(golden_dir):
    """The JAX-free copy of the objects golden scene that the card tests
    and ``chip_smoke.py`` render (``torch_parity.objects_golden_config``)
    is tests/test_golden.py's, for each generator and tilted."""
    from torch_parity import objects_golden_config

    for generator in RENDER:
        for tilt in (0.0, 1.0):
            want = _objects_cfg(".", generator)
            want["view"]["frame"]["tilt"] = tilt  # the golden leaves the default 0
            assert objects_golden_config(generator, tilt) == want
