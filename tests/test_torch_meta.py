"""Parity of the PyTorch port's metadata artifact and viewer with the JAX
package: config serialization, the reference bincode codec, the valid-slot
compaction, npz and ``.dat`` artifacts crossing between the packages, the
re-composite, pixel info, the viewer's events, and ``gen --output-meta`` /
``view`` end to end on the CPU.
"""

import copy
import gzip
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import matplotlib  # noqa: E402

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402

import test_bincode as BC  # noqa: E402
import test_golden as G  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators import render_fast as j_render_fast  # noqa: E402
from atm_raytracer_tpu.meta import bincode as JB, serialize as JS, viewer as JV  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import cli  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import fast as T  # noqa: E402
from atm_raytracer_tpu_torch.generators.base import HitBuffer, RenderResult  # noqa: E402
from atm_raytracer_tpu_torch.meta import bincode as TB, serialize as TS, viewer as TV  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("valid", "key", "dlat", "dlon", "distance", "elevation", "path_length",
          "normal", "kind", "rgba")


@pytest.fixture(scope="module")
def terrain_dir(tmp_path_factory):
    return make_terrain_folder(tmp_path_factory.mktemp("torch_meta"), tiles=((49, 21),),
                               n=181)


def _config(scene, terrain_dir, **output):
    cfg = G._base_config(**copy.deepcopy(G.SCENES[scene]))
    cfg["scene"]["terrain_folder"] = str(terrain_dir)
    cfg["output"].update(output)
    return cfg


@pytest.fixture(scope="module")
def port_renders(terrain_dir):
    """scene → (config dict, port Config, port result) on the CPU."""
    tt = TTerrain.from_folder(terrain_dir)
    out = {}
    for scene in ("plain", "translucent"):
        cfg = _config(scene, terrain_dir)
        config = TConfig.from_dict(cfg)
        out[scene] = (cfg, config, T.render_fast(config.into_params(tt), tt, "cpu"))
    return out


@pytest.fixture(scope="module")
def jax_translucent(terrain_dir):
    """(JAX Config, JAX result) of the translucent golden scene: K = 4 slots."""
    cfg = _config("translucent", terrain_dir)
    jt = JTerrain.from_folder(terrain_dir)
    config = JConfig.from_dict(cfg)
    return cfg, config, j_render_fast(config.into_params(jt), jt)


def _port_hits(hits) -> HitBuffer:
    """Another package's hit arrays (numpy or JAX) as this package's tensors."""
    return HitBuffer(**{f: torch.from_numpy(np.array(getattr(hits, f))) for f in FIELDS})


def _port_result_of(jres) -> RenderResult:
    """The JAX render's hits and grids as this package's RenderResult."""
    return RenderResult(
        image=np.asarray(jres.image),
        hits=_port_hits(jres.hits),
        elevation_deg=np.asarray(jres.elevation_deg),
        azimuth_deg=np.asarray(jres.azimuth_deg),
        observer=tuple(jres.observer),
    )


def _assert_hits_equal(got, want, fields=FIELDS):
    """Equal valid masks; every field bitwise equal on the valid slots."""
    gv, wv = np.asarray(got.valid), np.asarray(want.valid)
    np.testing.assert_array_equal(gv, wv)
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[gv],
                                      np.asarray(getattr(want, f))[wv], err_msg=f)


# -- config serialization -----------------------------------------------------

CONFIG_CASES = {
    **{s: {} for s in G.SCENES},
    "annotated": {"output": {
        "ticks": [{"Single": {"azimuth": -5.0, "size": 8, "labelled": True}},
                  {"Multiple": {"bias": 0.5, "step": 2.5, "size": 4, "labelled": False}}],
        "vertical_ticks": [{"Single": {"elevation": 1.0, "size": 6, "labelled": True}}],
        "show_eye_level": True, "show_flat_horizon": True, "file_metadata": "m.npz",
    }},
    "models": {
        "earth_shape": {"ObserverAe": {"projection_radius": 6_000_000.0}},
        "view": {"fog_distance": 9000.0,
                 "coloring": {"Shading": {"palette": "Legacy", "light_dir": 30.0}}},
        "atmosphere": {"temperature_fixed_point": {"altitude": 0.0, "temperature": 290.0},
                       "humidity": {"points": [[0.0, 0.8], [2000.0, 0.2]]}},
        "wavelength": 600e-9,
    },
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_config_to_dict_matches_jax(case, terrain_dir):
    scene = case if case in G.SCENES else "plain"
    cfg = _config(scene, terrain_dir)
    for key, val in CONFIG_CASES[case].items():
        if isinstance(val, dict) and isinstance(cfg.get(key), dict):
            for k, v in val.items():
                cfg[key][k] = v
        else:
            cfg[key] = val
    want = JConfig.from_dict(cfg).to_dict()
    got = TConfig.from_dict(cfg).to_dict()
    assert got == want
    # what JAX writes, the port reads back to the same tree
    assert TConfig.from_dict(want).to_dict() == want


@pytest.mark.parametrize("coloring", ["Simple", "Shading"])
def test_reference_params_dict_matches_jax(coloring, terrain_dir):
    """The tree the ``.dat`` writer encodes, equal to JAX's; scene objects
    at their absolute elevations, an Absolute and a Relative one (resolved
    on the terrain)."""
    cfg = _config("plain", terrain_dir)
    cfg["view"]["coloring"] = {coloring: {"water_level": 2.0}}
    want = JS.reference_params_dict(JConfig.from_dict(cfg))
    got = TS.reference_params_dict(TConfig.from_dict(cfg))
    assert got == want
    assert got["scene"]["objects"] == []
    cfg["scene"]["objects"] = [
        {"position": {"latitude": 49.6, "longitude": 21.6, "altitude": {"Absolute": 400.0}},
         "shape": {"Frustum": {"r1": 30.0, "r2": 10.0, "height": 120.0}},
         "color": {"r": 0.9, "g": 0.2, "b": 0.1}},
        {"position": {"latitude": 49.7, "longitude": 21.4, "altitude": {"Relative": 35.0}},
         "shape": {"Billboard": {"width": 40.0, "height": 20.0,
                                 "texture_path": "sign.png"}},
         "color": {"r": 0.1, "g": 0.2, "b": 0.9, "a": 0.5}},
    ]
    want = JS.reference_params_dict(JConfig.from_dict(cfg), JTerrain.from_folder(terrain_dir))
    got = TS.reference_params_dict(TConfig.from_dict(cfg), TTerrain.from_folder(terrain_dir))
    assert got == want
    elevs = [o["position"]["elev"] for o in got["scene"]["objects"]]
    assert elevs[0] == 400.0 and elevs[1] > 35.0


# -- the reference bincode codec ----------------------------------------------

@pytest.mark.parametrize("vec3_prefixed", [False, True])
def test_encode_alldata_bytes_match_jax(vec3_prefixed):
    params = BC._sample_params(BC._ENV)
    elev, az, hits = BC._sample_result()
    for compress in (True, False):
        want = JB.encode_alldata(params, elev, az, hits, vec3_prefixed=vec3_prefixed,
                                 compress=compress)
        got = TB.encode_alldata(params, elev, az, _port_hits(hits),
                                vec3_prefixed=vec3_prefixed, compress=compress)
        assert got == want


@pytest.mark.parametrize("vec3_prefixed", [False, True])
def test_decode_alldata_matches_jax(vec3_prefixed):
    params = BC._sample_params(BC._ENV)
    elev, az, hits = BC._sample_result()
    blob = JB.encode_alldata(params, elev, az, hits, vec3_prefixed=vec3_prefixed)
    jp, jel, jaz, jh = JB.decode_alldata(blob)
    tp, tel, taz, th = TB.decode_alldata(blob)
    assert tp == jp
    np.testing.assert_array_equal(tel, jel)
    np.testing.assert_array_equal(taz, jaz)
    assert all(getattr(th, f).device.type == "cpu" for f in FIELDS)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                                      err_msg=f)
    # both re-encode what they decoded (now f32 values) to the same bytes
    assert (TB.encode_alldata(tp, tel, taz, th, vec3_prefixed=vec3_prefixed)
            == JB.encode_alldata(jp, jel, jaz, jh, vec3_prefixed=vec3_prefixed))


def test_corrupt_artifact_errors():
    params = BC._sample_params(BC._ENV)
    elev, az, hits = BC._sample_result()
    raw = gzip.decompress(TB.encode_alldata(params, elev, az, hits))
    with pytest.raises(TB.BincodeError):
        TB.decode_alldata(raw[: len(raw) // 2])
    with pytest.raises(TB.BincodeError):
        TB.decode_alldata(TB.GZIP_MAGIC + b"\x00not a gzip stream")


def test_fuzzed_artifact_never_crashes():
    """Corrupted artifacts fail with the documented error family only
    (tests/test_bincode.py: the same mutations, the same seed)."""
    params = BC._sample_params(BC._ENV)
    elev, az, hits = BC._sample_result()
    blob = TB.encode_alldata(params, elev, az, hits)
    raw = gzip.decompress(blob)
    rng = np.random.RandomState(41)
    ok_types = (TB.BincodeError, ValueError, OSError, EOFError)

    def attempt(data):
        try:
            TB.decode_alldata(bytes(data))
        except ok_types:
            pass

    for src in (blob, raw):
        for _ in range(120):
            buf = bytearray(src)
            mode = rng.randint(3)
            if mode == 0:
                i = rng.randint(len(buf))
                buf[i] ^= 1 << rng.randint(8)
            elif mode == 1:
                buf = buf[: rng.randint(len(buf))]
            else:
                i = rng.randint(len(buf))
                n = min(rng.randint(1, 32), len(buf) - i)
                buf[i:i + n] = rng.bytes(n)
            attempt(buf)
    attempt(b"")
    attempt(b"\x1f\x8b")
    attempt(rng.bytes(4096))


# -- the valid-slot compaction --------------------------------------------------

def _random_hits(shape, seed, frac):
    rng = np.random.default_rng(seed)
    valid = rng.random(shape) < frac

    def f(*extra):
        return rng.normal(0.0, 100.0, shape + extra).astype(np.float32)

    return dict(
        valid=valid,
        key=np.where(valid, rng.random(shape) * 100.0, np.inf).astype(np.float32),
        dlat=f(), dlon=f(), distance=f(), elevation=f(), path_length=f(),
        normal=f(3), kind=rng.integers(0, 2, shape).astype(np.int32),
        rgba=rng.random(shape + (4,)).astype(np.float32),
    )


@pytest.mark.parametrize("shape,frac", [
    ((8, 12, 1), 0.5),    # P a multiple of 32
    ((7, 13, 4), 0.3),    # padded last word, K = 4
    ((5, 9, 2), 0.0),     # no hit at all
    ((3, 11, 1), 1.0),    # every slot valid
])
def test_compaction_matches_jax(shape, frac):
    h = _random_hits(shape, seed=sum(shape), frac=frac)
    jout = JS._pack_artifact(*(jnp.asarray(h[f]) for f in (
        "valid", "key", "dlat", "dlon", "elevation", "path_length", "normal",
        "kind", "rgba")))
    jbits, jcount = np.asarray(jout[0]), int(jout[1])
    bits, count, seg = TS._pack_artifact(
        HitBuffer(**{f: torch.from_numpy(v) for f, v in h.items()}))
    assert bits.dtype == np.uint32 and seg["kind"].dtype == np.uint8
    np.testing.assert_array_equal(bits, jbits)
    assert count == jcount == int(h["valid"].sum())
    for name, j in zip(TS.PACKED_FIELDS, jout[2:]):
        np.testing.assert_array_equal(seg[name], np.asarray(j)[:count].astype(seg[name].dtype),
                                      err_msg=name)


# -- artifacts: round trips, both formats, both packages ----------------------

@pytest.mark.parametrize("fmt", ["native", "reference"])
@pytest.mark.parametrize("scene", ["plain", "translucent"])
def test_artifact_roundtrip_recomposites_bit_exact(scene, fmt, port_renders, tmp_path):
    _, config, result = port_renders[scene]
    path = tmp_path / ("m.npz" if fmt == "native" else "m.dat")
    TS.save_metadata(path, config, result, fmt=fmt)
    config2, r2 = TS.load_metadata(path)
    assert r2.image is None and r2.hits.valid.device.type == "cpu"
    # the .dat stores distance, not the key: the key comes back as distance/step
    fields = FIELDS if fmt == "native" else tuple(f for f in FIELDS if f != "key")
    _assert_hits_equal(r2.hits, result.hits, fields)
    np.testing.assert_array_equal(TV._render_from_metadata(config2, r2, "cpu"),
                                  result.image)
    if fmt == "native":
        v = r2.hits.valid
        assert torch.isinf(r2.hits.key[~v]).all() and (r2.hits.distance[~v] == 0).all()
        assert config2.to_dict() == config.to_dict()


def test_port_npz_opens_in_jax(port_renders, tmp_path):
    cfg, config, result = port_renders["translucent"]
    path = tmp_path / "port.npz"
    TS.save_metadata(path, config, result)
    jconfig, jres = JS.load_metadata(path)
    assert jconfig.to_dict() == JConfig.from_dict(cfg).to_dict()
    _assert_hits_equal(jres.hits, result.hits)
    np.testing.assert_array_equal(JV._render_from_metadata(jconfig, jres), result.image)


@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_jax_artifact_opens_in_port(fmt, jax_translucent, tmp_path):
    cfg, jconfig, jres = jax_translucent
    path = tmp_path / ("jax.npz" if fmt == "native" else "jax.dat")
    JS.save_metadata(path, jconfig, jres, fmt=fmt)
    config, res = TS.load_metadata(path)
    _, jloaded = JS.load_metadata(path)
    _assert_hits_equal(res.hits, jloaded.hits)
    image = TV._render_from_metadata(config, res, "cpu")
    np.testing.assert_array_equal(image, JV._render_from_metadata(jconfig, jloaded))
    # the JAX render itself differs only in sky pixels that its composite
    # blackens (an invalid slot's NaN fog color times a zero alpha; this
    # package's composite zeroes invalid colors): one in this scene
    moved = (image != np.asarray(jres.image)).any(-1)
    assert moved.sum() <= 1 and not (moved & np.asarray(jres.hits.valid).any(-1)).any()
    assert (np.asarray(jres.image)[moved] == 0).all()


@pytest.mark.parametrize("scene", ["plain", "translucent"])
def test_reference_artifact_bytes_match_jax(scene, terrain_dir, jax_translucent,
                                            tmp_path):
    """The same render written by both packages as ``.dat``: the same bytes."""
    if scene == "translucent":
        cfg, jconfig, jres = jax_translucent
    else:
        cfg = _config(scene, terrain_dir)
        jconfig = JConfig.from_dict(cfg)
        jt = JTerrain.from_folder(terrain_dir)
        jres = j_render_fast(jconfig.into_params(jt), jt)
    JS.save_metadata(tmp_path / "j.dat", jconfig, jres, fmt="reference")
    TS.save_metadata(tmp_path / "t.dat", TConfig.from_dict(cfg), _port_result_of(jres),
                     fmt="reference")
    assert (tmp_path / "t.dat").read_bytes() == (tmp_path / "j.dat").read_bytes()


def test_native_artifact_arrays_match_jax(jax_translucent, tmp_path):
    """The same render written by both packages as npz: the same members
    (the zip container itself carries timestamps)."""
    cfg, jconfig, jres = jax_translucent
    JS.save_metadata(tmp_path / "j.npz", jconfig, jres)
    TS.save_metadata(tmp_path / "t.npz", TConfig.from_dict(cfg), _port_result_of(jres))
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        for name in j.files:
            assert t[name].dtype == j[name].dtype, name
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def test_v1_artifact_loads(port_renders, tmp_path):
    import yaml

    _, config, result = port_renders["translucent"]
    path = tmp_path / "v1.npz"
    np.savez_compressed(
        path,
        format_version=np.int64(1),
        config_yaml=np.frombuffer(yaml.safe_dump(config.to_dict()).encode(), np.uint8),
        observer=np.asarray(result.observer, np.float64),
        elevation_deg=np.asarray(result.elevation_deg, np.float64),
        azimuth_deg=np.asarray(result.azimuth_deg, np.float64),
        **{f: getattr(result.hits, f).numpy() for f in FIELDS},
    )
    config1, r1 = TS.load_metadata(path)
    for f in FIELDS:
        assert torch.equal(getattr(r1.hits, f), getattr(result.hits, f)), f
    np.testing.assert_array_equal(TV._render_from_metadata(config1, r1, "cpu"),
                                  result.image)


def test_pixel_info_matches_jax(port_renders, tmp_path):
    _, config, result = port_renders["translucent"]
    path = tmp_path / "m.npz"
    TS.save_metadata(path, config, result)
    tconf, tres = TS.load_metadata(path)
    jconf, jres = JS.load_metadata(path)
    valid = result.hits.valid.numpy()
    h, w, _ = valid.shape
    sky = np.argwhere(~valid.any(-1))[0]
    hit = np.argwhere(valid[..., 0])[[0, -1]]
    multi = np.argwhere(valid.sum(-1) > 1)
    pixels = [sky, *hit] + ([multi[0]] if len(multi) else [])
    for y, x in pixels:
        text = TV.pixel_info(tconf, tres, int(x), int(y))
        assert text == JV.pixel_info(jconf, jres, int(x), int(y))
    assert "No trace points" in TV.pixel_info(tconf, tres, int(sky[1]), int(sky[0]))


# -- the viewer's events (tests/test_viewer.py, on this package) --------------

def _fake_result(h=24, w=32, k=2):
    rng = np.random.default_rng(0)
    valid = np.zeros((h, w, k), bool)
    valid[..., 0] = True

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    hits = HitBuffer(
        valid=t(valid),
        key=t(np.where(valid, 1.0, np.inf).astype(np.float32)),
        dlat=t(rng.normal(0, 0.01, (h, w, k)).astype(np.float32)),
        dlon=t(rng.normal(0, 0.01, (h, w, k)).astype(np.float32)),
        distance=t(np.full((h, w, k), 1234.5, np.float32)),
        elevation=t(np.full((h, w, k), 321.0, np.float32)),
        path_length=t(np.full((h, w, k), 1240.0, np.float32)),
        normal=t(np.tile(np.array([0, 0, 1], np.float32), (h, w, k, 1))),
        kind=t(np.zeros((h, w, k), np.int32)),
        rgba=t(np.ones((h, w, k, 4), np.float32)),
    )
    return RenderResult(image=np.zeros((h, w, 3), np.uint8), hits=hits,
                        elevation_deg=np.linspace(5, -5, h),
                        azimuth_deg=np.linspace(40, 60, w),
                        observer=(49.5, 21.5, 400.0))


@pytest.fixture()
def app():
    fig, app = TV.build_viewer(None, _fake_result(), title="t")
    yield app
    import matplotlib.pyplot as plt

    plt.close(fig)


def _ev(app, x=None, y=None, key=None, step=0, inside=True):
    return types.SimpleNamespace(inaxes=app.ax_img if inside else None,
                                 xdata=x, ydata=y, key=key, step=step, button=1)


def test_viewer_click_selects_pixel(app):
    app.on_press(_ev(app, 10.2, 7.8))
    app.on_release(_ev(app, 10.2, 7.8))
    assert "Pixel (10, 8)" in app.text.get_text()
    assert list(app.marker.get_xdata()) == [10]


def test_viewer_wheel_zooms_about_cursor(app):
    x0, y0 = 10.0, 8.0
    xlim0 = app.ax_img.get_xlim()
    app.on_scroll(_ev(app, x0, y0, step=1))
    xlim1 = app.ax_img.get_xlim()
    scale = 1.0 / app.ZOOM_STEP
    assert xlim1[0] == pytest.approx(x0 - (x0 - xlim0[0]) * scale)
    assert xlim1[1] == pytest.approx(x0 + (xlim0[1] - x0) * scale)
    app.on_scroll(_ev(app, x0, y0, step=-1))
    assert app.ax_img.get_xlim() == pytest.approx(xlim0)


def test_viewer_drag_pans_and_does_not_select(app):
    xlim0, ylim0 = app.ax_img.get_xlim(), app.ax_img.get_ylim()
    app.on_press(_ev(app, 5.0, 5.0))
    app.on_motion(_ev(app, 8.0, 6.0))
    app.on_motion(_ev(app, 7.0, 5.0))
    app.on_release(_ev(app, 7.0, 5.0))
    xlim1, ylim1 = app.ax_img.get_xlim(), app.ax_img.get_ylim()
    assert xlim1[0] == pytest.approx(xlim0[0] - 5.0)
    assert xlim1[1] == pytest.approx(xlim0[1] - 5.0)
    assert ylim1[0] == pytest.approx(ylim0[0] - 1.0)
    assert "Pixel" not in app.text.get_text()


def test_viewer_space_selects_and_escape_clears(app):
    app.on_motion(_ev(app, 3.4, 2.1))
    app.on_key(_ev(app, key=" "))
    assert "Pixel (3, 2)" in app.text.get_text()
    assert "1.234 km" in app.text.get_text()
    app.on_key(_ev(app, key="escape"))
    assert "Pixel" not in app.text.get_text()
    assert len(app.marker.get_xdata()) == 0


def test_viewer_events_outside_image_ignored(app):
    xlim0 = app.ax_img.get_xlim()
    app.on_scroll(_ev(app, 5.0, 5.0, step=1, inside=False))
    app.on_press(_ev(app, 5.0, 5.0, inside=False))
    app.on_motion(_ev(app, 9.0, 9.0, inside=False))
    assert app.ax_img.get_xlim() == pytest.approx(xlim0)
    assert app._drag is None


# -- the CLI end to end ---------------------------------------------------------

def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "atm_raytracer_tpu_torch.cli", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
    )


@pytest.mark.parametrize("fmt,name", [("native", "m.npz"), ("reference", "m.dat")])
def test_cli_gen_output_meta_then_view(fmt, name, terrain_dir, tmp_path):
    import yaml
    from PIL import Image

    cfg = _config("translucent", terrain_dir, file="out.png")
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    gen = _cli(tmp_path, "gen", "-c", "cfg.yaml", "--device", "cpu",
               "--output-meta", name, "--meta-format", fmt)
    assert gen.returncode == 0, gen.stderr
    assert "Outputting metadata..." in gen.stdout and (tmp_path / name).exists()
    view = _cli(tmp_path, "view", name, "--pixel", "32", "40", "--device", "cpu",
                "--save-image", "view.png")
    assert view.returncode == 0, view.stderr
    assert "Pixel (32, 40)" in view.stdout and "Trace point 0 (terrain)" in view.stdout
    # no overlay is configured, so the re-composite is the written image
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "view.png")),
                                  np.asarray(Image.open(tmp_path / "out.png")))


def test_cli_view_refuses_cuda_without_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["view", str(tmp_path / "absent.npz"), "--device", "cuda"]) == 1
    assert "is_available() is false" in capsys.readouterr().err


def test_run_view_needs_a_device(tmp_path):
    """``run_view`` and the re-composite take the device from the caller,
    as ``render_fast`` does: no silent CPU default."""
    with pytest.raises(TypeError):
        TV.run_view(tmp_path / "missing.npz")
    with pytest.raises(TypeError):
        TV._render_from_metadata(TConfig(), None)
