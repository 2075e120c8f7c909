"""End-to-end parity of the PyTorch port's Fast render with the JAX package,
its CLI, and the guards of the ported slice.

The three golden Fast scenes (tests/test_golden.py) render on the CPU with
the port's plain path and must sit within the on-chip verify tolerance
(bench.py:548-551) of both the JAX render and the committed golden PNG.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_golden as G  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators import render_fast as j_render_fast  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import cli  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import fast as T  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402
from torch_parity import verify_tolerance  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FAST_SCENES = ("plain", "translucent", "flat_straight")


@pytest.fixture(scope="module")
def terrain_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_golden")
    return make_terrain_folder(d, tiles=((49, 21),), n=181)


def _config(scene, terrain_dir):
    cfg = G._base_config(**copy.deepcopy(G.SCENES[scene]))
    cfg["scene"]["terrain_folder"] = str(terrain_dir)
    return cfg


def _golden(scene):
    from PIL import Image

    return np.asarray(Image.open(G.GOLDEN_DIR / f"fast_{scene}.png").convert("RGB"))


@pytest.mark.parametrize("scene", FAST_SCENES)
def test_golden_scene_matches_jax_and_golden(scene, terrain_dir):
    cfg = _config(scene, terrain_dir)
    jt = JTerrain.from_folder(terrain_dir)
    jres = j_render_fast(JConfig.from_dict(cfg).into_params(jt), jt)
    tt = TTerrain.from_folder(terrain_dir)
    tres = T.render_fast(TConfig.from_dict(cfg).into_params(tt), tt, "cpu")

    assert tres.image.shape == jres.image.shape and tres.image.dtype == np.uint8
    for other in (np.asarray(jres.image), _golden(scene)):
        ok, frac_any, frac_big = verify_tolerance(tres.image, other)
        assert ok, (scene, frac_any, frac_big)
    np.testing.assert_allclose(tres.azimuth_deg, jres.azimuth_deg)
    np.testing.assert_allclose(tres.observer, jres.observer)

    jv = np.asarray(jres.hits.valid)
    tv = tres.hits.valid.numpy()
    assert (jv != tv).mean() <= 0.01
    both = jv & tv
    np.testing.assert_allclose(tres.hits.key.numpy()[both],
                               np.asarray(jres.hits.key)[both], atol=1e-3)
    np.testing.assert_allclose(tres.hits.elevation.numpy()[both],
                               np.asarray(jres.hits.elevation)[both], atol=0.05)


def test_cli_gen_writes_golden_png(tmp_path, terrain_dir):
    import yaml

    cfg = _config("plain", terrain_dir)
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "atm_raytracer_tpu_torch.cli", "gen",
         "-c", "cfg.yaml", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "Done." in proc.stdout
    from PIL import Image

    img = np.asarray(Image.open(tmp_path / "out.png").convert("RGB"))
    ok, frac_any, frac_big = verify_tolerance(img, _golden("plain"))
    assert ok, (frac_any, frac_big)


def test_port_modules_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import atm_raytracer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 35, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("extra", [
    G.SCENES["objects"],
    {"output": {"file_metadata": "meta.npz"}},
    {"output": {"ticks": [{"Single": {"azimuth": 40.0, "size": 5, "labelled": True}}]}},
    {"output": {"show_eye_level": True}},
    {"output": {"generator": "InterpolatingRectilinear"}},
], ids=["objects", "metadata", "ticks", "eye_level", "generator"])
def test_unported_features_raise(extra, terrain_dir, tmp_path, monkeypatch):
    """The features the first slices refused are ported, and ``gen``
    renders, writes and draws them: scene objects (the objects golden),
    the metadata artifact, the overlays and the Interpolating generator."""
    import yaml
    from PIL import Image

    from atm_raytracer_tpu_torch.meta.serialize import load_metadata

    objects = "objects" in extra.get("scene", {})
    cfg = _config("objects" if objects else "plain", terrain_dir)
    if not objects:
        for key, val in extra.items():
            cfg[key].update(val)
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["gen", "-c", "cfg.yaml", "--device", "cpu"]) == 0
    img = np.asarray(Image.open(tmp_path / "out.png").convert("RGB"))
    golden = _golden("plain")
    if objects:
        ok, frac_any, frac_big = verify_tolerance(img, _golden("objects"))
        assert ok, (frac_any, frac_big)
    elif "generator" in extra["output"]:
        golden = np.asarray(Image.open(
            G.GOLDEN_DIR / "interpolatingrectilinear_plain.png").convert("RGB"))
        ok, frac_any, frac_big = verify_tolerance(img, golden)
        assert ok, (frac_any, frac_big)
    elif "file_metadata" in extra["output"]:
        meta_config, meta = load_metadata(tmp_path / "meta.npz")
        assert meta.hits.valid.shape == (48, 64, 1) and bool(meta.hits.valid.any())
        assert meta_config.output.file_metadata == "meta.npz"
        ok, frac_any, frac_big = verify_tolerance(img, golden)
        assert ok, (frac_any, frac_big)
    else:  # the overlay's pixels are drawn over the render
        moved = (img != golden).any(-1)
        assert moved.any()
        if "show_eye_level" in extra["output"]:
            assert (img[moved] == (255, 128, 255)).all(-1).mean() > 0.9
        else:
            assert (img[:6][moved[:6]] == 255).all()  # the tick's white line


def test_render_fast_refuses_objects(terrain_dir):
    """Scene objects render: object hits (kind 1) on valid slots of the
    terrain's one plus the window overlap's slots, with zero payload on
    every invalid slot."""
    cfg = _config("objects", terrain_dir)
    tt = TTerrain.from_folder(terrain_dir)
    res = T.render_fast(TConfig.from_dict(cfg).into_params(tt), tt, "cpu")
    v, kind = res.hits.valid, res.hits.kind
    assert v.shape == (48, 64, 7)
    obj = v & (kind == 1)
    assert int(obj.sum()) > 100
    assert bool((res.hits.rgba[..., 3][obj] > 0).all())
    for f in ("dlat", "dlon", "distance", "elevation", "path_length", "normal", "rgba"):
        assert not getattr(res.hits, f)[~v].any(), f


def test_cli_refuses_cuda_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.resolve_device("cuda")
    assert cli.main(["gen", "--device", "cuda", "-t", "/nonexistent"]) == 1
    assert "is_available() is false" in capsys.readouterr().err


@pytest.mark.parametrize("config", ["missing", "bad_shape"])
def test_cli_error_line_matches_jax(config, tmp_path):
    """A failed command prints the JAX CLI's line, ``ERROR: <msg>``
    (main.rs:36-38), to stderr and exits 1."""
    cfg = tmp_path / "c.yaml"
    if config == "bad_shape":
        cfg.write_text("earth_shape: Bogus\n")
    lines = []
    for pkg in ("atm_raytracer_tpu", "atm_raytracer_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", "gen", "-c", str(cfg), "--device", "cpu"]
            if pkg.endswith("torch") else
            [sys.executable, "-m", f"{pkg}.cli", "gen", "-c", str(cfg)],
            cwd=tmp_path, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(REPO), "ATM_RAYTRACER_PLATFORM": "cpu",
                 "OMP_NUM_THREADS": "1"},
        )
        assert proc.returncode == 1, proc.stderr
        lines.append(proc.stderr.strip().splitlines()[-1])
    assert lines[0].startswith("ERROR: ") and lines[1] == lines[0]
