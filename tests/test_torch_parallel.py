"""The port's multi-device modes (``parallel.mesh``) on a repeated CPU
device list, against its own one-device renders and the JAX package's
sharded renders on conftest's 8-device CPU mesh; ``gen --shard`` and the
JAX-free ``dryrun_multichip``.

A mode split over ``["cpu"] * 3`` (or more) must render the one-device
image, hit mask and keys bit for bit, as tests/test_parallel.py pins for
JAX, and sit within the on-chip verify tolerance of JAX's sharded render.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.parallel import mesh as JM  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import cli  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import base  # noqa: E402
from atm_raytracer_tpu_torch.generators.fast import render_fast  # noqa: E402
from atm_raytracer_tpu_torch.generators.interpolating import render_interpolating  # noqa: E402
from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear  # noqa: E402
from atm_raytracer_tpu_torch.parallel import mesh as TM  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402
from torch_parity import parallel_config, parallel_object, verify_tolerance  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel")
    make_terrain_folder(d, tiles=((49, 21),), n=241)
    return {"dir": d, "jt": JTerrain.from_folder(d), "tt": TTerrain.from_folder(d)}


def _objects_cfg(d, **frame):
    cfg = parallel_config(d, **frame)
    cfg["scene"]["terrain_alpha"] = 0.85
    cfg["scene"]["objects"] = [parallel_object(
        700.0, {"r": 0.9, "g": 0.3, "b": 0.1, "a": 1.0},
        {"Cylinder": {"radius": 30.0, "height": 200.0}})]
    return cfg


# mode: (config, JAX sharded render, port split render, port one-device render)
MODES = {
    "fast": (lambda d: parallel_config(d), JM.render_fast_sharded, TM.render_fast_sharded,
             render_fast),
    "fast_objects": (lambda d: _objects_cfg(d), JM.render_fast_sharded,
                     TM.render_fast_sharded, render_fast),
    "rectilinear": (lambda d: parallel_config(d), JM.render_rectilinear_sharded,
                    TM.render_rectilinear_sharded, render_rectilinear),
    # tilted with objects: the dense per-pixel program, split by pixels
    "rectilinear_tilted_objects": (
        lambda d: _objects_cfg(d, tilt=4.0), JM.render_rectilinear_sharded,
        TM.render_rectilinear_sharded,
        lambda p, t, dev: render_rectilinear(p, t, dev, cull=False)),
    "interpolating": (lambda d: parallel_config(d), JM.render_interpolating_sharded,
                      TM.render_interpolating_sharded, render_interpolating),
}


@pytest.mark.parametrize("n_dev", [3, 5])
@pytest.mark.parametrize("mode", list(MODES))
def test_split_render_equals_one_device_and_jax(mode, n_dev, scene):
    """3 devices split the 72 columns and 40 rows evenly; 5 pad them."""
    make_cfg, j_render, t_render, t_single = MODES[mode]
    cfg = make_cfg(scene["dir"])
    tp = TConfig.from_dict(cfg).into_params(scene["tt"])
    split = t_render(tp, scene["tt"], TM.make_mesh(["cpu"] * n_dev))
    single = t_single(tp, scene["tt"], "cpu")
    assert split.image.shape == single.image.shape == (40, 72, 3)
    np.testing.assert_array_equal(split.image, single.image)
    assert torch.equal(split.hits.valid, single.hits.valid)
    assert torch.equal(split.hits.key, single.hits.key)
    if "objects" in mode:
        assert bool((split.hits.valid & (split.hits.kind == 1)).any()), "no object hits"
    if n_dev == 3:  # the JAX render once a mode
        jp = JConfig.from_dict(cfg).into_params(scene["jt"])
        j_image = np.asarray(j_render(jp, scene["jt"], JM.make_mesh()).image)
        ok, frac_any, frac_big = verify_tolerance(split.image, j_image)
        print(f"{mode}: {int((split.image != j_image).any(-1).sum())} pixels moved vs JAX")
        assert ok, (frac_any, frac_big)


def test_sweep_split_over_devices_equals_one_device(scene, monkeypatch):
    """Five frames over three devices (one padding frame) give the one-device
    sweep; per-frame atmospheres and tilts split with their frames."""
    from atm_raytracer_tpu_torch.physics.atmosphere import AtmosphereDef, LinearFunction, us_76

    inversion = AtmosphereDef(first_temperature_function=LinearFunction(0.02),
                              temperature_fixed_point=(0.0, 283.15))
    tp = TConfig.from_dict(parallel_config(scene["dir"])).into_params(scene["tt"])
    kw = dict(directions_deg=[0.0, 45.0, 90.0, 135.0, 180.0],
              tilts_deg=[0.0, 1.0, -1.0, 2.0, 0.0],
              atmospheres=[us_76(), inversion] * 2 + [us_76()])
    one, hits1 = TM.render_sweep_sharded(tp, scene["tt"], TM.make_mesh(["cpu"]),
                                         return_hits=True, **kw)
    built = []
    build = base.build_refraction_table
    monkeypatch.setattr(base, "build_refraction_table",
                        lambda *a, **k: built.append(a[2:]) or build(*a, **k))
    three, hits3 = TM.render_sweep_sharded(tp, scene["tt"], TM.make_mesh(["cpu"] * 3),
                                           return_hits=True, **kw)
    assert three.shape == (5, 40, 72, 3)
    np.testing.assert_array_equal(three, one)
    assert torch.equal(hits3.key, hits1.key)
    # one table per distinct atmosphere, on the first device, however many
    # devices and frames share it
    assert built == [(torch.device("cpu"), us_76()), (torch.device("cpu"), inversion)]


@pytest.mark.parametrize("kernel", ["combine", "march"])
def test_kernel_launches_with_its_tensors_device_current(kernel, monkeypatch):
    """A launch onto a stream of another device than the current one fails,
    and PyTorch's ops leave the current device as they found it, so each
    wrapper makes its tensors' device current around the launch. Stubs of
    the device guard, the stream and the kernel record the device that is
    current at the launch while another one was current before."""
    import contextlib

    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.ops import combine
    from atm_raytracer_tpu_torch.physics.ray import RefractionTable, march_cuda

    current = ["cuda:1"]  # the device current before the call
    seen = []

    @contextlib.contextmanager
    def device_guard(dev):
        before, current[0] = current[0], torch.device(dev)
        try:
            yield
        finally:
            current[0] = before

    class Stream:
        cuda_stream = 0

    def current_stream(dev):
        seen.append(("stream", torch.device(dev)))
        return Stream()

    k = _kernels.COMBINE if kernel == "combine" else _kernels.MARCH
    monkeypatch.setattr(torch.cuda, "device", device_guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(k, "_fn", lambda *args: seen.append(("launch", current[0])) or 0)
    monkeypatch.setattr(k, "launches", 0)
    rng = np.random.default_rng(0)
    if kernel == "combine":
        combine.crossing_segments_envelopes_cuda(
            torch.from_numpy(rng.normal(size=(4, 11)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(3, 11)).astype(np.float32)), 10, 1)
    else:
        table = RefractionTable.from_values(np.zeros(64, np.float32), -2000.0, 1.0, None, "cpu")
        alt = torch.full((5,), 100.0)
        march_cuda(alt, torch.zeros(5), 40.0, 3, table, 6.371e6,
                   fine=(10.0, 4, 12), nodes=False, rays_per_cta=8)
    cpu = torch.device("cpu")
    assert seen == [("stream", cpu), ("launch", cpu)]
    assert current == ["cuda:1"]  # restored after the launch
    assert k.launches == 1


def test_make_mesh_takes_the_callers_devices():
    assert TM.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="no devices"):
        TM.make_mesh([])


def test_cli_shard_on_one_device_prints_the_jax_line(scene, tmp_path, monkeypatch, capsys):
    """``gen --shard --device cpu`` sees one device: it prints the JAX CLI's
    line and renders the one-device PNG."""
    import yaml
    from PIL import Image

    cfg = parallel_config(scene["dir"])
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["gen", "-c", "cfg.yaml", "--device", "cpu", "--shard",
                     "--output", "shard.png"]) == 0
    out = capsys.readouterr().out
    assert ": --shard: only 1 device visible; rendering single-chip" in out
    assert cli.main(["gen", "-c", "cfg.yaml", "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "shard.png")),
                                  np.asarray(Image.open(tmp_path / "out.png")))


def test_cli_shard_splits_over_visible_cards(scene, tmp_path, monkeypatch, capsys):
    """With two cards visible ``gen --shard`` splits over cuda:0 and cuda:1
    (the split render stubbed here: the CPU has no card)."""
    import yaml

    seen = {}

    def fake_split(params, terrain, mesh, max_hits=None):
        seen["mesh"] = mesh
        return render_fast(params, terrain, "cpu")

    cfg = parallel_config(scene["dir"])
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(TM, "render_fast_sharded", fake_split)
    assert cli.main(["gen", "-c", "cfg.yaml", "--shard"]) == 0
    assert "Sharding over 2 devices" in capsys.readouterr().out
    assert seen["mesh"] == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_dryrun_multichip_on_cpu(capsys):
    line = TM.dryrun_multichip(4, "cpu")
    assert line.startswith("dryrun_multichip OK on 4 devices (cpu)")
    assert line in capsys.readouterr().out

