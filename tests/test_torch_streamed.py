"""The port's transfer group and banded Fast render, on the CPU.

``generators/base.py``'s fetches against plain copies; ``render_fast_streamed``
bit-equal to ``render_fast`` (image and every hit field) and within the verify
tolerance of JAX's ``render_fast_streamed``; ``fetch_image=False`` on every
generator; ``_pack_artifact`` against the per-field copies it replaced; the
CLI's banded route; and the tile loaders' fallback to the Python parsers
when they cannot be built (ROADMAP C1).

Bit-equality of the banded render holds on the CPU for shapes whose bands
keep every column's place in PyTorch's vectorized loops (one thread; band
width × samples and rows × band width × slots multiples of the vector
width): the CPU's atan2 rounds differently in a loop's scalar tail. The
64-column frames here split into 8 bands of 8 columns, 300 samples each.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_golden as G  # noqa: E402
import test_torch_native as N  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators.fast import render_fast_streamed as j_streamed  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import _kernels, cli  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import base, fast  # noqa: E402
from atm_raytracer_tpu_torch.generators.base import HitBuffer  # noqa: E402
from atm_raytracer_tpu_torch.generators.interpolating import render_interpolating  # noqa: E402
from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear  # noqa: E402
from atm_raytracer_tpu_torch.meta import serialize as TS  # noqa: E402
from atm_raytracer_tpu_torch.terrain import native  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import M_PER_DEG, make_terrain_folder  # noqa: E402
from torch_parity import verify_tolerance  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIELDS = tuple(f.name for f in dataclasses.fields(HitBuffer))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the transfer group ---------------------------------------------------------------

def _tensors():
    return (torch.arange(17 * 589, dtype=torch.float32).reshape(17, 589),
            torch.arange(300, dtype=torch.int64) * 2654435761 % (1 << 31),
            torch.rand(4, 5, 6, generator=torch.Generator().manual_seed(1)) < 0.5,
            torch.zeros(0, dtype=torch.uint8),
            torch.arange(12, dtype=torch.int16).reshape(3, 4).t())  # not contiguous


@pytest.mark.parametrize("chunk_bytes", [0, 4096, 10, 1 << 30])
def test_fetch_flat_equals_a_plain_copy(chunk_bytes):
    for t in _tensors():
        got = base.fetch_flat(t, chunk_bytes=chunk_bytes)
        assert got.shape == (t.numel(),) and got.dtype == t.numpy().dtype
        np.testing.assert_array_equal(got, t.reshape(-1).numpy())
    host = np.arange(12).reshape(3, 4)  # numpy passes through flat
    np.testing.assert_array_equal(base.fetch_flat(host, chunk_bytes=8), host.reshape(-1))


def test_slices_cover_the_array_once():
    assert base._slices(10, 4, 0) == [(0, 10)]
    assert base._slices(10, 4, 12) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert base._slices(10, 4, 2) == [(a, a + 1) for a in range(10)]  # under one item
    assert base._slices(0, 4, 8) == [(0, 0)]


def test_fetch_flat_many_and_submit_fetch_equal_plain_copies():
    ts = _tensors()
    host = np.arange(6.0)
    outs = base.fetch_flat_many(ts + (host,))
    assert base.fetch_flat_many(()) == []
    for got, t in zip(outs, ts):
        np.testing.assert_array_equal(got, t.reshape(-1).numpy())
    assert outs[-1] is not host and np.shares_memory(outs[-1], host)
    with base.fetch_pool() as pool:
        first, h1 = base.submit_fetch(pool, ts[:2])
        second, h2 = base.submit_fetch(pool, ts[2:])
    assert h1 == h2 == []  # CPU tensors need no copy to wait for
    for got, t in zip(first + second, ts):
        np.testing.assert_array_equal(got, t.reshape(-1).numpy())
    pool = base.fetch_pool()
    outs, handles = base.submit_fetch(pool, (ts[0],))
    pool.shutdown()
    np.testing.assert_array_equal(outs[0], ts[0].reshape(-1).numpy())


# -- the banded render ------------------------------------------------------------------

def _cfg(d, alpha=1.0, objects=False):
    cfg = {
        "scene": {"terrain_folder": str(d), "terrain_alpha": alpha},
        "view": {
            "position": {"latitude": 49.5, "longitude": 21.5,
                         "altitude": {"Relative": 30.0}},
            "frame": {"direction": 45.0, "fov": 20.0, "max_distance": 30000.0,
                      "tilt": 0.0},
            "coloring": {"Shading": {"water_level": -100.0}},
        },
        "straight_rays": False,
        "simulation_step": 100.0,
        "output": {"width": 64, "height": 48},
    }
    if objects:  # a Cylinder 900 m out at the frame's center azimuth, 45 degrees
        az = math.radians(45.0)
        cfg["scene"]["objects"] = [{
            "position": {"latitude": 49.5 + 900.0 / M_PER_DEG * math.cos(az),
                         "longitude": 21.5 + 900.0 / M_PER_DEG * math.sin(az)
                         / math.cos(math.radians(49.5)),
                         "altitude": {"Relative": 0.0}},
            "color": {"r": 0.9, "g": 0.3, "b": 0.1, "a": 1.0},
            "shape": {"Cylinder": {"radius": 40.0, "height": 200.0}},
        }]
    return cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = make_terrain_folder(tmp_path_factory.mktemp("torch_streamed"), tiles=((49, 21),),
                            n=361)
    return {"dir": d, "tt": TTerrain.from_folder(d), "jt": JTerrain.from_folder(d)}


def _assert_same_render(a, b):
    np.testing.assert_array_equal(a.image, b.image)
    for f in FIELDS:
        assert torch.equal(getattr(a.hits, f), getattr(b.hits, f)), f
    np.testing.assert_array_equal(a.azimuth_deg, b.azimuth_deg)
    np.testing.assert_array_equal(a.elevation_deg, b.elevation_deg)
    assert a.observer == b.observer


@pytest.mark.parametrize("alpha", [1.0, 0.65], ids=["opaque", "translucent"])
def test_streamed_equals_render_fast_and_jax(alpha, scene):
    """Bit-equal to the port's ``render_fast`` (image and all 10 hit fields),
    8 monotone progress lines ending at 100, and within the verify
    tolerance of JAX's banded render."""
    cfg = _cfg(scene["dir"], alpha)
    params = TConfig.from_dict(cfg).into_params(scene["tt"])
    plain = fast.render_fast(params, scene["tt"], "cpu")
    lines = []
    got = fast.render_fast_streamed(params, scene["tt"], "cpu", bands=8,
                                    progress=lines.append)
    _assert_same_render(got, plain)
    assert lines == [12, 25, 38, 50, 62, 75, 88, 100]
    jparams = JConfig.from_dict(cfg).into_params(scene["jt"])
    want = j_streamed(jparams, scene["jt"], bands=8)
    ok, frac_any, frac_big = verify_tolerance(got.image, np.asarray(want.image))
    assert ok, (frac_any, frac_big)


def test_streamed_objects_take_render_fast(scene, monkeypatch):
    params = TConfig.from_dict(_cfg(scene["dir"], 0.85, objects=True)).into_params(scene["tt"])
    plain = fast.render_fast(params, scene["tt"], "cpu")
    lines = []
    monkeypatch.setattr(fast, "fetch_pool", None)  # the banded path would need it
    got = fast.render_fast_streamed(params, scene["tt"], "cpu", progress=lines.append)
    _assert_same_render(got, plain)
    assert lines == [100] and plain.hits.kind.eq(1).any()


@pytest.mark.parametrize("w, bands, want", [(1920, 8, 8), (61, 8, 1), (60, 8, 6),
                                            (64, 3, 2), (5, 8, 5)])
def test_largest_band_divisor(w, bands, want):
    assert fast._largest_band_divisor(w, bands) == want


def test_streamed_with_a_band_count_that_does_not_divide(scene):
    """60 columns in 8 bands: 6 bands of 10, still the plain frame (one
    thread; 10 × 300 samples)."""
    cfg = _cfg(scene["dir"])
    cfg["output"]["width"] = 60
    params = TConfig.from_dict(cfg).into_params(scene["tt"])
    lines = []
    got = fast.render_fast_streamed(params, scene["tt"], "cpu", progress=lines.append)
    assert len(lines) == 6 and lines[-1] == 100 and lines == sorted(lines)
    np.testing.assert_array_equal(got.image, fast.render_fast(params, scene["tt"], "cpu").image)


@pytest.mark.parametrize("render", [
    fast.render_fast,
    render_interpolating,
    lambda p, t, dev, **kw: render_rectilinear(p, t, dev, **kw),
], ids=["Fast", "InterpolatingRectilinear", "Rectilinear"])
def test_fetch_image_false_leaves_a_device_tensor(render, scene):
    cfg = _cfg(scene["dir"])
    cfg["output"].update(width=32, height=24)
    params = TConfig.from_dict(cfg).into_params(scene["tt"])
    kept = render(params, scene["tt"], "cpu", fetch_image=False)
    fetched = render(params, scene["tt"], "cpu")
    assert isinstance(kept.image, torch.Tensor) and kept.image.dtype == torch.uint8
    assert isinstance(fetched.image, np.ndarray) and fetched.image.shape == (24, 32, 3)
    np.testing.assert_array_equal(base.fetch_flat(kept.image).reshape(24, 32, 3),
                                  fetched.image)


# -- the artifact's compaction ----------------------------------------------------------

def _per_field_copies(hits):
    """``_pack_artifact`` as it was: an int64 pow-2 sum of the words and one
    ``.cpu()`` a field."""
    vflat = hits.valid.reshape(-1)
    p = vflat.shape[0]
    idx = torch.nonzero(vflat).squeeze(1)
    words = torch.nn.functional.pad(vflat.to(torch.int64), (0, (-p) % 32))
    bits = (words.reshape(-1, 32) * torch.pow(2, torch.arange(32, dtype=torch.int64))).sum(1)
    segments = {}
    for name in TS.PACKED_FIELDS:
        x = getattr(hits, name)
        segments[name] = x.reshape((p,) + x.shape[hits.valid.ndim:]).index_select(
            0, idx).cpu().numpy()
    segments["kind"] = segments["kind"].astype(np.uint8)
    return bits.cpu().numpy().astype(np.uint32), int(idx.shape[0]), segments


@pytest.mark.parametrize("alpha", [1.0, 0.65])
def test_pack_artifact_unchanged(alpha, scene, tmp_path):
    params = TConfig.from_dict(_cfg(scene["dir"], alpha)).into_params(scene["tt"])
    hits = fast.render_fast(params, scene["tt"], "cpu").hits
    bits, n, seg = TS._pack_artifact(hits)
    want_bits, want_n, want_seg = _per_field_copies(hits)
    assert bits.dtype == np.uint32 and n == want_n > 0
    np.testing.assert_array_equal(bits, want_bits)
    for name in TS.PACKED_FIELDS:
        assert seg[name].dtype == want_seg[name].dtype, name
        np.testing.assert_array_equal(seg[name], want_seg[name], err_msg=name)


# -- the CLI's banded route ---------------------------------------------------------------

def test_cli_gen_on_cuda_takes_the_banded_render(scene, tmp_path, monkeypatch, capsys):
    """With a CUDA device ``gen`` renders Fast through ``render_fast_streamed``
    (bands 8, one ``NN%...`` line a band); stubbed here to run it on the
    CPU, its PNG equals ``gen --device cpu``'s."""
    import yaml

    from atm_raytracer_tpu_torch.render.image import load_png_rgb

    cfg = _cfg(scene["dir"])
    cfg["output"]["file"] = "out.png"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["gen", "-c", "cfg.yaml", "--device", "cpu"]) == 0
    cpu_png = load_png_rgb(tmp_path / "out.png")
    cpu_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.endswith("%...")]
    assert len(cpu_lines) == 1 and cpu_lines[0].endswith(": 100%...")

    calls = []
    real = fast.render_fast_streamed

    def on_cpu(params, terrain, device, **kw):
        calls.append((torch.device(device).type, kw.get("bands")))
        return real(params, terrain, "cpu", **kw)

    monkeypatch.setattr(cli, "resolve_device", lambda name: torch.device("cuda"))
    monkeypatch.setattr(fast, "render_fast_streamed", on_cpu)
    (tmp_path / "out.png").unlink()
    assert cli.main(["gen", "-c", "cfg.yaml"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.endswith("%...")]
    assert calls == [("cuda", 8)]
    assert [ln.split(": ")[1] for ln in lines] == [
        f"{p}%..." for p in (12, 25, 38, 50, 62, 75, 88, 100)]
    np.testing.assert_array_equal(load_png_rgb(tmp_path / "out.png"), cpu_png)


# -- C1: the tile loaders' fallback ------------------------------------------------------------

def _clear_loader_caches():
    for fn in (native.available, native.gtif_available, native._dted, native._gtif):
        fn.cache_clear()


@pytest.fixture
def no_gxx(monkeypatch):
    """The loaders' build fails: no g++ on the PATH."""
    real = _kernels.shutil.which
    monkeypatch.setattr(_kernels.shutil, "which",
                        lambda name, *a, **k: None if name == "g++" else real(name, *a, **k))
    _clear_loader_caches()
    yield
    monkeypatch.undo()
    _clear_loader_caches()


def test_unbuildable_loaders_say_so_once(no_gxx, capsys):
    assert native.available() is False and native.gtif_available() is False
    assert native.available() is False and native.gtif_available() is False
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2, err
    for line, what in zip(err, ("DTED", "GeoTIFF")):
        assert line.startswith(f"WARNING: the native {what} loader could not be built")
        assert "g++ not found on PATH" in line
        assert line.endswith(f"reading {what} tiles with the Python parser")


def test_an_unbuildable_loader_names_the_compiler_error(monkeypatch, tmp_path, capsys):
    """A compile that fails (here: a source that is not C++) is named too."""
    monkeypatch.setattr(_kernels, "NATIVE", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "broken.cpp").write_text("#include <no_such_header.h>\n")
    lib = _kernels.HostLibrary("broken.cpp")
    assert native._buildable(lib.load, "broken") is False
    (line,) = capsys.readouterr().err.splitlines()
    assert "g++ failed for libbroken_" in line and "no_such_header.h" in line


def test_cuda_kernels_still_raise_without_their_compiler(no_gxx, monkeypatch):
    """Only the host loaders fall back: K1 and K2 raise when nvcc cannot
    build them (nothing on the device path falls back)."""
    monkeypatch.setattr(_kernels.shutil, "which", lambda name, *a, **k: None)
    monkeypatch.setenv("CUDA_HOME", str(REPO / "no_such_cuda"))
    for kernel in _kernels.KERNELS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernel.build()


def test_store_reads_a_mixed_folder_without_the_loaders(no_gxx, tmp_path, capsys):
    d = N._mixed_folder(tmp_path)
    box = ((49.2, 50.7), (21.3, 23.6))
    got = TTerrain.from_folder(d).pack(*box, "cpu")
    want = TTerrain.from_folder(d, native=False).pack(*box, "cpu")
    for f in ("tiles", "rows_m1", "cols_m1"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    out = capsys.readouterr()
    assert sum(ln.startswith("WARNING: the native") for ln in out.err.splitlines()) == 2
    assert N._lazy_lines(out.out)["Detected 6 terrain files"] == 2


def test_gen_without_the_loaders_matches_jax(no_gxx, tmp_path, monkeypatch, capsys):
    """``gen --device cpu`` over a DTED + GeoTIFF folder with the loaders'
    build failing: one line a loader naming the error, the JAX CLI's image
    (0 pixels moved) and its ``Detected`` / ``Lazy loading`` lines."""
    import yaml

    from atm_raytracer_tpu_torch.render.image import load_png_rgb

    d = tmp_path / "terrain"
    d.mkdir()
    N._mixed_folder(d)
    cfg = G._base_config()
    cfg["scene"]["terrain_folder"] = str(d)
    cfg["view"]["position"].update(latitude=49.93, longitude=21.9)
    cfg["view"]["frame"].update(direction=60.0, fov=60.0, max_distance=40000.0)
    cfg["simulation_step"] = 200.0
    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "atm_raytracer_tpu.cli", "gen", "-c", "cfg.yaml"],
        cwd=tmp_path / "jax", capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "ATM_RAYTRACER_PLATFORM": "cpu",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    monkeypatch.chdir(tmp_path / "torch")
    assert cli.main(["gen", "-c", "cfg.yaml", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    warnings = [ln for ln in out.err.splitlines() if ln.startswith("WARNING: the native")]
    assert len(warnings) == 2 and all("g++ not found" in ln for ln in warnings), out.err
    want = load_png_rgb(tmp_path / "jax" / "out.png")
    got = load_png_rgb(tmp_path / "torch" / "out.png")
    assert got.shape == want.shape == (48, 64, 3)
    moved = int((got != want).any(-1).sum())
    assert moved == 0, moved
    assert N._lazy_lines(out.out) == N._lazy_lines(proc.stdout)
