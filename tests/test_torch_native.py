"""The PyTorch port's native tile loaders against the JAX package's parsers.

The port's tile writers must write the JAX writers' bytes. Its C++ loaders
(``atm_raytracer_tpu_torch/native/*.cpp``, built by g++ at first use) must
decode every tile bit for bit as the JAX package's Python parsers
(``atm_raytracer_tpu.terrain.dted.read_dted``, ``geotiff.read_geotiff``)
do: not as JAX's own shared libraries. ``Terrain.preload`` and
``Terrain.pack`` over folders of mixed formats, with the native loaders and
with ``native=False``, must match JAX's ``Terrain.pack``, and the port's
``gen --device cpu`` must match the JAX CLI's image and lines.
"""

import collections
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from atm_raytracer_tpu.terrain import dted as jdted, geotiff as jgeotiff  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch import _kernels, interop  # noqa: E402
from atm_raytracer_tpu_torch.physics import ray as TR  # noqa: E402
from atm_raytracer_tpu_torch.physics.atmosphere import Atmosphere, us_76  # noqa: E402
from atm_raytracer_tpu_torch.terrain import dted as tdted, geotiff as tgeotiff  # noqa: E402
from atm_raytracer_tpu_torch.terrain import native  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain, Tile as TTile  # noqa: E402
from fixtures import tile_grid  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORMATS = {"i2": (16, 2), "u2": (16, 1), "i4": (32, 2), "f4": (32, 3)}  # bits, SampleFormat


def _grid(seed, shape, lo=-500, hi=3000):
    """Seeded integer posts with a negative post and a void post (-32767)."""
    g = np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int16)
    g[3, 4] = -123
    g[5, 6] = jdted.VOID
    return g


def _tiff(path, img, endian="<", compression=1, fmt="i2", strips=3, inline_dims=True):
    """A baseline TIFF of ``img`` (north-first rows) in ``strips`` strips:
    either byte order, no compression (1), Deflate (8) or a code the loaders
    lack, and any of the four sample formats. ``inline_dims=False`` stores
    the width as two LONGs out of line."""
    h, w = img.shape
    bits, sample_format = FORMATS[fmt]
    raw = np.ascontiguousarray(img).astype(endian + fmt).tobytes()
    rps = -(-h // strips)
    row = w * bits // 8
    chunks = [raw[i * rps * row:(i + 1) * rps * row] for i in range(strips)]
    if compression == 8:
        chunks = [zlib.compress(c) for c in chunks]
    n_entries = 8
    extra = 8 + 2 + 12 * n_entries + 4  # offset of the out-of-line values
    width_at, offsets_at = extra, extra + 8
    counts_at = offsets_at + 4 * strips
    data_at = counts_at + 4 * strips
    offsets = np.cumsum([data_at] + [len(c) for c in chunks[:-1]])

    def entry(tag, type_, count, value):
        field = (struct.pack(endian + "HH", value, 0) if type_ == 3 and count == 1
                 else struct.pack(endian + "I", value))
        return struct.pack(endian + "HHI", tag, type_, count) + field

    entries = [
        entry(256, 4, 1, w) if inline_dims else entry(256, 4, 2, width_at),
        entry(257, 4, 1, h), entry(258, 3, 1, bits), entry(259, 3, 1, compression),
        entry(273, 4, strips, offsets_at), entry(278, 4, 1, rps),
        entry(279, 4, strips, counts_at), entry(339, 3, 1, sample_format),
    ]
    body = (struct.pack(endian + "II", w, 0)
            + struct.pack(f"{endian}{strips}I", *offsets)
            + struct.pack(f"{endian}{strips}I", *(len(c) for c in chunks)))
    head = (endian.replace("<", "II").replace(">", "MM").encode()
            + struct.pack(endian + "HI", 42, 8)
            + struct.pack(endian + "H", n_entries) + b"".join(entries)
            + struct.pack(endian + "I", 0))
    Path(path).write_bytes(head + body + b"".join(chunks))


def _lazy_lines(text):
    return collections.Counter(
        line for line in text.splitlines()
        if line.startswith(("Lazy loading terrain file:", "Detected ")))


# -- writers -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dted_north_east", "dted_south_west", "geotiff"])
def test_writers_write_the_jax_bytes(case, tmp_path):
    if case == "geotiff":
        grid = _grid(1, (37, 53))
        jgeotiff.write_geotiff(tmp_path / "j.tif", grid)
        tgeotiff.write_geotiff(tmp_path / "t.tif", grid)
        names = ("j.tif", "t.tif")
    else:
        lat, lon, shape = (49, 21, (121, 121)) if case == "dted_north_east" else (-3, -120,
                                                                                   (61, 41))
        grid = _grid(2, shape)
        jdted.write_dted(tmp_path / "j.dt2", lat, lon, grid)
        tdted.write_dted(tmp_path / "t.dt2", lat, lon, grid)
        names = ("j.dt2", "t.dt2")
    assert (tmp_path / names[0]).read_bytes() == (tmp_path / names[1]).read_bytes()


# -- loaders against the JAX package's Python parsers ---------------------------

@pytest.mark.parametrize("max_threads", [1, 3])
def test_dted_loader_matches_jax_parser(max_threads, tmp_path):
    """A negative post, a void post, and tiles of mixed sizes padded into
    one batch at their south-west corner."""
    shapes = {"a.dt2": (49, 21, (121, 121)), "b.dt2": (-3, -120, (61, 41)),
              "c.dt2": (50, 21, (121, 121))}
    for i, (name, (lat, lon, shape)) in enumerate(shapes.items()):
        tdted.write_dted(tmp_path / name, lat, lon, _grid(10 + i, shape))
    paths = [tmp_path / n for n in shapes]
    assert native.probe(paths[1]) == (-3.0, -120.0, 61, 41)
    tiles, origins, status = native.load_batch(paths, 121, 121, max_threads=max_threads)
    assert tiles.shape == (3, 121, 121) and (status == 0).all()
    for p, tile, origin, (lat, lon, shape) in zip(paths, tiles, origins, shapes.values()):
        hdr, want = jdted.read_dted(p)
        np.testing.assert_array_equal(tile[:shape[0], :shape[1]], want)
        assert not tile[shape[0]:].any() and not tile[:, shape[1]:].any()
        assert tuple(origin) == (hdr.origin_lat, hdr.origin_lon) == (lat, lon)
        assert want[3, 4] == -123.0 and want[5, 6] == 0.0  # negative; void -> 0


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("compression", [1, 8], ids=["none", "deflate"])
@pytest.mark.parametrize("endian", ["<", ">"], ids=["little", "big"])
def test_geotiff_loader_matches_jax_parser(endian, compression, fmt, tmp_path):
    """Both byte orders, no compression and Deflate, the i16, u16, i32 and
    f32 sample formats, three strips, padded into a larger batch."""
    rng = np.random.default_rng(20)
    img = {"i2": lambda: _grid(21, (45, 33), -30000, 30000),
           "u2": lambda: rng.integers(0, 65536, (45, 33)),
           "i4": lambda: rng.integers(-10**6, 10**6, (45, 33)),
           "f4": lambda: rng.normal(500.0, 300.0, (45, 33))}[fmt]()
    p = tmp_path / "N49E021.tif"
    _tiff(p, img, endian, compression, fmt)
    assert native.gtif_probe(p) == (45, 33)
    tiles, status = native.gtif_load_batch([p, p], 50, 40, max_threads=2)
    assert (status == 0).all()
    want = jgeotiff.read_geotiff(p)[::-1]  # the Python parser, south-first
    for tile in tiles:
        np.testing.assert_array_equal(tile[:45, :33], want)
        assert not tile[45:].any() and not tile[:, 33:].any()


def test_junk_and_unsupported_files(tmp_path):
    """A file that is neither format probes as None in both loaders; a TIFF
    in a compression the loader lacks gives a nonzero status, and the
    store hands it to the Python parser, which raises its ValueError, as
    the JAX store does."""
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not a tile at all")
    assert native.probe(junk) is None and native.gtif_probe(junk) is None
    junk.unlink()
    lzw = tmp_path / "N49E021.tif"
    _tiff(lzw, _grid(30, (21, 21)), compression=5)
    assert native.probe(lzw) is None and native.gtif_probe(lzw) == (21, 21)
    _, status = native.gtif_load_batch([lzw], 21, 21)
    assert status[0] != 0
    tdted.write_dted(tmp_path / "n49_e022.dt2", 49, 22, _grid(31, (21, 21)))
    box = ((49.1, 49.9), (21.1, 22.9))
    with pytest.raises(ValueError, match="unsupported TIFF compression 5"):
        TTerrain.from_folder(tmp_path).pack(*box, "cpu")
    with pytest.raises(ValueError, match="unsupported TIFF compression 5"):
        JTerrain.from_folder(tmp_path).pack(*box)


def test_out_of_line_dimensions_take_the_python_parser(tmp_path, capsys):
    """A TIFF whose width is not stored inline is outside what the native
    probe reads: the store loads it with the Python parser, equal to JAX's."""
    img = _grid(40, (31, 29))
    p = tmp_path / "N49E021.tif"
    _tiff(p, img, inline_dims=False)
    assert native.gtif_probe(p) is None
    tdted.write_dted(tmp_path / "n49_e022.dt2", 49, 22, _grid(41, (31, 29)))
    t = TTerrain.from_folder(tmp_path)
    t.preload(t.keys)
    np.testing.assert_array_equal(t._tile((49, 21)).elev, jgeotiff.read_geotiff(p)[::-1])
    np.testing.assert_array_equal(t._tile((49, 22)).elev,
                                  jdted.read_dted(tmp_path / "n49_e022.dt2")[1])
    assert sum(_lazy_lines(capsys.readouterr().out).values()) == 3  # Detected + 2


# -- the store -------------------------------------------------------------------

def _mixed_folder(d, n=61):
    """Six tiles over a 2 x 3 block, three formats: DTED, plain GeoTIFF
    (north-up rows, the port's writer) and big-endian Deflate GeoTIFF."""
    kinds = {(49, 21): "dted", (49, 22): "tif", (49, 23): "deflate",
             (50, 21): "tif", (50, 22): "dted", (50, 23): "dted"}
    for (la, lo), kind in kinds.items():
        grid = tile_grid(la, lo, n)
        if kind == "dted":
            tdted.write_dted(d / f"n{la}_e{lo:03d}.dt2", la, lo, grid)
        elif kind == "tif":
            tgeotiff.write_geotiff(d / f"N{la}E{lo:03d}.tif", grid[::-1])
        else:
            _tiff(d / f"N{la}E{lo:03d}.tif", grid[::-1], ">", 8)
    return d


def test_preload_decodes_a_mixed_folder(tmp_path, capsys):
    d = _mixed_folder(tmp_path)
    t = TTerrain.from_folder(d)
    assert t.keys == {(la, lo) for la in (49, 50) for lo in (21, 22, 23)}
    t.preload([(49, 21), (49, 22), (49, 23), (50, 23), (51, 21)])  # (51, 21): no file
    assert set(t._loaded) == {(49, 21), (49, 22), (49, 23), (50, 23)}
    lines = _lazy_lines(capsys.readouterr().out)
    assert lines["Detected 6 terrain files"] == 1 and sum(lines.values()) == 5
    for key, tile in t._loaded.items():
        path = t._paths[key]
        want = (jdted.read_dted(path)[1] if path.suffix == ".dt2"
                else jgeotiff.read_geotiff(path)[::-1])
        assert tile.elev.dtype == np.float32
        np.testing.assert_array_equal(tile.elev, want)
        assert f"Lazy loading terrain file: {path}" in lines
    t.add_tile(TTile(52, 21, np.zeros((3, 3), np.float32)))
    assert (52, 21) in t.keys


def _jax_tiles(jp):
    """The JAX pack's [T, S, S] int16 tiles, read back from its quad pack
    (lane 0 of row (r, c) holds post (r, c) in its low 16 bits)."""
    t, s = jp.rows_m1.shape[0], jp.tile_s
    lane0 = np.asarray(jp.quad).reshape(t, s, s, 2)[..., 0]
    return (lane0 & 0xFFFF).astype(np.uint16).view(np.int16)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_pack_from_a_folder_matches_jax(use_native, tmp_path, capsys):
    d = _mixed_folder(tmp_path)
    box = ((49.2, 50.7), (21.3, 23.6))
    jp = JTerrain.from_folder(d).pack(*box)
    want_lines = _lazy_lines(capsys.readouterr().out)
    tt = TTerrain.from_folder(d, native=use_native)
    assert tt.native is use_native
    tp = tt.pack(*box, "cpu")
    assert _lazy_lines(capsys.readouterr().out) == want_lines
    assert sum(want_lines.values()) == 7
    assert (tp.lat_min, tp.lon_min, tp.n_rows, tp.n_cols) == (
        jp.lat_min, jp.lon_min, jp.n_rows, jp.n_cols)
    assert tp.tiles.dtype == torch.int16
    np.testing.assert_array_equal(tp.tiles.numpy(), _jax_tiles(jp))
    np.testing.assert_array_equal(tp.rows_m1.numpy(), np.asarray(jp.rows_m1))
    np.testing.assert_array_equal(tp.cols_m1.numpy(), np.asarray(jp.cols_m1))
    assert (tp.grad_bound, tp.seam_jump) == (jp.grad_bound, jp.seam_jump)
    assert tp.grad_bound > 0.0


def test_native_and_python_stores_pack_equal(tmp_path):
    d = _mixed_folder(tmp_path, n=121)
    box = ((49.0, 50.9), (21.0, 23.9))
    a = TTerrain.from_folder(d).pack(*box, "cpu")
    b = TTerrain.from_folder(d, native=False).pack(*box, "cpu")
    for f in ("tiles", "rows_m1", "cols_m1"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.grad_bound, a.seam_jump) == (b.grad_bound, b.seam_jump)


def test_gen_cli_matches_jax_on_a_mixed_folder(tmp_path):
    """``gen --device cpu`` over a folder of DTED and GeoTIFF tiles: the JAX
    CLI's image (0 pixels moved) and the same ``Detected`` and ``Lazy
    loading`` lines."""
    import yaml
    from PIL import Image

    import test_golden as G

    d = tmp_path / "terrain"
    d.mkdir()
    _mixed_folder(d)
    cfg = G._base_config()
    cfg["scene"]["terrain_folder"] = str(d)
    cfg["view"]["position"].update(latitude=49.93, longitude=21.9)
    cfg["view"]["frame"].update(direction=60.0, fov=60.0, max_distance=40000.0)
    cfg["simulation_step"] = 200.0
    images, lines = [], []
    for pkg in ("atm_raytracer_tpu", "atm_raytracer_tpu_torch"):
        run = tmp_path / pkg
        run.mkdir()
        (run / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        cmd = [sys.executable, "-m", f"{pkg}.cli", "gen", "-c", "cfg.yaml"]
        proc = subprocess.run(
            cmd + (["--device", "cpu"] if pkg.endswith("torch") else []),
            cwd=run, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(REPO), "ATM_RAYTRACER_PLATFORM": "cpu",
                 "OMP_NUM_THREADS": "1"},
        )
        assert proc.returncode == 0, proc.stderr
        images.append(np.asarray(Image.open(run / "out.png").convert("RGB")))
        lines.append(_lazy_lines(proc.stdout))
    assert images[0].shape == images[1].shape == (48, 64, 3)
    moved = int((images[0] != images[1]).any(-1).sum())
    assert moved == 0, moved
    assert lines[0] == lines[1] and sum(lines[1].values()) >= 3, lines


# -- the builder ----------------------------------------------------------------

def test_loader_library_names_carry_source_flags_and_compiler(monkeypatch, tmp_path):
    name = _kernels.DTED_LOADER.library_path()
    assert name.parent == _kernels.BUILD_DIR and name.suffix == ".so"
    assert name != _kernels.HostLibrary("dted_loader.cpp", libs=("-lm",)).library_path()
    src = tmp_path / "dted_loader.cpp"
    src.write_text((_kernels.NATIVE / "dted_loader.cpp").read_text() + "\n// edited\n")
    monkeypatch.setattr(_kernels, "_compiler_id", lambda compiler: "another g++ aarch64")
    assert _kernels.DTED_LOADER.library_path() != name  # another toolchain
    monkeypatch.undo()
    assert _kernels.DTED_LOADER.library_path() == name
    monkeypatch.setattr(_kernels, "NATIVE", tmp_path)
    assert _kernels.HostLibrary("dted_loader.cpp").library_path() != name


def test_failed_builds_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "NATIVE", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for libbroken_"):
        _kernels.HostLibrary("broken.cpp").build()
    assert not list((tmp_path / "build").glob("*"))  # no library, no temporary
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _kernels.HostLibrary("broken.cpp").build()


def test_concurrent_first_builds(tmp_path):
    """Four processes build both loaders into one empty directory at once
    (as xdist workers do): each loads a whole library and decodes a tile."""
    tdted.write_dted(tmp_path / "t.dt2", 49, 21, _grid(50, (31, 31)))
    tgeotiff.write_geotiff(tmp_path / "N49E021.tif", _grid(51, (31, 31)))
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from atm_raytracer_tpu_torch import _kernels\n"
        f"_kernels.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        "from atm_raytracer_tpu_torch.terrain import native\n"
        f"d = Path({str(tmp_path)!r})\n"
        "assert native.load_batch([d / 't.dt2'], 31, 31)[2][0] == 0\n"
        "assert native.gtif_load_batch([d / 'N49E021.tif'], 31, 31)[1][0] == 0\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    built = sorted(f.name for f in (tmp_path / "build").iterdir())
    assert built == sorted(lib.library_path().name for lib in _kernels.LOADERS)


def test_preload_of_mixed_post_counts_keeps_no_padding(tmp_path):
    """Tiles of mixed post counts in both formats: each decodes bit for bit
    as its Python parse, and the arrays the store keeps alive hold exactly
    the tiles' posts (each group of one post count is one batch it fills)."""
    shapes = {(49, 21): (61, 61), (49, 22): (121, 121), (49, 23): (61, 61),
              (50, 21): (121, 61), (50, 22): (41, 41), (50, 23): (31, 37)}
    for i, ((la, lo), shape) in enumerate(shapes.items()):
        if la == 49:
            tdted.write_dted(tmp_path / f"n{la}_e{lo:03d}.dt2", la, lo, _grid(70 + i, shape))
        else:
            _tiff(tmp_path / f"N{la}E{lo:03d}.tif", _grid(70 + i, shape), ">", 8)
    t = TTerrain.from_folder(tmp_path)
    t.preload(t.keys)
    assert set(t._loaded) == set(shapes)
    held = {}
    for key, tile in t._loaded.items():
        path = t._paths[key]
        want = (jdted.read_dted(path)[1] if path.suffix == ".dt2"
                else jgeotiff.read_geotiff(path)[::-1])
        np.testing.assert_array_equal(tile.elev, want)
        base = tile.elev if tile.elev.base is None else tile.elev.base
        assert base.shape[-2:] == tile.elev.shape == shapes[key]
        held[id(base)] = base.nbytes
    assert sum(held.values()) == sum(tile.elev.nbytes for tile in t._loaded.values())


# -- no default device -------------------------------------------------------------

NEEDS_A_DEVICE = {
    "Terrain.pack": lambda: TTerrain().pack((49.1, 49.9), (21.1, 21.9)),
    "RefractionTable.build": lambda: TR.RefractionTable.build(Atmosphere(us_76()), 530e-9),
    "RefractionTable.from_values": lambda: TR.RefractionTable.from_values(
        np.zeros(8, np.float32), -2000.0, 1.0, None),
    "table_from_arrays": lambda: interop.table_from_arrays(
        -2000.0, 1.0, np.zeros(8, np.float32), None),
    "sweep_table_from_arrays": lambda: interop.sweep_table_from_arrays(
        -2000.0, 1.0, np.zeros((2, 8), np.float32), np.zeros((2, 7, 2), np.float32)),
    "pack_from_arrays": lambda: interop.pack_from_arrays(
        np.zeros((1, 2, 2), np.int16), [1.0], [1.0], 49, 21, 1, 1),
    "hits_from_arrays": lambda: interop.hits_from_arrays(
        *(np.zeros((1, 1, 1)),) * 7, np.zeros((1, 1, 1, 3)), np.zeros((1, 1, 1)),
        np.zeros((1, 1, 1, 4))),
    "objects_from_arrays": lambda: interop.objects_from_arrays(
        *(np.zeros(1),) * 14, seg_window=1, host_meta=()),
}


@pytest.mark.parametrize("entry", list(NEEDS_A_DEVICE))
def test_entry_points_need_a_device(entry):
    """No library entry point picks the CPU when the caller names no
    device: each call without one raises TypeError."""
    with pytest.raises(TypeError, match="device"):
        NEEDS_A_DEVICE[entry]()
