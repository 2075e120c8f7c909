"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The file
imports neither JAX nor the JAX package, so on a machine without JAX it runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from atm_raytracer_tpu_torch import _kernels  # noqa: E402
from atm_raytracer_tpu_torch.config import Config  # noqa: E402
from atm_raytracer_tpu_torch.generators import interpolating as I  # noqa: E402
from atm_raytracer_tpu_torch.generators.fast import render_fast  # noqa: E402
from atm_raytracer_tpu_torch.generators.rectilinear import render_rectilinear  # noqa: E402
from atm_raytracer_tpu_torch.ops import combine  # noqa: E402
from atm_raytracer_tpu_torch.ops import objects as O  # noqa: E402
from atm_raytracer_tpu_torch.physics import ray as R  # noqa: E402
from atm_raytracer_tpu_torch.physics.atmosphere import Atmosphere, us_76  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain, Tile  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    WINDOW_GRIDS,
    WINDOW_SHAPES,
    cuda_device,
    cull_fan,
    fast_window_args,
    objects_golden_config,
    seeded_objects_config,
    split_fit,
    verify_tolerance,
)

pytestmark = pytest.mark.cuda


def _fan(seed, h_n, w_n, n_seg, extra=0):
    rng = np.random.default_rng(seed)
    ray = (120.0 + np.linspace(-3.0, 1.0, h_n)[:, None] * np.arange(n_seg + 1)[None, :]
           + rng.normal(0.0, 2.0, (h_n, n_seg + 1)))
    terr = (100.0 + 30.0 * np.sin(np.arange(n_seg + 1 + extra) / 5.0)[None, :]
            + rng.uniform(-5.0, 5.0, (w_n, n_seg + 1 + extra)))
    return ray.astype(np.float32), terr.astype(np.float32), n_seg


def _death(floor):
    ray = np.full((1, 51), 10.0, np.float32)
    ray[0, 10:] = -2000.0 if floor == 0.0 else -1100.0
    if floor == 0.0:
        ray[0, 20:] = 50.0  # resurfaces after death: must not count
    return ray, np.full((1, 51), floor, np.float32), 50


def _chunk_edge(n_seg=700):
    """Every crossing is the last segment of chunk 1, which only the sample
    chunks 1 and 2 share reveals."""
    ray, terr, _ = _fan(4, 21, 70, n_seg)
    ray = np.float32(terr.min() - 60.0) + np.random.default_rng(4).normal(
        0.0, 2.0, ray.shape).astype(np.float32)
    ray[:, : 2 * combine.CHUNK] += np.float32(terr.max() - terr.min() + 120.0)
    return ray, terr, n_seg


COMBINE_CASES = {
    "fan": lambda: _fan(1, 6, 7, 50),
    "ragged": lambda: _fan(2, 37, 45, 301, extra=9),
    "tall": lambda: _fan(3, 130, 33, 1000),
    "death": lambda: _death(0.0),
    "deep_terrain": lambda: _death(-1500.0),
    "above_then_cross": lambda: (*cull_fan(5, 21, 70, 700, True, extra=11), 700),
    "below_then_cross": lambda: (*cull_fan(6, 21, 70, 700, False), 700),
    "chunk_edge": _chunk_edge,
}


@pytest.mark.parametrize("max_hits", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(COMBINE_CASES))
def test_combine_kernel_equals_plain(case, max_hits, cuda_device):
    ray, terr, n_seg = COMBINE_CASES[case]()
    r = torch.from_numpy(ray).to(cuda_device)
    t = torch.from_numpy(terr).to(cuda_device)
    before = _kernels.COMBINE.launches
    got = combine.terrain_crossing_segments(r, t, n_seg, max_hits)
    assert _kernels.COMBINE.launches == before + 1
    want = combine.terrain_crossing_segments_plain(r, t, n_seg, max_hits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    cpu = combine.terrain_crossing_segments(torch.from_numpy(ray), torch.from_numpy(terr),
                                            n_seg, max_hits)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("case", list(COMBINE_CASES) + ["nan"])
def test_envelope_kernel_equals_plain(case, cuda_device):
    ray, terr, n_seg = COMBINE_CASES["ragged" if case == "nan" else case]()
    if case == "nan":
        ray[4, 128] = np.nan  # the sample chunks 0 and 1 share
        terr[40, 7] = np.nan
    r = torch.from_numpy(ray).to(cuda_device)
    t = torch.from_numpy(terr).to(cuda_device)
    _, env = combine.crossing_segments_envelopes_cuda(r, t, n_seg, 1)
    want = combine.crossing_envelopes_plain(r, t, n_seg)
    torch.cuda.synchronize()
    for got_e, want_e in zip(env, want):
        assert torch.equal(got_e, want_e)


@pytest.fixture(scope="module")
def table():
    return R.RefractionTable.build(Atmosphere(us_76()), 530e-9, h_hi=30000.0, device="cpu")


@pytest.mark.parametrize("l_form", ["poly", "table"])
@pytest.mark.parametrize("radius", [6_371_000.0, None], ids=["sphere", "flat"])
def test_march_kernel_matches_plain(table, l_form, radius, cuda_device):
    tb = dataclasses.replace(
        table, values=table.values.to(cuda_device), pairs=table.pairs.to(cuda_device),
        poly=table.poly if l_form == "poly" else None,
    )
    elev = torch.deg2rad(torch.linspace(-0.6, 1.5, 1000, device=cuda_device))
    alt = torch.full_like(elev, 100.0)
    v0 = R.initial_slope(alt, elev, R.EarthShape(radius))
    before = _kernels.MARCH.launches
    hk, vk = R.march_nodes(alt, v0, 800.0, 250, tb, radius)
    assert _kernels.MARCH.launches == before + 1
    assert hk.shape == (251, 1000) and vk.shape == (251, 1000)
    hp, _ = R.march_nodes_plain(alt, v0, 800.0, 250, tb, radius)
    torch.cuda.synchronize()
    assert float((hk - hp).abs().max()) <= 2e-2  # m, as the Pallas march


MARCH_CASES = {  # (B rays, N steps of 50 m, C)
    "one_ray_headline_length": (1, 3999, 16),  # 3999 = 249·16 + 15
    "fan21_c1": (21, 200, 1),  # output-ray-paths: the nodes are the samples
    "headline": (1080, 3999, 16),
    "ragged_tail": (1080, 330, 16),  # 330 = 20·16 + 10
    "c16_no_tail": (37, 320, 16),
}


def _march_contract(tb, radius, b, n, c, device, check_rows=None, alt0=100.0):
    """K2's contract: nodes within 2e-2 m of march_nodes_plain; fine h
    torch.equal to the PyTorch Hermite fill of the kernel's own nodes; p
    within rtol 1e-6 / atol 1e-3 m of _finish_march's path length of it."""
    elev = torch.deg2rad(torch.linspace(-0.6, 1.5, b, device=device) if b > 1
                         else torch.full((1,), 0.05, device=device))
    alt = torch.full_like(elev, alt0)
    v0 = R.initial_slope(alt, elev, R.EarthShape(radius))
    coarse = max(1, min(c, n))
    n_coarse = -(-n // coarse)
    dx = R._f32(50.0 * coarse)
    before = _kernels.MARCH.launches
    h, p, nh, nv = R.march_cuda(alt, v0, dx, n_coarse, tb, radius, fine=(50.0, coarse, n))
    assert _kernels.MARCH.launches == before + 1
    assert h.shape == p.shape == (b, n + 1) and nh.shape == (n_coarse + 1, b)
    sel = torch.arange(b, device=device) if check_rows is None else check_rows
    hp, _ = R.march_nodes_plain(alt[sel], v0[sel], dx, n_coarse, tb, radius)
    h_t, p_t = R._finish_march(R.hermite_fill(nh[:, sel], nv[:, sel], dx, coarse, n),
                               50.0, radius)
    torch.cuda.synchronize()
    assert float((nh[:, sel] - hp).abs().max()) <= 2e-2  # m, as the Pallas march
    assert torch.equal(h[sel], h_t)
    torch.testing.assert_close(p[sel], p_t, rtol=1e-6, atol=1e-3)
    # march_rays on the card is this launch; plain=True is its oracle
    before = _kernels.MARCH.launches
    hr, pr = R.march_rays(alt0, elev, 50.0, n, R.EarthShape(radius), tb, False,
                          coarse=c)
    assert _kernels.MARCH.launches == before + 1
    assert torch.equal(hr, h) and torch.equal(pr, p)


@pytest.mark.parametrize("case", list(MARCH_CASES))
@pytest.mark.parametrize("l_form", ["poly", "table", "poly_split"])
@pytest.mark.parametrize("radius", [6_371_000.0, None], ids=["sphere", "flat"])
def test_fused_march_kernel_contract(table, l_form, radius, case, cuda_device):
    poly = {"poly": table.poly, "table": None, "poly_split": split_fit(table.poly)}[l_form]
    tb = dataclasses.replace(
        table, values=table.values.to(cuda_device), pairs=table.pairs.to(cuda_device),
        poly=poly,
    )
    _march_contract(tb, radius, *MARCH_CASES[case], cuda_device)


@pytest.mark.parametrize("radius", [6_371_000.0, None], ids=["sphere", "flat"])
def test_fused_march_kernel_zero_width_segment(table, radius, cuda_device):
    """Rays that start in a zero-width fit segment (width 1e-30: outside the
    kernel's fast division) take the step marched again with IEEE division."""
    fit = split_fit(table.poly)
    tb = dataclasses.replace(table, values=table.values.to(cuda_device),
                             pairs=table.pairs.to(cuda_device), poly=fit)
    lo = next(lo for lo, hi, _ in fit if lo == hi)
    _march_contract(tb, radius, 64, 330, 16, cuda_device, alt0=lo)


def test_fused_march_kernel_64bit_offsets(table, cuda_device):
    """B·(N+1) = 540 000 · 4000 > 2^31: the rows past the 32-bit range."""
    tb = dataclasses.replace(table, values=table.values.to(cuda_device),
                             pairs=table.pairs.to(cuda_device))
    b = 540_000
    rows = torch.cat([torch.arange(256), torch.arange(b - 1024, b)]).to(cuda_device)
    _march_contract(tb, 6_371_000.0, b, 3999, 16, cuda_device, check_rows=rows)


def _hills(n=121):
    lat = np.arange(n)[:, None] / (n - 1)
    lon = np.arange(n)[None, :] / (n - 1)
    return np.round(300.0 + 250.0 * np.sin(6 * np.pi * lat) * np.cos(4 * np.pi * lon)
                    + 120.0 * np.sin(2 * np.pi * (7 * lat + 5 * lon))).astype(np.float32)


def _fast_launches():
    """The launches of K1, K2, K3, K4 and K5 so far: a Fast frame adds one
    each to K1 and K2 and none to K3, K4 or K5."""
    return [_kernels.COMBINE.launches, _kernels.MARCH.launches, _kernels.RECT_SCAN.launches,
            _kernels.RECT_CULLED.launches, _kernels.RECT_EXACT.launches]


@pytest.mark.parametrize("alpha", [1.0, 0.65])
def test_render_on_card_matches_cpu(alpha, cuda_device):
    terrain = Terrain()
    terrain.add_tile(Tile(49, 21, _hills()))
    params = Config.from_dict({
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Relative": 30.0}},
                 "frame": {"direction": 45.0, "fov": 25.0, "max_distance": 25000.0}},
        "scene": {"terrain_alpha": alpha},
        "simulation_step": 100.0,
        "output": {"width": 96, "height": 64},
    }).into_params(terrain)
    before = _fast_launches()
    gpu = render_fast(params, terrain, cuda_device)
    assert _fast_launches() == [b + 1 for b in before[:2]] + before[2:]
    cpu = render_fast(params, terrain, "cpu")
    ok, frac_any, frac_big = verify_tolerance(gpu.image, cpu.image)
    assert ok, (frac_any, frac_big)


def test_pack_from_files_on_card(cuda_device, tmp_path):
    """A 2 x 2 mosaic written as DTED and GeoTIFF files, decoded by the native
    loaders and packed on the card, equals the CPU pack of the Python
    parsers' tiles; the Fast render over it launches both kernels."""
    from atm_raytracer_tpu_torch.terrain.dted import write_dted
    from atm_raytracer_tpu_torch.terrain.geotiff import write_geotiff

    rng = np.random.default_rng(8)
    for la, lo in ((49, 21), (49, 22), (50, 21), (50, 22)):
        grid = (_hills() + rng.integers(-20, 20, (121, 121))).astype(np.int16)
        if lo == 21:
            write_dted(tmp_path / f"n{la}_e{lo:03d}.dt2", la, lo, grid)
        else:
            write_geotiff(tmp_path / f"N{la}E{lo:03d}.tif", grid[::-1])
    box = ((49.2, 50.8), (21.2, 22.8))
    terrain = Terrain.from_folder(tmp_path)
    gpu = terrain.pack(*box, cuda_device)
    cpu = Terrain.from_folder(tmp_path, native=False).pack(*box, "cpu")
    assert gpu.tiles.device.type == "cuda" and gpu.tiles.dtype == torch.int16
    for f in ("tiles", "rows_m1", "cols_m1"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert (gpu.grad_bound, gpu.seam_jump) == (cpu.grad_bound, cpu.seam_jump)
    params = Config.from_dict({
        "view": {"position": {"latitude": 49.9, "longitude": 21.9,
                              "altitude": {"Relative": 30.0}},
                 "frame": {"direction": 45.0, "fov": 40.0, "max_distance": 30000.0}},
        "simulation_step": 100.0,
        "output": {"width": 96, "height": 64},
    }).into_params(terrain)
    before = _fast_launches()
    render_fast(params, terrain, cuda_device)
    assert _fast_launches() == [b + 1 for b in before[:2]] + before[2:]


def _rect_scene(tilt=0.0, alpha=1.0, size=(96, 64), earth=None):
    terrain = Terrain()
    terrain.add_tile(Tile(49, 21, _hills()))
    cfg = {
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Relative": 30.0}},
                 "frame": {"direction": 45.0, "fov": 25.0, "max_distance": 25000.0,
                           "tilt": tilt}},
        "scene": {"terrain_alpha": alpha},
        "simulation_step": 100.0,
        "output": {"width": size[0], "height": size[1]},
    }
    if earth is not None:
        cfg["earth_shape"] = earth
    return terrain, Config.from_dict(cfg).into_params(terrain)


def _first_hits_close(a, b, key_atol):
    va, vb = a.hits.valid[..., 0].cpu(), b.hits.valid[..., 0].cpu()
    assert float((va != vb).double().mean()) <= 0.01
    both = va & vb
    dk = (a.hits.key[..., 0].cpu() - b.hits.key[..., 0].cpu()).abs()[both]
    assert float(dk.max()) <= key_atol


@pytest.mark.parametrize("alpha", [1.0, 0.65])
def test_rectilinear_tilt0_on_card_matches_cpu(alpha, cuda_device):
    terrain, params = _rect_scene(alpha=alpha)
    gpu = render_rectilinear(params, terrain, cuda_device)
    assert gpu.hits.key.device.type == "cuda"
    cpu = render_rectilinear(params, terrain, "cpu")
    ok, frac_any, frac_big = verify_tolerance(gpu.image, cpu.image)
    assert ok, (frac_any, frac_big)
    _first_hits_close(gpu, cpu, 1e-3)
    if alpha == 1.0:  # K = 1 keys are the first keys of a K = 2 render
        r2 = render_rectilinear(params, terrain, cuda_device, max_hits=2)
        assert torch.equal(gpu.hits.valid[..., 0], r2.hits.valid[..., 0])
        v = gpu.hits.valid[..., 0]
        assert torch.equal(gpu.hits.key[..., 0][v], r2.hits.key[..., 0][v])


def test_rectilinear_culled_on_card(cuda_device):
    terrain, params = _rect_scene(tilt=1.5)
    before = _kernels.RECT_CULLED.launches, _kernels.RECT_EXACT.launches
    culled = render_rectilinear(params, terrain, cuda_device)
    assert culled.culled_rounds >= 1
    # K4 and K5 a round
    assert _kernels.RECT_CULLED.launches == before[0] + culled.culled_rounds
    assert _kernels.RECT_EXACT.launches == before[1] + culled.culled_rounds
    cpu = render_rectilinear(params, terrain, "cpu")
    ok, frac_any, frac_big = verify_tolerance(culled.image, cpu.image)
    assert ok, (frac_any, frac_big)
    # the cull drops no crossing the dense path finds
    dense = render_rectilinear(params, terrain, cuda_device, cull=False, plain=True)
    assert torch.equal(culled.hits.valid, dense.hits.valid)
    _first_hits_close(culled, dense, 1e-3)


def test_rectilinear_pixelwise_marches_through_the_kernel(cuda_device):
    terrain, params = _rect_scene(tilt=-1.0, alpha=0.65)
    before = _kernels.MARCH.launches
    gpu = render_rectilinear(params, terrain, cuda_device)
    assert _kernels.MARCH.launches > before
    cpu = render_rectilinear(params, terrain, "cpu")
    ok, frac_any, frac_big = verify_tolerance(gpu.image, cpu.image)
    assert ok, (frac_any, frac_big)


@pytest.mark.parametrize("alpha", [1.0, 0.65])
def test_artifact_compaction_on_card_equals_cpu(alpha, cuda_device):
    from atm_raytracer_tpu_torch.meta.serialize import PACKED_FIELDS, _pack_artifact

    terrain, params = _rect_scene(alpha=alpha)
    hits = render_fast(params, terrain, cuda_device).hits
    bits, count, seg = _pack_artifact(hits)
    bits_c, count_c, seg_c = _pack_artifact(hits.to("cpu"))
    np.testing.assert_array_equal(bits, bits_c)
    assert count == count_c == int(hits.valid.sum())
    for name in PACKED_FIELDS:
        np.testing.assert_array_equal(seg[name], seg_c[name], err_msg=name)


@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_recomposite_on_card_equals_render(fmt, cuda_device, tmp_path):
    from atm_raytracer_tpu_torch.meta.serialize import load_metadata, save_metadata
    from atm_raytracer_tpu_torch.meta.viewer import _render_from_metadata

    terrain, _ = _rect_scene(alpha=0.65)
    config = Config.from_dict({
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Relative": 30.0}},
                 "frame": {"direction": 45.0, "fov": 25.0, "max_distance": 25000.0}},
        "scene": {"terrain_alpha": 0.65},
        "simulation_step": 100.0,
        "output": {"width": 96, "height": 64},
    })
    result = render_fast(config.into_params(terrain), terrain, cuda_device)
    path = tmp_path / ("m.npz" if fmt == "native" else "m.dat")
    save_metadata(path, config, result, fmt=fmt)
    loaded_config, loaded = load_metadata(path)
    on_card = _render_from_metadata(loaded_config, loaded, cuda_device)
    np.testing.assert_array_equal(on_card, result.image)
    np.testing.assert_array_equal(on_card, _render_from_metadata(loaded_config, loaded, "cpu"))


def test_ray_paths_march_through_the_kernel(cuda_device, tmp_path):
    import argparse

    from atm_raytracer_tpu_torch.tools.ray_path import fan_heights

    cfg = tmp_path / "config.json"  # JSON is YAML
    cfg.write_text('{"view": {"position": {"latitude": 49.5, "longitude": 21.5}}}')
    args = argparse.Namespace(input=str(cfg), height=2.0, min_ang=-1.0, max_ang=1.0,
                              angle_step=0.1, ray_step=50.0, cutoff=100000.0,
                              output_step=50.0)
    before = _kernels.MARCH.launches
    xs, h = fan_heights(args, cuda_device)
    assert _kernels.MARCH.launches == before + 1
    xs_c, h_c = fan_heights(args, torch.device("cpu"))
    np.testing.assert_array_equal(xs, xs_c)
    assert float(np.abs(h - h_c).max()) <= 2e-2  # m, as the Pallas march


def _interp_golden(scene):
    """A golden Interpolating scene of tests/test_golden.py over its terrain
    (the analytic hills at 181 posts a degree)."""
    terrain = Terrain()
    terrain.add_tile(Tile(49, 21, _hills(181)))
    cfg = {
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Relative": 30.0}},
                 "frame": {"direction": 45.0, "fov": 25.0, "max_distance": 25000.0},
                 "coloring": {"Shading": {"water_level": -100.0}}},
        "simulation_step": 100.0,
        "output": {"width": 64, "height": 48, "generator": "InterpolatingRectilinear"},
    }
    if scene == "translucent":
        cfg["scene"] = {"terrain_alpha": 0.65}
        cfg["view"]["fog_distance"] = 15000.0
    elif scene == "flat_straight":
        cfg["earth_shape"] = "FlatDistorted"
        cfg["straight_rays"] = True
        cfg["view"]["coloring"] = {"Simple": {"water_level": -100.0}}
    return terrain, Config.from_dict(cfg).into_params(terrain)


@pytest.mark.parametrize("scene", ["plain", "translucent", "flat_straight"])
def test_interpolating_golden_on_card_matches_cpu(scene, cuda_device):
    """One render launches K1 (the grid's columns) once and, where the rays
    are refracted, K2 (its rows) once, and sits within the verify tolerance
    of the CPU plain path."""
    terrain, params = _interp_golden(scene)
    k1, k2 = _kernels.COMBINE.launches, _kernels.MARCH.launches
    gpu = I.render_interpolating(params, terrain, cuda_device)
    assert _kernels.COMBINE.launches == k1 + 1
    assert _kernels.MARCH.launches == k2 + (0 if params.straight_rays else 1)
    assert gpu.hits.key.device.type == "cuda"
    cpu = I.render_interpolating(params, terrain, "cpu")
    ok, frac_any, frac_big = verify_tolerance(gpu.image, cpu.image)
    assert ok, (frac_any, frac_big)
    assert float((gpu.hits.valid.cpu() != cpu.hits.valid).double().mean()) <= 0.01


def test_interpolating_kernels_match_plain_on_card(cuda_device):
    """The translucent grid (K = 4, 16 entries a pixel) through the kernels
    against ``plain=True`` on the card; the card's grid cells equal the
    CPU's at this size."""
    terrain, params = _rect_scene(alpha=0.65)
    gpu = I.render_interpolating(params, terrain, cuda_device)
    plain = I.render_interpolating(params, terrain, cuda_device, plain=True)
    ok, frac_any, frac_big = verify_tolerance(gpu.image, plain.image)
    assert ok, (frac_any, frac_big)
    assert gpu.hits.valid.shape == (64, 96, 8)
    assert float((gpu.hits.valid != plain.hits.valid).double().mean()) <= 0.01
    out, frame = params.output, params.view.frame
    cam = (out.width, out.height, frame.fov, frame.tilt, frame.direction)
    min_es, min_ds, i_min, j_min = I._camera_grids(*cam)[:4]
    args = (cam, float(min_es), float(min_ds), i_min, j_min)
    for a, b in zip(I.grid_coords(*args, cuda_device)[:2], I.grid_coords(*args, "cpu")[:2]):
        assert torch.equal(a.cpu(), b)


def _objects_golden(generator, tilt=0.0):
    terrain = Terrain()
    terrain.add_tile(Tile(49, 21, _hills(181)))
    cfg = objects_golden_config(generator, tilt)
    return terrain, Config.from_dict(cfg).into_params(terrain)


def _object_hits(res):
    return int((res.hits.valid & (res.hits.kind == 1)).sum())


@pytest.mark.parametrize("generator", ["Fast", "Rectilinear", "InterpolatingRectilinear"])
def test_objects_golden_on_card_matches_cpu(generator, cuda_device):
    """The objects golden scene on the card against the CPU plain path: K1
    and K2 launched once by Fast and Interpolating, K2 by the Rectilinear
    row chunks; images within the verify tolerance, object hits alike."""
    terrain, params = _objects_golden(generator)
    render = {"Fast": render_fast, "Rectilinear": render_rectilinear,
              "InterpolatingRectilinear": I.render_interpolating}[generator]
    k1, k2 = _kernels.COMBINE.launches, _kernels.MARCH.launches
    gpu = render(params, terrain, cuda_device)
    if generator == "Rectilinear":
        assert _kernels.MARCH.launches > k2
    else:
        assert (_kernels.COMBINE.launches, _kernels.MARCH.launches) == (k1 + 1, k2 + 1)
    cpu = render(params, terrain, "cpu")
    ok, frac_any, frac_big = verify_tolerance(gpu.image, cpu.image)
    assert ok, (frac_any, frac_big)
    assert float((gpu.hits.valid.cpu() != cpu.hits.valid).double().mean()) <= 0.01
    assert _object_hits(gpu) > 100 and abs(_object_hits(gpu) - _object_hits(cpu)) <= 10


def test_fast_object_pass_kernels_match_plain_on_card(cuda_device):
    """The Fast object frame through K1 and K2 against ``plain=True`` on the
    card: images within the tolerance, validity equal on >= 99.9 % of the
    slots, the same object hits."""
    terrain, params = _objects_golden("Fast")
    gpu = render_fast(params, terrain, cuda_device)
    plain = render_fast(params, terrain, cuda_device, plain=True)
    ok, frac_any, frac_big = verify_tolerance(gpu.image, plain.image)
    assert ok, (frac_any, frac_big)
    assert float((gpu.hits.valid == plain.hits.valid).double().mean()) >= 0.999
    assert abs(_object_hits(gpu) - _object_hits(plain)) <= 5


@pytest.mark.parametrize("shape", list(WINDOW_SHAPES))
def test_col_windows_on_card_equal_cpu(shape, cuda_device):
    """The objects' column windows scanned on the card equal the CPU scan
    at 1080p's 1920 columns over 200 km in 50 m steps (one [1920, 2000]
    float64 grid, two chunks of objects), on the scene whose CPU windows
    ``test_torch_objects.py`` holds equal to the JAX package's (this file
    imports no JAX, so the card is compared with the CPU here)."""
    cfg = seeded_objects_config(WINDOW_SHAPES[shape], seed=19, **WINDOW_GRIDS["1080p"])
    params = Config.from_dict(cfg).into_params(None)
    args = fast_window_args(params)
    gpu = O.object_col_windows(O.ObjectSet.build(params, cuda_device), params.model, *args)
    cpu = O.object_col_windows(O.ObjectSet.build(params, "cpu"), params.model, *args)
    assert gpu == cpu and sum(1 for _, n in gpu if n) == 6



def _object_pixels(hits, config):
    """For each object of a benchmark configuration, at its stored position:
    the pixels it is a valid kind-1 hit in (told apart by the hit's distance,
    within 250 m of the object's), and of those the pixels where a terrain
    hit lies in front of its nearest hit."""
    sc = config["scene"]["view"]["position"]
    lat0, lon0 = np.radians(sc["latitude"]), np.radians(sc["longitude"])
    inf = torch.full_like(hits.key, float("inf"))
    terrain = hits.valid & (hits.kind == 0)
    first_terrain = torch.where(terrain, hits.key, inf).min(-1).values
    seen, behind = [], []
    for lat, lon in config["objects"]["placed"]:
        lat, lon = np.radians(lat), np.radians(lon)
        d = 2 * 6371000.0 * np.arcsin(np.sqrt(
            np.sin((lat - lat0) / 2) ** 2
            + np.cos(lat0) * np.cos(lat) * np.sin((lon - lon0) / 2) ** 2))
        mine = hits.valid & (hits.kind == 1) & ((hits.distance - float(d)).abs() < 250.0)
        px = mine.any(-1)
        nearest = torch.where(mine, hits.key, inf).min(-1).values
        seen.append(int(px.sum()))
        behind.append(int((px & (first_terrain < nearest)).sum()))
    return seen, behind


def test_translucent_scene_sees_its_objects_through_the_terrain(cuda_device):
    """The benchmark's translucent scene (``portbench/configs/
    translucent_1080p.json``, bench.py's positions) at 1080p on the card,
    looking down the objects' sector (45 degrees) through the benchmark's
    route: each of the ten objects is a valid kind-1 hit, and each whose base
    a nearer ridge hides (objects 3-10, from 3.3 km out) is seen in some
    pixels through the translucent terrain, a terrain hit in front of it."""
    import tempfile
    from pathlib import Path

    from portbench import harness, scene

    config = harness.load_json(harness.HERE / "configs" / "translucent_1080p.json")
    keys, tiles = scene.make_tiles(config, cuda_device)
    program = harness.Program()
    terrain = scene.build_terrain(program.Terrain, program.Tile, keys, tiles)
    with tempfile.TemporaryDirectory() as d:
        texture = Path(d) / "checker64.png"
        scene.write_texture(texture)
        objects = scene.objects_at(config, config["objects"]["placed"], texture)
        frame = scene.frame_dict(config["scene"], 45.0, 0.0, "Fast", objects)
        hits = program.render(program.lower(frame, terrain), terrain, cuda_device).hits
    assert hits.valid.shape[-1] == 10
    seen, behind = _object_pixels(hits, config)
    assert all(seen), seen
    assert all(behind[2:]), behind


def test_tilted_object_frame_marches_through_the_kernel(cuda_device):
    """Tilted, an object frame takes the dense path (never the culled one),
    whose march goes through K2, and matches the CPU."""
    terrain, params = _objects_golden("Rectilinear", tilt=1.0)
    before = _kernels.MARCH.launches
    gpu = render_rectilinear(params, terrain, cuda_device)
    assert _kernels.MARCH.launches > before and gpu.culled_rounds is None
    cpu = render_rectilinear(params, terrain, "cpu")
    ok, frac_any, frac_big = verify_tolerance(gpu.image, cpu.image)
    assert ok, (frac_any, frac_big)
    assert _object_hits(gpu) > 100


def _translucent_scene(device, size):
    """(terrain, params) of the benchmark's translucent scene (``portbench/
    configs/translucent_1080p.json``) looking at 45 degrees: at 1080p with
    its stored objects, or at the benchmark tests' size (``"small"``), where
    the rule places them."""
    import tempfile
    from pathlib import Path

    from portbench import harness, scene

    config = harness.load_json(harness.HERE / "configs" / "translucent_1080p.json")
    if size == "small":
        config = harness.shrunk(config, {"width": 96, "height": 54, "max_distance": 20000.0,
                                         "posts": 121})
    keys, tiles = scene.make_tiles(config, device)
    program = harness.Program()
    terrain = scene.build_terrain(program.Terrain, program.Tile, keys, tiles)
    with tempfile.TemporaryDirectory() as d:
        texture = Path(d) / "checker64.png"
        scene.write_texture(texture)
        objects = harness.scene_objects(config, keys, tiles, texture, device)
        frame = scene.frame_dict(config["scene"], 45.0, 0.0, "Fast", objects)
        return terrain, program.lower(frame, terrain)


def _pass_inputs(terrain, params, device, monkeypatch):
    """The arguments ``separable_hits`` hands the object pass in a Fast
    render of ``params`` on ``device``: (planes, objects, model, lat0, step,
    ray_h, path_len, dlat, dlon, windows, k_out)."""
    from atm_raytracer_tpu_torch.generators import fast

    seen = []
    real = fast.apply_objects_planes

    def keep(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(fast, "apply_objects_planes", keep)
    render_fast(params, terrain, device)
    monkeypatch.setattr(fast, "apply_objects_planes", real)
    (args,) = seen
    return args


def _pass_contract(got, want):
    """The bar of ``test_fast_object_pass_matches_jax``: validity equal, keys
    within 1e-5 of a step, fields on valid slots within rtol 1e-5 / atol
    1e-3, every invalid slot's payload 0. Returns (valid slots, object
    hits)."""
    (gk, gv), (wk, wv) = got, want
    valid = torch.isfinite(wk)
    assert torch.equal(torch.isfinite(gk), valid)
    assert float((gk[valid] - wk[valid]).abs().max()) <= 1e-5
    for c, nm in enumerate(O.PLANE_CHANNELS):
        torch.testing.assert_close(gv[c][valid], wv[c][valid], rtol=1e-5, atol=1e-3,
                                   msg=nm)
    assert not gv[:, ~valid].any(), "a payload on an invalid slot"
    kind = O.PLANE_CHANNELS.index("kind")
    return int(valid.sum()), int((wv[kind][valid] > 0.5).sum())


@pytest.mark.parametrize("scene", ["objects golden", "objects golden, k_out 20",
                                   "translucent small", "translucent 1080p"])
def test_object_pass_kernel_matches_plain(scene, cuda_device, monkeypatch):
    """K6 against ``apply_objects_planes_plain`` on the card, on the object
    pass's own inputs: the objects golden (K = 1), the golden widened to 20
    slots, and the benchmark's translucent scene (K = 4 and k_out = 10, more
    windows over a column than the cap keeps, a textured Billboard and a
    true Frustum) at the tests' size and at 1080p. The tables K6's culling
    scan builds are ``object_column_tables``', bit for bit."""
    if scene.startswith("objects golden"):
        terrain, params = _objects_golden("Fast")
    else:
        terrain, params = _translucent_scene(cuda_device,
                                             "small" if "small" in scene else "1080p")
    args = list(_pass_inputs(terrain, params, cuda_device, monkeypatch))
    if "k_out 20" in scene:
        args[-1] = 20
    before = _kernels.OBJECT_PASS.launches
    got = O.apply_objects_planes(*args)
    assert _kernels.OBJECT_PASS.launches == before + 1
    want = O.apply_objects_planes(*args, plain=True)
    assert _kernels.OBJECT_PASS.launches == before + 1
    n_valid, n_obj = _pass_contract(got, want)
    planes, objects, model, lat0, _, _, _, dlat, dlon, windows, _ = args
    assert n_obj > 100 and n_valid > int(torch.isfinite(planes[0]).sum())
    kept = []
    O.object_pass_cuda(*args, tables_out=kept)
    (tables,) = kept
    plain = O.object_column_tables(objects, model, lat0, dlat, dlon, windows)
    assert tables.windows == plain.windows
    for field in ("k_lo", "seg_close", "terms"):
        assert torch.equal(getattr(tables, field), getattr(plain, field)), field
    if scene.startswith("translucent"):
        assert planes[0].shape[-1] == 4 and args[-1] == 10


def test_object_pass_kernel_averages_ties_as_the_plain_pass(cuda_device, monkeypatch):
    """Constructed ties, K6 against the plain pass: each golden object
    twice in a row, the copy in another colour (two objects at one key);
    the terrain's slot moved onto the first object hit of some pixels (a
    terrain key equal to an object key); and a second terrain slot at the
    first one's key (a pixel's slots not distinct)."""
    terrain, params = _objects_golden("Fast")
    planes, objects, *rest, windows, k_out = _pass_inputs(terrain, params, cuda_device,
                                                           monkeypatch)
    n = objects.n_objects
    twice = torch.arange(n, device=cuda_device).repeat_interleave(2)
    fields = {f.name: getattr(objects, f.name) for f in dataclasses.fields(O.ObjectSet)}
    for name in ("kind", "dlat", "dlon", "elev", "r1", "r2", "height", "width", "rgba",
                 "basis", "tex_id", "cull_r2"):
        fields[name] = fields[name][twice]
    fields["rgba"][1::2, :3] = 1.0 - fields["rgba"][1::2, :3]
    fields.update(n_objects=2 * n, kinds_static=tuple(k for k in objects.kinds_static
                                                      for _ in range(2)),
                  host_meta=tuple(m for m in objects.host_meta for _ in range(2)))
    doubled = O.ObjectSet(**fields)
    windows2 = tuple(w for w in windows for _ in range(2))
    key, vals = planes
    out_key, out_vals = O.apply_objects_planes(planes, objects, *rest, windows, k_out,
                                               plain=True)
    is_obj = out_vals[O.PLANE_CHANNELS.index("kind")] > 0.5
    obj_key = torch.where(is_obj, out_key, float("inf")).amin(dim=-1)
    moved = torch.isfinite(key[..., 0]) & (obj_key < key[..., 0])
    tied_key = torch.where(moved[..., None], obj_key[..., None], key)
    twin = torch.isfinite(key[..., :1]) & ~moved[..., None]
    twin_key = torch.cat([tied_key, torch.where(twin, tied_key, float("inf"))], dim=-1)
    twin_vals = torch.cat([vals, torch.where(twin, vals.flip(0), 0.0)], dim=-1)
    assert int(moved.sum()) >= 20 and int(twin.sum()) >= 1000
    cases = [((key, vals), doubled, windows2), ((tied_key, vals), objects, windows),
             ((twin_key, twin_vals), objects, windows)]
    for case_planes, case_objects, case_windows in cases:
        args = (case_planes, case_objects, *rest, case_windows, k_out)
        _pass_contract(O.apply_objects_planes(*args),
                       O.apply_objects_planes(*args, plain=True))


def test_object_frames_launch_the_object_pass_once(cuda_device):
    """A Fast frame with objects launches K6 once; under ``plain=True`` it
    runs the plain pass and launches nothing."""
    terrain, params = _objects_golden("Fast")
    before = _kernels.OBJECT_PASS.launches
    render_fast(params, terrain, cuda_device)
    assert _kernels.OBJECT_PASS.launches == before + 1
    render_fast(params, terrain, cuda_device, plain=True)
    assert _kernels.OBJECT_PASS.launches == before + 1


def _frames_fan(seed, f_n, h_n, w_n, n_seg):
    """F combine fans, a different death row in each frame."""
    parts = [_fan(seed + f, h_n, w_n, n_seg, extra=5) for f in range(f_n)]
    ray = np.stack([p[0] for p in parts])
    for f in range(f_n):
        ray[f, (3 * f) % h_n, n_seg // (f + 2):] = -2000.0
    return ray, np.stack([p[1] for p in parts])


@pytest.mark.parametrize("max_hits", [1, 4])
@pytest.mark.parametrize("f_n, h_n, w_n, n_seg", [(3, 41, 70, 300), (8, 720, 96, 400)],
                         ids=["3x41_rows", "8x720_rows"])
def test_combine_kernel_frame_axis_equals_frames(f_n, h_n, w_n, n_seg, max_hits,
                                                 cuda_device):
    """One K1 launch over [F, H, W, K] (41 rows: not a multiple of TILE_H)
    equals F one-frame launches, envelopes included, and the plain path."""
    ray, terr = _frames_fan(9, f_n, h_n, w_n, n_seg)
    r = torch.from_numpy(ray).to(cuda_device)
    t = torch.from_numpy(terr).to(cuda_device)
    before = _kernels.COMBINE.launches
    got, env = combine.crossing_segments_envelopes_cuda(r, t, n_seg, max_hits)
    assert _kernels.COMBINE.launches == before + 1
    assert got.shape == (f_n, h_n, w_n, max_hits)
    for f in range(f_n):
        one, env_f = combine.crossing_segments_envelopes_cuda(r[f], t[f], n_seg, max_hits)
        assert torch.equal(got[f], one)
        for a, b in zip(env, env_f):
            assert torch.equal(a[f], b)
    torch.cuda.synchronize()
    assert torch.equal(got, combine.terrain_crossing_segments_plain(r, t, n_seg, max_hits))
    for a, b in zip(env, combine.crossing_envelopes_plain(r, t, n_seg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("radius", [6_371_000.0, None], ids=["sphere", "flat"])
def test_march_kernel_table_stride_equals_two_launches(table, radius, cuda_device):
    """K2 over two frames' tables (stride n - 1) equals one launch a frame;
    with the plain march of the stacked table as its oracle."""
    second = R.RefractionTable.build(
        Atmosphere(dataclasses.replace(us_76(), temperature_fixed_point=(0.0, 283.15))),
        530e-9, h_hi=30000.0, device="cpu")
    n = min(table.values.shape[0], second.values.shape[0])
    one = [R.RefractionTable.from_values(t.values[:n].numpy(), t.h0, t.inv_dh, None,
                                         cuda_device) for t in (table, second)]
    stacked = R.RefractionTable.stack(one)
    h_n, steps = 37, 330
    elev = torch.deg2rad(torch.linspace(-0.6, 1.5, h_n, device=cuda_device))
    alt = torch.tensor([100.0, 700.0], device=cuda_device).repeat_interleave(h_n)
    shape = R.EarthShape(radius)
    before = _kernels.MARCH.launches
    h, p = R.march_rays(alt, elev.repeat(2), 50.0, steps, shape, stacked, False,
                        coarse=16, rays_per_frame=h_n)
    assert _kernels.MARCH.launches == before + 1
    hp, _ = R.march_rays(alt, elev.repeat(2), 50.0, steps, shape, stacked, False,
                         coarse=16, rays_per_frame=h_n, plain=True)
    for f in range(2):
        hf, pf = R.march_rays(float(alt[f * h_n]), elev, 50.0, steps, shape, one[f], False,
                              coarse=16)
        assert torch.equal(h[f * h_n:(f + 1) * h_n], hf)
        assert torch.equal(p[f * h_n:(f + 1) * h_n], pf)
    torch.cuda.synchronize()
    assert float((h - hp).abs().max()) <= 2e-2  # m, as the Pallas march
    assert not torch.equal(h[:h_n], h[h_n:])


def test_fast_split_over_two_entries_equals_one_device(cuda_device):
    """``[cuda, cuda]``: the columns split and gathered give the one-device
    render; a sweep of 3 frames launches each kernel once and its frames
    equal the single renders."""
    from atm_raytracer_tpu_torch.parallel import mesh as M

    terrain, params = _rect_scene()
    one = render_fast(params, terrain, cuda_device)
    two = M.render_fast_sharded(params, terrain, M.make_mesh([cuda_device] * 2))
    np.testing.assert_array_equal(two.image, one.image)
    assert torch.equal(two.hits.valid, one.hits.valid)
    assert torch.equal(two.hits.key, one.hits.key)
    k1, k2 = _kernels.COMBINE.launches, _kernels.MARCH.launches
    frames = M.render_sweep_sharded(params, terrain, M.make_mesh([cuda_device]),
                                    [45.0, 90.0, 135.0])
    assert (_kernels.COMBINE.launches, _kernels.MARCH.launches) == (k1 + 1, k2 + 1)
    np.testing.assert_array_equal(frames[0], one.image)


# -- the transfer group, the frame codec and the banded render -------------------------

def test_pinned_fetch_equals_cpu(cuda_device):
    """``fetch_flat`` / ``fetch_flat_many`` copy through page-locked buffers
    and give ``.cpu()``'s values, whole and in slices."""
    from atm_raytracer_tpu_torch.generators import base

    g = torch.Generator(device=cuda_device).manual_seed(3)
    ts = [torch.rand(1080, 1920, 3, device=cuda_device, generator=g).mul(255).to(torch.uint8),
          torch.randn(37, 53, 4, device=cuda_device, generator=g),
          torch.rand(1000, device=cuda_device, generator=g) < 0.5,
          torch.arange(12, device=cuda_device, dtype=torch.int16).reshape(3, 4).t(),
          torch.zeros(0, device=cuda_device)]
    for t in ts:
        for chunk in (0, 4096):
            got = base.fetch_flat(t, chunk_bytes=chunk)
            np.testing.assert_array_equal(got, t.cpu().reshape(-1).numpy())
            if t.numel():
                assert torch.from_numpy(got).is_pinned()
    for got, t in zip(base.fetch_flat_many(ts), ts):
        np.testing.assert_array_equal(got, t.cpu().reshape(-1).numpy())


def test_fetch_of_a_strided_tensor_after_the_first_waits_for_its_flattening(cuda_device):
    """A non-contiguous tensor after the first of a batch: its flat copy, a
    kernel on the producer stream, runs before the copy stream reads it."""
    from atm_raytracer_tpu_torch.generators import base

    n = 8192
    want = np.arange(n * n, dtype=np.int32).reshape(n, n).T.reshape(-1)
    for _ in range(3):
        torch.full((n * n,), -1, device=cuda_device, dtype=torch.int32)  # stale bytes
        busy = torch.randn(4096, 4096, device=cuda_device)
        for _ in range(10):  # queue device work ahead of both tensors
            busy = busy @ busy / 4096.0
        big = torch.arange(n * n, device=cuda_device, dtype=torch.int32).reshape(n, n)
        small = torch.ones(1, device=cuda_device)
        got = base.fetch_flat_many((small, big.t()))
        assert got[0][0] == 1
        np.testing.assert_array_equal(got[1], want)


def test_two_renders_keep_their_own_images(cuda_device):
    """No staging buffer is reused under a returned image: a second render
    (and a second fetch) leaves the first one's bytes alone."""
    from atm_raytracer_tpu_torch.generators import base

    terrain, params = _rect_scene()
    first = render_fast(params, terrain, cuda_device)
    kept = first.image.copy()
    turned = dataclasses.replace(params, view=dataclasses.replace(
        params.view, frame=dataclasses.replace(params.view.frame, direction=200.0)))
    second = render_fast(turned, terrain, cuda_device)
    assert not np.shares_memory(first.image, second.image)
    assert not np.array_equal(first.image, second.image)
    np.testing.assert_array_equal(first.image, kept)
    a = base.fetch_flat(torch.ones(1 << 20, device=cuda_device))
    base.fetch_flat(torch.zeros(1 << 20, device=cuda_device))
    assert (a == 1).all()


def test_source_freed_under_a_pending_copy_is_read_right(cuda_device):
    """``record_stream``: a source dropped while its copy still waits on the
    producer keeps its memory until the copy has run."""
    from atm_raytracer_tpu_torch.generators import base

    n = 1 << 24
    busy = torch.randn(4096, 4096, device=cuda_device)
    src = torch.arange(n, device=cuda_device, dtype=torch.int32)
    want = np.arange(n, dtype=np.int32)
    ptr = src.data_ptr()
    with base.fetch_pool() as pool:
        for _ in range(20):  # queue device work ahead of the copy
            busy = busy @ busy / 4096.0
        src = src + 0  # the copy's source is made behind that work
        ptr = src.data_ptr()
        (out,), handles = base.submit_fetch(pool, (src,))
        del src
        other = torch.full((n,), -7, device=cuda_device, dtype=torch.int32)
        assert other.data_ptr() != ptr  # the pending block is not handed out
    np.testing.assert_array_equal(out, want)
    assert int((other == -7).sum()) == n


def test_pack_frame_stream_makes_no_sync(cuda_device):
    """The band codec runs under ``set_sync_debug_mode("error")`` and packs
    the CPU's bytes from the same inputs."""
    from atm_raytracer_tpu_torch.meta import pack as P

    rng = np.random.default_rng(5)
    valid = rng.random((108, 240, 2)) < 0.6
    img = (np.cumsum(rng.integers(-3, 4, (108 * 240, 3)), axis=0) % 200).astype(np.uint8)
    img = img.reshape(108, 240, 3)
    img[~valid.any(-1)] = (28, 28, 28)
    v, im = torch.from_numpy(valid).to(cuda_device), torch.from_numpy(img).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = P.pack_frame_stream(v, im, 4096)
        batched = P.pack_frame_compact(v[None].expand(3, -1, -1, -1),
                                       im[None].expand(3, -1, -1, -1))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = P.pack_frame_stream(torch.from_numpy(valid), torch.from_numpy(img), 4096)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert 0 < int(got[4][1:].max()) <= 4096  # exceptions, all inside the cap
    out = P.unpack_frame_stream(*(g.cpu().numpy() for g in got), np.array([28] * 3), 108,
                                240, 4096)
    np.testing.assert_array_equal(out, img)
    assert torch.equal(batched[4].cpu(), P.pack_frame_compact(
        torch.from_numpy(valid), torch.from_numpy(img))[4][None].expand(3, -1))


@pytest.mark.parametrize("alpha", [1.0, 0.65], ids=["k1", "k4"])
def test_banded_render_equals_render_fast(alpha, cuda_device):
    """192x108 (8 bands of 24 columns) and K = 4: ``torch.equal`` to
    ``render_fast``, one K2 launch and one K1 a band, 8 progress lines."""
    from atm_raytracer_tpu_torch.generators import fast

    terrain, params = _rect_scene(alpha=alpha)
    params = dataclasses.replace(params, output=dataclasses.replace(
        params.output, width=192, height=108))
    plain = fast.render_fast(params, terrain, cuda_device)
    k1, k2 = _kernels.COMBINE.launches, _kernels.MARCH.launches
    lines = []
    got = fast.render_fast_streamed(params, terrain, cuda_device, bands=8,
                                    progress=lines.append)
    assert (_kernels.COMBINE.launches - k1, _kernels.MARCH.launches - k2) == (8, 1)
    assert lines == [12, 25, 38, 50, 62, 75, 88, 100]
    np.testing.assert_array_equal(got.image, plain.image)
    for f in dataclasses.fields(got.hits):
        assert torch.equal(getattr(got.hits, f.name), getattr(plain.hits, f.name)), f.name


K3_FORMS = ("poly sphere", "table sphere", "straight sphere", "poly flat")


def _k3_inputs(device, terrain, params, rows=None):
    """The tilt-0 scan's inputs of ``params`` on ``device`` and its keywords,
    the l(h) form and shape left to the caller."""
    from atm_raytracer_tpu_torch.generators import base
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    out, frame = params.output, params.view.frame
    alt0 = float(params.view.position.abs_altitude(terrain))
    n_terr = int(np.ceil(frame.max_distance / params.simulation_step))
    az = torch.from_numpy(rect.camera.rectilinear_column_azimuths(
        out.width, frame.fov, frame.direction).astype(np.float32)).to(device)
    elev_hw, terr_pad, _, coarse = rect.tilt0_inputs(
        terrain.pack(*base.terrain_bbox(params), device), az,
        cam=(out.width, out.height, float(frame.fov)), model=params.model,
        step=float(params.simulation_step), n_terr=n_terr, lat0=49.5, lon0=21.5, rows=rows)
    table = base.build_refraction_table(params, alt0, device)
    return (elev_hw, terr_pad, alt0), table, dict(step=float(params.simulation_step),
                                                  n_seg=n_terr - 1, coarse=coarse)


def _k3_form(form, table):
    l_form, shape = form.split()
    return dict(shape=R.FLAT if shape == "flat" else R.EarthShape(6_371_000.0),
                table=dataclasses.replace(table, poly=None) if l_form == "table" else table,
                straight=l_form == "straight")


def _k3_contract(got, want):
    """chip_smoke's K3 contract: valid flags equal on >= 99.99 % of pixels;
    where both hit, keys within 1e-3 of a step and path lengths within
    rtol 1e-6 / atol 1e-3 m."""
    (key, plh), (key_p, plh_p) = got, want
    v, vp = torch.isfinite(key), torch.isfinite(key_p)
    assert int((v != vp).any(-1).sum()) <= 1e-4 * v.shape[0] * v.shape[1]
    both = v & vp
    assert both.any()
    assert float((key - key_p).abs()[both].max()) <= 1e-3
    assert torch.allclose(plh[both], plh_p[both], rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("max_hits", [1, 4])
@pytest.mark.parametrize("form", K3_FORMS)
def test_rect_scan_kernel_matches_plain(form, max_hits, cuda_device):
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    terrain, params = _rect_scene()
    args, table, kw = _k3_inputs(cuda_device, terrain, params)
    fkw = _k3_form(form, table)
    before = _kernels.RECT_SCAN.launches
    key, plh, flags = rect.tilt0_hits_cuda(*args, max_hits=max_hits, **fkw, **kw)
    n_coarse = -(-kw["n_seg"] // kw["coarse"])
    assert _kernels.RECT_SCAN.launches == before + len(rect.scan_launches(n_coarse))
    want = rect.tilt0_hits_plain(*args, max_hits=max_hits, **fkw, **kw)
    torch.cuda.synchronize()
    _k3_contract((key, plh), want)
    # every pixel stopped or ran every window; the hits it counted are its slots
    windows = flags >> rect.SCAN_WINDOWS_SHIFT
    assert bool((((flags & 1) == 1) | (windows == n_coarse)).all())
    assert torch.equal((flags >> 1) & 0xFF, torch.isfinite(key).sum(-1).to(torch.int32))
    # the plain scan with K3's rules: the plain scan's values, and K3's flags
    # (the windows each pixel marched, its hits, whether it stopped)
    key_r, plh_r, flags_r, tally = rect.tilt0_hits_ruled(*args, max_hits=max_hits, **fkw,
                                                         **kw)
    assert torch.equal(key_r, want[0]) and torch.equal(plh_r, want[1])
    assert torch.equal(flags, flags_r)
    assert int(windows.sum()) <= int(tally.plain.sum())  # the flat fit never exits


def test_rect_scan_kernel_on_a_row_subset(cuda_device):
    """A row shard (rows given, as parallel.mesh passes them) gives those
    rows of the full frame, bit for bit."""
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    terrain, params = _rect_scene(alpha=0.65)
    rows = torch.tensor([0, 5, 6, 31, 63], device=cuda_device)
    full, tb, kw = _k3_inputs(cuda_device, terrain, params)
    part, _, _ = _k3_inputs(cuda_device, terrain, params, rows=rows)
    for k in (1, 4):
        fkw = _k3_form("poly sphere", tb)
        key_f, plh_f, _ = rect.tilt0_hits_cuda(*full, max_hits=k, **fkw, **kw)
        key_r, plh_r, _ = rect.tilt0_hits_cuda(*part, max_hits=k, **fkw, **kw)
        assert torch.equal(key_r, key_f[rows]) and torch.equal(plh_r, plh_f[rows])


def test_rect_scan_kernel_short_march(cuda_device):
    """A march shorter than one coarse window (n_seg = 6 < 8): the window
    is clamped to it, and K3 agrees with the plain scan."""
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    terrain, params = _rect_scene()
    params.view.frame.max_distance = 700.0
    args, table, kw = _k3_inputs(cuda_device, terrain, params)
    assert kw["coarse"] == kw["n_seg"] == 6
    for k in (1, 2):
        fkw = _k3_form("poly sphere", table)
        key, plh, _ = rect.tilt0_hits_cuda(*args, max_hits=k, **fkw, **kw)
        _k3_contract((key, plh), rect.tilt0_hits_plain(*args, max_hits=k, **fkw, **kw))


@pytest.mark.parametrize("alpha", [1.0, 0.65])
def test_rectilinear_tilt0_scans_through_the_kernel(alpha, cuda_device):
    """The tilt-0 frame's scan is K3 on the card (its launches counted), and
    ``plain=True`` renders the same image through the plain scan."""
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    terrain, params = _rect_scene(alpha=alpha)
    before = _fast_launches()
    gpu = render_rectilinear(params, terrain, cuda_device)
    n_coarse = -(-(250 - 1) // 8)  # 25 km in 100 m steps, windows of 8
    assert _fast_launches() == (before[:2] + [before[2] + len(rect.scan_launches(n_coarse))]
                                + before[3:])
    plain = render_rectilinear(params, terrain, cuda_device, plain=True)
    assert _fast_launches()[2] == before[2] + len(rect.scan_launches(n_coarse))
    ok, frac_any, frac_big = verify_tolerance(gpu.image, plain.image)
    assert ok, (frac_any, frac_big)
    _first_hits_close(gpu, plain, 1e-3)


def _culled_inputs(device, terrain, params):
    """The tilted frame's capture inputs on ``device``, as
    ``fused_culled_core`` builds them: (CulledInputs, alt0, table, the scan
    keywords), the l(h) form and shape left to the caller."""
    from atm_raytracer_tpu_torch.generators import base
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    out, frame = params.output, params.view.frame
    alt0 = float(params.view.position.abs_altitude(terrain))
    n_terr = int(np.ceil(frame.max_distance / params.simulation_step))
    step = float(params.simulation_step)
    blocks = rect.culled_blocks(n_terr, step)
    inp = rect.culled_envelope(
        terrain.pack(*base.terrain_bbox(params), device),
        cam=(out.width, out.height, float(frame.fov), float(frame.tilt),
             float(frame.direction)),
        model=params.model, step=step, blocks=blocks, lat0=49.5, lon0=21.5)
    kw = dict(step=step, blocks=blocks)
    return inp, alt0, base.build_refraction_table(params, alt0, device), kw


def _k4_contract(got, want, nb):
    """chip_smoke's K4 contract: count and blocks equal on >= 99.99 % of
    pixels, and there the death flags equal and the captured states within
    rtol 1e-6 / atol 1e-3 m (slope 1e-6)."""
    cnt, s_h, s_v, s_p, s_d, s_b = got[:6]
    cnt_p, s_h_p, s_v_p, s_p_p, s_d_p, s_b_p = want
    same = (cnt == cnt_p) & (s_b == s_b_p).all(-1)
    assert int((~same).sum()) <= 1e-4 * cnt.numel()
    assert torch.equal(s_d[same], s_d_p[same])
    held = same[:, None] & (s_b < nb)
    assert held.any()
    for a, b, atol in ((s_h, s_h_p, 1e-3), (s_v, s_v_p, 1e-6), (s_p, s_p_p, 1e-3)):
        assert torch.allclose(a[held], b[held], rtol=1e-6, atol=atol)


@pytest.mark.parametrize("tilt", [1.0, 2.0])
@pytest.mark.parametrize("form", K3_FORMS)
def test_rect_culled_kernel_matches_plain(form, tilt, cuda_device):
    """K4 against ``culled_capture_plain`` on the same inputs at 192x108, one
    launch a call, at skip 0 and M_CAND; each pixel marched every window or
    stopped at a block's start; counting the windows changes no output."""
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    terrain, params = _rect_scene(tilt=tilt, size=(192, 108))
    inp, alt0, table, kw = _culled_inputs(cuda_device, terrain, params)
    fkw = _k3_form(form, table)
    blocks = kw["blocks"]
    args = (inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px)
    for skip in (0, rect.M_CAND):
        before = _kernels.RECT_CULLED.launches
        got = rect.culled_capture_cuda(*args, skip=skip, count_windows=True, **fkw, **kw)
        assert _kernels.RECT_CULLED.launches == before + 1
        want = rect.culled_capture_plain(*args, skip=skip, **fkw, **kw)
        torch.cuda.synchronize()
        _k4_contract(got, want, blocks.nb)
        plain_out = rect.culled_capture(*args, skip=skip, **fkw, **kw)
        assert all(torch.equal(a, b) for a, b in zip(plain_out, got[:6]))
        windows = got[6]
        n_coarse = blocks.n_march // blocks.coarse
        assert bool(((windows == n_coarse) | (windows % rect.BLOCK_WINDOWS == 0)).all())
        assert bool((windows <= n_coarse).all()) and bool((windows == n_coarse).any())


@pytest.mark.parametrize("tilt", [1.0, 2.0])
def test_rectilinear_culled_captures_through_the_kernel(tilt, cuda_device):
    """The golden view tilted: its capture is K4 on the card (one launch a
    round, counted), and ``plain=True`` renders the same image through the
    plain capture."""
    terrain, params = _rect_scene(tilt=tilt, size=(64, 48))
    before = _fast_launches()
    gpu = render_rectilinear(params, terrain, cuda_device)
    rounds = gpu.culled_rounds
    assert _fast_launches() == before[:3] + [before[3] + rounds, before[4] + rounds]
    plain = render_rectilinear(params, terrain, cuda_device, plain=True)
    assert _fast_launches() == before[:3] + [before[3] + rounds, before[4] + rounds]
    ok, frac_any, frac_big = verify_tolerance(gpu.image, plain.image)
    assert ok, (frac_any, frac_big)
    _first_hits_close(gpu, plain, 1e-3)


# the four geodesic forms of K5 (csrc/terrain_device.cuh), by the earth model
# that takes each: the great circle on the sphere, Vincenty on WGS84, and the
# two flat forms (ObserverAe takes the sphere's form with flat rays)
K5_MODELS = {"sphere": None, "vincenty": "Wgs84", "flat distorted": "FlatDistorted",
             "azimuthal equidistant": "AzimuthalEquidistant", "observer ae": "SimpleObserverAe"}


def _k5_contract(got, want):
    """K5's contract against the plain test on the same inputs: validity
    equal on every pixel; where both hit, keys within 1e-3 of a step and
    path lengths within rtol 1e-5."""
    (key, plh), (key_p, plh_p) = got, want
    v, vp = torch.isfinite(key), torch.isfinite(key_p)
    assert torch.equal(v, vp), int((v != vp).sum())
    assert float((key - key_p).abs()[v].max()) <= 1e-3
    assert torch.allclose(plh[v], plh_p[v], rtol=1e-5, atol=0.0)


def _k5_round(pack, slots, az, hits, test_kw):
    """One round of K5 (counted: one launch) and of the plain test on the
    same slots; each updates its own (key, plh)."""
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    (key, plh), (key_p, plh_p) = hits
    before = _kernels.RECT_EXACT.launches
    rect.culled_test_round(pack, slots, az, key, plh, **test_kw)
    assert _kernels.RECT_EXACT.launches == before + 1
    rect.culled_test_round(pack, slots, az, key_p, plh_p, plain=True, **test_kw)
    assert _kernels.RECT_EXACT.launches == before + 1
    torch.cuda.synchronize()
    _k5_contract((key, plh), (key_p, plh_p))


@pytest.mark.parametrize("tilt", [1.0, -1.0, 3.0])
@pytest.mark.parametrize("model", list(K5_MODELS))
def test_rect_exact_kernel_matches_plain(model, tilt, cuda_device):
    """K5 against ``culled_test_round(plain=True)`` on the same card inputs
    at 192x108, round by round: the capture's two rounds (the second holds
    pixels hit in the first, which K5 skips), the first round's slots again
    (every pixel they hit already has its key), and slots with the first one
    emptied (block nb). Some pixel holds crossings in two of its slots, and
    K5 keeps the first."""
    from atm_raytracer_tpu_torch.generators import base
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    terrain, params = _rect_scene(tilt=tilt, size=(192, 108), earth=K5_MODELS[model])
    inp, alt0, table, kw = _culled_inputs(cuda_device, terrain, params)
    pack = terrain.pack(*base.terrain_bbox(params), cuda_device)
    blocks = kw["blocks"]
    scan_kw = dict(shape=params.model.to_shape(), table=table, straight=False, **kw)
    test_kw = dict(model=params.model, lat0=49.5, lon0=21.5, **scan_kw)
    args = (inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px)
    p_n = inp.elev.shape[0]

    def fresh():
        key = torch.full((p_n, 1), float("inf"), device=cuda_device)
        return key, torch.zeros_like(key)

    hits = (fresh(), fresh())
    first = None
    for skip in (0, rect.M_CAND):
        cnt, *slots = rect.culled_capture(*args, skip=skip, **scan_kw)
        first = first or slots
        _k5_round(pack, slots, inp.az_px, hits, test_kw)
    assert bool(torch.isfinite(hits[0][0]).any())
    _k5_round(pack, first, inp.az_px, hits, test_kw)  # a hit in every pixel it can reach

    emptied = list(first)
    emptied[4] = first[4].clone()
    emptied[4][::3, 0] = blocks.nb  # every third pixel's first slot empty
    _k5_round(pack, emptied, inp.az_px, (fresh(), fresh()), test_kw)

    # crossings in two slots of one pixel: each slot alone through the plain test
    alone = []
    for k in range(rect.M_CAND):
        one = list(first)
        one[4] = torch.where(torch.arange(rect.M_CAND, device=cuda_device) == k, first[4],
                             blocks.nb)
        key, plh = fresh()
        rect.culled_test_round(pack, one, inp.az_px, key, plh, plain=True, **test_kw)
        alone.append(torch.isfinite(key[:, 0]))
    assert bool((torch.stack(alone).sum(0) >= 2).any())


def test_exact_test_span_is_timed_and_counts_its_slots(cuda_device, monkeypatch):
    """On the card ``rect.exact_test`` carries ``device_ms`` and, each round,
    ``rect.test_slots``: the filled slots of the pixels with no hit yet when
    the round starts."""
    from atm_raytracer_tpu_torch import tracing
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    terrain, params = _rect_scene(tilt=1.0, size=(192, 108))
    render_rectilinear(params, terrain, cuda_device)  # CUDA initialised, K4 and K5 built
    seen = []
    real = rect.culled_test_round

    def spy(pack, slots, az, key, plh, **kw):
        seen.append(int(((slots[4] < kw["blocks"].nb) & torch.isinf(key)).sum()))
        return real(pack, slots, az, key, plh, **kw)

    monkeypatch.setattr(rect, "culled_test_round", spy)
    tracing.enable()
    try:
        res = render_rectilinear(params, terrain, cuda_device)
    finally:
        tracing.disable()
    spans = [s for s in tracing.take() if s.name == "rect.exact_test"]
    assert len(spans) == res.culled_rounds == len(seen) >= 1
    assert all(s.device_ms is not None and s.device_ms > 0.0 for s in spans)
    assert [s.counts["rect.test_slots"] for s in spans] == [[float(n)] for n in seen]


def test_rectilinear_1080p_tilted_exact_test_matches_plain(cuda_device):
    """The tilted frame at 1920x1080 through K4 and K5 against the same frame
    with ``plain=True``: hit validity equal, keys within 1e-3 of a step."""
    terrain, params = _rect_scene(tilt=1.0, size=(1920, 1080))
    gpu = render_rectilinear(params, terrain, cuda_device)
    plain = render_rectilinear(params, terrain, cuda_device, plain=True)
    assert gpu.culled_rounds == plain.culled_rounds
    v = gpu.hits.valid
    assert torch.equal(v, plain.hits.valid) and bool(v.any())
    assert float((gpu.hits.key[v] - plain.hits.key[v]).abs().max()) <= 1e-3
