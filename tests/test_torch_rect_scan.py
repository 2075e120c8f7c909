"""The tilt-0 Rectilinear scan of the PyTorch port (``generators/
rectilinear.py::tilt0_hits``) on the CPU, where it runs its plain version.

K3, the CUDA kernel it launches on the card (``csrc/rect_scan.cu``), builds
and runs only there (tests/test_torch_cuda.py, chip_smoke.py phases 3, 4 and
7). Here: the plain version against the JAX package's ``fused_shared_core``
on the same scenes, the first-flagged-window rule K3 keeps, K3's two exact
rules (the terrain-clear exit and the window cull, ``ray_device.cuh``)
through their PyTorch mirrors (``scan_rules``, ``rule_exit``,
``rule_hull_clear``, ``tilt0_hits_ruled``; the hull's property test is in
test_torch_rect_hull.py), the launch stride and its
progress lines, the launcher's arguments against the C signature in
``rect_scan.cu``, every kernel's argtypes (K4's too) against its entry point
in ``csrc/``, and the rebuild of a library when a header it includes
changes.
"""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators import fast as JFast  # noqa: E402
from atm_raytracer_tpu.generators import rectilinear as JRect  # noqa: E402
from atm_raytracer_tpu.models import camera as JC  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu.terrain.store import Tile as JTile  # noqa: E402
from atm_raytracer_tpu_torch import _kernels  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import fast as TFast  # noqa: E402
from atm_raytracer_tpu_torch.generators import rectilinear as TRect  # noqa: E402
from atm_raytracer_tpu_torch.models import camera as TCam  # noqa: E402
from atm_raytracer_tpu_torch.physics import ray as TR  # noqa: E402
from atm_raytracer_tpu_torch.physics.atmosphere import (  # noqa: E402
    AtmosphereDef, LinearFunction, atmosphere_def_to_dict)
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Tile as TTile  # noqa: E402
from test_torch_rectilinear import small_scene_setup  # noqa: E402

# the flat-Earth, straight-ray flavour of the golden scenes (test_golden.py)
FLAT_STRAIGHT = {"earth_shape": "FlatDistorted", "straight_rays": True}
# a 200 m layer warming by 0.15 K/m around the small scene's observer (340 m):
# a duct, bending rays down harder than the Earth curves, so the exit rule's
# band starts above it (chip_smoke.py's inversion at the headline's 400 m)
INVERSION = AtmosphereDef(
    first_temperature_function=LinearFunction(-0.0065),
    next_functions=((300.0, LinearFunction(0.15)), (500.0, LinearFunction(-0.0065))),
    temperature_fixed_point=(0.0, 288.15))
# tests/test_torch_parallel.py's inversion: 0.02 K/m from the ground up,
# which bends rays by at most 0.46 of the Earth's curvature above -1000 m
WARM = AtmosphereDef(first_temperature_function=LinearFunction(0.02),
                     temperature_fixed_point=(0.0, 283.15))


def _scene(cfg, jterrain, tterrain):
    """Both packages' tilt-0 scan of one config: (the JAX fused_shared_core's
    hits, the port's scan inputs and keywords)."""
    jp = JConfig.from_dict(cfg).into_params(jterrain)
    tp = TConfig.from_dict(cfg).into_params(tterrain)
    out, frame, pos = tp.output, tp.view.frame, tp.view.position
    alt0 = float(pos.abs_altitude(tterrain))
    n_terr = int(np.ceil(frame.max_distance / tp.simulation_step))
    kw = dict(model=tp.model, step=float(tp.simulation_step), n_terr=n_terr,
              lat0=float(pos.latitude), lon0=float(pos.longitude))
    cam = (out.width, out.height, float(frame.fov))

    def jax_hits(max_hits):
        az = JC.rectilinear_column_azimuths(out.width, frame.fov, frame.direction)
        _, hits = JRect._fused_shared_device(
            jterrain.pack(*JFast.terrain_bbox(jp)),
            JFast.build_refraction_table(jp, float(jp.view.position.abs_altitude(jterrain))),
            None, jnp.asarray(az, jnp.float32), alt0, cam=cam,
            shape=jp.model.to_shape(), straight=jp.straight_rays, max_hits=max_hits,
            coloring=jp.coloring, fog_distance=jp.view.fog_distance,
            terrain_alpha=float(jp.terrain_alpha), **dict(kw, model=jp.model))
        return np.asarray(hits.key), np.asarray(hits.path_length)

    az = torch.from_numpy(TCam.rectilinear_column_azimuths(
        out.width, frame.fov, frame.direction).astype(np.float32))
    elev_hw, terr_pad, _, coarse = TRect.tilt0_inputs(
        tterrain.pack(*TFast.terrain_bbox(tp), "cpu"), az, cam=cam, **kw)
    scan_kw = dict(shape=tp.model.to_shape(),
                   table=TFast.build_refraction_table(tp, alt0, "cpu"),
                   straight=tp.straight_rays, step=kw["step"], n_seg=n_terr - 1,
                   coarse=coarse)
    return jax_hits, (elev_hw, terr_pad, alt0), scan_kw


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rect_scan")
    small = small_scene_setup(d)
    flat = {**small, **FLAT_STRAIGHT}
    jt, tt = JTerrain.from_folder(d), TTerrain.from_folder(d)
    return {"small": (small, jt, tt), "flat_straight": (flat, jt, tt),
            "inversion": ({**small, "atmosphere": atmosphere_def_to_dict(INVERSION)}, jt, tt),
            "warm": ({**small, "atmosphere": atmosphere_def_to_dict(WARM)}, jt, tt)}


def _assert_close_to_jax(key, plh, jkey, jplh):
    """test_torch_rectilinear.py's hit tolerances: validity differs on
    <= 1 % of slots; where both hit, keys within 1e-3 of a step and path
    lengths within 1e-5 relative + 0.05 m."""
    tv, jv = np.isfinite(key), np.isfinite(jkey)
    assert key.shape == jkey.shape
    assert (tv != jv).mean() <= 0.01
    both = tv & jv
    assert both.any()
    np.testing.assert_allclose(key[both], jkey[both], rtol=0, atol=1e-3)
    np.testing.assert_allclose(plh[both], jplh[both], rtol=1e-5, atol=0.05)


@pytest.mark.parametrize("max_hits", [1, 2])
@pytest.mark.parametrize("scene", ["small", "flat_straight"])
def test_tilt0_hits_equal_plain_and_match_jax(scenes, scene, max_hits):
    """On CPU tensors ``tilt0_hits`` is ``tilt0_hits_plain``; both sit within
    the parity tolerances of the JAX package's fused_shared_core."""
    jax_hits, args, scan_kw = _scene(*scenes[scene])
    key, plh = TRect.tilt0_hits(*args, max_hits=max_hits, **scan_kw)
    key_p, plh_p = TRect.tilt0_hits_plain(*args, max_hits=max_hits, **scan_kw)
    assert torch.equal(key, key_p) and torch.equal(plh, plh_p)
    assert key.shape == args[0].shape + (max_hits,)
    if max_hits > 1:  # empty slots hold path length 0
        assert (plh[torch.isinf(key)] == 0.0).all()
    _assert_close_to_jax(key.numpy(), plh.numpy(), *jax_hits(max_hits))


@pytest.mark.parametrize("max_hits", [1, 2])
@pytest.mark.parametrize("scene", ["small", "flat_straight", "inversion"])
def test_rules_leave_the_plain_scan_unchanged(scenes, scene, max_hits):
    """The plain scan with K3's two rules applied (``tilt0_hits_ruled``: an
    exited pixel tests no later window, a cleared window runs no test) is
    ``torch.equal`` to ``tilt0_hits_plain`` and within the parity tolerances
    of JAX's fused_shared_core, while marching a fraction of its windows;
    its flags word is K3's."""
    jax_hits, args, scan_kw = _scene(*scenes[scene])
    key_p, plh_p = TRect.tilt0_hits_plain(*args, max_hits=max_hits, **scan_kw)
    key, plh, flags, tally = TRect.tilt0_hits_ruled(*args, max_hits=max_hits, **scan_kw)
    assert torch.equal(key, key_p) and torch.equal(plh, plh_p)
    _assert_close_to_jax(key.numpy(), plh.numpy(), *jax_hits(max_hits))
    n_coarse = -(-scan_kw["n_seg"] // scan_kw["coarse"])
    marched, plain = int(tally.marched.sum()), int(tally.plain.sum())
    print(f"{scene} K={max_hits}: {marched} of {plain} pixel-windows marched, "
          f"{int(tally.skipped.sum())} tests skipped, {int(tally.exited.sum())} exits")
    assert bool(tally.exited.any()) and bool((tally.skipped > 0).any())
    assert marched < plain
    assert bool((tally.marched <= tally.plain).all())
    assert bool((tally.skipped <= tally.marched).all())
    assert torch.equal(flags >> TRect.SCAN_WINDOWS_SHIFT, tally.marched)
    assert torch.equal((flags >> 1) & 0xFF, torch.isfinite(key).sum(-1).to(torch.int32))
    # a pixel stopped (done) or marched every window; an exited pixel holds
    # fewer than K hits
    done = (flags & 1) == 1
    assert bool((done | (tally.marched == n_coarse)).all())
    assert bool((torch.isfinite(key[tally.exited]).sum(-1) < max_hits).all())


def test_inversion_band_starts_above_the_layer(scenes):
    """The exit's band: the duct (l below -1/R between 300 and 500 m) puts
    h_safe just above its top, so no ray exits inside it; US-76 and the
    0.02 K/m inversion bend rays less than 2/3 of the Earth's curvature, so
    their band reaches down to DEATH_ALTITUDE; straight rays have no l; a
    flat Earth with l < 0 above never exits; a march longer than half a
    radian turns the exit off."""
    def rules(scene, **over):
        _, args, scan_kw = _scene(*scenes[scene])
        kw = {**scan_kw, **over}
        c = kw["coarse"]
        return TRect.scan_rules(args[1].t().contiguous(), coarse=c,
                                n_coarse=-(-kw["n_seg"] // c), shape=kw["shape"],
                                table=kw["table"], straight=kw["straight"], step=kw["step"])

    inv = rules("inversion")
    assert 500.0 <= inv.h_safe <= 510.0
    _, args, scan_kw = _scene(*scenes["inversion"])
    assert args[2] < inv.h_safe  # the observer sits inside the layer
    assert rules("small").h_safe == TR.DEATH_ALTITUDE
    assert rules("warm").h_safe == TR.DEATH_ALTITUDE
    assert rules("small", straight=True).h_safe == TR.DEATH_ALTITUDE
    assert rules("small", shape=TR.FLAT).h_safe == np.inf
    assert rules("flat_straight").h_safe == TR.DEATH_ALTITUDE
    assert rules("small", n_seg=80_000, coarse=16).h_safe == np.inf  # 4000 km
    # the suffix maximum: non-increasing down the windows, above each window's
    r = rules("small")
    assert bool((r.smax[:-1] >= r.smax[1:]).all()) and bool((r.smax >= r.tmax).all())
    assert torch.equal(r.smax[0], r.tmax.amax(0))
    assert r.tmax.shape == (-(-scan_kw["n_seg"] // scan_kw["coarse"]), args[0].shape[1])


def test_exit_margin_holds_over_the_later_windows():
    """Rule 1 on seeded states: wherever ``rule_exit`` holds against a
    terrain level just under its margin, every later fine sample the plain
    march gives stays above that level (US-76, the duct, straight rays; a
    200 km march of 16-step windows)."""
    from atm_raytracer_tpu_torch.physics.atmosphere import Atmosphere, us_76

    rng = np.random.default_rng(14)
    n, c, step = 4096, 16, 50.0
    dx = TR._f32(step * c)
    coeffs = TR.hermite_coeffs(c)
    shape = TR.EarthShape(6_371_000.0)
    inv_r = TR._f32(1.0 / shape.radius)
    fired = 0
    for atm in (us_76(), INVERSION, None):
        table = None if atm is None else TR.RefractionTable.build(Atmosphere(atm), 530e-9,
                                                                  device="cpu")
        terr = torch.zeros((250 * c + 1, 1))
        rules = TRect.scan_rules(terr, coarse=c, n_coarse=250, shape=shape, table=table,
                                 straight=atm is None, step=step)
        h = torch.from_numpy(rng.uniform(-900.0, 12_000.0, n).astype(np.float32))
        v = torch.from_numpy((rng.uniform(0.0, 1.0, n) ** 3 * 0.6).astype(np.float32))
        v[: n // 8] = 0.0
        lo = h - (rules.m_abs + TRect.RULE_M_EXIT * (h.abs() + v * dx))
        level = torch.nextafter(lo, torch.full_like(lo, -np.inf))
        ok = TRect.rule_exit(rules, h, v, dx, inv_r, level)
        fired += int(ok.sum())
        low = torch.full_like(h, np.inf)
        for _ in range(250):
            h1, v1 = TR._rk4_step(h, v, dx, table, shape.radius)
            for j in range(c + 1):
                low = torch.minimum(low, TR.hermite_plane(h, v * dx, h1, v1 * dx, coeffs, j))
            h, v = h1, v1
        assert bool((low[ok] > level[ok]).all())
    assert fired > 3 * n // 2


def _deep_scene():
    """Steep rays over terrain at -1200 m that drops to -5000 m 2 km north:
    many rays fall below DEATH_ALTITUDE inside the window where they first
    cross the terrain (the crossing after the death, so not a hit), and
    cross again in a later window, past the drop."""
    n = 1201
    lats = 49 + np.arange(n) / (n - 1)
    grid = np.where(lats < 49.518, -1200, -5000).astype(np.int16)[:, None].repeat(n, 1)
    cfg = {"view": {"position": {"latitude": 49.5, "longitude": 21.5,
                                 "altitude": {"Absolute": 100.0}},
                    "frame": {"direction": 0.0, "fov": 160.0, "max_distance": 6000.0}},
           "simulation_step": 50.0, "output": {"width": 24, "height": 31}}
    jt, tt = JTerrain(), TTerrain()
    jt.add_tile(JTile(49, 21, grid))
    tt.add_tile(TTile(49, 21, grid))
    return cfg, jt, tt


def test_first_flagged_window_decides():
    """A ray that dies inside its first flagged window and crosses the
    terrain in a later one has no hit, in both packages (K3 stops at that
    window too)."""
    jax_hits, args, scan_kw = _scene(*_deep_scene())
    elev_hw, terr_pad, alt0 = args
    c = scan_kw["coarse"]
    n_seg = scan_kw["n_seg"]
    ray_h, _ = TR.march_rays(alt0, elev_hw.reshape(-1), scan_kw["step"], n_seg,
                             scan_kw["shape"], scan_kw["table"], False, coarse=c)
    ray_h = ray_h.reshape(elev_hw.shape + (n_seg + 1,))
    d = ray_h - terr_pad[None, :, : n_seg + 1]
    cross = d[..., :-1] * d[..., 1:] < 0.0
    witnesses = []
    for r, w in zip(*np.nonzero(cross.any(-1).numpy())):
        segs = torch.nonzero(cross[r, w]).flatten().tolist()
        dead = torch.nonzero(ray_h[r, w] < TR.DEATH_ALTITUDE).flatten().tolist()
        if dead and dead[0] < segs[0] and dead[0] // c == segs[0] // c \
                and segs[-1] // c > segs[0] // c:
            witnesses.append((r, w))
    assert len(witnesses) >= 10
    rows, cols = (torch.tensor(x) for x in zip(*witnesses))
    best_w, *_ = TRect.first_window_scan(elev_hw, terr_pad, alt0, **scan_kw)
    assert (best_w[rows, cols] < -(-n_seg // c)).all()  # the window is flagged
    jkey, _ = jax_hits(1)
    assert np.isinf(jkey[rows.numpy(), cols.numpy()]).all()
    for k in (1, 2):
        key, _ = TRect.tilt0_hits(*args, max_hits=k, **scan_kw)
        assert torch.isinf(key[rows, cols]).all()
    assert torch.isfinite(key).any()  # other rays do hit


def _per_window_progress(n_coarse, coarse, upto=None):
    """The progress values the plain scan reports over windows [0, upto)."""
    got = []
    emit = TRect.percent_reporter(got.append)
    for w in range(n_coarse if upto is None else upto):
        TRect._window_progress(emit, w * coarse, coarse, n_coarse)
    return got


@pytest.mark.parametrize("n_coarse", [250, 1, 7, 31, 32, 33, 64, 1000])
def test_launch_stride_progress(n_coarse, monkeypatch):
    """K3's launches cover the windows once, in order, one a progress
    stride (36 at the 250-window headline); the progress seen between
    launches is the plain scan's, monotone and ending at 100."""
    launches = TRect.scan_launches(n_coarse)
    assert launches[0][0] == 0 and launches[-1][1] == n_coarse
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(launches, launches[1:]))
    stride = max(1, n_coarse // 32)
    assert len(launches) == -(-n_coarse // stride)
    if n_coarse == 250:
        assert len(launches) == 36

    # the launcher's own loop, its kernel stubbed: the progress it reports
    got, calls = [], []
    monkeypatch.setattr(_kernels.RECT_SCAN, "call",
                        lambda dev, *a: calls.append((a[9], a[10], len(got))))
    coarse = 4
    n_seg = n_coarse * coarse
    elev = torch.zeros((2, 3))
    TRect.tilt0_hits_cuda(elev, torch.zeros((3, n_coarse * coarse + 1)), 10.0,
                          shape=TR.EarthShape(6_371_000.0), table=None, straight=True,
                          step=50.0, n_seg=n_seg, coarse=coarse, max_hits=1,
                          emit=TRect.percent_reporter(got.append))
    assert [c[:2] for c in calls] == launches
    assert got == _per_window_progress(n_coarse, coarse)
    assert got[-1] == 100 and all(a < b for a, b in zip(got, got[1:]))
    # each launch comes after the progress of the windows before it
    assert all(n_before == len(_per_window_progress(n_coarse, coarse, w0))
               for w0, _, n_before in calls)


def _c_signature(source: str, entry: str):
    """The parameter types of ``extern "C" int entry(...)`` in a csrc file."""
    text = (_kernels.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, f"no extern \"C\" {entry} in {source}"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    return [p.rsplit(" ", 1)[0] for p in params]


C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("kernel", ["RECT_SCAN", "MARCH", "COMBINE", "RECT_CULLED",
                                    "RECT_EXACT"])
def test_argtypes_match_the_c_signature(kernel):
    """Each kernel's ctypes argtypes are its entry point's parameters, as the
    source declares them: a binding slip shows here, not on the card."""
    k = getattr(_kernels, kernel)
    want = [C_TYPES[t] for t in _c_signature(k.source, k.entry)]
    assert k.argtypes == want


def test_launcher_arguments_convert_to_the_argtypes(monkeypatch):
    """``tilt0_hits_cuda`` hands the entry point one value per parameter,
    each convertible to its ctypes type, for every l(h) form."""
    seen = []

    def convert(dev, *args):
        args = (*args, 0)  # the stream, which CudaKernel.call appends
        assert len(args) == len(_kernels.RECT_SCAN.argtypes)
        seen.append([t(a) for t, a in zip(_kernels.RECT_SCAN.argtypes, args)])

    monkeypatch.setattr(_kernels.RECT_SCAN, "call", convert)
    from atm_raytracer_tpu_torch.physics.atmosphere import Atmosphere, us_76

    table = TR.RefractionTable.build(Atmosphere(us_76()), 530e-9, device="cpu")
    elev = torch.full((2, 5), -0.01)
    terr = torch.zeros((5, 16 * 3 + 1))
    for tb, straight, shape in ((table, False, TR.EarthShape(6_371_000.0)),
                                (TR.RefractionTable.from_values(
                                    table.values.numpy(), table.h0, table.inv_dh, None,
                                    "cpu"), False, TR.FLAT),
                                (None, True, TR.FLAT)):
        TRect.tilt0_hits_cuda(elev, terr, 100.0, shape=shape, table=tb, straight=straight,
                              step=50.0, n_seg=40, coarse=16, max_hits=4)
    assert len(seen) == 3 * 3  # three windows, one launch each (stride 1)
    n_poly = [s[13].value for s in seen[::3]]
    assert n_poly == [len(table.poly), 0, 0]
    assert [s[18].value for s in seen[::3]] == [1, 1, 0]  # refract
    # the rules' inputs, last: tmax and smax, then h_safe, h_top, k_cap, m_abs
    assert all(s[30].value and s[31].value for s in seen)
    h_safe = [s[32].value for s in seen[::3]]
    assert h_safe == [TR.DEATH_ALTITUDE, np.inf, TR.DEATH_ALTITUDE]  # flat l < 0: never
    assert seen[0][33].value == pytest.approx(0.1 * 6_371_000.0)
    assert [s[33].value for s in seen[3::3]] == [np.inf, np.inf]
    assert seen[0][34].value == pytest.approx(np.sin(3 * 800.0 / 6_371_000.0) / 0.1)
    assert [s[34].value for s in seen[3::3]] == [0.0, 0.0]
    assert seen[0][35].value == pytest.approx(800.0 ** 2 / (4 * 6_371_000.0) + 1e-3)


def test_tilt0_hits_refuses_other_devices():
    elev = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TRect.tilt0_hits(elev, torch.zeros((3, 17), device="meta"), 10.0,
                         shape=TR.FLAT, table=None, straight=True, step=50.0, n_seg=16,
                         coarse=16, max_hits=1)


def test_fused_shared_core_passes_plain(scenes, monkeypatch):
    """``render_rectilinear(plain=...)`` reaches the tilt-0 scan's wrapper
    through ``fused_shared_core``."""
    cfg, _, tt = scenes["small"]
    params = TConfig.from_dict(cfg).into_params(tt)
    seen = []
    real = TRect.tilt0_hits

    def spy(*args, plain=False, **kw):
        seen.append(plain)
        return real(*args, plain=plain, **kw)

    monkeypatch.setattr(TRect, "tilt0_hits", spy)
    a = TRect.render_rectilinear(params, tt, "cpu")
    b = TRect.render_rectilinear(params, tt, "cpu", plain=True)
    assert seen == [False, True]
    assert np.array_equal(a.image, b.image) and torch.equal(a.hits.key, b.hits.key)


@pytest.mark.parametrize("kernel", ["MARCH", "RECT_SCAN", "COMBINE", "RECT_CULLED"])
def test_library_name_follows_the_header(kernel, tmp_path, monkeypatch):
    """A library's name hashes the csrc headers its source includes, so an
    edit of ray_device.cuh rebuilds K2, K3 and K4 (and leaves K1, which
    does not include it, alone)."""
    for f in _kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels, "_compiler_id", lambda compiler: "nvcc 0.0 x86_64")
    k = getattr(_kernels, kernel)
    before = k.library_path()
    header = tmp_path / "ray_device.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    changed = k.library_path() != before
    assert changed == (kernel != "COMBINE")
    assert k.library_path().name.startswith(f"lib{k.source.split('.')[0]}_")
