"""The capture scan of the port's tilted Rectilinear path
(``generators/rectilinear.py::culled_capture``) on the CPU, where it runs its
plain version.

K4, the CUDA kernel it launches on the card (``csrc/rect_culled.cu``), builds
and runs only there (tests/test_torch_cuda.py, chip_smoke.py phases 4, 7 and
12). Here: the plain capture against the JAX package's ``march_scan`` driven
with a consumer that records every window, the candidates and slots derived
from those windows in numpy, on the golden scene tilted 1 and 2 degrees, its
flat straight-ray flavour, and an envelope that makes some pixel hold more
than M_CAND candidates, at skip 0 and M_CAND; the CPU dispatch; K4's launch a
round and its arguments against the ctypes argtypes (its kernel stubbed);
and ``plain`` reaching the capture through ``render_rectilinear``. The exact
test (``culled_test_round``): its plain version on CPU tensors, K5's wrapper
refusing other devices and shapes, and K5's launch a round (its kernel
stubbed; K5, ``csrc/rect_exact.cu``, runs in tests/test_torch_cuda.py).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_golden as G  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators import fast as JFast  # noqa: E402
from atm_raytracer_tpu.physics import ray as JR  # noqa: E402
from atm_raytracer_tpu_torch import _kernels  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators import fast as TFast  # noqa: E402
from atm_raytracer_tpu_torch.generators import rectilinear as TRect  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402

BW = TRect.BLOCK_WINDOWS
# (golden scene, tilt in degrees, whether the envelope is seeded so that some
# pixels hold more than M_CAND candidates)
CASES = {
    "plain tilt 1": ("plain", 1.0, False),
    "plain tilt 2": ("plain", 2.0, False),
    "flat_straight tilt 1": ("flat_straight", 1.0, False),
    "plain tilt 1, many candidates": ("plain", 1.0, True),
}


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rect_culled")
    return make_terrain_folder(d, tiles=((49, 21),), n=181)


@pytest.fixture(scope="module")
def terrains(golden_dir):
    return JTerrain.from_folder(golden_dir), TTerrain.from_folder(golden_dir)


def _config(scene, golden_dir, tilt):
    cfg = G._base_config(**copy.deepcopy(G.SCENES[scene]))
    cfg["scene"]["terrain_folder"] = str(golden_dir)
    cfg["output"]["generator"] = "Rectilinear"
    cfg["view"]["frame"]["tilt"] = tilt
    return cfg


def _seeded_envelope(inp, seed):
    """The scene's envelope with each (row, block) made, from a seed, one of:
    met by every range (±1e9), met by none, or left as it is."""
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.integers(0, 3, tuple(inp.env_hi.shape)))
    hi = torch.where(pick == 0, 1e9, torch.where(pick == 1, -1e9, inp.env_hi))
    lo = torch.where(pick == 0, -1e9, torch.where(pick == 1, 1e9, inp.env_lo))
    return inp._replace(env_hi=hi.to(torch.float32), env_lo=lo.to(torch.float32))


def _case(name, golden_dir, terrains):
    """One case's capture inputs: (the port's CulledInputs, alt0, the scan
    keywords of the port, the JAX table and shape, n_march)."""
    scene, tilt, seeded = CASES[name]
    jt, tt = terrains
    cfg = _config(scene, golden_dir, tilt)
    jp = JConfig.from_dict(cfg).into_params(jt)
    tp = TConfig.from_dict(cfg).into_params(tt)
    out, frame, pos = tp.output, tp.view.frame, tp.view.position
    alt0 = float(pos.abs_altitude(tt))
    n_terr = int(np.ceil(frame.max_distance / tp.simulation_step))
    step = float(tp.simulation_step)
    blocks = TRect.culled_blocks(n_terr, step)
    inp = TRect.culled_envelope(
        tt.pack(*TFast.terrain_bbox(tp), "cpu"),
        cam=(out.width, out.height, float(frame.fov), float(frame.tilt),
             float(frame.direction)),
        model=tp.model, step=step, blocks=blocks, lat0=float(pos.latitude),
        lon0=float(pos.longitude))
    if seeded:
        inp = _seeded_envelope(inp, 15)
    kw = dict(shape=tp.model.to_shape(), table=TFast.build_refraction_table(tp, alt0, "cpu"),
              straight=tp.straight_rays, step=step, blocks=blocks)
    jtable = JFast.build_refraction_table(jp, float(jp.view.position.abs_altitude(jt)))
    return inp, alt0, kw, (jtable, jp.model.to_shape(), jp.straight_rays)


def _jax_windows(elev, alt0, jax_scan, step, n_march, coarse):
    """Every window of the JAX package's ``march_scan`` over ``elev``:
    (h_f, plen_f [n_coarse, P, C+1], alive [n_coarse, P, C], v [n_coarse, P])
    as numpy arrays."""
    jtable, jshape, straight = jax_scan
    n_coarse = n_march // coarse
    p_n = elev.shape[0]

    def consumer(carry, k0, h_f, plen_f, alive, v):
        i = k0 // coarse
        return tuple(c.at[i].set(x) for c, x in zip(carry, (h_f, plen_f, alive, v)))

    init = (jnp.zeros((n_coarse, p_n, coarse + 1)), jnp.zeros((n_coarse, p_n, coarse + 1)),
            jnp.zeros((n_coarse, p_n, coarse), bool), jnp.zeros((n_coarse, p_n)))
    out = jax.jit(lambda e: JR.march_scan(
        alt0, e, step, n_march, jshape, jtable, straight, consumer, init, coarse=coarse,
        with_slope=True))(jnp.asarray(elev))
    return tuple(np.asarray(x) for x in out)


def _expected_capture(windows, env_hi, env_lo, j_px, *, skip, n_seg, coarse):
    """capture_round's outputs derived in numpy from the recorded windows:
    each block's range over its windows' fine samples (NaN-propagating, as
    ``jnp.min``), its start state and death flag, the candidate test against
    the pixel's envelope row, and the slot ``cnt - skip``."""
    h_f, plen_f, alive, v = windows
    n_coarse, p_n, _ = h_f.shape
    nb = n_coarse // BW
    b_len = BW * coarse
    m = TRect.M_CAND
    wmin, wmax = h_f.min(-1), h_f.max(-1)
    cnt = np.zeros(p_n, np.int32)
    s_h, s_v, s_p = (np.zeros((p_n, m), np.float32) for _ in range(3))
    s_d = np.zeros((p_n, m), bool)
    s_b = np.full((p_n, m), nb, np.int32)
    for b in range(nb):
        w0 = b * BW
        rmin, rmax = wmin[w0:w0 + BW].min(0), wmax[w0:w0 + BW].max(0)
        bd = ~alive[w0][:, 0]
        cand = ((rmin <= env_hi[j_px, b]) & (rmax >= env_lo[j_px, b]) & ~bd
                & (b * b_len < n_seg))
        for k in range(m):
            wm = cand & (cnt - skip == k)
            s_h[wm, k] = h_f[w0][wm, 0]
            s_v[wm, k] = v[w0][wm]
            s_p[wm, k] = plen_f[w0][wm, 0]
            s_d[wm, k] = bd[wm]
            s_b[wm, k] = b
        cnt += cand.astype(np.int32)
    return cnt, s_h, s_v, s_p, s_d, s_b


@pytest.mark.parametrize("case", list(CASES))
def test_capture_plain_matches_jax_windows(case, golden_dir, terrains):
    """``culled_capture_plain`` against the candidates and slots derived from
    the JAX march's own windows: counts, blocks and death flags equal, the
    captured states within rtol 1e-6 / atol 1e-3 m (slope 1e-6)."""
    inp, alt0, kw, jax_scan = _case(case, golden_dir, terrains)
    blocks = kw["blocks"]
    windows = _jax_windows(inp.elev.numpy(), alt0, jax_scan, kw["step"], blocks.n_march,
                           blocks.coarse)
    env = (inp.env_hi.numpy(), inp.env_lo.numpy(), inp.j_px.numpy())
    dead = ~windows[2][:, :, 0]  # [n_coarse, P]: dead at the window's start
    assert dead[-1].any() and not dead[-1].all()  # some rays die, some do not
    for skip in (0, TRect.M_CAND):
        got = TRect.culled_capture_plain(inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px,
                                         skip=skip, **kw)
        want = _expected_capture(windows, *env, skip=skip, n_seg=blocks.n_seg,
                                 coarse=blocks.coarse)
        cnt, s_h, s_v, s_p, s_d, s_b = (x.numpy() for x in got)
        assert got[0].dtype == torch.int32 and got[4].dtype == torch.bool
        assert got[5].dtype == torch.int32 and s_h.shape == (inp.elev.shape[0], TRect.M_CAND)
        np.testing.assert_array_equal(cnt, want[0])
        np.testing.assert_array_equal(s_b, want[5])
        np.testing.assert_array_equal(s_d, want[4])
        for got_f, want_f, atol in ((s_h, want[1], 1e-3), (s_v, want[2], 1e-6),
                                    (s_p, want[3], 1e-3)):
            np.testing.assert_allclose(got_f, want_f, rtol=1e-6, atol=atol)
        assert (cnt > 0).any()
        np.testing.assert_array_equal(s_b[:, 0] < blocks.nb, cnt > skip)  # the first slot filled
    if CASES[case][2]:
        assert (cnt > TRect.M_CAND).any()  # the second round's slots are not empty


def test_capture_on_cpu_is_the_plain_version(golden_dir, terrains, monkeypatch):
    """On CPU tensors ``culled_capture`` runs the plain capture and launches
    nothing."""
    inp, alt0, kw, _ = _case("plain tilt 1", golden_dir, terrains)

    def refuse(*args):
        raise AssertionError("K4 launched on CPU tensors")

    monkeypatch.setattr(_kernels.RECT_CULLED, "call", refuse)
    before = _kernels.RECT_CULLED.launches
    args = (inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px)
    got = TRect.culled_capture(*args, skip=0, **kw)
    want = TRect.culled_capture_plain(*args, skip=0, **kw)
    assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert _kernels.RECT_CULLED.launches == before


def test_capture_refuses_other_devices():
    elev = torch.zeros(6, device="meta")
    env = torch.zeros((3, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TRect.culled_capture(elev, 10.0, env, env, torch.zeros(6, dtype=torch.int64,
                                                               device="meta"),
                             skip=0, shape=TRect.EarthShape(6_371_000.0), table=None,
                             straight=True, step=50.0,
                             blocks=TRect.culled_blocks(101, 50.0))


def test_k4_launches_once_a_round(golden_dir, terrains, monkeypatch):
    """The culled render launches K4 once a round, each with the round's
    skip, and every argument converts to its ctypes type (the kernel
    stubbed; the plain capture supplies the values). M_CAND = 1 makes the
    golden scene take several rounds."""
    _, tt = terrains
    params = TConfig.from_dict(_config("plain", golden_dir, 2.0)).into_params(tt)
    calls = []

    def launch(dev, *args):
        args = (*args, 0)  # the stream, which CudaKernel.call appends
        assert len(args) == len(_kernels.RECT_CULLED.argtypes)
        calls.append([t(a) for t, a in zip(_kernels.RECT_CULLED.argtypes, args)])

    real_plain = TRect.culled_capture_plain

    def capture(*args, plain=False, **kw):
        assert not plain
        out = TRect.culled_capture_cuda(*args, **kw)  # one stubbed launch
        assert len(out) == 7 and out[0].shape == args[0].shape and out[6] is None
        assert not out[4].any()  # a captured block starts alive
        return real_plain(*args, **kw)

    monkeypatch.setattr(_kernels.RECT_CULLED, "call", launch)
    monkeypatch.setattr(TRect, "culled_capture", capture)
    monkeypatch.setattr(TRect, "M_CAND", 1)
    res = TRect.render_rectilinear(params, tt, "cpu")
    assert res.culled_rounds > 1
    assert len(calls) == res.culled_rounds
    assert [c[9].value for c in calls] == list(range(res.culled_rounds))  # skip
    assert all(c[8].value == 1 and c[7].value == BW for c in calls)  # M_CAND, BLOCK_WINDOWS
    assert all(c[-2].value is None for c in calls)  # no window count asked for
    n_terr = 250  # 25 km in 100 m steps, windows of 8, blocks of 32 segments
    first = calls[0]  # n_seg, coarse, n_march, nb
    assert [first[i].value for i in (3, 4, 5, 6)] == [n_terr - 1, 8, 256, 8]


def test_fused_culled_core_passes_plain(golden_dir, terrains, monkeypatch):
    """``render_rectilinear(plain=...)`` reaches the capture through
    ``fused_culled_core``; on the CPU both render the same frame."""
    _, tt = terrains
    params = TConfig.from_dict(_config("plain", golden_dir, 1.0)).into_params(tt)
    seen = []
    real = TRect.culled_capture

    def spy(*args, plain=False, **kw):
        seen.append(plain)
        return real(*args, plain=plain, **kw)

    monkeypatch.setattr(TRect, "culled_capture", spy)
    a = TRect.render_rectilinear(params, tt, "cpu")
    b = TRect.render_rectilinear(params, tt, "cpu", plain=True)
    assert seen == [False] * a.culled_rounds + [True] * b.culled_rounds
    assert np.array_equal(a.image, b.image) and torch.equal(a.hits.key, b.hits.key)
    assert a.hits.valid.any()


def _test_inputs(golden_dir, terrains, name="plain tilt 1"):
    """A case's first round: (pack, slots, azimuths, the test's keywords)."""
    inp, alt0, kw, _ = _case(name, golden_dir, terrains)
    _, tt = terrains
    tp = TConfig.from_dict(_config(CASES[name][0], golden_dir, CASES[name][1])).into_params(tt)
    pack = tt.pack(*TFast.terrain_bbox(tp), "cpu")
    cnt, *slots = TRect.culled_capture(inp.elev, alt0, inp.env_hi, inp.env_lo, inp.j_px,
                                       skip=0, **kw)
    test_kw = dict(model=tp.model, lat0=float(tp.view.position.latitude),
                   lon0=float(tp.view.position.longitude), **kw)
    return pack, slots, inp.az_px, test_kw


def test_exact_test_on_cpu_is_the_plain_version(golden_dir, terrains, monkeypatch):
    """On CPU tensors ``culled_test_round`` runs ``culled_exact_test`` in its
    chunks, keeping the nearer hit, and launches nothing."""
    pack, slots, az, test_kw = _test_inputs(golden_dir, terrains)

    def refuse(*args):
        raise AssertionError("K5 launched on CPU tensors")

    monkeypatch.setattr(_kernels.RECT_EXACT, "call", refuse)
    before = _kernels.RECT_EXACT.launches
    p_n = az.shape[0]
    key = torch.full((p_n, 1), float("inf"))
    plh = torch.zeros_like(key)
    TRect.culled_test_round(pack, slots, az, key, plh, **test_kw)
    keyc, plc = TRect.culled_exact_test(pack, *slots, az, **test_kw)
    hit = torch.isfinite(keyc)
    assert hit.any() and torch.equal(torch.isfinite(key), hit)
    assert torch.equal(key[hit], keyc[hit]) and torch.equal(plh[hit], plc[hit])
    # chunks of a few pixels give the same keys
    monkeypatch.setattr(TRect, "EXACT_TEST_ELEMS", 7 * TRect.M_CAND * 33)
    key2 = torch.full_like(key, float("inf"))
    plh2 = torch.zeros_like(plh)
    TRect.culled_test_round(pack, slots, az, key2, plh2, **test_kw)
    assert torch.equal(key2, key) and torch.equal(plh2, plh)
    assert _kernels.RECT_EXACT.launches == before


def test_exact_test_refuses_other_devices_and_shapes(golden_dir, terrains, monkeypatch):
    """``culled_test_round`` takes CPU and CUDA tensors only; K5's wrapper
    refuses slots, hits or terrain on another device than the hits', and
    shapes or types that do not fit its pixels (its kernel stubbed)."""
    pack, slots, az, test_kw = _test_inputs(golden_dir, terrains)
    p_n = az.shape[0]
    key = torch.full((p_n, 1), float("inf"))
    plh = torch.zeros_like(key)
    meta = [s.to("meta") for s in slots]
    with pytest.raises(ValueError, match="unsupported device"):
        TRect.culled_test_round(pack, meta, az.to("meta"), key.to("meta"), plh.to("meta"),
                                **test_kw)
    monkeypatch.setattr(_kernels.RECT_EXACT, "call", lambda *a: None)
    TRect.culled_exact_test_cuda(pack, *slots, az, key, plh, **test_kw)  # fits
    with pytest.raises(ValueError, match="different devices"):
        TRect.culled_exact_test_cuda(pack, *meta, az.to("meta"), key, plh, **test_kw)
    with pytest.raises(ValueError, match="different devices"):
        TRect.culled_exact_test_cuda(pack, *slots, az, key.to("meta"), plh.to("meta"),
                                     **test_kw)
    bad = [(0, slots[0][:, :2]), (4, slots[4].to(torch.int64)), (3, slots[3].to(torch.int32))]
    for i, wrong in bad:
        args = list(slots)
        args[i] = wrong
        with pytest.raises(ValueError, match="do not fit"):
            TRect.culled_exact_test_cuda(pack, *args, az, key, plh, **test_kw)
    for k, p in ((key[:-1], plh), (key, plh[:, 0]), (key.double(), plh)):
        with pytest.raises(ValueError, match="do not fit"):
            TRect.culled_exact_test_cuda(pack, *slots, az, k, p, **test_kw)
    with pytest.raises(ValueError, match="do not fit"):
        TRect.culled_exact_test_cuda(pack, *slots, az[:-1], key, plh, **test_kw)


def test_k5_launches_once_a_round(golden_dir, terrains, monkeypatch):
    """The culled render launches K5 once a round, each with the frame's
    geometry and geodesic form, and every argument converts to its ctypes
    type (the kernel stubbed; the plain test supplies the values). M_CAND = 1
    makes the golden scene take several rounds."""
    _, tt = terrains
    params = TConfig.from_dict(_config("plain", golden_dir, 2.0)).into_params(tt)
    calls = []

    def launch(dev, *args):
        args = (*args, 0)  # the stream, which CudaKernel.call appends
        assert len(args) == len(_kernels.RECT_EXACT.argtypes)
        calls.append([t(a) for t, a in zip(_kernels.RECT_EXACT.argtypes, args)])

    real_round = TRect.culled_test_round

    def test_round(pack, slots, az, key, plh, *, plain=False, **kw):
        assert not plain
        k, p = key.clone(), plh.clone()
        TRect.culled_exact_test_cuda(pack, *slots, az, k, p, **kw)  # one stubbed launch
        assert torch.equal(k, key) and torch.equal(p, plh)  # the stub wrote nothing
        return real_round(pack, slots, az, key, plh, plain=True, **kw)

    monkeypatch.setattr(_kernels.RECT_EXACT, "call", launch)
    monkeypatch.setattr(TRect, "culled_test_round", test_round)
    monkeypatch.setattr(TRect, "M_CAND", 1)
    res = TRect.render_rectilinear(params, tt, "cpu")
    assert res.culled_rounds > 1
    assert len(calls) == res.culled_rounds
    n_terr = 250  # 25 km in 100 m steps, windows of 8, blocks of 32 segments
    for c in calls:  # n_pix, M_CAND, nb, n_seg, coarse, BLOCK_WINDOWS
        assert [c[i].value for i in range(6)] == [64 * 48, 1, 8, n_terr - 1, 8, BW]
        assert c[17].value == pytest.approx(32 * 100.0)  # a block's distance
        assert c[24].value == 1 and c[27].value == 1  # refracted, spherical
        assert c[40].value == TRect.GEO_FORMS["Spherical"]
