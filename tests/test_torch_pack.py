"""The port's ``meta/pack.py`` against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packers: every packed segment,
cut to its counts, must carry the JAX segment's bytes (the port's u32 words
and indices travel as int32 bits and its u16 codes as int16 bits, viewed as
unsigned here), every host decode must equal JAX's, and the range-coded
fields must sit inside the tolerances of ``tests/test_meta_pack.py``.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_golden as G  # noqa: E402
from atm_raytracer_tpu.config import Config as JConfig  # noqa: E402
from atm_raytracer_tpu.generators import base as JBase  # noqa: E402
from atm_raytracer_tpu.meta import pack as JP  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain  # noqa: E402
from atm_raytracer_tpu_torch.config import Config as TConfig  # noqa: E402
from atm_raytracer_tpu_torch.generators.fast import render_fast  # noqa: E402
from atm_raytracer_tpu_torch.meta import pack as TP  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain  # noqa: E402
from fixtures import M_PER_DEG, make_terrain_folder  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bytes_equal(port, want, what=""):
    """A port segment (tensor or array) carries the JAX segment's bytes."""
    a = np.ascontiguousarray(port.numpy() if isinstance(port, torch.Tensor) else port)
    b = np.ascontiguousarray(np.asarray(want))
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, (
        what, a.shape, a.dtype, b.shape, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _fields(shape, frac, seed=3):
    rng = np.random.RandomState(seed)
    valid = rng.rand(*shape) < frac
    key = np.where(valid, rng.rand(*shape) * 4000.0, np.inf).astype(np.float32)
    dlat = (rng.rand(*shape) * 2.7 - 1.35).astype(np.float32)
    dlon = (rng.rand(*shape) * 2.7 - 1.35).astype(np.float32)
    elevation = (rng.rand(*shape) * 1500.0).astype(np.float32)
    return valid, key, dlat, dlon, elevation


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the dense viewer pack ------------------------------------------------------------

@pytest.mark.parametrize("shape,frac", [((37, 53, 2), 0.7), ((4, 5, 1), 0.0),
                                        ((6, 11, 4), 1.0)], ids=["random", "empty", "full"])
def test_pack_viewer_fields_matches_jax(shape, frac):
    valid, key, dlat, dlon, elevation = _fields(shape, frac)
    step = 50.0
    want = JP.pack_viewer_fields(key, dlat, dlon, elevation)
    got = TP.pack_viewer_fields(*_t(key, dlat, dlon, elevation))
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.int16
    for name, g, w in zip(("key", "dlat", "dlon", "elevation", "ranges"), got, want):
        _bytes_equal(g, w, name)
    jfields = JP.unpack_viewer_fields(*(np.asarray(x) for x in want), shape, step)
    tfields = TP.unpack_viewer_fields(*(g.numpy() for g in got), shape, step)
    for name, a, b in zip(("valid", "key", "distance", "dlat", "dlon", "elevation"),
                          tfields, jfields):
        np.testing.assert_array_equal(a, b, err_msg=name)
    v2, key2, dist2, dlat2, dlon2, el2 = tfields
    np.testing.assert_array_equal(v2, valid)
    np.testing.assert_array_equal(dist2, np.where(valid, key, 0.0).astype(np.float32)
                                  * np.float32(step))
    if valid.any():  # the JAX tolerances of tests/test_meta_pack.py
        assert np.abs(dlat2[valid] - dlat[valid]).max() < 2.7 * 2.0**-22
        assert np.abs(dlon2[valid] - dlon[valid]).max() < 2.7 * 2.0**-22
        assert np.abs(el2[valid] - elevation[valid]).max() < 1500.0 * 2.0**-15
    vf = TP.ViewerFields(*(g.numpy() for g in got), shape, step)
    assert vf.nbytes == 14 * int(np.prod(shape))
    y, x = shape[0] // 2, shape[1] // 3
    px = vf.pixel(y, x)
    for f in ("valid", "key", "distance", "dlat", "dlon", "elevation"):
        np.testing.assert_array_equal(px[f], getattr(vf, f)[y, x], err_msg=f)


# -- the separable and delta packs ------------------------------------------------------

@pytest.mark.parametrize("shape,frac", [((29, 41, 1), 0.6), ((7, 13, 4), 0.3),
                                        ((5, 7, 1), 0.0)], ids=["k1", "k4", "empty"])
def test_pack_viewer_fields_separable_matches_jax(shape, frac):
    _, key, _, _, elevation = _fields(shape, frac, seed=sum(shape))
    bits, key_c, el_c, ranges, count = JP.pack_viewer_fields_separable(key, elevation)
    t_bits, t_key, t_el, t_ranges, t_count = TP.pack_viewer_fields_separable(
        *_t(key, elevation))
    n = int(count)
    assert int(t_count) == n == int(np.isfinite(key).sum())
    _bytes_equal(t_bits, bits, "bits")
    _bytes_equal(t_key[:n], np.asarray(key_c)[:n], "key_c")
    _bytes_equal(t_el[:n], np.asarray(el_c)[:n], "el_c")
    _bytes_equal(t_ranges, ranges, "el_ranges")


def _delta_inputs(case):
    rng = np.random.RandomState(9)
    h, w, k = 23, 31, 2
    valid = rng.rand(h, w, k) < (0.0 if case == "empty" else 0.55)
    key = np.where(valid, np.cumsum(rng.rand(h, w, k), axis=1) * 40.0, np.inf)
    elevation = 200.0 + np.cumsum(rng.randint(-3, 4, size=(h, w, k)), axis=1) * 1.5
    if case == "adversarial":  # key jumps past i8, elevation past 4 bits
        key = np.where(valid, rng.rand(h, w, k) * 4000.0, np.inf)
        elevation = rng.rand(h, w, k) * 3000.0
    image = (np.cumsum(rng.randint(-3, 4, size=(h * w, 3)), axis=0) % 200).astype(np.uint8)
    image = image.reshape(h, w, 3)
    image[~valid.any(-1)] = (28, 28, 28)
    if case == "adversarial":
        image = np.where(valid.any(-1)[..., None], rng.randint(0, 2, (h, w, 3)) * 255,
                         28).astype(np.uint8)
    return key.astype(np.float32), elevation.astype(np.float32), image


@pytest.mark.parametrize("case", ["smooth", "adversarial", "empty"])
def test_pack_viewer_fields_delta_matches_jax(case):
    key, elevation, image = _delta_inputs(case)
    want = JP.pack_viewer_fields_delta(key, elevation, image)
    got = TP.pack_viewer_fields_delta(*_t(key, elevation, image))
    counts = np.asarray(want[11])
    _bytes_equal(got[11], counts, "counts")
    n, n_px, n_kexc, n_eexc, *n_img = (int(c) for c in counts)
    if case == "adversarial":
        assert n_kexc > 0 and n_eexc > 0 and min(n_img) > 0
    if case == "empty":
        assert not counts.any() and not np.asarray(want[0]).any()
    cuts = {"bits": None, "key_d": n, "key_exc_idx": n_kexc, "key_exc_val": n_kexc,
            "el_n": (n + 1) // 2, "el_exc_idx": n_eexc, "el_exc_val": n_eexc,
            "el_ranges": None}
    for (name, cut), g, w in zip(cuts.items(), got, want):
        _bytes_equal(g[:cut] if cut is not None else g,
                     np.asarray(w)[:cut] if cut is not None else w, name)
    for c in range(3):
        _bytes_equal(got[8][c, :(n_px + 1) // 2], np.asarray(want[8])[c, :(n_px + 1) // 2],
                     f"img_n {c}")
        _bytes_equal(got[9][c, :n_img[c]], np.asarray(want[9])[c, :n_img[c]], f"img_ei {c}")
        _bytes_equal(got[10][c, :n_img[c]], np.asarray(want[10])[c, :n_img[c]],
                     f"img_ev {c}")


# -- the exception channels ---------------------------------------------------------------

def _adversarial_stream(nibble):
    rng = np.random.RandomState(5 if nibble else 11)
    if nibble:
        x = np.cumsum(rng.randint(-8, 8, size=4097)).astype(np.int64)  # odd length
        x[0] += 300
        x[77:] += 5000
        x[3000:] -= 12345
    else:
        x = np.cumsum(rng.randint(-40, 40, size=4096)).astype(np.int64)
        x[0] += 1_000_000
        x[100:] += 900_000
        x[2000:] -= 2_000_000
    return x


@pytest.mark.parametrize("count", ["all", "part"])
@pytest.mark.parametrize("coder", ["i16", "nibble"])
def test_delta_encoders_match_jax(coder, count):
    """_delta_encode (an i16 clip) and _delta_encode4 on adversarial streams:
    every segment equal to JAX's, and the host decode exact; ``part`` codes
    only the first 3000 entries (the rest is garbage past the count)."""
    nibble = coder == "nibble"
    x = _adversarial_stream(nibble)
    n = len(x) if count == "all" else 3000
    if nibble:
        want = JP._delta_encode4(jnp.asarray(x, jnp.int32), jnp.int32(n))
        got = TP._delta_encode4(torch.from_numpy(x.astype(np.int32)), n)
    else:
        want = JP._delta_encode(jnp.asarray(x, jnp.int32), jnp.int32(n), 32767, jnp.int16)
        got = TP._delta_encode(torch.from_numpy(x.astype(np.int32)), n, 32767, torch.int16)
    ne = int(want[3])
    assert int(got[3]) == ne >= 3
    _bytes_equal(got[0], want[0], "stream")
    _bytes_equal(got[1][:ne], np.asarray(want[1])[:ne], "exc_idx")
    _bytes_equal(got[2][:ne], np.asarray(want[2])[:ne], "exc_val")
    ei, ev = got[1][:ne].numpy(), got[2][:ne].numpy()
    dec = (TP._delta_decode4(got[0].numpy(), n, ei, ev) if nibble
           else TP._delta_decode(got[0].numpy()[:n], ei, ev))
    np.testing.assert_array_equal(dec, x[:n])
    jdec = (JP._delta_decode4(np.asarray(want[0]), n, np.asarray(want[1])[:ne],
                              np.asarray(want[2])[:ne]) if nibble
            else JP._delta_decode(np.asarray(want[0])[:n], np.asarray(want[1])[:ne],
                                  np.asarray(want[2])[:ne]))
    np.testing.assert_array_equal(dec, jdec)


# -- the frame codec ----------------------------------------------------------------------

def _stream_frame(seed=2, h=24, w=40, k=2, wild=False):
    rng = np.random.RandomState(seed)
    sky = np.array([7, 8, 9], np.uint8)
    valid = rng.rand(h, w, k) < 0.5
    if wild:
        img = (rng.randint(0, 2, size=(h, w, 3)) * 255).astype(np.uint8)
    else:
        base = np.cumsum(rng.randint(-3, 4, size=(h * w, 3)), axis=0) % 200
        img = base.astype(np.uint8).reshape(h, w, 3)
    img[~valid.any(-1)] = sky
    return valid, img, sky


@pytest.mark.parametrize("cap", [64, 4, 2000], ids=["capped", "overflow", "past_hw"])
def test_pack_frame_stream_matches_jax(cap):
    valid, img, sky = _stream_frame(wild=cap == 4)
    h, w = img.shape[:2]
    want = JP.pack_frame_stream(jnp.asarray(valid), jnp.asarray(img), cap)
    got = TP.pack_frame_stream(*_t(valid, img), cap)
    for name, g, wv in zip(("bits", "img_n", "img_ei", "img_ev", "counts"), got, want):
        _bytes_equal(g, wv, name)
    out = TP.unpack_frame_stream(*(g.numpy() for g in got), sky, h, w, cap)
    jout = JP.unpack_frame_stream(*(np.asarray(x) for x in want), sky, h, w, cap)
    if cap == 4:  # every channel overflows the cap: the raw-refetch signal
        assert out is None and jout is None
    else:
        np.testing.assert_array_equal(out, img)
        np.testing.assert_array_equal(out, jout)


def test_pack_frame_compact_batched_equals_frames_and_jax():
    """A leading frame axis packs each frame alone: equal to a loop over the
    frames and to JAX's ``jax.vmap(pack_frame_compact)``."""
    frames = [_stream_frame(seed=s, h=12, w=21, k=1 + s % 2) for s in range(3)]
    k = 2
    valid = np.stack([np.pad(v, ((0, 0), (0, 0), (0, k - v.shape[2]))) for v, _, _ in frames])
    imgs = np.stack([im for _, im, _ in frames])
    got = TP.pack_frame_compact(*_t(valid, imgs))
    want = jax.vmap(JP.pack_frame_compact)(jnp.asarray(valid), jnp.asarray(imgs))
    for name, g, wv in zip(("bits", "img_n", "img_ei", "img_ev", "counts"), got, want):
        _bytes_equal(g, wv, name)
        for f in range(len(frames)):
            one = TP.pack_frame_compact(*_t(valid[f], imgs[f]))
            _bytes_equal(g[f], one[("bits", "img_n", "img_ei", "img_ev", "counts").index(name)],
                         f"{name} frame {f}")
    for f, (_, img, sky) in enumerate(frames):
        n_px, *nes = (int(c) for c in got[4][f])
        frame = TP.unpack_frame_compact(
            got[0][f].numpy(),
            [(got[1][f, c, :(n_px + 1) // 2].numpy(), got[2][f, c, :nes[c]].numpy(),
              got[3][f, c, :nes[c]].numpy()) for c in range(3)],
            sky, img.shape[0], img.shape[1], n_px)
        np.testing.assert_array_equal(frame, img)


def test_popcount_matches_its_fallback():
    """The module's ``_popcount`` (NumPy's ``bitwise_count`` where it exists)
    agrees with the unpackbits fallback on arrays, scalars and no words."""
    def fallback(a):
        arr = np.atleast_1d(np.ascontiguousarray(a, dtype=np.uint32))
        bits = np.unpackbits(arr.view(np.uint8)).reshape(arr.size, 32)
        return bits.sum(axis=-1, dtype=np.int64).reshape(np.shape(a))

    words = np.random.default_rng(7).integers(0, 2**32, size=257, dtype=np.uint32)
    assert np.array_equal(np.asarray(TP._popcount(words)), fallback(words))
    assert np.array_equal(np.asarray(TP._popcount(words)), np.asarray(JP._popcount(words)))
    assert int(TP._popcount(np.uint32(0xDEADBEEF))) == int(fallback(np.uint32(0xDEADBEEF)))
    assert int(fallback(words[:0]).sum(dtype=np.int64)) == 0


# -- on rendered frames ---------------------------------------------------------------------

def _lossless_cfg(d):
    """tests/test_meta_pack.py's fog + translucency + object scene."""
    return {
        "scene": {
            "terrain_folder": str(d),
            "terrain_alpha": 0.7,
            "objects": [{
                "position": {"latitude": 49.5 + 600.0 / M_PER_DEG, "longitude": 21.5,
                             "altitude": {"Relative": 0.0}},
                "color": {"r": 0.9, "g": 0.2, "b": 0.1, "a": 0.5},
                "shape": {"Cylinder": {"radius": 25.0, "height": 150.0}},
            }],
        },
        "view": {
            "position": {"latitude": 49.5, "longitude": 21.5,
                         "altitude": {"Relative": 25.0}},
            "frame": {"direction": 0.0, "fov": 15.0, "max_distance": 6000.0},
            "fog_distance": 10000.0,
        },
        "simulation_step": 50.0,
        "output": {"width": 48, "height": 36},
    }


def _small_cfg(d):
    """tests/test_meta_pack.py's separable-pack scene."""
    return {
        "scene": {"terrain_folder": str(d)},
        "view": {
            "position": {"latitude": 49.35, "longitude": 21.30,
                         "altitude": {"Relative": 120.0}},
            "frame": {"direction": 45.0, "fov": 20.0, "max_distance": 30000.0, "tilt": 0.0},
            "coloring": {"Shading": {"water_level": -100.0}},
        },
        "straight_rays": False,
        "simulation_step": 100.0,
        "output": {"width": 64, "height": 48},
    }


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    d = make_terrain_folder(tmp_path_factory.mktemp("torch_pack"), tiles=((49, 21),), n=121)
    terrain, jterrain = TTerrain.from_folder(d), JTerrain.from_folder(d)
    out = {}
    for name, cfg in (("small", _small_cfg(d)), ("lossless", _lossless_cfg(d)),
                      ("golden_translucent", _golden_cfg("translucent", d))):
        params = TConfig.from_dict(cfg).into_params(terrain)
        jparams = JConfig.from_dict(cfg).into_params(jterrain)
        out[name] = (jparams, params, render_fast(params, terrain, "cpu"))
    return out


def _golden_cfg(scene, d):
    cfg = G._base_config(**copy.deepcopy(G.SCENES[scene]))
    cfg["scene"]["terrain_folder"] = str(d)
    return cfg


@pytest.mark.parametrize("scene", ["small", "lossless", "golden_translucent"])
def test_frame_compact_lossless_on_renders(scene, renders):
    """After test_frame_compact_lossless_with_fog_and_objects: the port's
    render (fog, translucency and an object in ``lossless``) packs to JAX's
    bytes from the same valid mask and image and unpacks bit for bit with
    the port's ``frame_base_rgb`` (equal to JAX's)."""
    jparams, params, r = renders[scene]
    sky = TP.frame_base_rgb(params.coloring, params.view.fog_distance)
    np.testing.assert_array_equal(
        sky, JP.frame_base_rgb(jparams.coloring, jparams.view.fog_distance))
    valid = r.hits.valid
    got = TP.pack_frame_compact(valid, torch.from_numpy(r.image))
    want = JP.pack_frame_compact(jnp.asarray(valid.numpy()), jnp.asarray(r.image))
    for name, g, w in zip(("bits", "img_n", "img_ei", "img_ev", "counts"), got, want):
        _bytes_equal(g, w, name)
    h, w = r.image.shape[:2]
    n, *nes = (int(c) for c in got[4])
    assert 0 < n <= h * w
    channels = [(got[1][c, :(n + 1) // 2].numpy(), got[2][c, :nes[c]].numpy(),
                 got[3][c, :nes[c]].numpy()) for c in range(3)]
    frame = TP.unpack_frame_compact(got[0].numpy(), channels, sky, h, w, n)
    np.testing.assert_array_equal(frame, r.image)
    staged = got[0].numpy().nbytes + sum(x.nbytes for ch in channels for x in ch)
    if n < h * w:
        assert staged < 3 * h * w


def _jax_result(r):
    """The port's render as a JAX RenderResult (hits as JAX arrays)."""
    hits = JBase.HitBuffer(**{f: jnp.asarray(getattr(r.hits, f).numpy())
                              for f in ("valid", "key", "dlat", "dlon", "distance",
                                        "elevation", "path_length", "normal", "kind",
                                        "rgba")})
    return JBase.RenderResult(image=r.image, hits=hits, elevation_deg=r.elevation_deg,
                              azimuth_deg=r.azimuth_deg, observer=r.observer)


def test_fetch_viewer_fields_on_a_render_match_jax(renders):
    """``fetch_viewer_fields``, ``_separable`` (with the image co-fetched) and
    ``_delta`` on the port's small Fast render, against JAX's on the same
    hits, and within tests/test_meta_pack.py's tolerances of the render."""
    jparams, params, r = renders["small"]
    step = float(params.simulation_step)
    jr = _jax_result(r)
    key = r.hits.key.numpy()
    valid = np.isfinite(key)
    assert valid.any() and (~valid).any()

    vf = TP.fetch_viewer_fields(r.hits, step)
    jvf = JP.fetch_viewer_fields(jr.hits, step)
    for f in ("valid", "key", "distance", "dlat", "dlon", "elevation"):
        np.testing.assert_array_equal(getattr(vf, f), getattr(jvf, f), err_msg=f)

    sep, (img,) = TP.fetch_viewer_fields_separable(r, params.model, step,
                                                   co_fetch=(torch.from_numpy(r.image),))
    np.testing.assert_array_equal(img, r.image.reshape(-1))
    jsep = JP.fetch_viewer_fields_separable(jr, jparams.model, step)
    for f in ("valid", "key", "distance", "elevation"):
        np.testing.assert_array_equal(getattr(sep, f), getattr(jsep, f), err_msg=f)
    for f in ("dlat", "dlon"):
        np.testing.assert_allclose(getattr(sep, f), getattr(jsep, f), rtol=0, atol=1e-12)
        dev = getattr(r.hits, f).numpy().astype(np.float64)
        assert np.abs(getattr(sep, f)[valid] - dev[valid]).max() < 1.5e-6
    p = key.size
    assert sep.nbytes == jsep.nbytes == (p + 31) // 32 * 4 + int(valid.sum()) * 6
    ys, xs = np.nonzero(valid[..., 0])
    y, x = int(ys[len(ys) // 2]), int(xs[len(xs) // 2])
    for f, v in sep.pixel(y, x).items():
        np.testing.assert_array_equal(v, jsep.pixel(y, x)[f], err_msg=f)

    sky = TP.frame_base_rgb(params.coloring, None)
    v3, frame, stats = TP.fetch_viewer_fields_delta(r, params.model, step, sky)
    jv3, jframe, jstats = JP.fetch_viewer_fields_delta(jr, jparams.model, step, sky)
    np.testing.assert_array_equal(frame, r.image)
    np.testing.assert_array_equal(frame, jframe)
    assert stats == jstats
    for f in ("valid", "key", "distance", "elevation"):
        np.testing.assert_array_equal(getattr(v3, f), getattr(jv3, f), err_msg=f)
    assert np.abs(v3.key[valid] - sep.key[valid]).max() <= 0.5 / TP._KEY_QUANT + 1e-5
    np.testing.assert_array_equal(v3.elevation, sep.elevation)
    assert 0 < stats["staged_bytes"] < sep.nbytes + r.image.nbytes


def test_fetch_viewer_fields_on_an_empty_frame():
    """An all-sky frame: no payload past the bitmask, empty decodes, no
    exception in the delta pack."""
    from atm_raytracer_tpu_torch.generators.base import HitBuffer, RenderResult
    from atm_raytracer_tpu_torch.models.earth import EarthModel

    shape = (5, 7, 1)
    z = torch.zeros(shape)
    hits = HitBuffer(valid=torch.zeros(shape, dtype=torch.bool),
                     key=torch.full(shape, float("inf")), dlat=z, dlon=z, distance=z,
                     elevation=z, path_length=z, normal=torch.zeros(shape + (3,)),
                     kind=torch.zeros(shape, dtype=torch.int32),
                     rgba=torch.zeros(shape + (4,)))
    r = RenderResult(image=np.full((5, 7, 3), 28, np.uint8), hits=hits,
                     elevation_deg=np.linspace(-1, 1, 5),
                     azimuth_deg=np.linspace(44, 46, 7), observer=(49.0, 21.0, 300.0))
    model = EarthModel.from_config("SimpleSphere")
    vf = TP.fetch_viewer_fields_separable(r, model, 50.0)
    assert not vf.valid.any() and (vf.distance == 0).all()
    assert vf.nbytes == ((5 * 7 + 31) // 32) * 4
    assert not vf.pixel(2, 3)["valid"].any()
    v3, frame, stats = TP.fetch_viewer_fields_delta(r, model, 50.0, np.array([28] * 3))
    assert stats["n_valid"] == stats["n_exceptions"] == 0
    np.testing.assert_array_equal(frame, r.image)
    with pytest.raises(ValueError, match="separable"):
        TP.fetch_viewer_fields_separable(
            RenderResult(image=None, hits=hits, elevation_deg=np.zeros((5, 7)),
                         azimuth_deg=np.zeros((5, 7)), observer=(49.0, 21.0, 0.0)),
            model, 50.0)
