"""Parity of the PyTorch port's crossing combine with the JAX package.

The plain ``terrain_crossing_segments`` must return the JAX package's
segment indices exactly; its float keys must match the JAX Pallas kernel
(interpret mode) and the brute-force transcription of the reference loop.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from atm_raytracer_tpu.experimental.combine_pallas import first_crossing_pallas  # noqa: E402
from atm_raytracer_tpu.ops import combine as JC  # noqa: E402
from atm_raytracer_tpu_torch.ops import combine as TC  # noqa: E402
from test_combine import brute_force_keys  # noqa: E402
from torch_parity import cull_fan  # noqa: E402


def _fan(seed, h_n, w_n, n_seg, extra=0):
    """Descending-ish ray lines + noise over rolling noisy terrain; the
    terrain may run ``extra`` samples past the rays."""
    rng = np.random.default_rng(seed)
    ray = (120.0 + np.linspace(-3.0, 1.0, h_n)[:, None] * np.arange(n_seg + 1)[None, :]
           + rng.normal(0.0, 2.0, (h_n, n_seg + 1)))
    n_t = n_seg + 1 + extra
    terr = (100.0 + 30.0 * np.sin(np.arange(n_t) / 5.0)[None, :]
            + rng.uniform(-5.0, 5.0, (w_n, n_t)))
    return ray.astype(np.float32), terr.astype(np.float32)


def _death_case(floor):
    n = 50
    ray = np.full((1, n + 1), 10.0, np.float32)
    if floor == 0.0:
        ray[0, 10:] = -2000.0  # dead from sample 10
        ray[0, 20:] = 50.0  # resurfaces: must not count
    else:
        ray[0, 10:] = -1100.0  # dead while still above a -1500 m floor
    return ray, np.full((1, n + 1), floor, np.float32), n


CASES = {
    "fan": lambda: (*_fan(1, 6, 7, 50), 50),
    "ragged": lambda: (*_fan(2, 13, 29, 301, extra=9), 301),
    "death": lambda: _death_case(0.0),
    "deep_terrain": lambda: _death_case(-1500.0),
}


@pytest.mark.parametrize("max_hits", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_segments_equal_jax(case, max_hits):
    ray, terr, n_seg = CASES[case]()
    want = np.asarray(JC.terrain_crossing_segments(ray, terr, n_seg, max_hits))
    got = TC.terrain_crossing_segments(torch.from_numpy(ray), torch.from_numpy(terr),
                                       n_seg, max_hits)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_plain_chunking_does_not_change_segments(chunk):
    ray, terr = _fan(3, 9, 11, 200)
    r, t = torch.from_numpy(ray), torch.from_numpy(terr)
    ref = TC.terrain_crossing_segments_plain(r, t, 200, 4)
    got = TC.terrain_crossing_segments_plain(r, t, 200, 4, chunk=chunk)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_keys_match_pallas_interpret_and_brute_force(case):
    ray, terr, n_seg = CASES[case]()
    got = TC.terrain_crossing_keys(torch.from_numpy(ray), torch.from_numpy(terr),
                                   n_seg, 1).numpy()
    pallas = np.asarray(first_crossing_pallas(jnp.asarray(ray), terr, n_seg,
                                              interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, brute_force_keys(ray, terr, n_seg, 1),
                               rtol=1e-5, atol=1e-5)


def test_multi_hit_keys_match_brute_force():
    ray, terr = _fan(4, 8, 10, 120)
    got = TC.terrain_crossing_keys(torch.from_numpy(ray), torch.from_numpy(terr),
                                   120, 3).numpy()
    np.testing.assert_allclose(got, brute_force_keys(ray, terr, 120, 3),
                               rtol=1e-5, atol=1e-5)


def test_death_limit_matches_alive_mask():
    ray, _ = _fan(5, 40, 1, 90)
    ray[3, 17:] = -3000.0
    ray[7, 0] = -1500.0  # dead at the observer: only segment 0 survives
    ray[9, 90] = -1200.0  # dead at the last sample: every segment survives
    r = torch.from_numpy(ray)
    alive = TC.ray_alive_mask(r).numpy()
    limit = TC.ray_death_limit(r, 90).numpy()
    np.testing.assert_array_equal(alive, np.arange(90)[None, :] < limit[:, None])
    np.testing.assert_array_equal(alive, np.asarray(JC.ray_alive_mask(ray)))


def test_k_smallest_and_merge_match_sort():
    rng = np.random.default_rng(3)
    cand = rng.permutation(np.arange(64))[None].repeat(5, 0).astype(np.int32)
    cand[cand % 3 == 0] = TC.NO_HIT_SEG
    for k in (1, 2, 3, 4):
        got = TC.k_smallest(torch.from_numpy(cand), k).numpy()
        np.testing.assert_array_equal(got, np.sort(cand, axis=-1)[:, :k])
        a = np.sort(rng.uniform(0, 100, (7, k)), -1).astype(np.float32)
        b = np.sort(rng.uniform(0, 100, (7, k)), -1).astype(np.float32)
        b[1] = np.inf
        got = TC.merge_sorted_k(torch.from_numpy(a), torch.from_numpy(b), k).numpy()
        np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b], -1), -1)[:, :k])


def test_pair_gathers_and_prop_match_jax():
    ray, terr = _fan(6, 5, 6, 40)
    segs = np.asarray(JC.terrain_crossing_segments(ray, terr, 40, 2))
    ks = np.where(segs < 40, segs, 0).astype(np.int32)
    want = np.asarray(JC.crossing_prop(jnp.asarray(ray), jnp.asarray(terr), jnp.asarray(ks)))
    got = TC.crossing_prop(torch.from_numpy(ray), torch.from_numpy(terr),
                           torch.from_numpy(ks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    stack = np.stack([terr, 2.0 * terr], -1)
    jlo, jhi = JC.gather_column_pairs(jnp.asarray(stack), jnp.asarray(ks))
    tlo, thi = TC.gather_column_pairs(torch.from_numpy(stack), torch.from_numpy(ks))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def _brute_envelope(rows, n_seg, tile):
    n_tiles, n_chunks = -(-rows.shape[0] // tile), -(-n_seg // TC.CHUNK)
    lo = np.empty((n_tiles, n_chunks), np.float32)
    hi = np.empty((n_tiles, n_chunks), np.float32)
    for i in range(n_tiles):
        for c in range(n_chunks):
            k0 = c * TC.CHUNK
            block = rows[i * tile:(i + 1) * tile, k0:min(k0 + TC.CHUNK, n_seg) + 1]
            lo[i, c], hi[i, c] = np.nanmin(block), np.nanmax(block)
    return lo, hi


@pytest.mark.parametrize("fan", ["ragged", "above", "below"])
def test_envelopes_plain_match_brute_force(fan):
    n_seg = 301
    if fan == "ragged":
        ray, terr = _fan(8, 13, 45, n_seg, extra=9)
    else:
        ray, terr = cull_fan(9, 13, 45, n_seg, fan == "above", extra=9)
    ray[4, 128] = np.nan  # the overlap sample of chunks 0 and 1
    terr[40, 7] = np.nan
    got = TC.crossing_envelopes_plain(torch.from_numpy(ray), torch.from_numpy(terr), n_seg)
    want = (*_brute_envelope(ray, n_seg, TC.TILE_H), *_brute_envelope(terr, n_seg, TC.TILE_W))
    assert [tuple(g.shape) for g in got] == [(2, 3), (2, 3), (2, 3), (2, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _segments_from_cube(cross, k):
    """First k crossing indices of a [H, W, n_seg] bool cube, ascending."""
    idx = np.where(cross, np.arange(cross.shape[-1], dtype=np.int64), TC.NO_HIT_SEG)
    return np.sort(idx, axis=-1)[..., :k]


@pytest.mark.parametrize("max_hits", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["fan", "above", "below", "all_below", "step"])
def test_envelope_cull_drops_no_crossing(case, max_hits):
    n_seg = 700
    if case == "fan":
        ray, terr = _fan(10 + max_hits, 21, 70, n_seg)
    elif case in ("all_below", "step"):
        _, terr = _fan(10 + max_hits, 21, 70, n_seg)
        noise = np.random.default_rng(max_hits).normal(0.0, 2.0, (21, n_seg + 1))
        ray = (terr.min() - 60.0 + noise).astype(np.float32)  # all culled
        if case == "step":  # above the terrain up to sample 2·CHUNK − 1: every
            # crossing is the last segment of chunk 1, which only the
            # chunks' shared sample 2·CHUNK reveals
            ray[:, : 2 * TC.CHUNK] += np.float32(terr.max() - terr.min() + 120.0)
    else:
        ray, terr = cull_fan(10 + max_hits, 21, 70, n_seg, case == "above")
    r, t = torch.from_numpy(ray), torch.from_numpy(terr)
    ray_lo, ray_hi, terr_lo, terr_hi = (
        e.numpy() for e in TC.crossing_envelopes_plain(r, t, n_seg))
    culled = ((ray_lo[:, None, :] > terr_hi[None, :, :])
              | (ray_hi[:, None, :] < terr_lo[None, :, :]))  # [tiles_h, tiles_w, C]
    # the plain sign cube, with the death bound
    d = ray[:, None, :] - terr[None, :, : n_seg + 1]
    alive = TC.ray_alive_mask(r).numpy()
    cross = (d[..., :-1] * d[..., 1:] < 0.0) & alive[:, None, :]
    seg_culled = culled[np.arange(ray.shape[0])[:, None, None] // TC.TILE_H,
                        np.arange(terr.shape[0])[None, :, None] // TC.TILE_W,
                        np.arange(n_seg)[None, None, :] // TC.CHUNK]
    assert not (cross & seg_culled).any()
    if case == "all_below":
        assert culled.all()
    elif case != "fan":  # both outcomes occur, so the check has teeth
        assert culled.any() and not culled.all() and cross.any()
    if case == "step":
        assert cross[..., 2 * TC.CHUNK - 1].all() and cross.sum() == cross[..., 0].size
    want = TC.terrain_crossing_segments_plain(r, t, n_seg, max_hits).numpy()
    np.testing.assert_array_equal(_segments_from_cube(cross & ~seg_culled, max_hits), want)


def test_rejects_short_rows_and_bad_k():
    ray, terr = _fan(7, 2, 2, 10)
    with pytest.raises(ValueError):
        TC.terrain_crossing_segments(torch.from_numpy(ray), torch.from_numpy(terr), 11, 1)
    with pytest.raises(ValueError):
        TC.terrain_crossing_segments(torch.from_numpy(ray), torch.from_numpy(terr), 10, 5)
