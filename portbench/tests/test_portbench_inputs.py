"""The seed fixes the views (the terrain is the configuration's); the
frame-time arithmetic."""

import copy
import itertools

import numpy as np
import pytest

from portbench import harness, scene, views
from portbench.tests.conftest import SEED


def config(name="headline_1080p", posts=31):
    c = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    c = copy.deepcopy(c)
    c["terrain"]["posts"] = posts
    return c


def test_the_headline_box_is_45_tiles():
    keys, tiles = scene.make_tiles(config(), "cpu")
    assert len(keys) == 45 and tiles.shape == (45, 31, 31) and tiles.dtype == np.int16
    assert {k[0] for k in keys} == set(range(47, 52)) and {k[1] for k in keys} == set(range(17, 26))


def test_the_terrain_is_the_configurations_for_every_seed():
    """The seed orders the views; the terrain, and so each frame's work, is
    the same for every seed: tile (49, 21) equals
    ``tests/fixtures.py::tile_grid`` (numpy, inlined here: that file imports
    the JAX package)."""
    keys, tiles = scene.make_tiles(config(), "cpu")
    assert np.array_equal(tiles, scene.make_tiles(config(), "cpu")[1])
    assert -100 <= tiles.min() and tiles.max() <= 700  # 300 +- 370 m of hills
    n = 31
    lats = 49 + np.arange(n) / (n - 1)
    lons = 21 + np.arange(n) / (n - 1)
    la = lats[:, None] - 49.0
    lo = lons[None, :] - 21.0
    grid = (300.0 + 250.0 * np.sin(2 * np.pi * la * 3.0) * np.cos(2 * np.pi * lo * 2.0)
            + 120.0 * np.sin(2 * np.pi * (la * 7.0 + lo * 5.0)))
    got = tiles[keys.index((49, 21))].astype(np.int32)
    assert np.abs(got - np.round(grid).astype(np.int16)).max() <= 1  # two libraries' sin


@pytest.mark.parametrize("traffic", ["fast_pan", "fast_sector", "rect_tilt1_pan",
                                     "rect_tilt0_pan"])
def test_the_seed_fixes_the_views(traffic):
    t = harness.load_json(harness.HERE / "traffic" / f"{traffic}.json")
    take = lambda seed, stream=0, n=2 * t["strata"]: list(  # noqa: E731
        itertools.islice(views.directions(t, seed, stream), n))
    a, b, c = take(SEED), take(SEED), take(SEED + 1)
    assert a == b and a != c and take(SEED, 1) != a
    assert sorted(a) == sorted(c)  # every seed: the same views, in another order
    lo, hi = t["direction_deg"]
    assert all(lo <= d < hi for d in a)
    # each pass over the strata visits every stratum once
    width = (hi - lo) / t["strata"]
    for p in (a[:t["strata"]], a[t["strata"]:]):
        assert sorted(int((d - lo) // width) for d in p) == list(range(t["strata"]))
    # no mix asks for a view twice: each pass moves its views within the strata
    assert len({round(d, 9) for d in a}) == len(a)


def test_frame_stats_on_synthetic_times_with_a_stall():
    starts = [10.0 + 0.05 * i for i in range(100)]
    ends = [s + 0.04 for s in starts]
    # a stall: frame 50 takes 1 s and every later frame starts after it
    ends[50] = starts[50] + 1.0
    for i in range(51, 100):
        starts[i] += 0.96
        ends[i] += 0.96
    frame_ms, p95 = views.frame_stats(starts, ends)
    assert frame_ms == pytest.approx((ends[-1] - starts[0]) * 1e3 / 100)
    assert frame_ms == pytest.approx((0.05 * 99 + 0.96 + 0.04) * 1e3 / 100)
    walls = sorted([40.0] * 99 + [1000.0])
    assert p95 == pytest.approx(float(np.percentile(walls, 95.0)))
    assert p95 == pytest.approx(40.0)
    assert views.frame_stats([], []) == (None, None)


def test_the_sample_is_uniform_over_the_frames():
    rng = np.random.default_rng(1)
    counts = np.zeros(20)
    for _ in range(4000):
        kept = [None] * 3
        for i in range(20):
            slot = harness._kept(rng, i, 3)
            if slot is not None:
                kept[slot] = i
        counts[kept] += 1
    assert np.all(np.abs(counts / 4000 - 3 / 20) < 0.03)


def test_the_objects_stand_where_the_configuration_stores_them(tmp_path):
    """At its own size a run places nothing: the objects stand at the
    configuration's stored positions. At a test's size the rule places them
    again."""
    c = config("objects_1080p")
    objects = harness.scene_objects(c, [], None, tmp_path / "checker64.png", "cpu")
    assert len(c["objects"]["placed"]) == len(c["objects"]["rules"]) == len(objects) == 8
    assert [[o["position"]["latitude"], o["position"]["longitude"]] for o in objects] \
        == c["objects"]["placed"]
    assert "placed" not in harness.shrunk(c, {"width": 96})["objects"]


@pytest.mark.cuda
def test_the_stored_object_positions_are_the_rules(cuda_device):
    """The rule, run again on the card at the configuration's size, stands
    the objects where ``objects_1080p`` stores them."""
    c = config("objects_1080p", posts=1201)
    keys, tiles = scene.make_tiles(c, cuda_device)
    assert harness.place(c, keys, tiles, cuda_device) == c["objects"]["placed"]
