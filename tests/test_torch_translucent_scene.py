"""The benchmark's translucent scene (``portbench/configs/translucent_1080p.json``,
BASELINE.json configs[2]: terrain_alpha 0.65 and ten objects) through the
port's Fast route on the CPU, at the benchmark tests' golden size: a run of
its cell is correct, its hits carry the translucent terrain's four slots and
the object depth the windows' overlap gives, and a run that renders the
scene opaque, or its objects without their alpha, or the control in the
program's place, is called wrong."""

import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

from atm_raytracer_tpu_torch import tracing  # noqa: E402
from atm_raytracer_tpu_torch.generators import fast  # noqa: E402
from portbench import compare, control, harness, scene, views  # noqa: E402

from portbench.tests.conftest import SEED, SMALL  # noqa: E402

# several test processes share the host; the benchmark tests' conftest,
# imported above, set two threads
torch.set_num_threads(1)

CELL = "translucent_1080p.fast_sector"


class Opaque(harness.Program):
    """The scene rendered with opaque terrain: one hit slot a pixel (K = 1)."""

    def render(self, params, terrain, device):
        return super().render(dataclasses.replace(params, terrain_alpha=1.0), terrain, device)


class ObjectsOpaque(harness.Program):
    """The objects' alpha dropped: each object's color drawn at alpha 1."""

    def lower(self, frame, terrain):
        for o in frame.get("scene", {}).get("objects", ()):
            o["color"].pop("a", None)
        return super().lower(frame, terrain)


def _run(tmp_path, monkeypatch, program=None):
    monkeypatch.setattr(harness, "RUNS", tmp_path)
    return harness.run(CELL, SEED, 3.0, False, device="cpu", t_zero=time.perf_counter(),
                       program=program, overrides=SMALL)


def test_a_run_of_the_cell_is_correct(tmp_path, monkeypatch):
    line, checks = _run(tmp_path, monkeypatch)
    assert line["correct"] is True, checks
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"frame_ms", "setup_s"}  # no card: no peak


@pytest.mark.parametrize("fault", [Opaque, ObjectsOpaque])
def test_a_run_that_drops_a_translucency_is_not_correct(fault, tmp_path, monkeypatch):
    line, checks = _run(tmp_path, monkeypatch, fault())
    assert line["attempted"] >= 1
    assert line["correct"] is False, checks


def test_the_control_is_called_wrong():
    """The reference with its fields in bfloat16, in the program's place,
    fails the cell's limits on at least one number, on each seed."""
    _, _, _, _, limits = harness.find_cell(harness.load_json(harness.BENCHMARK), CELL)
    rows = control.readings(CELL, [], [SEED, SEED + 1], "cpu", overrides=SMALL,
                            emit=lambda s: None)
    assert len(rows) == 2
    for row in rows:
        assert not compare.judge(row, limits), row


def test_the_stored_positions_are_bench_pys():
    """The positions the configuration stores for its own size
    (``objects.placed``) are bench.py's, by bench.py's formula from the
    observer: its eight Cylinders and Cones alternating at 1.5 + 0.9 i km
    along azimuth 40 + 1.5 i degrees, then the Billboard at 20 km, 43 degrees
    and the Frustum at 35 km, 48 degrees."""
    import math

    config = harness.find_cell(harness.load_json(harness.BENCHMARK), CELL)[2]
    lat0, lon0, m_per_deg = 49.5, 21.5, 111_194.9
    pos = config["scene"]["view"]["position"]
    assert (pos["latitude"], pos["longitude"]) == (lat0, lon0)

    def at(dist, az_deg):
        az = math.radians(az_deg)
        return [lat0 + dist * math.cos(az) / m_per_deg,
                lon0 + dist * math.sin(az) / m_per_deg / math.cos(math.radians(lat0))]

    want = [at(1500.0 + 900.0 * i, 40.0 + 1.5 * i) for i in range(8)]
    want += [at(20000.0, 43.0), at(35000.0, 48.0)]
    assert config["objects"]["placed"] == want
    shapes = [next(iter(r["shape"])) if isinstance(r["shape"], dict) else r["shape"]
              for r in config["objects"]["rules"]]
    assert shapes == ["Cylinder", "Cone"] * 4 + ["Billboard", "Frustum"]


def test_the_hits_carry_four_terrain_slots_and_the_object_depth(monkeypatch):
    """One view of the cell: the combine finds 4 terrain slots a pixel
    (terrain_alpha < 1), and the hits widen to 4 + min(2·overlap,
    OBJ_HIT_CAP) slots, the overlap being the deepest of the ten objects'
    column windows; pixels see terrain through terrain, and objects."""
    crossing = fast.combine.terrain_crossing_segments
    depths = []

    def counted(*args):
        segs = crossing(*args)
        depths.append(segs.shape[-1])
        return segs

    monkeypatch.setattr(fast.combine, "terrain_crossing_segments", counted)
    bench = harness.load_json(harness.BENCHMARK)
    _, _, config, traffic, _ = harness.find_cell(bench, CELL)
    config = harness.shrunk(config, SMALL)
    keys, tiles = scene.make_tiles(config, "cpu")
    program = harness.Program()
    terrain = scene.build_terrain(program.Terrain, program.Tile, keys, tiles)
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        texture = Path(d) / "checker64.png"
        scene.write_texture(texture)
        objects = harness.scene_objects(config, keys, tiles, texture, "cpu")
        assert len(objects) == 10
        direction = next(views.directions(traffic, SEED))
        frame = scene.frame_dict(config["scene"], direction, 0.0, "Fast", objects)
        params = program.lower(frame, terrain)
        tracing.enable()
        try:
            hits = program.render(params, terrain, torch.device("cpu")).hits
        finally:
            tracing.disable()
            spans = tracing.take()
    counts = {}
    for s in spans:
        for k, v in (s.counts or {}).items():
            counts.setdefault(k, []).extend(v)
    (max_hits,), (overlap,), (k_out,) = (counts[n] for n in (
        "fast.max_hits", "objects.overlap", "objects.k_out"))
    assert depths == [4] and max_hits == 4 and overlap >= 1
    assert hits.valid.shape[-1] == k_out == 4 + min(2 * overlap, fast.OBJ_HIT_CAP)
    terrain_slots = (hits.valid & (hits.kind == 0)).sum(-1)
    assert 2 <= int(terrain_slots.max()) <= 4
    assert bool(((hits.kind == 1) & hits.valid).any())
    assert counts["fast.slots"] == [float(hits.valid.numel())]
