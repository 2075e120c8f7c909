"""The reference against the program's plain path, and the control that
the comparison has to call wrong."""

import time

import pytest

from portbench import compare, control, harness, scene
from portbench.reference import Reference
from portbench.tests.conftest import CELLS, SEED, SMALL


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_programs_plain_path(cell):
    """On the CPU the program runs its plain paths: at a golden size every
    frame of each traffic mix equals the reference's, image and hits."""
    rows = control.readings(cell, [SEED], [], "cpu", overrides=SMALL, emit=lambda s: None)
    assert len(rows) == 1
    assert all(rows[0][k] == 0.0 for k in compare.NUMBERS), rows[0]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_called_wrong(cell):
    """The reference with its fields in bfloat16, in the program's place,
    fails the cell's limits on at least one number."""
    _, _, _, _, limits = harness.find_cell(harness.load_json(harness.BENCHMARK), cell)
    rows = control.readings(cell, [], [SEED, SEED + 1], "cpu", overrides=SMALL,
                            emit=lambda s: None)
    assert len(rows) == 2
    for row in rows:
        assert not compare.judge(row, limits), row


def test_the_reference_builds_its_own_inputs():
    """Two references of one tile array render one frame alike, and the
    reference's store holds float32 copies of the raw integer tiles."""
    c = harness.shrunk(harness.load_json(harness.HERE / "configs" / "headline_1080p.json"), SMALL)
    keys, tiles = scene.make_tiles(c, "cpu")
    frame = scene.frame_dict(c["scene"], 123.0, 0.0, "Fast")
    a, b = Reference(keys, tiles, "cpu"), Reference(keys, tiles, "cpu")
    ra, rb = a.render(frame), b.render(frame)
    assert (ra.image == rb.image).all()
    t = a.terrain._loaded[keys[0]]
    assert t.elev.dtype.name == "float32" and (t.elev == tiles[0]).all()


@pytest.mark.cuda
def test_the_control_on_the_card(cuda_device):
    """The program's readings and the control's at 192x108 on the card."""
    small = dict(SMALL, width=192, height=108)
    t0 = time.perf_counter()
    rows = control.readings("headline_1080p.fast_pan", [SEED], [SEED], cuda_device,
                            overrides=small, emit=lambda s: None)
    _, _, _, _, limits = harness.find_cell(harness.load_json(harness.BENCHMARK),
                                           "headline_1080p.fast_pan")
    prog = [r for r in rows if r["side"] == "program"][0]
    ctrl = [r for r in rows if r["side"] == "control"][0]
    assert compare.judge(prog, limits) and not compare.judge(ctrl, limits)
    assert time.perf_counter() - t0 < 300
