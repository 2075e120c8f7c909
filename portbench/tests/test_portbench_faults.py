"""A run with the timed path broken underneath comes out not correct, once
for each fault a frame of this system can have (there is no exchange
between cards: every cell runs on one)."""

import dataclasses
import time

import numpy as np
import pytest

from portbench import harness
from portbench.tests.conftest import CELLS, SEED, SMALL


class Stale(harness.Program):
    """A step that returns its state unchanged: every frame is the first."""

    def render(self, params, terrain, device):
        if not hasattr(self, "first"):
            self.first = super().render(params, terrain, device)
        return self.first


class HalfLeftOut(harness.Program):
    """Half of the batch left out: the right half of the columns is never
    rendered (no hit, the sky's color)."""

    def render(self, params, terrain, device):
        r = super().render(params, terrain, device)
        w = r.image.shape[1]
        image = r.image.copy()
        image[:, w // 2:] = image[0, 0]
        valid = r.hits.valid.clone()
        valid[:, w // 2:] = False
        return dataclasses.replace(r, image=image, hits=dataclasses.replace(r.hits, valid=valid))


class Altered(harness.Program):
    """An answer altered where it is produced: the hits of a quarter of the
    rows one march step farther, and their pixels a shade lighter."""

    def render(self, params, terrain, device):
        r = super().render(params, terrain, device)
        step = float(params.simulation_step)
        key, dist = r.hits.key.clone(), r.hits.distance.clone()
        h, w = key.shape[:2]
        rows, cols = slice(h // 2, h // 2 + max(1, h // 4)), slice(0, w)
        key[rows, cols] += 1.0
        dist[rows, cols] += step
        image = r.image.copy()
        image[rows, cols] = np.minimum(image[rows, cols].astype(np.int16) + 8, 255)
        return dataclasses.replace(
            r, image=image, hits=dataclasses.replace(r.hits, key=key, distance=dist))


@pytest.mark.parametrize("fault", [Stale, HalfLeftOut, Altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_frame_is_not_correct(cell, fault, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "RUNS", tmp_path)
    t0 = time.perf_counter()
    line, checks = harness.run(cell, SEED, 2.0, False, device="cpu", t_zero=t0,
                               program=fault(), overrides=SMALL)
    assert line["attempted"] >= 2
    assert line["correct"] is False, checks


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "RUNS", tmp_path)
    line, checks = harness.run(cell, SEED, 2.0, False, device="cpu",
                               t_zero=time.perf_counter(), overrides=SMALL)
    assert line["correct"] is True, checks
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert checks[-1] == "check frames_failed 0 limit 0"
