"""The harness finds each part of a cell by name, and takes a new one added
as a file without an edit."""

import json
import shutil
import time

import pytest

from portbench import harness
from portbench.tests.conftest import CELLS, SEED, SMALL


def bench():
    return harness.load_json(harness.BENCHMARK)


@pytest.mark.parametrize("cell", CELLS)
def test_every_part_of_a_cell_is_found_by_name(cell):
    b = bench()
    entry_cell, entry, config, traffic, limits = harness.find_cell(b, cell)
    assert entry_cell["name"] == cell and entry["name"] == entry_cell["config"]
    assert config["name"] == entry["name"] and config["scene"]["output"]["width"] == 1920
    assert traffic["generator"] in ("Fast", "Rectilinear")
    assert set(limits) >= {"image_px_pct", "valid_pct", "kind_pct", "key_p99", "dist_p99_m"}
    for traced in (False, True):
        metrics = harness.cell_metrics(b, cell, traced)
        assert metrics
        for m in metrics:
            assert callable(harness.reader(m["name"]))


# each cell's end-to-end metrics, and with a trace its per-layer metrics, as
# BENCHMARK.json selects them
SETUP = {"terrain_pack_s", "import_init_s"}
SELECTED = {
    "headline_1080p.fast_pan": (
        {"frame_ms", "frame_p95_ms", "peak_mem_mib", "setup_s"},
        {"device_idle_pct", "k1_roofline_pct", "k2_roofline_pct", "band_issue_ms"} | SETUP),
    "objects_1080p.fast_sector": (
        {"frame_ms", "peak_mem_mib", "setup_s"},
        {"device_idle_pct", "k1_roofline_pct", "k2_roofline_pct", "object_plan_ms",
         "object_pass_stream_ms"} | SETUP),
    "headline_1080p.rect_tilt1_pan": (
        {"frame_ms.culled", "peak_mem_mib", "setup_s"},
        {"device_idle_pct.culled", "k4_kernel_ms", "camera_ms.culled", "exact_test_stream_ms",
         "exact_test_ns_per_slot"} | SETUP),
    "headline_1080p.rect_tilt0_pan": (
        {"peak_mem_mib", "setup_s"},
        {"frame_ms.tilt0", "device_idle_pct.tilt0", "k3_kernel_ms", "camera_ms.tilt0"} | SETUP),
    "translucent_1080p.fast_sector": (
        {"frame_ms", "peak_mem_mib", "setup_s"},
        {"device_idle_pct", "k1_roofline_pct.k4", "object_pass_stream_ms",
         "object_pass_ns_per_slot", "hit_fields_stream_ms", "composite_stream_ms"} | SETUP),
    "objects_1080p.rect_tilt0_sector": (
        {"frame_ms.rect_objects", "peak_mem_mib", "setup_s"},
        {"device_idle_pct.rect_objects", "object_plan_ms.rect_objects", "camera_ms.tilt0"}
        | SETUP),
}


def test_metric_selection_follows_workloads_and_moves():
    b = bench()
    names = lambda cell, t: {m["name"] for m in harness.cell_metrics(b, cell, t)}  # noqa: E731
    assert set(SELECTED) == set(CELLS) == {c["name"] for c in b["workloads"]}
    for cell, (e2e, traced) in SELECTED.items():
        assert names(cell, False) == e2e, cell
        assert names(cell, True) == traced, cell
    # every per-layer metric moves an end-to-end metric its cells report
    for cell in CELLS:
        e2e = names(cell, False)
        assert all(m["moves"] in e2e for m in harness.cell_metrics(b, cell, True))


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path, monkeypatch):
    """A new traffic mix, a new metric and a new cell, added as files and
    entries in a copy of the benchmark, run through the unchanged harness."""
    here = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.HERE / sub, here / sub)
    traffic = json.loads((here / "traffic" / "fast_pan.json").read_text())
    traffic.update(direction_deg=[90.0, 100.0], strata=10, check_frames=1)
    (here / "traffic" / "fast_east.json").write_text(json.dumps(traffic))
    (here / "metrics" / "frames_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.starts))\n")
    cell = "headline_1080p.fast_east"
    shutil.copy(here / "limits" / "headline_1080p.fast_pan.json", here / "limits" / f"{cell}.json")
    b = bench()
    b["workloads"].append({"name": cell, "config": "headline_1080p", "traffic": "fast_east",
                           "chips": 1, "why": "a test cell"})
    b["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                            "bound": 0.1, "source": "host_clock", "workloads": [cell]})
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "RUNS", tmp_path / "runs")
    line, _ = harness.run(cell, SEED, 0.5, False, device="cpu", t_zero=time.perf_counter(),
                          overrides=SMALL, bench=b)
    assert line["correct"] is True
    assert line["metrics"]["frames_done"]["value"] == line["attempted"] >= 1
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert (tmp_path / "runs" / cell / f"seed{SEED}-trace0" / "spans.json").exists()


# cells that need no harness edit, only files and entries: an Interpolating
# pan (a new traffic mix) and the translucent scene tilted 1 degree (the
# tilted pan's mix), each with the limits file of a cell of its own
# configuration
FILES_ONLY = {
    "headline_1080p.interp_pan": ("headline_1080p", {
        "generator": "InterpolatingRectilinear", "tilt_deg": 0.0,
        "direction_deg": [0.0, 360.0], "strata": 24, "warmup_frames": 3,
        "check_frames": 3, "trace_frames": 10}, "headline_1080p.fast_pan"),
    "translucent_1080p.rect_tilt1_pan": ("translucent_1080p", None,
                                         "translucent_1080p.fast_sector"),
}


@pytest.mark.parametrize("cell", FILES_ONLY)
def test_an_open_cell_runs_as_files_alone(cell, tmp_path, monkeypatch):
    """The cells of every one-card route ``gen`` takes are added as files
    and entries in a copy of the benchmark, and run correct through the
    unchanged harness and reference."""
    config, traffic, limits_of = FILES_ONLY[cell]
    here = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.HERE / sub, here / sub)
    mix = cell.split(".", 1)[1]
    if traffic is not None:
        (here / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    shutil.copy(here / "limits" / f"{limits_of}.json", here / "limits" / f"{cell}.json")
    b = bench()
    b["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                           "why": "a test cell"})
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "RUNS", tmp_path / "runs")
    line, checks = harness.run(cell, SEED, 0.5, False, device="cpu",
                               t_zero=time.perf_counter(), overrides=SMALL, bench=b)
    assert line["correct"] is True, checks
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert {m["name"] for m in harness.cell_metrics(b, cell, False)} == {
        "peak_mem_mib", "setup_s"}
    assert "setup_s" in line["metrics"]


def _idle_by_host_direct(trace, spans, n=10):
    """The breakdown's idle time by host activity, by a direct scan of every
    runtime call for every gap."""
    host = [(s.name, s.start * 1e6 + trace.offset_us, s.end * 1e6 + trace.offset_us)
            for s in spans]
    out = {}
    for a, b in trace.idle_gaps():
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        where = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "outside spans"
        calls = [r[0] for r in trace.runtime if r[1] <= mid <= r[2]]
        label = f"{where}: {calls[0] if calls else 'host code, no CUDA call'}"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]


@pytest.mark.parametrize("seed", range(5))
def test_idle_by_host_sums_the_gaps_as_a_direct_scan(seed):
    """Random device records and overlapping runtime calls (two host threads)
    in shuffled trace order: the sweep labels and sums every idle gap as the
    direct scan does."""
    import random

    from portbench import trace

    rng = random.Random(seed)
    device, t = [], 0.0
    for i in range(400):
        t += rng.choice([0.0, rng.uniform(0.1, 50.0)])
        d = rng.uniform(0.5, 20.0)
        device.append((f"k{i % 7}", t, t + d))
        t += d * rng.choice([0.5, 1.0])
    runtime = []
    for i in range(900):
        s = rng.uniform(-50.0, t + 50.0)
        runtime.append((rng.choice(["cudaLaunchKernel", "cudaMemcpyAsync", "cudaEventQuery"]),
                        s, s + rng.uniform(0.1, 30.0)))
    rng.shuffle(runtime)
    spans = [harness.Span(f"s{i}", (i * t / 20) / 1e6, ((i + 1.5) * t / 20) / 1e6, None)
             for i in range(20)]
    tr = trace.Trace(device, runtime, t / 1e6, 0.0)
    assert len(tr.idle_gaps()) > 100
    got = trace.idle_by_host(tr, spans, n=1000)
    want = _idle_by_host_direct(tr, spans, n=1000)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [v for _, v in got] == pytest.approx([v for _, v in want], rel=0, abs=0)
