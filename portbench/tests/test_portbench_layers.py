"""The readers of the port's layer spans (``portbench/layers.py``): the spans
of the traced frames, each reader's number a frame, the metrics each cell
reports, and the traced run with the port's span recorder and without it."""

import sys
import time
from types import SimpleNamespace

import pytest

from atm_raytracer_tpu_torch import tracing
from portbench import harness, layers, trace
from portbench.tests.conftest import CELLS, SEED, SMALL

# metric -> (the span it reads, the cells that list it)
READERS = {
    "band_issue_ms": ("fast.bands", ("headline_1080p.fast_pan",)),
    "object_plan_ms": ("objects.plan", ("objects_1080p.fast_sector",)),
    "object_plan_ms.rect_objects": ("objects.plan", ("objects_1080p.rect_tilt0_sector",)),
    "camera_ms.culled": ("camera", ("headline_1080p.rect_tilt1_pan",)),
    "camera_ms.tilt0": ("camera", ("headline_1080p.rect_tilt0_pan",
                                   "objects_1080p.rect_tilt0_sector")),
}


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _span(name, start_ms, end_ms, parent=None):
    return tracing.Span(name, start_ms / 1e3, end_ms / 1e3, parent)


def _frames(n, t0=0.0):
    """``n`` render calls of a root and a camera span each, 10 ms apart."""
    out = []
    for i in range(n):
        out += [_span(layers.ROOT, t0 + 10 * i, t0 + 10 * i + 8),
                _span("camera", t0 + 10 * i + 1, t0 + 10 * i + 3, len(out))]
    return out


@pytest.mark.parametrize("tries,frames", [(1, 3), (2, 3), (3, 1)])
def test_the_traced_frames_are_the_last_render_calls(tries, frames):
    """A trace taken again leaves its earlier tries' spans first: only the
    last try's render calls, and what they hold, are read."""
    spans = []
    for k in range(tries):
        spans += _frames(frames, t0=1000.0 * k)
    got = layers.traced_spans(spans, frames)
    assert got == spans[-2 * frames:]
    assert [s.name for s in got if s.parent is None] == [layers.ROOT] * frames


def test_too_few_render_calls_read_as_none():
    assert layers.traced_spans(_frames(2), 3) is None
    assert layers.traced_spans(_frames(2), 0) is None
    # a root of another name is no render call
    assert layers.traced_spans([_span("outer", 0, 5)] + _frames(1)[1:], 1) is None


@pytest.mark.parametrize("metric", READERS)
def test_each_layer_reader_reads_its_span_a_frame(metric):
    name = READERS[metric][0]
    spans = [_span(layers.ROOT, 0, 90), _span(name, 1, 4, 0), _span("other", 5, 9, 0),
             _span(name, 10, 11.5, 0)]
    read = harness.reader(metric)
    assert read(SimpleNamespace(trace=object(), trace_frames=2, program_spans=spans)) == \
        pytest.approx(2.25)
    # a failed reading is missing, never 0: no trace, no spans, its span
    # renamed or gone
    for ctx in (SimpleNamespace(trace=None, trace_frames=2),
                SimpleNamespace(trace=object(), trace_frames=2, program_spans=None),
                SimpleNamespace(trace=object(), trace_frames=2, program_spans=[]),
                SimpleNamespace(trace=object(), trace_frames=2,
                                program_spans=[s for s in spans if s.name != name])):
        assert read(ctx) is None, ctx


def test_the_first_reader_takes_the_recording_and_leaves_it_for_the_others():
    tracing.enable()
    for _ in range(3):
        with tracing.span(layers.ROOT):
            with tracing.span("camera"):
                pass
            with tracing.span("objects.plan"):
                pass
    tracing.disable()
    ctx = SimpleNamespace(trace=object(), trace_frames=2)
    assert harness.reader("camera_ms.tilt0")(ctx) > 0
    assert tracing.take() == []
    assert [s.name for s in ctx.program_spans] == [layers.ROOT, "camera", "objects.plan"] * 2
    assert harness.reader("object_plan_ms")(ctx) > 0


def test_a_tree_without_the_recorder_reads_none(monkeypatch):
    import atm_raytracer_tpu_torch

    monkeypatch.delattr(atm_raytracer_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "atm_raytracer_tpu_torch.tracing", None)
    ctx = SimpleNamespace(trace=object(), trace_frames=1)
    for metric in READERS:
        assert harness.reader(metric)(ctx) is None
    assert ctx.program_spans is None


@pytest.mark.parametrize("cell", CELLS)
def test_each_layer_metric_is_reported_in_its_one_cell(cell):
    names = {m["name"] for m in harness.cell_metrics(harness.load_json(harness.BENCHMARK),
                                                     cell, True)}
    assert {m for m in READERS if m in names} == {m for m, (_, cs) in READERS.items()
                                                  if cell in cs}


def _profiled_trace_call(fn, out_file, tries=3):
    """trace_call off a card: ``fn`` under a CPU profiler, which turns the
    port's recorder on as a CUDA trace does; a trace of one kernel."""
    from torch.profiler import ProfilerActivity, profile

    assert tracing._spans == []  # warm-up and window recorded nothing
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    at = t0 * 1e6
    return trace.Trace([("kernel", at + 10, at + 20)], [("cudaLaunchKernel", at, at + 1)],
                       wall, 0.0)


# the traced metrics each cell reports from that trace (its kernel is none of
# K1-K3) on a tree without the recorder
WITHOUT_RECORDER = {
    "objects_1080p.fast_sector": {"device_idle_pct", "terrain_pack_s", "import_init_s"},
    "headline_1080p.rect_tilt0_pan": {"frame_ms.tilt0", "device_idle_pct.tilt0",
                                      "terrain_pack_s", "import_init_s"},
}


@pytest.mark.parametrize("cell,recorder", [("objects_1080p.fast_sector", True),
                                           ("headline_1080p.rect_tilt0_pan", True),
                                           ("headline_1080p.rect_tilt0_pan", False)])
def test_the_traced_run_reads_the_program_spans_where_the_tree_has_them(
        cell, recorder, tmp_path, monkeypatch):
    import atm_raytracer_tpu_torch
    import atm_raytracer_tpu_torch.generators.fast  # noqa: F401
    import atm_raytracer_tpu_torch.generators.rectilinear  # noqa: F401

    monkeypatch.setattr(harness, "RUNS", tmp_path)
    monkeypatch.setattr(trace, "trace_call", _profiled_trace_call)
    if not recorder:  # the parent's tree: no atm_raytracer_tpu_torch.tracing to read
        monkeypatch.delattr(atm_raytracer_tpu_torch, "tracing")
        monkeypatch.setitem(sys.modules, "atm_raytracer_tpu_torch.tracing", None)
    line, _ = harness.run(cell, SEED, 0.5, True, device="cpu", t_zero=time.perf_counter(),
                          overrides=SMALL)
    assert line["correct"] is True
    names = set(line["metrics"])
    new = {m for m, (_, cs) in READERS.items() if cell in cs}
    if recorder:
        assert names == WITHOUT_RECORDER[cell] | new
        assert all(line["metrics"][m]["value"] > 0 for m in new)
        assert tracing._spans == []  # the reader took the stretch's spans
    else:
        assert names == WITHOUT_RECORDER[cell]
