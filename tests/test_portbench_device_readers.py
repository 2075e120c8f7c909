"""The benchmark's readers of the port's device-timed spans and counters
(``portbench/device_layers.py`` and the metrics that use it): each reads its
span or counter a traced frame, reads None without them, and the traced run
of each cell that lists them reports them, here with the CUDA events of the
port's recorder stood in for by host-clock events.

The reader tests sit here, beside the port's tests, rather than under
``portbench/tests``: they run in the repository's tier-1 suite.
"""

import sys
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from atm_raytracer_tpu_torch import tracing  # noqa: E402
from portbench import harness, layers, trace  # noqa: E402

from portbench.tests.conftest import SEED, SMALL  # noqa: E402

# several test processes share the host; the benchmark tests' conftest,
# imported above, set two threads
torch.set_num_threads(1)

TRANSLUCENT = "translucent_1080p.fast_sector"
OBJECTS = "objects_1080p.fast_sector"
# metric -> the span whose device time it reads
DEVICE_READERS = {
    "object_pass_stream_ms": "objects.pass",
    "hit_fields_stream_ms": "fast.fields",
    "composite_stream_ms": "composite",
}
NEW = {"k1_roofline_pct.k4", "object_pass_ns_per_slot", *DEVICE_READERS}


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


class _Timed:
    """Two events ``ms`` apart, as a device-timed span's."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _span(name, parent=None, device_ms=None, counts=None):
    s = tracing.Span(name, 0.0, 1.0, parent, counts=counts)
    if device_ms is not None:
        s.events = (_Timed(0.0), _Timed(device_ms))
    return s


def _ctx(spans, frames=2):
    return SimpleNamespace(trace=object(), trace_frames=frames, program_spans=spans)


@pytest.mark.parametrize("metric", DEVICE_READERS)
def test_each_device_reader_reads_its_span_a_frame(metric):
    name = DEVICE_READERS[metric]
    spans = [_span(layers.ROOT), _span(name, 0, 3.0), _span("other", 0, 50.0),
             _span(layers.ROOT), _span(name, 3, 1.5)]
    read = harness.reader(metric)
    assert read(_ctx(spans)) == pytest.approx(2.25)
    # a failed reading is missing, never 0: no trace, no spans, the span
    # gone or not timed on the device (the CPU, or a tree before the port
    # timed its spans)
    untimed = [_span(layers.ROOT), _span(name, 0)]
    for ctx in (SimpleNamespace(trace=None, trace_frames=2), _ctx(None), _ctx([]),
                _ctx([s for s in spans if s.name != name]), _ctx(untimed, 1)):
        assert read(ctx) is None, ctx


def test_a_tree_whose_spans_carry_no_device_time_or_counts_reads_none():
    """The parent tree's spans have neither ``device_ms`` nor ``counts``."""
    old = SimpleNamespace(name="objects.pass", start=0.0, end=1.0, parent=None)
    for metric in NEW:
        assert harness.reader(metric)(_ctx([old], 1)) is None


def test_the_slot_reader_divides_the_pass_by_the_counted_slots():
    spans = [_span(layers.ROOT, counts={"fast.slots": [1000.0], "fast.max_hits": [4.0]}),
             _span("objects.pass", 0, 2.0),
             _span(layers.ROOT, counts={"fast.slots": [3000.0]}),
             _span("objects.pass", 2, 6.0)]
    read = harness.reader("object_pass_ns_per_slot")
    assert read(_ctx(spans)) == pytest.approx(1e6 * 8.0 / 4000.0)
    no_count = [_span(layers.ROOT), _span("objects.pass", 0, 2.0)]
    no_time = [_span(layers.ROOT, counts={"fast.slots": [1000.0]}), _span("objects.pass", 0)]
    for spans in (no_count, no_time):
        assert read(_ctx(spans, 1)) is None


def test_the_k4_roofline_counts_the_k_slots():
    """K1's bytes at the K the program counts (``fast.max_hits``) over its
    records' time, a frame; None where K was not counted (the parent tree)."""
    read = harness.reader("k1_roofline_pct.k4")
    shapes = {"height": 1080, "width": 1920, "n_terr": 2000, "coarse": 4}
    tr = trace.Trace([("crossing_segments_kernel<4>", 0.0, 1500.0),
                      ("chunk_envelopes_kernel", 2000.0, 2500.0),
                      ("other_kernel", 0.0, 9000.0)], [], 1.0, 0.0)

    def ctx(k, trace_=tr):
        spans = [_span(layers.ROOT, counts={"fast.max_hits": [float(k)]}),
                 _span(layers.ROOT, counts={"fast.max_hits": [float(k)]})]
        return SimpleNamespace(trace=trace_, trace_frames=2, shapes=shapes,
                               program_spans=spans)

    for k in (4, 1):
        need = 4 * ((1080 + 1920) * 2000 + 1080 * 1920 * k + 1080) / 3.35e12
        assert read(ctx(k)) == pytest.approx(100.0 * need / 1e-3)
        assert 0.0 < read(ctx(k)) <= 100.0
    assert read(ctx(4)) > read(ctx(1))
    assert read(SimpleNamespace(trace=None, trace_frames=2, shapes=shapes)) is None
    no_k1 = trace.Trace([("other_kernel", 0.0, 9000.0)], [], 1.0, 0.0)
    assert read(ctx(4, no_k1)) is None
    for spans in (None, [], [_span(layers.ROOT)]):
        assert read(SimpleNamespace(trace=tr, trace_frames=2, shapes=shapes,
                                    program_spans=spans)) is None


def test_each_new_metric_is_reported_in_the_cells_that_list_it():
    b = harness.load_json(harness.BENCHMARK)
    names = lambda cell: {m["name"] for m in harness.cell_metrics(b, cell, True)}  # noqa: E731
    assert names(TRANSLUCENT) == NEW | {"device_idle_pct", "terrain_pack_s", "import_init_s"}
    assert NEW & names(OBJECTS) == {"object_pass_stream_ms"}
    assert {m["name"] for m in harness.cell_metrics(b, TRANSLUCENT, False)} == {
        "frame_ms", "peak_mem_mib", "setup_s"}
    for cell in ("headline_1080p.fast_pan", "headline_1080p.rect_tilt1_pan",
                 "headline_1080p.rect_tilt0_pan"):
        assert not NEW & names(cell)


class _HostEvent:
    """``torch.cuda.Event`` stood in for off a card: recorded on the host's
    clock."""

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        self.at = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.at - self.at)


def _profiled_trace_call(fn, out_file, tries=3):
    """trace_call off a card: ``fn`` under a CPU profiler, which turns the
    port's recorder on as a CUDA trace does; a trace of K1's two kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    at = t0 * 1e6
    return trace.Trace([("chunk_envelopes_kernel", at + 10, at + 20),
                        ("crossing_segments_kernel", at + 30, at + 90)],
                       [("cudaLaunchKernel", at, at + 1)], wall, 0.0)


@pytest.mark.parametrize("cell,timed", [(TRANSLUCENT, True), (OBJECTS, True),
                                        (TRANSLUCENT, False)])
def test_the_traced_run_reports_the_device_metrics_where_spans_are_timed(
        cell, timed, tmp_path, monkeypatch):
    """With device-timed spans (their events on the host's clock here) the
    traced run of each cell reports the metrics it lists, each above 0; with
    spans not timed, as on the CPU or the parent tree, it leaves them out
    and still reports the rest."""
    import atm_raytracer_tpu_torch.generators.fast  # noqa: F401

    monkeypatch.setattr(harness, "RUNS", tmp_path)
    monkeypatch.setattr(trace, "trace_call", _profiled_trace_call)
    if timed:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    line, _ = harness.run(cell, SEED, 0.5, True, device="cpu", t_zero=time.perf_counter(),
                          overrides=SMALL)
    assert line["correct"] is True
    b = harness.load_json(harness.BENCHMARK)
    listed = {m["name"] for m in harness.cell_metrics(b, cell, True)} & NEW
    got = set(line["metrics"])
    if not timed:
        listed -= set(DEVICE_READERS) | {"object_pass_ns_per_slot"}
    assert got & NEW == listed
    assert all(line["metrics"][m]["value"] > 0 for m in listed)
    assert {"device_idle_pct", "terrain_pack_s", "import_init_s"} <= got
    assert tracing._spans == []


def test_a_tree_without_the_recorder_reads_none(monkeypatch):
    import atm_raytracer_tpu_torch

    monkeypatch.delattr(atm_raytracer_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "atm_raytracer_tpu_torch.tracing", None)
    ctx = SimpleNamespace(trace=object(), trace_frames=1)
    for metric in NEW:
        assert harness.reader(metric)(ctx) is None
    assert ctx.program_spans is None


TILTED = "headline_1080p.rect_tilt1_pan"
EXACT = {"exact_test_stream_ms", "exact_test_ns_per_slot"}


def test_the_exact_test_readers_read_its_span_and_slots():
    """``exact_test_stream_ms`` sums the stream time of every round's
    ``rect.exact_test`` a frame; ``exact_test_ns_per_slot`` divides it by the
    slots those spans counted (``rect.test_slots``). Each reads None without
    a trace, without the span, with the span untimed or, for the slot
    reader, uncounted."""
    spans = [_span(layers.ROOT), _span("rect.capture", 0, 20.0),
             _span("rect.exact_test", 0, 1.0, counts={"rect.test_slots": [1000.0]}),
             _span("rect.exact_test", 0, 0.5, counts={"rect.test_slots": [200.0]}),
             _span(layers.ROOT),
             _span("rect.exact_test", 4, 1.5, counts={"rect.test_slots": [800.0]})]
    assert harness.reader("exact_test_stream_ms")(_ctx(spans)) == pytest.approx(1.5)
    assert harness.reader("exact_test_ns_per_slot")(_ctx(spans)) == pytest.approx(
        1e6 * 3.0 / 2000.0)
    untimed = [_span(layers.ROOT), _span("rect.exact_test", 0,
                                         counts={"rect.test_slots": [10.0]})]
    uncounted = [_span(layers.ROOT), _span("rect.exact_test", 0, 1.0)]
    old = SimpleNamespace(name="rect.exact_test", start=0.0, end=1.0, parent=None)
    for metric in EXACT:
        read = harness.reader(metric)
        for ctx in (SimpleNamespace(trace=None, trace_frames=2), _ctx(None), _ctx([]),
                    _ctx(untimed, 1), _ctx([old], 1)):
            assert read(ctx) is None, (metric, ctx)
    assert harness.reader("exact_test_ns_per_slot")(_ctx(uncounted, 1)) is None


def test_the_exact_test_metrics_are_reported_in_the_tilted_cell_alone():
    b = harness.load_json(harness.BENCHMARK)
    for cell in (TILTED, TRANSLUCENT, OBJECTS, "headline_1080p.fast_pan",
                 "headline_1080p.rect_tilt0_pan"):
        got = {m["name"] for m in harness.cell_metrics(b, cell, True)} & EXACT
        assert got == (EXACT if cell == TILTED else set()), cell
        assert not EXACT & {m["name"] for m in harness.cell_metrics(b, cell, False)}


@pytest.mark.parametrize("timed", [True, False])
def test_the_tilted_traced_run_reports_the_exact_test_where_it_is_timed(
        timed, tmp_path, monkeypatch):
    """The tilted cell's traced run (its CUDA events on the host's clock
    here) reports both exact-test metrics, each above 0; with the spans not
    timed, as on the CPU, it leaves them out."""
    import atm_raytracer_tpu_torch.generators.rectilinear  # noqa: F401

    monkeypatch.setattr(harness, "RUNS", tmp_path)
    monkeypatch.setattr(trace, "trace_call", _profiled_trace_call)
    if timed:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    line, _ = harness.run(TILTED, SEED, 0.5, True, device="cpu", t_zero=time.perf_counter(),
                          overrides=SMALL)
    assert line["correct"] is True
    got = set(line["metrics"]) & EXACT
    assert got == (EXACT if timed else set())
    assert all(line["metrics"][m]["value"] > 0 for m in got)
    assert tracing._spans == []
