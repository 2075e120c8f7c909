"""The port's span recorder (``atm_raytracer_tpu_torch/tracing.py``) on the CPU.

Off, ``span`` hands out one shared null context manager and nothing is
recorded. On, each route a benchmark cell takes records its layer spans
under one ``gen.render`` root: Fast with objects, the banded Fast render,
Rectilinear at tilt 1 (the culled path) and at tilt 0 (the scan), all on
the golden terrain at its golden size. The recorder changes no output; a
span closes when its body raises; each thread keeps its own stack.
"""

import copy
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

import test_golden as G  # noqa: E402
from atm_raytracer_tpu_torch import tracing  # noqa: E402
from atm_raytracer_tpu_torch.config import Config  # noqa: E402
from atm_raytracer_tpu_torch.generators import fast, rectilinear  # noqa: E402
from atm_raytracer_tpu_torch.generators.base import HitBuffer  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402

# route -> (golden scene, generator, tilt, render call, the spans under its root)
ROUTES = {
    "fast objects": ("objects", "Fast", 0.0, fast.render_fast, {
        "camera", "objects.plan", "fast.march", "fast.terrain_columns", "fast.combine",
        "fast.fields", "objects.pass", "composite", "fetch"}),
    "fast banded": ("plain", "Fast", 0.0,
                    lambda p, t, d: fast.render_fast_streamed(p, t, d, bands=8), {
                        "camera", "fast.march", "fast.bands", "fast.terrain_columns",
                        "fast.combine", "fast.fields", "composite", "fetch"}),
    "rectilinear tilt 1": ("plain", "Rectilinear", 1.0, rectilinear.render_rectilinear, {
        "camera", "rect.capture", "rect.exact_test", "fetch"}),
    "rectilinear tilt 0": ("plain", "Rectilinear", 0.0, rectilinear.render_rectilinear, {
        "camera", "rect.scan", "fetch"}),
}


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    d = make_terrain_folder(tmp_path_factory.mktemp("torch_tracing"), tiles=((49, 21),), n=181)
    return d, Terrain.from_folder(d)


def _params(golden, scene, generator, tilt):
    d, terrain = golden
    cfg = G._base_config(**copy.deepcopy(G.SCENES[scene]))
    cfg["scene"]["terrain_folder"] = str(d)
    cfg["output"]["generator"] = generator
    cfg["view"]["frame"]["tilt"] = tilt
    return Config.from_dict(cfg).into_params(terrain)


@pytest.fixture(scope="module")
def renders(golden):
    """route -> (the render with the recorder off, with it on, its spans)."""
    out = {}
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for route, (scene, generator, tilt, render, _) in ROUTES.items():
            params = _params(golden, scene, generator, tilt)
            off = render(params, golden[1], "cpu")
            tracing.enable()
            try:
                on = render(params, golden[1], "cpu")
            finally:
                tracing.disable()
            out[route] = (off, on, tracing.take())
    finally:
        torch.set_num_threads(before)
    return out


def test_off_records_nothing_and_hands_out_the_shared_null(golden):
    assert tracing.span("gen.render") is tracing.span("fast.bands")
    with tracing.span("gen.render") as inner:
        assert inner is None
    fast.render_fast(_params(golden, "plain", "Fast", 0.0), golden[1], "cpu")
    assert tracing.take() == []


@pytest.mark.parametrize("route", ROUTES)
def test_each_route_records_its_layer_spans_under_one_render(route, renders):
    want = ROUTES[route][4]
    spans = renders[route][2]
    assert spans[0].name == "gen.render" and spans[0].parent is None
    assert {s.name for s in spans[1:]} == want
    for i, s in enumerate(spans):
        assert s.start <= s.end
        if i:
            parent = spans[s.parent]
            assert s.parent < i and parent.start <= s.start and s.end <= parent.end
    if route == "fast banded":
        assert [s.name for s in spans].count("fast.bands") == 1
        assert {spans[s.parent].name for s in spans if s.name == "fast.combine"} == {"fast.bands"}
    if route == "rectilinear tilt 1":
        captures = [s for s in spans if s.name == "rect.capture"]
        assert renders[route][1].culled_rounds == len(captures) >= 1


@pytest.mark.parametrize("route", ROUTES)
def test_the_recorder_changes_no_output(route, renders):
    off, on, _ = renders[route]
    assert torch.equal(torch.from_numpy(off.image), torch.from_numpy(on.image))
    for f in dataclasses.fields(HitBuffer):
        assert torch.equal(getattr(off.hits, f.name), getattr(on.hits, f.name)), f.name


def test_the_window_scan_opens_only_when_the_plan_misses(golden):
    """``objects.col_windows`` opens once inside ``objects.plan`` for a new
    Params with objects, not on a second render of the same Params (the
    memo hits), and a scene without objects opens neither."""
    params = _params(golden, "objects", "Fast", 0.0)
    tracing.enable()
    fast.render_fast(params, golden[1], "cpu")
    first = tracing.take()
    fast.render_fast(params, golden[1], "cpu")
    again = tracing.take()
    fast.render_fast(_params(golden, "plain", "Fast", 0.0), golden[1], "cpu")
    plain = tracing.take()
    scans = [s for s in first if s.name == "objects.col_windows"]
    assert len(scans) == 1 and first[scans[0].parent].name == "objects.plan"
    assert [s.name for s in again].count("objects.plan") == 1
    assert "objects.col_windows" not in {s.name for s in again}
    assert not {"objects.plan", "objects.col_windows"} & {s.name for s in plain}


def test_a_profiler_recording_turns_the_recorder_on():
    """A ``torch.profiler`` trace records the spans of what it profiles,
    with the recorder not enabled; once it stops, spans are off again."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("gen.render"):
            with tracing.span("camera"):
                pass
    assert tracing.span("after") is tracing.span("after.too")
    root, cam = tracing.take()
    assert (root.name, root.parent, cam.name, cam.parent) == ("gen.render", None, "camera", 0)
    assert root.start <= cam.start <= cam.end <= root.end


def test_a_span_closes_and_unwinds_when_its_body_raises():
    tracing.enable()
    with tracing.span("outer"):
        with pytest.raises(ValueError):
            with tracing.span("inner"):
                raise ValueError("in the body")
        with tracing.span("after"):
            pass
    with tracing.span("next"):
        pass
    outer, inner, after, nxt = tracing.take()
    assert inner.end >= inner.start and inner.end <= after.start
    assert inner.parent == 0 and after.parent == 0
    assert nxt.parent is None and outer.end <= nxt.start


def test_a_second_thread_keeps_its_own_parent_stack():
    tracing.enable()
    opened, release = threading.Event(), threading.Event()

    def worker():
        with tracing.span("worker"):
            opened.set()
            release.wait(10)
            with tracing.span("worker.child"):
                pass

    t = threading.Thread(target=worker)
    with tracing.span("main"):
        t.start()
        assert opened.wait(10)
        with tracing.span("main.child"):
            release.set()
            t.join(10)
    assert not t.is_alive()
    spans = {s.name: (i, s) for i, s in enumerate(tracing.take())}
    (i_main, main), (i_worker, worker_span) = spans["main"], spans["worker"]
    assert main.parent is None and worker_span.parent is None
    assert spans["worker.child"][1].parent == i_worker
    assert spans["main.child"][1].parent == i_main


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` off a card: its time is when it
    was recorded, on the host's clock."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self):
        import time

        self.at = time.perf_counter()

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return 1e3 * (end.at - self.at)


def test_off_a_device_span_and_a_count_make_and_store_nothing(monkeypatch):
    """Off, a device-timed span is the shared null context manager (no
    event made, even with CUDA initialised) and a count stores nothing."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    assert tracing.span("objects.pass", device=True) is tracing.span("composite") is tracing._NULL
    with tracing.span("fast.fields", device=True) as inner:
        assert inner is None
        tracing.count("fast.slots", 10)
    tracing.count("fast.slots", torch.tensor(3))
    assert _FakeEvent.made == 0
    assert tracing.take() == []


def test_device_time_is_none_on_the_cpu(renders):
    """Without CUDA initialised a device-timed span records no event: its
    ``device_ms`` is None, on a bare span and on every span of a render."""
    assert not torch.cuda.is_initialized()
    tracing.enable()
    with tracing.span("composite", device=True):
        pass
    (s,) = tracing.take()
    assert s.events is None and s.device_ms is None
    for route in ROUTES:
        assert all(sp.device_ms is None for sp in renders[route][2])


def test_a_device_span_reads_the_time_between_its_two_events(monkeypatch):
    """With CUDA initialised a device-timed span records an event when it
    opens and one when it closes; ``device_ms`` is their elapsed time. A
    span not asked to be device-timed records none."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    tracing.enable()
    with tracing.span("gen.render"):
        with tracing.span("objects.pass", device=True):
            pass
    root, timed = tracing.take()
    assert _FakeEvent.made == 2 and root.events is None and root.device_ms is None
    opened, closed = timed.events
    assert timed.start <= opened.at <= closed.at <= timed.end
    assert timed.device_ms == pytest.approx(1e3 * (closed.at - opened.at))


class _Lazy:
    """A counter value that notes when it is read, as a 0-d device tensor
    read by ``float`` would synchronize."""

    def __init__(self, value):
        self.value, self.reads = value, 0

    def __float__(self):
        self.reads += 1
        return float(self.value)


def test_a_tensor_count_is_read_only_at_take():
    """A count is kept on the innermost open span and read when the
    recording is taken, not when it is counted; each count of a name under
    one span is kept, and a count with no span open is not."""
    lazy = _Lazy(7)
    tracing.enable()
    tracing.count("outside", 1)
    with tracing.span("gen.render"):
        tracing.count("fast.slots", 100)
        with tracing.span("fast.bands"):
            tracing.count("objects.k_out", lazy)
            tracing.count("objects.k_out", torch.tensor(5))
            assert lazy.reads == 0
    assert lazy.reads == 0
    root, bands = tracing.take()
    assert lazy.reads == 1
    assert root.counts == {"fast.slots": [100.0]}
    assert bands.counts == {"objects.k_out": [7.0, 5.0]}


def test_the_object_pass_opens_once_a_frame_with_its_launch_count(renders):
    """On the "fast objects" route ``objects.pass`` opens once, in the
    frame's one render, and carries ``objects.pass_launches``: 0 on the
    CPU, which runs the plain pass (K6 counts 1 on the card)."""
    spans = renders["fast objects"][2]
    (one,) = [s for s in spans if s.name == "objects.pass"]
    assert one.counts["objects.pass_launches"] == [0.0]
    assert [s.name for s in spans].count("gen.render") == 1


@pytest.mark.parametrize("route", ["fast objects", "fast banded"])
def test_a_fast_render_counts_its_hit_slots(route, renders):
    """The Fast routes count the hit depth, the object windows' overlap and
    the object depth it gives, and the slots of the hit buffer, as the
    returned hits have them."""
    _, on, spans = renders[route]
    counts = {}
    for s in spans:
        for k, v in (s.counts or {}).items():
            counts.setdefault(k, []).extend(v)
    assert sum(counts["fast.slots"]) == on.hits.valid.numel()
    k = on.hits.valid.shape[-1]
    if route == "fast objects":
        (max_hits,), (overlap,), (k_out,) = (counts[n] for n in (
            "fast.max_hits", "objects.overlap", "objects.k_out"))
        assert k_out == k == max_hits + min(2 * overlap, fast.OBJ_HIT_CAP) and overlap >= 1
    else:
        assert set(counts["fast.max_hits"]) == {k} and "objects.k_out" not in counts


def test_the_exact_test_counts_its_slots_each_round(golden, monkeypatch):
    """On the tilted route ``rect.exact_test`` opens once a round and counts
    ``rect.test_slots``: the filled slots (block < nb) of the pixels with no
    hit when the round starts, the slots K5 walks at most on the card.
    M_CAND = 1 makes the golden frame take several rounds."""
    seen = []
    real = rectilinear.culled_test_round

    def spy(pack, slots, az, key, plh, **kw):
        seen.append(int(((slots[4] < kw["blocks"].nb) & torch.isinf(key)).sum()))
        return real(pack, slots, az, key, plh, **kw)

    monkeypatch.setattr(rectilinear, "culled_test_round", spy)
    monkeypatch.setattr(rectilinear, "M_CAND", 1)
    params = _params(golden, "plain", "Rectilinear", 1.0)
    tracing.enable()
    try:
        res = rectilinear.render_rectilinear(params, golden[1], "cpu")
    finally:
        tracing.disable()
    spans = [s for s in tracing.take() if s.name == "rect.exact_test"]
    assert len(spans) == res.culled_rounds == len(seen) > 1
    assert [s.counts["rect.test_slots"] for s in spans] == [[float(n)] for n in seen]
    assert seen[0] > seen[-1] > 0  # hits and emptier rounds leave fewer slots to walk
