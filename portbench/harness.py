"""One run of one cell: set-up, a closed-loop window of frames, an optional
profiled stretch, and the check against the reference.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that names, its traffic in
``traffic/<traffic>.json``, its correctness limits in
``limits/<cell>.json``, and each metric in ``metrics/<metric>.py``, a
reader of the run's measurements. A cell, a traffic mix or a metric is
added by adding files and entries.

The window drives the program as ``gen`` does on a card
(``atm_raytracer_tpu_torch/cli.py``): a frame is the frame's config dict
lowered through the program's ``config.py``, then ``render_rectilinear``,
``render_interpolating`` or, for Fast, ``render_fast_streamed`` with 8
bands (``render_fast`` off a card), until the image is on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import json
import math
import resource
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import compare, scene, trace, views
from .device import device_entry

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
RUNS = ROOT / "portbench_runs"  # spans of each run; listed in .gitignore


@dataclasses.dataclass
class Span:
    name: str
    start: float  # time.perf_counter() seconds
    end: float
    parent: Optional[int]


class Spans:
    """Spans the benchmark records around its calls into each layer, kept
    in memory and written out when the run ends."""

    def __init__(self):
        self.spans: list = []
        self._open: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        parent = self._open[-1] if self._open else None
        span = Span(name, time.perf_counter(), math.nan, parent)
        self.spans.append(span)
        self._open.append(len(self.spans) - 1)
        try:
            yield span
        finally:
            span.end = time.perf_counter()
            self._open.pop()

    def since(self, t0: float) -> list:
        return [s for s in self.spans if s.start >= t0]

    def write(self, path: Path, t_zero: float) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps([
            {"name": s.name, "start_s": s.start - t_zero, "end_s": s.end - t_zero,
             "parent": s.parent} for s in self.spans]))


class Program:
    """The system under test: the port's entry points a frame goes through."""

    def __init__(self):
        from atm_raytracer_tpu_torch.config import Config
        from atm_raytracer_tpu_torch.generators import fast, interpolating, rectilinear
        from atm_raytracer_tpu_torch.terrain.store import Terrain, Tile

        self.Config, self.fast, self.rect = Config, fast, rectilinear
        self.interp = interpolating
        self.Terrain, self.Tile = Terrain, Tile

    def lower(self, frame: dict, terrain):
        return self.Config.from_dict(frame).into_params(terrain)

    def pack(self, params, terrain, device):
        return terrain.pack(*self.fast.terrain_bbox(params), device)

    def render(self, params, terrain, device):
        """The route of ``gen`` (cli.py:134-149): Rectilinear,
        InterpolatingRectilinear, or on a card the banded Fast render (which
        hands a scene with objects to ``render_fast``), or ``render_fast``
        off a card."""
        if params.output.generator == "Rectilinear":
            return self.rect.render_rectilinear(params, terrain, device)
        if params.output.generator == "InterpolatingRectilinear":
            return self.interp.render_interpolating(params, terrain, device)
        if device.type == "cuda":
            return self.fast.render_fast_streamed(params, terrain, device, bands=8)
        return self.fast.render_fast(params, terrain, device)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, workload: str):
    """(cell, configuration entry, configuration, traffic, limits)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return cell, entry, config, traffic, limits


def cell_metrics(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics, or with a trace its per-layer ones. A metric with a
    ``workloads`` list is reported in those cells; a per-layer metric
    without one wherever the metric it moves is reported."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}

    def reported(m):
        return workload in m["workloads"] if "workloads" in m else m["moves"] in moved

    return [m for m in bench["per_layer"] if reported(m)]


def reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def shrunk(config: dict, overrides: Optional[dict]) -> dict:
    """The configuration at a test's smaller size: ``width``, ``height``,
    ``max_distance`` and ``posts`` (tests on the CPU only). The objects'
    stored positions hold at the configuration's own size only: at another
    the rule places them again."""
    config = json.loads(json.dumps(config))
    if overrides and config.get("objects"):
        config["objects"].pop("placed", None)
    for key, value in (overrides or {}).items():
        if key in ("width", "height"):
            config["scene"]["output"][key] = value
        elif key == "max_distance":
            config["scene"]["view"]["frame"][key] = value
        elif key == "posts":
            config["terrain"][key] = value
        else:
            raise KeyError(f"unknown override {key!r}")
    return config


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_counters() -> dict:
    """Cumulative host readings a window's record is the difference of: the
    process's CPU seconds, split into user and kernel time, its minor page
    faults (pages the kernel mapped and zeroed for it), and its context
    switches, those it made waiting (voluntary) and those forced on it
    (involuntary: another thread took its core)."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": time.process_time(), "user_s": use.ru_utime, "system_s": use.ru_stime,
            "page_faults_minor": use.ru_minflt, "switches_voluntary": use.ru_nvcsw,
            "switches_involuntary": use.ru_nivcsw}


class _GcPauses:
    """The garbage collector's pauses while registered in ``gc.callbacks``."""

    def __init__(self):
        self.seconds, self.count, self._t = 0.0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count += 1
            self._t = None


def _keep(result) -> tuple:
    """A frame kept for the check: its image copied on the host, and its hit
    fields copied to the host behind the frame's work on the device, without
    a wait (``_kept_fields`` reads them once the window has closed)."""
    return (np.array(result.image, copy=True),
            {f: getattr(result.hits, f).detach().to("cpu", non_blocking=True, copy=True)
             for f in compare.FIELDS})


def _kept_fields(fields: dict) -> dict:
    """The host arrays of ``_keep``'s fields, after a synchronize."""
    return {f: t.numpy() for f, t in fields.items()}


def _kept(rng, i: int, k: int) -> Optional[int]:
    """Reservoir sampling: the slot frame ``i`` takes in a uniform sample of
    ``k`` frames, or None."""
    if i < k:
        return i
    j = int(rng.integers(0, i + 1))
    return j if j < k else None


def run(workload: str, seed: int, seconds: float, traced: bool, *, device,
        t_zero: float, program=None, overrides: Optional[dict] = None,
        bench: Optional[dict] = None):
    """One run; returns (result line as a dict, check lines).

    ``t_zero`` is the process's start on the ``time.perf_counter`` clock.
    ``program`` defaults to the port; ``overrides`` shrink the
    configuration (tests). The reference renders on ``device`` too."""
    device = torch.device(device)
    spans = Spans()
    with spans("import_init"):
        program = program or Program()
        if device.type == "cuda":
            torch.zeros(1, device=device)
            _sync(device)
    import_init_s = time.perf_counter() - t_zero
    bench = bench or load_json(BENCHMARK)
    _, _, config, traffic, limits = find_cell(bench, workload)
    config = shrunk(config, overrides)
    sc = config["scene"]
    generator, tilt = traffic["generator"], float(traffic["tilt_deg"])

    with spans("terrain_make"):
        keys, tiles = scene.make_tiles(config, device)
        terrain = scene.build_terrain(program.Terrain, program.Tile, keys, tiles)
    base = scene.frame_dict(sc, sc["view"]["frame"]["direction"], tilt, generator)
    with spans("terrain_pack") as pack_span:
        program.pack(program.lower(base, terrain), terrain, device)
        _sync(device)
    terrain_pack_s = pack_span.end - pack_span.start

    texture_dir = None
    objects = None
    try:
        if config.get("objects"):
            with spans("objects"):
                texture_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
                texture = texture_dir / "checker64.png"
                scene.write_texture(texture)
                objects = scene_objects(config, keys, tiles, texture, device)
        frame_of = lambda d: scene.frame_dict(sc, d, tilt, generator, objects)  # noqa: E731

        with spans("warmup"):
            # each warm-up frame is kept twice as the window keeps its
            # sample, so the page-locked host buffers of those copies are
            # allocated and cached here, not in the window (which holds
            # ``check_frames`` of them and takes one more at a time)
            warm = []
            for d in itertools.islice(views.directions(traffic, seed, stream=1),
                                      int(traffic["warmup_frames"])):
                result = program.render(program.lower(frame_of(d), terrain), terrain, device)
                warm += [_keep(result), _keep(result)]
            _sync(device)
            del warm, result

        # -- the window ---------------------------------------------------
        gc.collect()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        seq = views.directions(traffic, seed, stream=0)
        sample_rng = np.random.default_rng([int(seed), 3])
        k = int(traffic["check_frames"])
        samples: list = [None] * k
        starts, ends, failed = [], [], 0
        pauses = _GcPauses()
        gc.callbacks.append(pauses)
        host0 = _host_counters()
        t_window = time.perf_counter()
        setup_s = t_window - t_zero
        while True:
            d = next(seq)
            t_a = time.perf_counter()
            try:
                with spans("frame"):
                    with spans("lower"):
                        params = program.lower(frame_of(d), terrain)
                    with spans("render"):
                        result = program.render(params, terrain, device)
                t_b = time.perf_counter()
            except Exception:  # a frame that fails is counted and reported
                failed += 1
                traceback.print_exc(file=sys.stderr)
                if time.perf_counter() - t_window >= seconds:
                    break
                continue
            starts.append(t_a)
            ends.append(t_b)
            slot = _kept(sample_rng, len(starts) - 1, k)
            if slot is not None:
                with spans("keep"):
                    samples[slot] = (d, *_keep(result))
            del result, params
            if t_b - t_window >= seconds:
                break
        t_closed = time.perf_counter()
        host1 = _host_counters()
        gc.callbacks.remove(pauses)
        _sync(device)
        peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        samples = [(d, image, _kept_fields(fields)) for d, image, fields in
                   (s for s in samples if s is not None)]
        record = {"frames": len(starts), "failed": failed, "wall_s": t_closed - t_window,
                  "keep_s": sum(sp.end - sp.start for sp in spans.since(t_window)
                                if sp.name == "keep"),
                  "gc_pause_s": pauses.seconds, "gc_collections": pauses.count,
                  **{name: host1[name] - host0[name] for name in host0}}
        print(f"[window] {workload} seed {seed}: {len(starts)} frames, {failed} failed, "
              f"{(ends[-1] - starts[0]) if starts else 0.0:.3f} s; host: "
              + ", ".join(f"{name} {value:.4f}" for name, value in record.items()
                          if name not in ("frames", "failed")),
              file=sys.stderr, flush=True)

        # -- the profiled stretch (--trace 1) ---------------------------------
        traced_run = None
        if traced:
            n_tr = int(traffic["trace_frames"])
            ahead = list(itertools.islice(seq, n_tr))

            def stretch():
                for d in ahead:
                    with spans("frame"):
                        with spans("lower"):
                            params = program.lower(frame_of(d), terrain)
                        with spans("render"):
                            program.render(params, terrain, device)

            t_tr = time.perf_counter()
            traced_run = trace.trace_call(stretch, _run_dir(workload, seed, traced) / "trace.json")
            traced_spans = spans.since(t_tr)

        # -- the check ----------------------------------------------------------
        del terrain
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with spans("check"):
            numbers = _check(keys, tiles, samples, frame_of, device)
    finally:
        if texture_dir is not None:
            shutil.rmtree(texture_dir, ignore_errors=True)

    correct = bool(failed == 0 and starts and numbers is not None
                   and compare.judge(numbers, limits))
    ctx = SimpleNamespace(
        starts=starts, ends=ends, peak_bytes=peak, setup_s=setup_s,
        import_init_s=import_init_s, terrain_pack_s=terrain_pack_s, trace=traced_run,
        trace_frames=int(traffic["trace_frames"]), shapes=_shapes(config))
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": len(starts) + failed, "failed": failed,
            "metrics": metrics}
    line["device"] = device_entry(device, 1, peak)
    if traced_run is not None:
        line["device"].update(busy_s=traced_run.busy_s(), window_s=traced_run.wall_s)
        line["breakdown"] = {
            "device_ops": trace.top_device_ops(traced_run),
            "idle_gaps": trace.idle_by_host(traced_run, traced_spans)}
    checks = {}
    for name in compare.NUMBERS:
        value = numbers[name] if numbers is not None else math.inf
        checks[name] = {"value": value if math.isfinite(value) else str(value),
                        "limit": limits[name]}
    line["checks"] = checks
    spans.write(_run_dir(workload, seed, traced) / "spans.json", t_zero)
    (_run_dir(workload, seed, traced) / "window.json").write_text(json.dumps(record))
    lines = [f"check {name} {c['value']} limit {c['limit']}" for name, c in checks.items()]
    lines.append(f"check frames_failed {failed} limit 0")
    return line, lines


def _run_dir(workload: str, seed: int, traced: bool) -> Path:
    return RUNS / workload / f"seed{int(seed)}-trace{int(bool(traced))}"


def scene_objects(config, keys, tiles, texture, device) -> list:
    """The configuration's objects: at the positions it stores, or, where it
    stores none (a test's smaller size), where its rule places them."""
    positions = config["objects"].get("placed") or place(config, keys, tiles, device)
    return scene.objects_at(config, positions, texture)


def place(config, keys, tiles, device) -> list:
    """The positions the configuration's rule gives its objects: by the
    reference's object-free Fast frame at the rule's direction."""
    from .reference import Reference

    sc = config["scene"]
    ref = Reference(keys, tiles, device)
    try:
        free = ref.render(scene.frame_dict(sc, config["objects"]["direction_deg"], 0.0, "Fast"))
        return scene.rule_positions(config, sc, free.hits)
    finally:
        ref.close()


def _check(keys, tiles, samples, frame_of, device):
    """The worst of each number over the sampled frames, rendered again by
    the reference; None without a frame."""
    from .reference import Reference

    if not samples:
        return None
    ref = Reference(keys, tiles, device)
    try:
        per_frame = []
        for d, image, fields in samples:
            r = ref.render(frame_of(d))
            per_frame.append(compare.frame_numbers(image, fields, r.image,
                                                   compare.host_fields(r.hits)))
            del r
        return compare.worst(per_frame)
    finally:
        ref.close()


def _shapes(config: dict) -> dict:
    """The frame's sizes the metric readers count bytes from."""
    from .reference.frozen.physics.ray import march_coarse

    sc = config["scene"]
    step = float(sc.get("simulation_step", 50.0))
    n_terr = int(math.ceil(float(sc["view"]["frame"]["max_distance"]) / step))
    return {"height": int(sc["output"]["height"]), "width": int(sc["output"]["width"]),
            "n_terr": n_terr, "coarse": march_coarse(step)}
