"""Device records of a profiled stretch of frames, and what they add up to.

The profiler opener and the record union are copied from ``chip_smoke.py``
(``trace_events``, ``busy_us``, ``merged``): on the H100 a torch.profiler
trace loses a prefix of its device records, more the more traces a process
takes, so each trace opens with spin kernels whose records are dropped, and
a trace that kept none of them is taken again.
"""

from __future__ import annotations

import heapq
import json
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# spin kernels that open every profiler trace, ahead of the records it keeps
TRACE_SPACER = 256
SYNC_NAMES = ("cudaDeviceSynchronize",)


def merged(spans):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(spans))


class Trace:
    """One profiled call: its device records, the host's CUDA runtime calls,
    the host wall it took, and the offset that maps the host clock
    (``time.perf_counter``) onto the trace's clock."""

    def __init__(self, device, runtime, wall_s: float, offset_us):
        self.device = device  # [(name, start_us, end_us)]
        self.runtime = runtime  # [(name, start_us, end_us)]
        self.wall_s = wall_s
        self.offset_us = offset_us  # trace_us = perf_counter_s * 1e6 + offset

    def busy_s(self) -> float:
        return busy_us([(s, e) for _, s, e in self.device]) / 1e6

    def by_name_s(self) -> dict:
        out: dict = {}
        for name, s, e in self.device:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def idle_gaps(self):
        """[(start_us, end_us)] of the traced stretch's device idle time
        between its first and last device record."""
        spans = merged([(s, e) for _, s, e in self.device])
        return [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]


def trace_call(fn, out_file: Path, tries: int = 3) -> Trace:
    """Profile one ``fn()`` with CUDA activity: its device records (kernels,
    copies, memsets) and the host's runtime calls. The trace file is parsed
    and deleted."""
    from torch.profiler import ProfilerActivity, profile

    out_file.parent.mkdir(parents=True, exist_ok=True)
    spacer = 0
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_SPACER):
                torch.cuda._sleep(1)
            t_sync = time.perf_counter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(str(out_file))
        events = [e for e in json.loads(out_file.read_text())["traceEvents"]
                  if e.get("ph") == "X"]
        out_file.unlink()
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        spacer = sum("spin_kernel" in e["name"] for e in dev)
        if spacer:
            break
    if not spacer:
        raise RuntimeError(f"the profiler lost every spacer record of {tries} traces")
    device = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in dev if "spin_kernel" not in e["name"]]
    runtime = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") == "cuda_runtime"]
    syncs = sorted(s for name, s, _ in runtime if name in SYNC_NAMES)
    offset = syncs[0] - t_sync * 1e6 if syncs else None
    # the stretch itself: what ran after the spacer's synchronize
    if syncs:
        device = [d for d in device if d[1] >= syncs[0]]
        runtime = [r for r in runtime if r[1] > syncs[0]]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    return Trace(device, runtime, wall, offset)


def top_device_ops(trace: Trace, n: int = 10):
    """[[name, seconds]] of the ``n`` device operations that took most time."""
    ranked = sorted(trace.by_name_s().items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], s] for name, s in ranked]


def idle_by_host(trace: Trace, spans, n: int = 10):
    """[[what the host was doing, seconds]]: the device's idle time summed by
    the benchmark's innermost span around it and the CUDA runtime call that
    covers its middle (the first in the trace's order, where several do),
    the ``n`` largest. One sweep over the gaps, which come in time order, and
    the runtime calls by their start: a trace holds thousands of each."""
    host = []
    if trace.offset_us is not None:
        host = [(s.name, s.start * 1e6 + trace.offset_us, s.end * 1e6 + trace.offset_us)
                for s in spans]
    runtime = trace.runtime
    by_start = sorted(range(len(runtime)), key=lambda i: runtime[i][1])
    started = []  # heap of (index in trace order, end) of the calls begun so far
    j = 0
    out: dict = {}
    for a, b in trace.idle_gaps():
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        where = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "outside spans"
        while j < len(by_start) and runtime[by_start[j]][1] <= mid:
            heapq.heappush(started, (by_start[j], runtime[by_start[j]][2]))
            j += 1
        while started and started[0][1] < mid:  # ended: before every later middle too
            heapq.heappop(started)
        call = runtime[started[0][0]][0] if started else "host code, no CUDA call"
        label = f"{where}: {call}"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    ranked = sorted(out.items(), key=lambda kv: -kv[1])[:n]
    return [[label, s] for label, s in ranked]
