"""Spans and counters at the port's layer boundaries, recorded in memory
while enabled or while a ``torch.profiler`` trace is being taken.

``span(name)`` wraps one layer's call. Off, the default, it returns one
shared null context manager: no clock is read, no event is recorded,
nothing is stored. On (``enable()``, or a profiler recording, so that a
profiled stretch carries the spans its device records were launched under),
a span reads ``time.perf_counter()`` when it opens and when it closes and is
appended once to the recording. It never synchronizes the device or
launches anything, so the device work it encloses is only enqueued inside
it: a profiler's device record belongs to the span that was open when the
host call that launched it was made.

``span(name, device=True)`` also records a CUDA event on the current stream
when it opens and when it closes, where CUDA is initialised: its
``device_ms`` is the stream's time from the one to the other, read once the
recording is taken. That is the time the stream took to pass through the
layer's work, so it includes the stream's idle time where the host issued
the layer slower than the device ran it.

``count(name, value)`` records a counter on the innermost span open on its
thread, under the same condition; a count with no span open belongs to no
layer and is not kept. ``value`` is a host number or a 0-d tensor, which
stays on its device until ``take()`` reads it: no counter synchronizes a
frame.

Each thread keeps its own stack of open spans: a span's parent is the
innermost span open on its thread. ``take()`` returns the recording and
clears it; take it once the spans have closed. Spans recorded under a
profiler stay in the recording until they are taken.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_spans: list = []
_enabled = False


@dataclasses.dataclass
class Span:
    name: str
    start: float  # time.perf_counter() seconds
    end: float  # nan while open
    parent: Optional[int]  # index in the recording, None for an outermost span
    # counter name -> the values counted while this span was innermost, in
    # order; floats once taken
    counts: Optional[dict] = None
    # the (open, close) CUDA events of a device-timed span
    events: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device_ms(self) -> Optional[float]:
        """The stream's ms from the span's open to its close; None for a
        span without events (not device-timed, or CUDA not initialised).
        Waits for the closing event: read it after ``take()``."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return float(start.elapsed_time(end))


class _Open:
    """The context manager of one recorded span."""

    __slots__ = ("name", "timed", "record")

    def __init__(self, name: str, timed: bool):
        self.name, self.timed = name, timed

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.record = Span(self.name, time.perf_counter(), math.nan,
                           stack[-1][0] if stack else None)
        if self.timed:
            opened = torch.cuda.Event(enable_timing=True)
            opened.record()
            self.record.events = (opened, torch.cuda.Event(enable_timing=True))
        with _lock:
            stack.append((len(_spans), self.record))
            _spans.append(self.record)
        return self

    def __exit__(self, *exc):
        if self.record.events is not None:
            self.record.events[1].record()
        self.record.end = time.perf_counter()
        _local.stack.pop()
        return False


def span(name: str, device: bool = False):
    """A context manager around one layer's call: recorded while enabled or
    while a profiler records, else the shared null context manager. With
    ``device``, timed on the current CUDA stream where CUDA is initialised."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, device and torch.cuda.is_initialized())


def count(name: str, value) -> None:
    """Record ``value`` (a host number or a 0-d tensor, read at ``take()``)
    under ``name`` on the innermost open span of this thread, while
    recording; each count of a name under one span is kept."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    stack = getattr(_local, "stack", None)
    if not stack:
        return
    record = stack[-1][1]
    with _lock:
        if record.counts is None:
            record.counts = {}
        record.counts.setdefault(name, []).append(value)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def take() -> list:
    """The recorded spans, in the order they opened, with their counts read
    to the host as floats, and a cleared recording."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    for s in out:
        if s.counts:
            s.counts = {k: [float(v) for v in vs] for k, vs in s.counts.items()}
    return out
