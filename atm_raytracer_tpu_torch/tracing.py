"""Spans at the port's layer boundaries, recorded in memory while enabled or
while a ``torch.profiler`` trace is being taken.

``span(name)`` wraps one layer's call. Off, the default, it returns one
shared null context manager: no clock is read, nothing is stored. On
(``enable()``, or a profiler recording, so that a profiled stretch carries
the spans its device records were launched under), a span reads
``time.perf_counter()`` when it opens and when it closes and is appended
once to the recording. It never synchronizes the device, records a CUDA
event or launches anything, so the device work it encloses is only enqueued
inside it: a profiler's device record belongs to the span that was open
when the host call that launched it was made.

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


class _Open:
    """The context manager of one recorded span."""

    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.record = Span(self.name, time.perf_counter(), math.nan,
                           stack[-1] if stack else None)
        with _lock:
            stack.append(len(_spans))
            _spans.append(self.record)
        return self

    def __exit__(self, *exc):
        self.record.end = time.perf_counter()
        _local.stack.pop()
        return False


def span(name: str):
    """A context manager around one layer's call: recorded while enabled or
    while a profiler records, else the shared null context manager."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def take() -> list:
    """The recorded spans, in the order they opened, and a cleared recording."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out
