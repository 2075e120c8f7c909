"""The stream time and the counters of the port's layer spans over a traced
stretch, as the layer readers take them.

A span the port times on the device (``tracing.span(name, device=True)``)
carries ``device_ms``: the CUDA stream's time from the span's open to its
close, from two events recorded on the stream, the stream's idle time inside
the span included. A counter (``tracing.count``) is kept on the span open
when it was counted. Both come with the spans ``layers.program_spans`` takes
once the run ends. A tree whose spans carry neither, as before the port
timed them, reads None: the line lacks the metric.
"""

from __future__ import annotations

from portbench.layers import program_spans


def stream_ms_per_frame(ctx, name: str):
    """The stream time of the program's spans named ``name`` over the traced
    frames, a frame, in ms; None where none of them was timed on the device."""
    times = [getattr(s, "device_ms", None) for s in program_spans(ctx) or () if s.name == name]
    times = [t for t in times if t is not None]
    if not times:
        return None
    return sum(times) / ctx.trace_frames


def counts(ctx, name: str) -> list:
    """Every value of the program's counter ``name`` over the traced frames."""
    return [v for s in program_spans(ctx) or ()
            for v in (getattr(s, "counts", None) or {}).get(name, ())]


def count_per_frame(ctx, name: str):
    """The sum of the program's counter ``name`` over the traced frames, a
    frame; None where it was not counted."""
    values = counts(ctx, name)
    if not values:
        return None
    return sum(values) / ctx.trace_frames
