"""The port's layer spans over a traced stretch, as the layer readers take
them.

The port records its spans (``atm_raytracer_tpu_torch.tracing``) while a
``torch.profiler`` trace is being taken, so the traced stretch leaves them in
its recording. The first reader of a run takes them, keeps those of the
traced frames and leaves them on ``ctx`` for the others. A tree without the
recorder has none, and its readers give None: the line lacks the metric.
"""

from __future__ import annotations

ROOT = "gen.render"  # the span of one render call, one a frame


def traced_spans(spans: list, frames: int):
    """The spans of the last ``frames`` render calls, from the first of
    their roots on (a trace taken again leaves its earlier tries' spans
    before them); None where fewer roots were recorded."""
    roots = [i for i, s in enumerate(spans) if s.parent is None and s.name == ROOT]
    if frames < 1 or len(roots) < frames:
        return None
    return spans[roots[-frames]:]


def program_spans(ctx):
    """The port's spans of the traced frames, or None: no trace, or a tree
    without the recorder."""
    if not hasattr(ctx, "program_spans"):
        held = None
        if ctx.trace is not None:
            try:
                from atm_raytracer_tpu_torch import tracing
            except ImportError:
                tracing = None
            if tracing is not None:
                held = traced_spans(tracing.take(), ctx.trace_frames)
        ctx.program_spans = held
    return ctx.program_spans


def host_ms_per_frame(ctx, name: str):
    """The host wall of the program's spans named ``name`` over the traced
    frames, a frame, in ms; None where no such span opened in them (no
    trace, a tree without the recorder, or a span renamed or gone)."""
    spans = [s for s in program_spans(ctx) or () if s.name == name]
    if not spans:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / ctx.trace_frames
