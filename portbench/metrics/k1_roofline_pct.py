"""k1_roofline_pct: K1's bound over its device time a frame. The bound is
the frame's bytes (``bounds.k1_bytes``: each input read once, each output
written once) over the HBM rate; the time is the sum of K1's records
(``chunk_envelopes_kernel``, ``crossing_segments_kernel``) over the
traced frames' launches, a frame."""

from portbench import bounds

NAMES = ("chunk_envelopes_kernel", "crossing_segments_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(s for name, s in ctx.trace.by_name_s().items() if any(n in name for n in NAMES))
    if t <= 0.0:
        return None
    sh = ctx.shapes
    need = bounds.bound_s(bounds.k1_bytes(sh["height"], sh["width"], sh["n_terr"] - 1))
    return 100.0 * need / (t / ctx.trace_frames)
