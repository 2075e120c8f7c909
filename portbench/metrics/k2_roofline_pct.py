"""k2_roofline_pct: K2's bound over its device time a frame. The bound is
the bytes of one march of the frame's rows (``bounds.k2_bytes``; the l(h)
fit rows, under a kilobyte, left out) over the HBM rate; the time is the
sum of the ``march_kernel`` records over the traced frames, a frame."""

from portbench import bounds


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(s for name, s in ctx.trace.by_name_s().items() if "march_kernel" in name)
    if t <= 0.0:
        return None
    sh = ctx.shapes
    need = bounds.bound_s(bounds.k2_bytes(sh["height"], sh["n_terr"] - 1, sh["coarse"], 0))
    return 100.0 * need / (t / ctx.trace_frames)
