"""k1_roofline_pct.k4: K1's bound over its device time a frame, at the K hit
slots a pixel the program counts (``fast.max_hits``: 4 for translucent
terrain). The bound is the frame's bytes (each ray altitude and terrain
sample read once, the [H, W, K] segments written once, the rays' death
limits read once: ``csrc/combine.cu``'s arguments) over the HBM rate; the
time is the sum of K1's records (``chunk_envelopes_kernel``,
``crossing_segments_kernel``) over the traced frames' launches, a frame.
None on a tree that does not count its hit slots."""

from portbench import bounds
from portbench.device_layers import counts
from portbench.metrics.k1_roofline_pct import NAMES


def k1_bytes(h_n: int, w_n: int, n_seg: int, k: int) -> int:
    """K1's bytes for one frame of [h_n, w_n] at ``k`` hit slots."""
    return 4 * ((h_n + w_n) * (n_seg + 1) + h_n * w_n * k + h_n)


def read(ctx):
    if ctx.trace is None:
        return None
    k = max(counts(ctx, "fast.max_hits"), default=None)
    if k is None:
        return None
    t = sum(s for name, s in ctx.trace.by_name_s().items() if any(n in name for n in NAMES))
    if t <= 0.0:
        return None
    sh = ctx.shapes
    need = bounds.bound_s(k1_bytes(sh["height"], sh["width"], sh["n_terr"] - 1, int(k)))
    return 100.0 * need / (t / ctx.trace_frames)
