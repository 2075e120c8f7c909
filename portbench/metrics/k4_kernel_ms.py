"""k4_kernel_ms: the device time of K4, the tilted Rectilinear capture scan, a frame: the sum of its
``rect_culled_kernel`` records over the traced frames, in ms."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(s for name, s in ctx.trace.by_name_s().items() if "rect_culled_kernel" in name)
    return 1e3 * t / ctx.trace_frames if t > 0.0 else None
