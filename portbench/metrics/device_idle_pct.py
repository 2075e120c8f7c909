"""device_idle_pct: the share of the traced stretch of frames (host wall)
in which no device record (kernel, copy, memset) runs."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.wall_s)
