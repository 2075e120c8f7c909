"""frame_p95_ms: the 95th percentile of every completed frame's wall in
the window (host clock, from the config dict to the image on the host)."""

from portbench.views import frame_stats


def read(ctx):
    return frame_stats(ctx.starts, ctx.ends)[1]
