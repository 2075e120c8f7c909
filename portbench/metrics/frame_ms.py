"""frame_ms: the window's wall from the first frame's start to the last
frame's end, over the frames completed in it (host clock)."""

from portbench.views import frame_stats


def read(ctx):
    return frame_stats(ctx.starts, ctx.ends)[0]
