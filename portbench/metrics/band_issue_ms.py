"""band_issue_ms: the host wall of the program's span ``fast.bands``, the loop
that issues the banded Fast render's bands and submits their fetches, a traced
frame, in ms."""

from portbench.layers import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "fast.bands")
