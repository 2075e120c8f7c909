"""exact_test_stream_ms: the CUDA stream's time through the program's span
``rect.exact_test`` (the tilted Rectilinear path's exact test of its
candidate blocks, one span a round), a traced frame, in ms: from the event
recorded when the span opens to the one recorded when it closes, the
stream's idle time inside it included."""

from portbench.device_layers import stream_ms_per_frame


def read(ctx):
    return stream_ms_per_frame(ctx, "rect.exact_test")
