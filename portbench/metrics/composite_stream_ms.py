"""composite_stream_ms: the CUDA stream's time through the program's span
``composite`` (coloring and front-to-back compositing of every hit slot in
``fast_core``), a traced frame, in ms: from the event recorded when the span
opens to the one recorded when it closes, the stream's idle time inside it
included."""

from portbench.device_layers import stream_ms_per_frame


def read(ctx):
    return stream_ms_per_frame(ctx, "composite")
