"""hit_fields_stream_ms: the CUDA stream's time through the program's span
``fast.fields`` (the Fast route's gathers of the terrain and ray fields at
each of the K hit slots, and the hit buffer they make), a traced frame, in
ms: from the event recorded when the span opens to the one recorded when it
closes, the stream's idle time inside it included."""

from portbench.device_layers import stream_ms_per_frame


def read(ctx):
    return stream_ms_per_frame(ctx, "fast.fields")
