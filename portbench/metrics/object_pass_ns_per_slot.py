"""object_pass_ns_per_slot: the CUDA stream's time through the program's
span ``objects.pass`` (``object_pass_stream_ms``) over the hit slots the frame's objects widen to (the
program's counter ``fast.slots``, H x W x k_out a frame), in ns a slot."""

from portbench.device_layers import count_per_frame, stream_ms_per_frame


def read(ctx):
    ms = stream_ms_per_frame(ctx, "objects.pass")
    slots = count_per_frame(ctx, "fast.slots")
    if ms is None or not slots:
        return None
    return 1e6 * ms / slots
