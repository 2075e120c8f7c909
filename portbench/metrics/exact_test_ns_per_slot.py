"""exact_test_ns_per_slot: the CUDA stream's time through the program's span
``rect.exact_test`` (``exact_test_stream_ms``) over the candidate slots it
was handed to test (the program's counter ``rect.test_slots``: each round,
the filled slots of the pixels with no hit yet), in ns a slot."""

from portbench.device_layers import count_per_frame, stream_ms_per_frame


def read(ctx):
    ms = stream_ms_per_frame(ctx, "rect.exact_test")
    slots = count_per_frame(ctx, "rect.test_slots")
    if ms is None or not slots:
        return None
    return 1e6 * ms / slots
