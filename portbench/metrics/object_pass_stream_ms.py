"""object_pass_stream_ms: the CUDA stream's time through the program's span
``objects.pass`` (``ops/objects.py::apply_objects_planes``, the separable
object pass), a traced frame, in ms: from the event recorded on the stream
when the span opens to the one recorded when it closes. That is not the
device's busy time: where the host issues the pass's launches slower than
the device runs them, the stream's idle time inside the span counts too."""

from portbench.device_layers import stream_ms_per_frame


def read(ctx):
    return stream_ms_per_frame(ctx, "objects.pass")
