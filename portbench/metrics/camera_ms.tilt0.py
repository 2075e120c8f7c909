"""camera_ms.tilt0: the host wall of the program's span ``camera`` (the
Rectilinear camera's [H, W] float64 angles and its column azimuths) a traced
frame, in ms, in the cells of the tilt-0 Rectilinear path."""

from portbench.layers import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "camera")
