"""camera_ms.culled: the host wall of the program's span ``camera`` (the
Rectilinear camera's [H, W] float64 angles, ``rectilinear_ray_params``) a
traced frame, in ms, in the cells of the culled tilted path."""

from portbench.layers import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "camera")
