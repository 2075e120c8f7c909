"""object_plan_ms: the host wall of the program's span ``objects.plan``
(``ObjectSet.build`` and the objects' column windows, ``object_col_windows``),
a traced frame, in ms."""

from portbench.layers import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "objects.plan")
