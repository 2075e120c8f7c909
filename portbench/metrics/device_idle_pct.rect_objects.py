"""device_idle_pct.rect_objects: device_idle_pct in the cells that report
frame_ms.rect_objects (the tilt-0 Rectilinear object path)."""

from portbench.metrics.device_idle_pct import read  # noqa: F401
