"""device_idle_pct.tilt0: device_idle_pct in the cells of the tilt-0 Rectilinear path,
which report their frame wall per layer (frame_ms.tilt0)."""

from portbench.metrics.device_idle_pct import read  # noqa: F401
