"""device_idle_pct.culled: device_idle_pct in the cells of the culled tilted path, which report
frame_ms.culled: their frames are paced by the device and spread under 2 %
run to run, where host-paced frames spread ~10 %."""

from portbench.metrics.device_idle_pct import read  # noqa: F401
