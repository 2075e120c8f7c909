"""frame_ms.rect_objects: frame_ms in the cells of the tilt-0 Rectilinear
object path, which report frame_ms.rect_objects: their ~6 s frames are paced
by the device, and their runs spread a few %, where host-paced frames spread
~10 %."""

from portbench.metrics.frame_ms import read  # noqa: F401
