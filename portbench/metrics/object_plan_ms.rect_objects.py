"""object_plan_ms.rect_objects: object_plan_ms in the cells that report
frame_ms.rect_objects (the tilt-0 Rectilinear object path, whose
``objects.plan`` is ``ObjectSet.build`` alone: it plans no column windows)."""

from portbench.metrics.object_plan_ms import read  # noqa: F401
