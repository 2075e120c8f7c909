"""frame_ms.tilt0: frame_ms in the cells of the tilt-0 Rectilinear path, read per layer:
its frames are paced by the host's work a new view pays (the camera's [H, W] angles),
whose speed on a shared host swings from one process to the next by more than the
largest bound an end-to-end metric may have."""

from portbench.metrics.frame_ms import read  # noqa: F401
