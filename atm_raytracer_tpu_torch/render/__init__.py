"""Image output and the annotation overlays."""
