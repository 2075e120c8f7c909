# Frozen copy of atm_raytracer_tpu_torch/ops/__init__.py (commit 05461a6); the benchmark's reference, not the program.
"""Device ops: the crossing combine, coloring and compositing."""
