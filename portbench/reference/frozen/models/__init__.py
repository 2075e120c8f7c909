# Frozen copy of atm_raytracer_tpu_torch/models/__init__.py (commit 05461a6); the benchmark's reference, not the program.
"""Earth models and the Fast camera."""
