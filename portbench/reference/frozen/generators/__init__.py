# Frozen copy of atm_raytracer_tpu_torch/generators/__init__.py (commit 05461a6); the benchmark's reference, not the program.
"""Generators: the Fast (separable) renderer."""
