# Frozen copy of atm_raytracer_tpu_torch/physics/__init__.py (commit 05461a6); the benchmark's reference, not the program.
"""Refraction physics: atmosphere model and the ray march."""
