# Frozen copy of atm_raytracer_tpu_torch/terrain/__init__.py (commit 05461a6); the benchmark's reference, not the program.
"""Terrain tiles: readers, the tile store and device sampling."""
