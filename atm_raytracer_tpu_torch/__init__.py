"""PyTorch + CUDA port of atm_raytracer_tpu: refraction panoramas from
elevation tiles, rendered on an NVIDIA GPU.

The package mirrors the JAX package's layout and names. Plain tensor code is
PyTorch; the two hot loops of the Fast generator run as hand-written CUDA
kernels for Hopper (``csrc/``): the ray march, RK4 nodes to path lengths
(``physics.ray.march_rays``), and the first-crossing combine
(``ops.combine.terrain_crossing_segments``). On CPU tensors both run their
plain PyTorch versions.

Entry point: ``python -m atm_raytracer_tpu_torch.cli`` with the subcommands
``gen``, ``view``, ``output-atm``, ``output-ray-paths`` and
``output-elev-profile``.
"""
