"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; state
crosses from the JAX package through ``atm_raytracer_tpu_torch.interop``.
"""

import numpy as np
import pytest


def verify_tolerance(a, b):
    """The on-chip verify tolerance of bench.py:548-551 on two u8 images:
    (ok, fraction of pixels that moved at all, fraction moved > 2 counts)."""
    pix = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max(axis=-1)
    frac_any = float((pix > 0).mean())
    frac_big = float((pix > 2).mean())
    return frac_big <= 0.01 and frac_any <= 0.05, frac_any, frac_big


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    return torch.device("cuda")
