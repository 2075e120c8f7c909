"""The table of peaks and the byte counts of the port's two Fast kernels.

Copied from ``chip_smoke.py`` (``bound``, ``k1_bound``, ``k2_bound``):
NVIDIA's H100 SXM data sheet at the full 700 W, and each kernel's input
read once and its output written once, counted from the frame's shapes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time the H100 could take: the larger of the bytes over the
    HBM rate and the float32 operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def k1_bytes(h_n: int, w_n: int, n_seg: int, frames: int = 1) -> int:
    """K1 (the first-crossing combine) at K = 1 over ``frames`` frames of
    [h_n, w_n]: each ray altitude and terrain sample read once, the
    segments written and the rays' death limits read once."""
    return 4 * frames * ((h_n + w_n) * (n_seg + 1) + h_n * w_n + h_n)


def k2_bytes(n_rays: int, n: int, coarse: int, l_floats: int) -> int:
    """K2 (the march) for ``n_rays`` rays of ``n`` steps: the altitudes and
    slopes in, the l(h) fit rows (``l_floats``) and the Hermite basis, the
    [B, N+1] altitudes and path lengths out."""
    return 4 * (2 * n_rays + l_floats + 4 * (coarse + 1) + 2 * n_rays * (n + 1))
