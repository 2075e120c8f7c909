# Frozen copy of atm_raytracer_tpu_torch/generators/base.py (commit 05461a6); the benchmark's reference, not the program.
"""Hit buffers: the dense fixed-K replacement for Vec<TracePoint>.

Counterpart of ``atm_raytracer_tpu/generators/base.py`` (reference
generators/mod.rs:14-80): each pixel's variable-length trace points become
K fixed slots with a validity mask, sorted ascending by march position.
``kind``: 0 = terrain, 1 = RGBA object; ``rgba[..., 3]`` holds the alpha.
Positions are observer-relative degrees.

``fetch_flat`` brings a frame's image to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class HitBuffer:
    valid: torch.Tensor  # [H, W, K] bool
    key: torch.Tensor  # [H, W, K] f32 march sort position (k + prop)
    dlat: torch.Tensor  # [H, W, K] degrees from observer
    dlon: torch.Tensor
    distance: torch.Tensor  # [H, W, K] meters (x at hit)
    elevation: torch.Tensor  # terrain elevation at the hit
    path_length: torch.Tensor
    normal: torch.Tensor  # [H, W, K, 3]
    kind: torch.Tensor  # [H, W, K] int32: 0 terrain / 1 rgba
    rgba: torch.Tensor  # [H, W, K, 4]


@dataclasses.dataclass
class RenderResult:
    """One rendered frame: host image + device hit buffers + angle grids."""

    image: Optional[np.ndarray]  # [H, W, 3] uint8; None in a loaded artifact
    hits: HitBuffer
    # Fast: [H] and [W] (azimuth wrapped to [0, 360)); Rectilinear: [H, W]
    # each, host f64 (azimuth from atan2, in (-180, 180])
    elevation_deg: np.ndarray
    azimuth_deg: np.ndarray
    observer: tuple  # (lat0, lon0, alt_abs)
    culled_rounds: Optional[int] = None  # rounds the culled Rectilinear path ran


def fetch_flat(t: torch.Tensor) -> np.ndarray:
    """A tensor's data on the host, flattened."""
    return t.detach().reshape(-1).cpu().numpy()
