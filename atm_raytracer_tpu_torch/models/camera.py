"""Fast (separable) camera: pixel row → elevation, column → azimuth.

Reference src/generator/generators/fast.rs:111-125: azimuth depends only on
the pixel column, elevation only on the row (README.md:273-279). Host f64.
"""

from __future__ import annotations

import numpy as np


def fast_ray_elevations(width: int, height: int, fov: float, tilt: float) -> np.ndarray:
    """Per-row elevation angle, degrees (fast.rs:111-118). [H] f64."""
    aspect = width / height
    y = (np.arange(height) - height // 2) / height
    return tilt - y * fov / aspect


def fast_ray_azimuths(width: int, height: int, fov: float, direction: float) -> np.ndarray:
    """Per-column azimuth, degrees, NOT wrapped to [0,360) (fast.rs:120-125)."""
    x = (np.arange(width) - width // 2) / width
    return direction + x * fov


def wrap_azimuth_deg(az):
    """Normalize to [0, 360) like fast.rs:67-72."""
    az = np.asarray(az)
    return np.where(az < 0.0, az + 360.0, np.where(az >= 360.0, az - 360.0, az))
