# Frozen copy of atm_raytracer_tpu_torch/models/camera.py (commit 05461a6); the benchmark's reference, not the program.
"""Camera models: pixel → (elevation, azimuth) ray parameters.

Fast camera (separable), reference src/generator/generators/fast.rs:111-125:
azimuth depends only on the pixel column, elevation only on the row
(README.md:273-279). Host f64.

Rectilinear camera (true pinhole), reference rectilinear.rs:78-100: the
per-pixel direction of the camera-frame vector [forward = z_focal, right =
x, up = -y] rotated by nalgebra's ``from_euler_angles(roll=0, pitch=-tilt,
yaw=direction)`` = R_z(yaw)·R_y(pitch). Host f64 grids, plus a float32
device twin that renderers derive on the device.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


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


def rectilinear_column_azimuths(width: int, fov: float, direction: float) -> np.ndarray:
    """Per-column azimuth of the tilt-0 pinhole, degrees ([W] f64): at pitch
    0 the per-pixel direction reduces to ``direction + atan2(x_off,
    z_focal)``, constant down each image column."""
    x = (np.arange(width) - width // 2).astype(np.float64)
    z = width / 2.0 / np.tan(np.deg2rad(fov) / 2.0)
    return direction + np.rad2deg(np.arctan2(x, z))


def _euler_zyx(yaw: float, pitch: float) -> np.ndarray:
    """R_z(yaw) @ R_y(pitch) (roll = 0), as nalgebra's from_euler_angles."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    return rz @ ry


@functools.lru_cache(maxsize=8)
def rectilinear_ray_params(width: int, height: int, fov: float, tilt: float,
                           direction: float) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel (elevation_rad [H, W], direction_rad [H, W]), host f64
    (rectilinear.rs:78-100): z = (W/2)/tan(fov/2) pixels, camera vector
    (z, x_off, -y_off) rotated by yaw = direction and pitch = -tilt;
    elevation = asin(d_z), direction = atan2(d_y, d_x).

    Memoized, since 1080p grids cost ~150 ms of host trig; the arrays are
    read-only.
    """
    x = (np.arange(width) - width // 2).astype(np.float64)
    y = (np.arange(height) - height // 2).astype(np.float64)
    z = width / 2.0 / np.tan(np.deg2rad(fov) / 2.0)
    rot = _euler_zyx(np.deg2rad(direction), -np.deg2rad(tilt))
    v = np.stack([
        np.full((height, width), z),
        np.broadcast_to(x[None, :], (height, width)),
        np.broadcast_to(-y[:, None], (height, width)),
    ], axis=-1)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    d = v @ rot.T
    elevation = np.arcsin(np.clip(d[..., 2], -1.0, 1.0))
    direction_r = np.arctan2(d[..., 1], d[..., 0])
    elevation.setflags(write=False)
    direction_r.setflags(write=False)
    return elevation, direction_r


def rectilinear_ray_params_device(width: int, height: int, fov: float, tilt: float,
                                  direction: float, device):
    """Float32 twin of ``rectilinear_ray_params`` on ``device``:
    (elevation_rad [H, W], direction_rad [H, W]) from the same camera
    algebra, with every host constant rounded to float32 first, as the JAX
    package's jitted twin does."""
    f32 = np.float32
    x = torch.arange(width, dtype=torch.float32, device=device) - float(width // 2)
    y = torch.arange(height, dtype=torch.float32, device=device) - float(height // 2)
    z = f32(width / 2.0 / math.tan(math.radians(fov) / 2.0))
    yaw = math.radians(direction)
    pitch = -math.radians(tilt)
    cy, sy = f32(math.cos(yaw)), f32(math.sin(yaw))
    cp, sp = f32(math.cos(pitch)), f32(math.sin(pitch))
    # v = (z, x, -y); d = R_z(yaw) @ R_y(pitch) @ v
    v1 = x[None, :]
    v2 = -y[:, None]
    n = torch.sqrt(float(z * z) + v1 * v1 + v2 * v2)  # [H, W]
    a0 = float(cp * z) + float(sp) * v2
    a2 = float(-sp * z) + float(cp) * v2
    d0 = float(cy) * a0 - float(sy) * v1
    d1 = float(sy) * a0 + float(cy) * v1
    elevation = torch.asin((a2 / n).clamp(-1.0, 1.0))
    return elevation, torch.atan2(d1, d0)
