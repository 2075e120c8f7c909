# Frozen copy of atm_raytracer_tpu_torch/ops/coloring.py (commit 05461a6); the benchmark's reference, not the program.
"""Coloring: Simple + Shading with the Legacy/Improved palettes (PyTorch).

Counterpart of ``atm_raytracer_tpu/ops/coloring.py`` (reference
src/coloring/). Colors are truncated to the u8 grid where the reference
casts ``as u8`` (truncate and saturate) before fog and compositing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ColoringParams:
    """Lowered coloring parameters."""

    kind: str  # "Simple" | "Shading"
    water_level: float = 0.0
    max_distance: float = 0.0  # Simple only
    ambient_light: float = 0.4  # Shading only
    light_dir: Optional[Tuple[float, float, float]] = None  # global cartesian
    palette: str = "Improved"


def on_device(values, device, dtype=torch.float32) -> torch.Tensor:
    """Host constants as a tensor on ``device`` without a host sync: a CUDA
    upload goes non-blocking from page-locked memory (a pageable ``.to``
    waits for the device's queue to drain, which would stall a banded
    render's loop)."""
    t = torch.as_tensor(np.asarray(values)).to(dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def quantize_u8_grid(x: torch.Tensor) -> torch.Tensor:
    """(x*255) as u8 / 255: Rust float→int casts truncate and saturate."""
    return torch.trunc(x.clamp(0.0, 1.0) * 255.0) / 255.0


def _hsv(h, s, v):
    """hsv → rgb matching simple.rs:57-87 (h degrees, wrapped)."""
    h = torch.remainder(h, 360.0)
    h = torch.where(h < 0.0, h + 360.0, h)
    c = v * s
    x = c * (1.0 - torch.abs(torch.remainder(h / 60.0, 2.0) - 1.0))
    m = v - c
    zeros = torch.zeros_like(c)
    sector = torch.floor(h / 60.0).to(torch.int32)

    def select(choices, default):
        out = default
        for i in reversed(range(len(choices))):  # first match wins
            out = torch.where(sector == i, choices[i], out)
        return out

    rp = select([c, x, zeros, zeros, x], c)
    gp = select([x, c, c, x, zeros], zeros)
    bp = select([zeros, zeros, x, c, c], x)
    return torch.stack([rp + m, gp + m, bp + m], dim=-1)


def _palette_colors(palette: str):
    if palette == "Legacy":  # shading.rs:33-56
        thr = (300.0, 1200.0, 1800.0, 3000.0)
        cols = np.array(
            [[0.0, 1.0, 0.0], [0.6, 1.0, 0.0], [0.5, 0.5, 0.5], [1.0, 1.0, 1.0]],
            np.float32,
        )
        sky = np.array([0.11, 0.11, 0.11], np.float32)
        water = np.array([0.0, 0.5, 1.0], np.float32)
    else:  # Improved, shading.rs:57-80
        thr = (300.0, 1000.0, 1800.0, 3000.0)
        cols = np.array(
            [[0.4, 0.8, 0.3], [0.77, 0.84, 0.4], [0.41, 0.52, 0.4], [0.85, 0.92, 0.95]],
            np.float32,
        )
        sky = np.array([0.23, 0.41, 0.55], np.float32)
        water = np.array([0.23, 0.41, 0.55], np.float32)
    return thr, cols, sky, water


def _elev_ramp(elev: torch.Tensor, palette: str) -> torch.Tensor:
    thr, cols, _, _ = _palette_colors(palette)
    t1, t2, t3, t4 = thr
    g, base, mid, top = [on_device(c, elev.device) for c in cols]

    def lerp(a, b, p):
        return a * (1.0 - p[..., None]) + b * p[..., None]

    p12 = ((elev - t1) / (t2 - t1)).clamp(0.0, 1.0)
    p23 = ((elev - t2) / (t3 - t2)).clamp(0.0, 1.0)
    p34 = ((elev - t3) / (t4 - t3)).clamp(0.0, 1.0)
    return torch.where(
        (elev < t2)[..., None],
        lerp(g, base, p12),
        torch.where((elev < t3)[..., None], lerp(base, mid, p23), lerp(mid, top, p34)),
    )


def color_hits(params: ColoringParams, distance, elevation, normal, kind, rgb,
               light_dir: Optional[torch.Tensor] = None):
    """color_for_pixel over all hit slots: [..., K] fields → [..., K, 3]
    on the u8 grid. ``light_dir`` (float32, [3] or broadcastable against
    ``normal``, e.g. [F, 1, 1, 1, 3] for a sweep's frames) overrides
    ``params.light_dir`` under Shading."""
    if params.kind == "Simple":
        dist_ratio = distance / params.max_distance
        mul = 1.0 - dist_ratio * 0.6
        # Rgb([0, (128*mul) as u8, (255*mul) as u8]) — simple.rs:26-27
        water = torch.stack(
            [torch.zeros_like(mul),
             torch.trunc((128.0 * mul).clamp(0.0, 255.0)) / 255.0,
             torch.trunc((255.0 * mul).clamp(0.0, 255.0)) / 255.0],
            dim=-1,
        )
        # land: HSV ramp (simple.rs:29-43)
        elev_ratio = elevation / 4500.0
        powed = torch.where(
            elev_ratio < 0.0,
            -torch.pow((-elev_ratio).clamp(min=0.0), 0.65),
            torch.pow(elev_ratio.clamp(min=0.0), 0.65),
        )
        h = 120.0 - 240.0 * powed
        v = torch.where(
            elev_ratio > 0.7, 2.1 - elev_ratio * 2.0, 0.9 - elev_ratio / 0.7 * 0.2
        ) * (1.0 - dist_ratio * 0.6)
        s = 1.0 - dist_ratio * 0.9
        land = quantize_u8_grid(_hsv(h, s, v))
        return torch.where((elevation <= params.water_level)[..., None], water, land)

    # Shading: ambient + (1 − ambient)·max(L·N, 0)² (shading.rs:108-112)
    light = on_device(params.light_dir, normal.device) if light_dir is None else light_dir
    light_dot = (normal * light).sum(-1).clamp(min=0.0)
    brightness = params.ambient_light + (1.0 - params.ambient_light) * light_dot ** 2
    _, _, _, water_col = _palette_colors(params.palette)
    terrain_col = torch.where(
        (elevation <= params.water_level)[..., None],
        on_device(water_col, normal.device),
        _elev_ramp(elevation, params.palette),
    )
    base = torch.where((kind == 1)[..., None], rgb, terrain_col)
    return quantize_u8_grid(base * brightness[..., None])


def sky_color(params: ColoringParams) -> np.ndarray:
    if params.kind == "Simple":
        return np.array([28, 28, 28], np.float32) / 255.0  # simple.rs:47-49
    _, _, sky, _ = _palette_colors(params.palette)
    return np.trunc(sky * 255.0) / 255.0


def fog_color() -> np.ndarray:
    return np.array([160, 160, 160], np.float32) / 255.0  # renderer/mod.rs:369
