# Frozen copy of atm_raytracer_tpu_torch/ops/composite.py (commit 05461a6); the benchmark's reference, not the program.
"""Front-to-back alpha compositing + fog — the reference's draw_image core.

Counterpart of ``atm_raytracer_tpu/ops/composite.py`` (renderer/mod.rs:
367-414): result += color·accum_negα·α; accum_negα *= (1−α); the remainder
goes to the sky color, or the fog color when fog is configured. Hits arrive
as fixed-K slots sorted by march position; invalid slots carry alpha 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from .coloring import (
    ColoringParams,
    color_hits,
    fog_color,
    on_device,
    quantize_u8_grid,
    sky_color,
)


def apply_fog(color: torch.Tensor, path_length: torch.Tensor,
              fog_dist: float) -> torch.Tensor:
    """coeff = 1 − exp(−path_length/fog_dist), mixed toward rgb(160,160,160)
    and truncated to the u8 grid (renderer/mod.rs:367-376)."""
    coeff = 1.0 - torch.exp(-path_length / fog_dist)
    fogc = on_device(fog_color(), color.device)
    return quantize_u8_grid(color * (1.0 - coeff[..., None]) + fogc * coeff[..., None])


def composite(coloring: ColoringParams, fog_distance: Optional[float], valid,
              alpha, distance, elevation, path_length, normal, kind, rgb,
              light_dir: Optional[torch.Tensor] = None):
    """[..., K] hit fields → the composited image [..., 3] uint8.
    ``light_dir``: a per-frame light override (``color_hits``)."""
    colors = color_hits(coloring, distance, elevation, normal, kind, rgb, light_dir)
    if fog_distance is not None:
        colors = apply_fog(colors, path_length, fog_distance)
        def_color = on_device(fog_color(), colors.device)
    else:
        def_color = on_device(sky_color(coloring), colors.device)

    a = torch.where(valid, alpha, torch.zeros_like(alpha))
    # The reference re-quantizes the running sum to the u8 grid after EVERY
    # trace point (add() returns Rgb<u8>: renderer/mod.rs:378-383,406,410,
    # utils/mod.rs:24-29). Fold in u8-count space, where integer-valued
    # floats are exact, truncating after every slot. An invalid slot's
    # fields are whatever the hit path left there (an extrapolated path
    # length can overflow the fog's exp), so its color is zeroed, not only
    # its alpha: NaN · 0 would blacken the pixel.
    colors255 = torch.where(valid[..., None], torch.round(colors * 255.0), 0.0)
    def255 = torch.round(def_color * 255.0)
    result = torch.zeros(colors.shape[:-2] + (3,), dtype=torch.float32,
                         device=colors.device)
    accum = torch.ones(a.shape[:-1], dtype=torch.float32, device=colors.device)
    for i in range(a.shape[-1]):
        step = colors255[..., i, :] * (accum * a[..., i])[..., None]
        result = torch.trunc((result + step).clamp(0.0, 255.0))
        accum = accum * (1.0 - a[..., i])
    result = torch.trunc((result + def255 * accum[..., None]).clamp(0.0, 255.0))
    return result.to(torch.uint8)
