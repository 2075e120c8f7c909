"""Overlay annotations: azimuth/elevation ticks, eye-level & flat-horizon lines.

Counterpart of ``atm_raytracer_tpu/render/annotate.py``, drawn the same way
on the host (numpy + PIL) after the render. The reference's renderer overlays
(src/renderer/mod.rs): tick generation with per-pixel dedupe keeping the
larger tick (mod.rs:227-268), label decimal inference (mod.rs:208-225),
nearest-pixel angle lookup with the 1.5×-gap validity rule (mod.rs:39-80),
the magenta eye-level line (elevation 0°) and — on flat shapes with
refraction — the blue flat-Earth horizon at arccos(1/n(h_obs))
(mod.rs:325-365,416-431). Text uses DejaVuSans (same face the reference
embeds, via matplotlib's bundled copy) through PIL.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from ..config import Params, Tick

WHITE = (255, 255, 255)
EYE_LEVEL_COLOR = (255, 128, 255)  # mod.rs:430
FLAT_HORIZON_COLOR = (0, 128, 255)  # mod.rs:427


def _font(size: int = 15):
    try:
        import matplotlib

        path = f"{matplotlib.get_data_path()}/fonts/ttf/DejaVuSans.ttf"
        return ImageFont.truetype(path, size)
    except (ImportError, OSError):  # no matplotlib, or no font file in it
        return ImageFont.load_default()


def num_decimals(x: float) -> int:
    """Label decimal inference (mod.rs:208-216; unit-tested at mod.rs:439-460)."""
    for i in range(10):
        mul_x = x * 10.0**i
        if abs(round(mul_x) - mul_x) < 0.001:
            return i
    return 10


def _round_decimals(ticks: List[Tick]) -> int:
    vals = [num_decimals(t.angle()) for t in ticks if t.labelled]
    return max(vals) if vals else 0


def _diff_azimuth(az1: float, az2: float) -> float:
    d = az1 - az2
    if d < -180.0:
        return d + 360.0
    if d > 180.0:
        return d - 360.0
    return d


def _azimuth_to_x(azimuth: float, row_az: np.ndarray) -> Optional[int]:
    """Nearest column for an azimuth; None if outside 1.5× the pixel gap
    (mod.rs:39-59)."""
    diffs = np.abs([_diff_azimuth(azimuth, a) for a in row_az])
    cand = int(np.argmin(diffs))
    neighbor = 1 if cand == 0 else cand - 1
    per_pixel = abs(_diff_azimuth(float(row_az[cand]), float(row_az[neighbor])))
    return cand if diffs[cand] < per_pixel * 1.5 else None


def _elevation_to_y(elev: float, col_elev: np.ndarray) -> Optional[int]:
    """Nearest row for an elevation, same rule (mod.rs:60-80, and the
    constant-elevation lines of mod.rs:325-343)."""
    diffs = np.abs(col_elev - elev)
    cand = int(np.argmin(diffs))
    neighbor = 1 if cand == 0 else cand - 1
    per_pixel = abs(float(col_elev[cand]) - float(col_elev[neighbor]))
    return cand if diffs[cand] < per_pixel * 1.5 else None


def _expand_ticks(
    ticks: List[Tick], params: Params, vertical: bool
) -> List[Tuple[float, str, int, bool]]:
    """→ [(lookup_angle, label, size, labelled)] (mod.rs:82-201).

    Single ticks label the RAW configured angle (mod.rs:98,158 format the
    config value directly — a Single at -5° is labelled "-5", not "355").
    Multiple ticks enumerate bias + k·step across the frame's angular span
    and label the wrapped angle ([0,360) azimuths mod.rs:118-124, [-90,90]
    mirror-wrapped elevations mod.rs:179-185). The pixel lookup uses the
    unwrapped azimuth (mod.rs:125) but the WRAPPED elevation (mod.rs:186).
    Per-pixel dedupe happens in the caller.
    """
    frame = params.view.frame
    out = params.output
    decimals = _round_decimals(ticks)
    items: List[Tuple[float, str, int, bool]] = []
    for tick in ticks:
        if tick.kind == "Single":
            angles = [tick.azimuth]
        else:
            if vertical:
                aspect = out.height / out.width
                lo = frame.tilt - frame.fov * aspect / 2.0
                hi = frame.tilt + frame.fov * aspect / 2.0
            else:
                lo = frame.direction - frame.fov / 2.0
                hi = frame.direction + frame.fov / 2.0
            cur = math.ceil((lo - tick.bias) / tick.step) * tick.step + tick.bias
            angles = []
            while cur < hi:
                angles.append(cur)
                cur += tick.step
        for ang in angles:
            if tick.kind == "Single":
                lookup, disp = ang, ang
            elif vertical:
                disp = ang
                if disp < -90.0:
                    disp = -180.0 - disp
                elif disp > 90.0:
                    disp = 180.0 - disp
                lookup = disp  # mod.rs:186 — wrapped elevation drives the row
            else:
                disp = ang
                if disp < 0.0:
                    disp += 360.0
                elif disp >= 360.0:
                    disp -= 360.0
                lookup = ang  # mod.rs:125 — unwrapped azimuth drives the column
            items.append((lookup, f"{disp:.{decimals}f}", tick.size, tick.labelled))
    return items


def annotate_image(
    image_u8: np.ndarray,
    params: Params,
    elevation_deg: np.ndarray,  # [H] or [H, W]
    azimuth_deg: np.ndarray,  # [W] or [H, W]
    observer_alt: float,
) -> np.ndarray:
    """Draw ticks + eye-level + flat-horizon overlays; returns a new array."""
    img = Image.fromarray(np.asarray(image_u8, np.uint8), "RGB")
    draw = ImageDraw.Draw(img)
    font = _font(15)
    out = params.output

    el = np.asarray(elevation_deg)
    az = np.asarray(azimuth_deg)
    row_az = az[0] if az.ndim == 2 else az  # top row (mod.rs:40)
    col_el = el[:, 0] if el.ndim == 2 else el  # left column (mod.rs:63)

    # horizontal (azimuth) ticks
    horiz = {}
    for ang, label, size, labelled in _expand_ticks(out.ticks, params, vertical=False):
        x = _azimuth_to_x(ang, row_az)
        if x is None:
            continue
        if x not in horiz or horiz[x][0] < size:
            horiz[x] = (size, labelled, label)
    for x, (size, labelled, label) in horiz.items():
        draw.line([(x, 0), (x, size)], fill=WHITE)
        if labelled:
            draw.text((x - 8, size + 5), label, fill=WHITE, font=font)

    vert = {}
    for ang, label, size, labelled in _expand_ticks(
        out.vertical_ticks, params, vertical=True
    ):
        y = _elevation_to_y(ang, col_el)
        if y is None:
            continue
        if y not in vert or vert[y][0] < size:
            vert[y] = (size, labelled, label)
    for y, (size, labelled, label) in vert.items():
        draw.line([(0, y), (size, y)], fill=WHITE)
        if labelled:
            draw.text((size + 5, y - 7), label, fill=WHITE, font=font)

    # constant-elevation polylines (mod.rs:325-365)
    def draw_const_elev(elev_value: float, color):
        if el.ndim == 2:
            cols = el.T  # [W, H]
        else:
            cols = np.broadcast_to(el, (image_u8.shape[1], el.shape[0]))
        y_old = _elevation_to_y(elev_value, cols[0])
        for x in range(1, image_u8.shape[1]):
            y_new = _elevation_to_y(elev_value, cols[x])
            if y_old is not None and y_new is not None:
                draw.line([(x - 1, y_old), (x, y_new)], fill=color)
            y_old = y_new

    if (
        out.show_flat_horizon
        and params.model.to_shape().is_flat
        and not params.straight_rays
    ):
        n_obs = float(params.atmosphere.n(observer_alt, params.wavelength))
        elev_h = math.degrees(math.acos(1.0 / n_obs))
        draw_const_elev(elev_h, FLAT_HORIZON_COLOR)
    if out.show_eye_level:
        draw_const_elev(0.0, EYE_LEVEL_COLOR)

    return np.asarray(img)
