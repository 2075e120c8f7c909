"""Metadata viewer: re-render + per-pixel inspection (``view`` subcommand).

Counterpart of ``atm_raytracer_tpu/meta/viewer.py`` (reference FLTK GUI,
src/viewer/app.rs): the image is re-composited from the stored trace points
by the renderer's own compositor (app.rs:244 reuses renderer::draw_image),
on the device the caller names; a pixel shows its view direction and each
trace point's distance (km/mi), elevation (m/ft) and lat/lon in DMS
(app.rs:112-176).

Two modes:
* interactive (a matplotlib window, where a display exists): drag pans,
  the wheel zooms, a click or Space selects a pixel, Esc clears;
* headless: ``--pixel X Y`` prints the same text; ``--save-image`` writes
  the re-composited PNG.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import Config
from ..generators.base import RenderResult, fetch_flat
from ..ops.composite import composite
from ..render.image import save_png
from .serialize import load_metadata


def _render_from_metadata(config: Config, result: RenderResult,
                          device) -> np.ndarray:
    """The artifact's image [H, W, 3] u8, composited on ``device``."""
    coloring = config.view.coloring.into_coloring(
        config.view.frame, config.view.position, config.earth_shape
    )
    hits = result.hits.to(device)
    img = composite(
        coloring, config.view.fog_distance, hits.valid, hits.rgba[..., 3],
        hits.distance, hits.elevation, hits.path_length, hits.normal,
        hits.kind, hits.rgba[..., :3],
    )
    return fetch_flat(img).reshape(img.shape)


def _dms(value: float, pos: str, neg: str) -> str:
    """Degrees-minutes-seconds like viewer/app.rs:141-176."""
    hemi = pos if value >= 0 else neg
    v = abs(value)
    d = int(v)
    m = int((v - d) * 60)
    s = (v - d - m / 60) * 3600
    return f"{d}°{m:02d}'{s:05.2f}\"{hemi}"


def pixel_info(config: Config, result: RenderResult, x: int, y: int) -> str:
    """Text info for one pixel (viewer/app.rs:112-176)."""
    el = np.asarray(result.elevation_deg)
    az = np.asarray(result.azimuth_deg)
    elev_ang = float(el[y, x] if el.ndim == 2 else el[y])
    azim = float(az[y, x] if az.ndim == 2 else az[x])
    lines = [
        f"Pixel ({x}, {y})",
        f"View direction: azimuth {azim:.4f}°, elevation {elev_ang:.4f}°",
    ]
    hits = result.hits
    lat0, lon0, _ = result.observer
    any_hit = False
    for k in range(hits.valid.shape[-1]):
        if not bool(hits.valid[y, x, k]):
            continue
        any_hit = True
        dist = float(hits.distance[y, x, k])
        elev = float(hits.elevation[y, x, k])
        lat = lat0 + float(hits.dlat[y, x, k])
        lon = lon0 + float(hits.dlon[y, x, k])
        kind = "terrain" if int(hits.kind[y, x, k]) == 0 else "object"
        lines.append(
            f"Trace point {k} ({kind}): distance {dist / 1000.0:.3f} km "
            f"({dist / 1609.344:.3f} mi), elevation {elev:.1f} m "
            f"({elev / 0.3048:.1f} ft)"
        )
        lines.append(f"  position: {_dms(lat, 'N', 'S')} {_dms(lon, 'E', 'W')}")
    if not any_hit:
        lines.append("No trace points (sky).")
    return "\n".join(lines)


class ViewerApp:
    """Interactive pixel inspection with the reference window's events
    (src/viewer/app.rs:272-328): left-drag pans, the wheel zooms about the
    cursor, Space selects the pixel under the cursor, a click selects, Esc
    clears. Built on matplotlib's backend-independent event API, so the
    same logic runs in a window (TkAgg) and under Agg with synthetic events.
    """

    ZOOM_STEP = 1.25  # per wheel click (app.rs:291-305 zoom-about-point)
    CLICK_SLOP = 3.0  # data units of motion below which press+release selects
    HINT = "Click a pixel (Space selects, drag pans, wheel zooms)"

    def __init__(self, fig, ax_img, ax_info, config, result):
        self.fig = fig
        self.ax_img = ax_img
        self.ax_info = ax_info
        self.config = config
        self.result = result
        self._drag = None  # (x0, y0) grabbed, in data coordinates
        self._moved = 0.0
        self.cursor = None  # last (x, y) over the image
        ax_info.axis("off")
        self.text = ax_info.text(0.0, 1.0, self.HINT, va="top", fontsize=8,
                                 family="monospace", wrap=True)
        self.marker = ax_img.plot([], [], "r+", markersize=12)[0]
        for name, cb in (
            ("button_press_event", self.on_press),
            ("button_release_event", self.on_release),
            ("motion_notify_event", self.on_motion),
            ("scroll_event", self.on_scroll),
            ("key_press_event", self.on_key),
        ):
            fig.canvas.mpl_connect(name, cb)

    def select(self, x: float, y: float) -> None:
        h, w = self.result.image.shape[:2]
        xi, yi = int(round(x)), int(round(y))
        if not (0 <= xi < w and 0 <= yi < h):
            return
        self.marker.set_data([xi], [yi])
        self.text.set_text(pixel_info(self.config, self.result, xi, yi))
        self.fig.canvas.draw_idle()

    def clear(self) -> None:
        self.marker.set_data([], [])
        self.text.set_text(self.HINT)
        self.fig.canvas.draw_idle()

    def on_press(self, event):
        if event.inaxes is not self.ax_img or event.xdata is None:
            return
        self._drag = (event.xdata, event.ydata)
        self._moved = 0.0

    def on_motion(self, event):
        if event.inaxes is not self.ax_img or event.xdata is None:
            return
        self.cursor = (event.xdata, event.ydata)
        if self._drag is None:
            return
        x0, y0 = self._drag
        # shift the current limits so the grabbed point lands back under the
        # cursor; the cursor then maps to (x0, y0) again, so each motion
        # event's delta is incremental (app.rs:285-290,319-328)
        dx = event.xdata - x0
        dy = event.ydata - y0
        self._moved += abs(dx) + abs(dy)
        xlim = self.ax_img.get_xlim()
        ylim = self.ax_img.get_ylim()
        self.ax_img.set_xlim(xlim[0] - dx, xlim[1] - dx)
        self.ax_img.set_ylim(ylim[0] - dy, ylim[1] - dy)
        self.fig.canvas.draw_idle()

    def on_release(self, event):
        drag = self._drag
        self._drag = None
        if drag is None or event.xdata is None:
            return
        if self._moved <= self.CLICK_SLOP:
            self.select(event.xdata, event.ydata)

    def on_scroll(self, event):
        if event.inaxes is not self.ax_img or event.xdata is None:
            return
        scale = self.ZOOM_STEP ** (-event.step)  # up = zoom in
        x, y = event.xdata, event.ydata
        xlim = self.ax_img.get_xlim()
        ylim = self.ax_img.get_ylim()
        self.ax_img.set_xlim(x - (x - xlim[0]) * scale, x + (xlim[1] - x) * scale)
        self.ax_img.set_ylim(y - (y - ylim[0]) * scale, y + (ylim[1] - y) * scale)
        self.fig.canvas.draw_idle()

    def on_key(self, event):
        if event.key == " " and self.cursor is not None:
            self.select(*self.cursor)
        elif event.key == "escape":
            self.clear()


def build_viewer(config, result, title="", backend=None):
    """The figure and its ViewerApp (apart, so tests can drive it headless)."""
    import matplotlib

    if backend:
        matplotlib.use(backend)
    import matplotlib.pyplot as plt

    fig, (ax_img, ax_info) = plt.subplots(
        1, 2, figsize=(12.8, 8.0), gridspec_kw={"width_ratios": [4, 1]}
    )
    ax_img.imshow(result.image)
    ax_img.set_title(str(title))
    return fig, ViewerApp(fig, ax_img, ax_info, config, result)


def run_view(path, device, pixel=None, save_image: Optional[str] = None) -> int:
    """The ``view`` subcommand: load, re-composite on ``device``, then print
    a pixel, save the image, or open the window."""
    config, result = load_metadata(path)
    result.image = _render_from_metadata(config, result, device)

    if save_image:
        save_png(result.image, save_image)
        print(f"Saved re-rendered image to {save_image}")
    if pixel is not None:
        x, y = pixel
        print(pixel_info(config, result, x, y))
        return 0
    if save_image:
        return 0

    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        print("No display available; use --pixel X Y or --save-image.")
        return 1
    import matplotlib.pyplot as plt

    build_viewer(config, result, title=path, backend="TkAgg")
    plt.tight_layout()
    plt.show()
    return 0
