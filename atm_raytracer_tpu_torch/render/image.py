"""PNG output (host side): the ``image`` crate's PNG encode in the reference
(src/renderer/mod.rs:433-436)."""

from __future__ import annotations

import numpy as np


def save_png(image_u8: np.ndarray, path) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(image_u8, np.uint8), "RGB").save(path)


def load_png_rgb(path) -> np.ndarray:
    """A PNG's pixels as [H, W, 3] u8 (JAX ``render.image.load_png_rgb``)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))
