"""The comparison that decides ``correct``: a frame the program served
against the reference's render of the same frame.

Five numbers a frame, each the worst over the frames checked:

- ``image_px_pct``: % of pixels with a channel more than 2 counts off;
- ``valid_pct``: % of hit slots whose ``valid`` differs;
- ``kind_pct``: % of slots valid on both sides whose ``kind`` differs;
- ``key_p99``: the 99th percentile of |key difference| over slots valid
  on both sides, in march steps;
- ``dist_p99_m``: the same of the hit distance, in meters.

A frame whose shapes differ from the reference's reads 100 % and inf.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("image_px_pct", "valid_pct", "kind_pct", "key_p99", "dist_p99_m")
FIELDS = ("valid", "key", "distance", "kind")


def host_fields(hits) -> dict:
    """The hit fields that decide the image, on the host."""
    return {f: getattr(hits, f).detach().cpu().numpy() for f in FIELDS}


def _p99(x: np.ndarray) -> float:
    """The 99th percentile, a NaN counted as inf; 0 for no slot."""
    return float(np.percentile(np.where(np.isnan(x), np.inf, x), 99.0)) if x.size else 0.0


def frame_numbers(image, fields: dict, ref_image, ref_fields: dict) -> dict:
    """The five numbers of one frame: the program's ``image`` and hit
    ``fields`` against the reference's."""
    worst = {"image_px_pct": 100.0, "valid_pct": 100.0, "kind_pct": 100.0,
             "key_p99": math.inf, "dist_p99_m": math.inf}
    image, ref_image = np.asarray(image), np.asarray(ref_image)
    if image.shape != ref_image.shape or any(
            fields[f].shape != ref_fields[f].shape for f in FIELDS):
        return worst
    diff = np.abs(image.astype(np.int16) - ref_image.astype(np.int16)).max(axis=-1)
    va, vb = fields["valid"].astype(bool), ref_fields["valid"].astype(bool)
    both = va & vb
    dk = np.abs(fields["key"][both].astype(np.float64) - ref_fields["key"][both])
    dd = np.abs(fields["distance"][both].astype(np.float64) - ref_fields["distance"][both])
    return {
        "image_px_pct": 100.0 * float((diff > 2).mean()),
        "valid_pct": 100.0 * float((va != vb).mean()),
        "kind_pct": (100.0 * float((fields["kind"][both] != ref_fields["kind"][both]).mean())
                     if both.any() else 0.0),
        "key_p99": _p99(dk),
        "dist_p99_m": _p99(dd),
    }


def worst(per_frame) -> dict:
    """Each number's worst reading over the frames checked."""
    return {k: max(f[k] for f in per_frame) for k in NUMBERS}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN is never within)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
