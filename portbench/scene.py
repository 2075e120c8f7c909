"""The inputs of a cell, made from its configuration file and the seed.

A configuration file (``configs/<name>.json``) holds the scene as the
program's config dict (``scene``), how its terrain is made (``terrain``)
and, where it has them, its objects (``objects``): the rule that places
them and the positions that rule gives at the configuration's size.
The terrain is made on the device in one call and handed to both sides as
one host array of integer meters; each side builds its own tile store from
it. The seed orders the views (``views.py``) and draws the frames checked.
Nothing here imports the program.
"""

from __future__ import annotations

import copy
import math
from pathlib import Path

import numpy as np
import torch

def analytic_hills(lat, lon, base_lat=49.0, base_lon=21.0):
    """Smooth deterministic landscape, meters; torch float64 tensors in
    degrees. Copied from ``tests/fixtures.py::analytic_hills`` (numpy
    there), which this package does not import: that file imports the JAX
    package."""
    la = lat - base_lat
    lo = lon - base_lon
    return (
        300.0
        + 250.0 * torch.sin(2 * math.pi * la * 3.0) * torch.cos(2 * math.pi * lo * 2.0)
        + 120.0 * torch.sin(2 * math.pi * (la * 7.0 + lo * 5.0))
    )


def tile_box(scene: dict):
    """The 1-degree tile keys the render can touch: a copy of the program's
    ``generators/fast.py::terrain_bbox`` (observer +- max_distance and a
    margin), which does not depend on the direction."""
    pos = scene["view"]["position"]
    lat0, lon0 = float(pos["latitude"]), float(pos["longitude"])
    d_deg = float(scene["view"]["frame"]["max_distance"]) / 90_000.0 + 0.1
    lat_pole = min(abs(lat0) + d_deg, 90.0)
    coslat = max(0.01, math.cos(math.radians(lat_pole)))
    d_lon = min(d_deg / coslat, 180.0)
    lats = range(math.floor(lat0 - d_deg), math.floor(lat0 + d_deg) + 1)
    lons = range(math.floor(lon0 - d_lon), math.floor(lon0 + d_lon) + 1)
    return list(lats), list(lons)


def make_tiles(config: dict, device):
    """(keys, tiles): the tile keys (lat0, lon0) and one int16 host array
    [T, n, n] of integer meters, south-first rows, inclusive edges (the
    layout of ``tests/fixtures.py::tile_grid``), made on ``device`` in one
    call. The terrain is the configuration's, the same for every seed: a
    seed that moved the hills would change the work of every frame."""
    terrain_cfg = config["terrain"]
    if terrain_cfg["kind"] != "analytic_hills":
        raise ValueError(f"unknown terrain kind {terrain_cfg['kind']!r}")
    n = int(terrain_cfg["posts"])
    lats, lons = tile_box(config["scene"])
    base_lat, base_lon = float(terrain_cfg["base_lat"]), float(terrain_cfg["base_lon"])
    f = torch.arange(n, dtype=torch.float64, device=device) / (n - 1)
    lat = torch.tensor(lats, dtype=torch.float64, device=device)[:, None] + f  # [R, n]
    lon = torch.tensor(lons, dtype=torch.float64, device=device)[:, None] + f  # [C, n]
    grid = analytic_hills(lat[:, None, :, None], lon[None, :, None, :], base_lat, base_lon)
    tiles = torch.round(grid).to(torch.int16).reshape(len(lats) * len(lons), n, n)
    keys = [(la, lo) for la in lats for lo in lons]
    return keys, tiles.cpu().numpy()


def build_terrain(terrain_cls, tile_cls, keys, tiles):
    """A tile store of ``terrain_cls`` holding ``tiles`` as float32 tiles,
    as the program's loaders hand them over."""
    terrain = terrain_cls()
    for (la, lo), grid in zip(keys, tiles):
        terrain.add_tile(tile_cls(la, lo, grid.astype(np.float32)))
    return terrain


def write_texture(path) -> None:
    """A 64x64 RGBA checker with a fully transparent band (rows 24-39):
    texels of alpha 0 never count as hits. Copied from
    ``chip_smoke.py::write_texture``."""
    from PIL import Image

    yy, xx = np.mgrid[0:64, 0:64]
    check_ = ((xx // 8 + yy // 8) % 2).astype(bool)
    rgba = np.zeros((64, 64, 4), np.uint8)
    rgba[..., 0] = np.where(check_, 230, 30)
    rgba[..., 1] = 120
    rgba[..., 2] = np.where(check_, 30, 230)
    rgba[..., 3] = 255
    rgba[24:40, :, 3] = 0
    Image.fromarray(rgba, "RGBA").save(path)


def rule_positions(config: dict, scene: dict, hits) -> list:
    """Where the configuration's rules stand its objects: [latitude,
    longitude] a rule, the terrain point of its band of columns that the
    object-free Fast frame (``hits``, the reference's, at the rule's
    direction) hits nearest ``d_share`` of its farthest hit. The rule of
    ``chip_smoke.py::object_headline``, copied."""
    width = int(scene["output"]["width"])
    pos = scene["view"]["position"]
    lat0, lon0 = float(pos["latitude"]), float(pos["longitude"])
    valid = hits.valid[..., 0].cpu().numpy()
    dist, dlat, dlon = (getattr(hits, f)[..., 0].cpu().numpy()
                        for f in ("distance", "dlat", "dlon"))
    d_far = float(dist[valid].max())
    positions = []
    for rule in config["objects"]["rules"]:
        c0, c1 = rule["cols"]
        cols = slice(int(c0 * width), max(int(c1 * width), int(c0 * width) + 1))
        gap = np.where(valid[:, cols], np.abs(dist[:, cols] - rule["d_share"] * d_far),
                       np.inf)
        if not np.isfinite(gap).any():
            raise RuntimeError(f"object placement: no terrain hit in columns {cols}")
        r, c = np.unravel_index(int(np.argmin(gap)), gap.shape)
        col = cols.start + int(c)
        positions.append([lat0 + float(dlat[r, col]), lon0 + float(dlon[r, col])])
    return positions


def objects_at(config: dict, positions: list, texture: Path) -> list:
    """The configuration's objects as config dicts, each rule's at its
    [latitude, longitude] in ``positions``; Billboards read ``texture``."""
    spec = config["objects"]
    objects = []
    for rule, (lat, lon) in zip(spec["rules"], positions, strict=True):
        shape = rule["shape"]
        if shape == "Billboard":
            shape = {"Billboard": dict(spec["billboard"], texture_path=str(texture))}
        objects.append({
            "position": {"latitude": float(lat), "longitude": float(lon),
                         "altitude": {"Relative": 0.0}},
            "shape": copy.deepcopy(shape), "color": dict(rule["color"])})
    return objects


def frame_dict(scene: dict, direction: float, tilt: float, generator: str,
               objects=None) -> dict:
    """One frame's config dict: the scene turned to ``direction``, tilted
    by ``tilt``, through ``generator``, with ``objects`` placed."""
    d = copy.deepcopy(scene)
    d["view"]["frame"]["direction"] = float(direction)
    d["view"]["frame"]["tilt"] = float(tilt)
    d.setdefault("output", {})["generator"] = generator
    if objects:
        d.setdefault("scene", {})["objects"] = copy.deepcopy(objects)
    return d
