"""The plain reference a cell's outputs are judged against.

It is the frozen copy of the program's plain paths in ``frozen/`` (plain
PyTorch, no kernel), driven from the benchmark's own inputs: the frame's
config dict and the raw tile array. It lowers the dict, builds its own tile
store, pack, refraction table and camera, and takes nothing the program
made. It imports neither JAX nor the JAX package nor the program.
"""

from __future__ import annotations

import torch

from .frozen.config import Config
from .frozen.generators.fast import render_fast
from .frozen.generators.interpolating import render_interpolating
from .frozen.generators.rectilinear_routes import render_rectilinear
from .frozen.terrain.store import Terrain, Tile


class Reference:
    """Renders frames of one scene on ``device`` by the plain paths."""

    def __init__(self, keys, tiles, device):
        from ..scene import build_terrain

        self.device = torch.device(device)
        self.terrain = build_terrain(Terrain, Tile, keys, tiles)

    def params(self, frame: dict):
        return Config.from_dict(frame).into_params(self.terrain)

    def render(self, frame: dict):
        """The frame's RenderResult: image on the host, hits on the device.
        Fast frames take ``render_fast`` (the banded render the program runs
        on a card equals it bit for bit, column by column); Rectilinear
        frames the route the port's ``render_rectilinear`` takes for them;
        InterpolatingRectilinear frames ``render_interpolating``."""
        params = self.params(frame)
        if params.output.generator == "Rectilinear":
            return render_rectilinear(params, self.terrain, self.device)
        if params.output.generator == "Fast":
            return render_fast(params, self.terrain, self.device)
        if params.output.generator == "InterpolatingRectilinear":
            return render_interpolating(params, self.terrain, self.device)
        raise ValueError(f"no reference route for {params.output.generator!r}")

    def close(self) -> None:
        """Drop the device copy of the terrain (the pack) this reference made."""
        self.terrain._pack_cache.clear()
