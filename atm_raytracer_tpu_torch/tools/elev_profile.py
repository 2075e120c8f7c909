"""output-elev-profile: terrain elevation vs distance along one azimuth.

Counterpart of ``atm_raytracer_tpu/tools/elev_profile.py`` (reference
src/elev_profile.rs): the host f64 geodesic walk from the configured
viewpoint, the terrain's elevation at each step, rows ``x\\televation``.
"""

from __future__ import annotations

import numpy as np

from ..config import parse_config
from ..terrain.store import Terrain


def run(args) -> int:
    if args.step <= 0.0:
        raise ValueError("step must be positive")
    config = parse_config(args.input)
    terrain = Terrain.from_folder(config.scene.terrain_folder)
    pos = config.view.position
    xs = np.arange(0.0, args.cutoff + args.step * 0.5, args.step)
    lats, lons = config.earth_shape.coords_at_dist_host(
        pos.latitude, pos.longitude, args.azim, xs
    )
    for x, la, lo in zip(xs, np.atleast_1d(lats), np.atleast_1d(lons)):
        print(f"{x:g}\t{terrain.get_elev_or0(float(la), float(lo)):g}")
    return 0


def add_parser(subparsers):
    p = subparsers.add_parser("output-elev-profile",
                              help="Output elevation profile", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("input", help="Path to the input file")
    p.add_argument("-a", "--azim", dest="azim", type=float, default=0.0)
    p.add_argument("-s", "--step", dest="step", type=float, default=50.0)
    p.add_argument("-c", "--cutoff-dist", dest="cutoff", type=float, default=10000.0)
    p.set_defaults(func=run)
