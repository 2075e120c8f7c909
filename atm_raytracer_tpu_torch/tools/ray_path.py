"""output-ray-paths: a fan of refracted rays as height-vs-distance columns.

Counterpart of ``atm_raytracer_tpu/tools/ray_path.py`` (reference
src/ray_path.rs): one ray per elevation angle, heights recorded where x
crosses an ``output_step`` boundary (ray_path.rs:76-91), printed as
gnuplot-ready columns (x, then one column per angle). The whole fan marches
in one batch on ``--device``: on a CUDA device the RK4 node loop is the
kernel ``csrc/march.cu``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import parse_config
from ..physics.atmosphere import Atmosphere
from ..physics.ray import RefractionTable, march_rays


def fan_heights(args, device):
    """(x [M] meters, heights [n_angles, M] meters) of the printed rows."""
    if args.angle_step <= 0.0:
        raise ValueError("step must be positive")
    config = parse_config(args.input)
    atm = Atmosphere(config.atmosphere)
    shape = config.earth_shape.to_shape()

    angles = []
    ang = args.min_ang
    while ang <= args.max_ang + 1e-12:
        angles.append(ang)
        ang += args.angle_step
    angles = np.asarray(angles, np.float64)

    n_steps = int(math.ceil(args.cutoff / args.ray_step))
    top = args.height + abs(math.tan(math.radians(
        max(abs(args.min_ang), abs(args.max_ang))))) * args.cutoff
    table = RefractionTable.build(
        atm, config.wavelength, h_lo=-2000.0,
        h_hi=float(min(max(20000.0, top * 1.2), 90000.0)), device=device,
    )
    h, _ = march_rays(
        float(args.height),
        torch.from_numpy(np.deg2rad(angles).astype(np.float32)).to(device),
        float(args.ray_step), n_steps, shape, table,
        straight=False,  # ray_path.rs:71 always casts bent rays
    )
    h = h.cpu().numpy().astype(np.float64)  # [n_angles, n_steps+1]

    xs_all = np.arange(n_steps + 1) * args.ray_step
    # ray_path.rs:80-83: record where x crosses an output_step boundary
    lo = np.floor((xs_all - args.ray_step / 2.0) / args.output_step)
    hi = np.floor((xs_all + args.ray_step / 2.0) / args.output_step)
    mask = lo != hi
    mask[0] = True  # the x = 0 row is pushed unconditionally (ray_path.rs:67,74)
    return xs_all[mask], h[:, mask]


def run(args) -> int:
    from ..cli import resolve_device

    xs, cols = fan_heights(args, resolve_device(args.device))
    for i in range(len(xs)):
        row = [f"{xs[i]:g}"] + [f"{cols[j, i]:g}" for j in range(cols.shape[0])]
        print("\t".join(row) + "\t")
    return 0


def add_parser(subparsers):
    p = subparsers.add_parser("output-ray-paths", help="Output ray paths",
                              add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("input", help="Path to the input file")
    p.add_argument("-h", "--height", dest="height", type=float, default=2.0)
    p.add_argument("-a", "--min-ang", dest="min_ang", type=float, default=-1.0)
    p.add_argument("-b", "--max-ang", dest="max_ang", type=float, default=1.0)
    p.add_argument("-s", "--angle-step", dest="angle_step", type=float, default=0.1)
    p.add_argument("-r", "--ray-step", dest="ray_step", type=float, default=50.0)
    p.add_argument("-c", "--cutoff-dist", dest="cutoff", type=float, default=10000.0)
    p.add_argument("-o", "--output-step", dest="output_step", type=float, default=50.0)
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device to march on (default: cuda)")
    p.set_defaults(func=run)
