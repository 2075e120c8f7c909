"""CLI: the reference's five subcommands with its flag surface, plus ``--device``.

Counterpart of ``atm_raytracer_tpu/cli.py`` (reference src/main.rs:17-39):
``gen`` (src/generator/params.rs:531-676), ``view`` (src/viewer/mod.rs),
``output-atm``, ``output-ray-paths`` and ``output-elev-profile``. Short
flags are preserved, including ``-h`` meaning height — use ``--help`` for
help on those subcommands.

``--device`` (``gen``, ``view``, ``output-ray-paths``) defaults to ``cuda``
and is never chosen for the user: without a GPU the command fails loudly;
``--device cpu`` runs the plain PyTorch versions of the kernels.

``gen`` renders the Fast, Rectilinear and InterpolatingRectilinear
generators, scene objects included, draws the annotation overlays, and
writes the metadata artifact (``--output-meta``). On a CUDA device, Fast
takes the banded render (``render_fast_streamed``, one progress line a
band); on the CPU, ``render_fast``. ``gen --shard`` splits the
frame over every visible device of ``--device``'s type
(``parallel.mesh``); with fewer than two it renders on the one device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path


def _add_gen_parser(subparsers):
    p = subparsers.add_parser("gen", help="Render a panorama", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-t", "--terrain", dest="terrain")
    p.add_argument("-l", "--lat", dest="lat", type=float)
    p.add_argument("-g", "--lon", dest="lon", type=float)
    p.add_argument("-a", "--alt", dest="alt", type=float)
    p.add_argument("-e", "--elev", dest="elev", type=float)
    p.add_argument("-d", "--dir", dest="dir", type=float)
    p.add_argument("-f", "--fov", dest="fov", type=float)
    p.add_argument("-i", "--tilt", dest="tilt", type=float)
    p.add_argument("-m", "--maxdist", dest="maxdist", type=float,
                   help="Cutoff distance in km (default: 150)")
    p.add_argument("--step", dest="step", type=float)
    p.add_argument("-R", "--radius", dest="radius", type=float,
                   help="Earth radius in km (conflicts with --flat)")
    p.add_argument("--flat", action="store_true")
    p.add_argument("-s", "--straight", action="store_true")
    p.add_argument("--output", dest="output")
    p.add_argument("--output-meta", dest="output_meta",
                   help="Write the per-pixel metadata artifact to this file")
    p.add_argument("--meta-format", dest="meta_format",
                   choices=["native", "reference"], default="native",
                   help="Metadata artifact format: native npz (default), "
                        "or gzip(bincode(AllData)) as transcribed from the "
                        "reference's src/generator/mod.rs:26-45. Its "
                        "atmosphere segment is a guess, so the reference's "
                        "own viewer is not known to read it; `view` does")
    p.add_argument("-w", "--width", dest="width", type=int)
    p.add_argument("-h", "--height", dest="height", type=int)
    p.add_argument("-c", "--config", dest="config")
    p.add_argument("--generator", dest="generator",
                   choices=["Fast", "Rectilinear", "InterpolatingRectilinear"],
                   help="Override the generator")
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--shard", action="store_true",
                   help="Split the frame over every visible device of --device's "
                        "type (an extension over the reference CLI, which is "
                        "single-node rayon)")
    p.set_defaults(func=run_gen)


def resolve_device(name: str):
    """The torch device to render on; CUDA must really be there."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is false; pass "
            "--device cpu to render with the plain PyTorch path"
        )
    return device


def run_gen(args) -> int:
    import torch

    from .config import Config, merge_cli, parse_config
    from .generators.fast import render_fast, render_fast_streamed
    from .generators.interpolating import render_interpolating
    from .generators.rectilinear import render_rectilinear
    from .meta.serialize import save_metadata
    from .parallel.mesh import (
        make_mesh,
        render_fast_sharded,
        render_interpolating_sharded,
        render_rectilinear_sharded,
    )
    from .render.annotate import annotate_image
    from .render.image import save_png
    from .terrain.store import Terrain

    config = parse_config(args.config) if args.config else Config()
    config = merge_cli(config, args)
    device = resolve_device(args.device)

    start = time.monotonic()

    def phase(msg):
        print(f"{time.monotonic() - start:.3f}: {msg}")

    terrain_folder = Path(os.getcwd()) / config.scene.terrain_folder
    phase(f"Using terrain data directory: {terrain_folder}")
    terrain = Terrain.from_folder(terrain_folder)
    params = config.into_params(terrain)
    generator = params.output.generator
    phase(f"Generating ({generator}) on {device}...")

    def progress(pct):
        # per-percent progress counter, fast.rs:78-87 / rectilinear.rs:40-49
        phase(f"{pct}%...")

    mesh = None
    if getattr(args, "shard", False):
        # every visible device of the type; the CPU counts as one
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        if n_dev < 2:
            phase(f"--shard: only {n_dev} device visible; rendering single-chip")
        else:
            phase(f"Sharding over {n_dev} devices")
            mesh = make_mesh([torch.device(device.type, i) for i in range(n_dev)])
    if mesh is not None:
        split = {"Rectilinear": render_rectilinear_sharded,
                 "InterpolatingRectilinear": render_interpolating_sharded}
        result = split.get(generator, render_fast_sharded)(params, terrain, mesh)
        progress(100)
    elif generator == "Rectilinear":
        result = render_rectilinear(params, terrain, device, progress=progress)
    elif generator == "InterpolatingRectilinear":  # one launch sequence
        result = render_interpolating(params, terrain, device, progress=progress)
    elif device.type == "cuda":
        # banded: one line a band while the bands' images stream to the host
        # (the JAX CLI's route on the accelerator, its cli.py:133-145)
        result = render_fast_streamed(params, terrain, device, bands=8, progress=progress)
    else:  # Fast on the CPU is one launch sequence: its only line is the last
        result = render_fast(params, terrain, device)
        progress(100)
    phase("Outputting image...")
    image = annotate_image(
        result.image, params, result.elevation_deg, result.azimuth_deg,
        result.observer[2],
    )
    save_png(image, Path(os.getcwd()) / params.output.file)
    if params.output.file_metadata:
        phase("Outputting metadata...")
        save_metadata(params.output.file_metadata, config, result,
                      fmt=args.meta_format, terrain=terrain)
    phase("Done.")
    return 0


def _add_view_parser(subparsers):
    p = subparsers.add_parser("view", help="View a metadata file")
    p.add_argument("input", help="Path to the metadata file")
    p.add_argument("--pixel", nargs=2, type=int, metavar=("X", "Y"),
                   help="Headless: print info for one pixel")
    p.add_argument("--save-image", dest="save_image",
                   help="Headless: write the re-rendered PNG here")
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device to re-composite on (default: cuda)")
    p.set_defaults(func=run_view_cmd)


def run_view_cmd(args) -> int:
    from .meta.viewer import run_view

    return run_view(args.input, device=resolve_device(args.device),
                    pixel=tuple(args.pixel) if args.pixel else None,
                    save_image=args.save_image)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="atm-raytracer-torch",
        description="Atmospheric Panorama Raytracer (PyTorch / CUDA)",
    )
    subparsers = parser.add_subparsers(dest="subcommand", required=True)
    _add_gen_parser(subparsers)
    _add_view_parser(subparsers)

    from .tools import atm_printer, elev_profile, ray_path

    atm_printer.add_parser(subparsers)
    ray_path.add_parser(subparsers)
    elev_profile.add_parser(subparsers)
    args = parser.parse_args(argv)
    try:
        return args.func(args)
    except Exception as e:  # main.rs:36-38 prints "ERROR: {}"
        if os.environ.get("ATM_RAYTRACER_TRACEBACK"):
            raise
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
