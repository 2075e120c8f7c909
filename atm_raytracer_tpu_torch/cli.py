"""CLI: ``gen`` with the reference's flag surface, plus ``--device``.

Counterpart of ``atm_raytracer_tpu/cli.py`` (reference src/main.rs:17-39,
src/generator/params.rs:531-676). Short flags are preserved, including
``-h`` meaning height — use ``--help`` for help.

``--device`` defaults to ``cuda`` and is never chosen for the user: without
a GPU the command fails loudly; ``--device cpu`` renders with the plain
PyTorch versions of the kernels.

This package renders the Fast and Rectilinear generators without scene
objects; InterpolatingRectilinear, metadata output, annotations, ``view`` and
the diagnostic tools are not ported yet and are refused with the ROADMAP item
that will port them.
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
                   help="Metadata output (not ported yet: ROADMAP A7)")
    p.add_argument("-w", "--width", dest="width", type=int)
    p.add_argument("-h", "--height", dest="height", type=int)
    p.add_argument("-c", "--config", dest="config")
    p.add_argument("--generator", dest="generator",
                   choices=["Fast", "Rectilinear", "InterpolatingRectilinear"],
                   help="Override the generator (Fast and Rectilinear are ported)")
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.set_defaults(func=run_gen)


def check_supported(config) -> None:
    """Raise NotImplementedError for any part of a config this package does
    not render yet, naming the ROADMAP item that ports it."""
    out = config.output
    if out.generator == "InterpolatingRectilinear":
        raise NotImplementedError(
            "generator InterpolatingRectilinear is not ported yet (ROADMAP A11)"
        )
    if config.scene.objects:
        raise NotImplementedError("scene objects are not ported yet (ROADMAP A9)")
    if out.file_metadata:
        raise NotImplementedError(
            "metadata output (output.file_metadata / --output-meta) is not "
            "ported yet (ROADMAP A7)"
        )
    if out.ticks or out.vertical_ticks or out.show_eye_level or out.show_flat_horizon:
        raise NotImplementedError(
            "annotations (ticks, vertical_ticks, show_eye_level, "
            "show_flat_horizon) are not ported yet (ROADMAP: render/annotate.py)"
        )


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
    from .config import Config, merge_cli, parse_config
    from .generators.fast import render_fast
    from .generators.rectilinear import render_rectilinear
    from .render.image import save_png
    from .terrain.store import Terrain

    config = parse_config(args.config) if args.config else Config()
    config = merge_cli(config, args)
    check_supported(config)
    device = resolve_device(args.device)

    start = time.monotonic()

    def phase(msg):
        print(f"{time.monotonic() - start:.3f}: {msg}")

    terrain_folder = Path(os.getcwd()) / config.scene.terrain_folder
    phase(f"Using terrain data directory: {terrain_folder}")
    terrain = Terrain.from_folder(terrain_folder)
    params = config.into_params(terrain)
    generator = params.output.generator
    render = render_rectilinear if generator == "Rectilinear" else render_fast
    phase(f"Generating ({generator}) on {device}...")
    result = render(params, terrain, device)
    phase("100%...")
    phase("Outputting image...")
    save_png(result.image, Path(os.getcwd()) / params.output.file)
    phase("Done.")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="atm-raytracer-torch",
        description="Atmospheric Panorama Raytracer (PyTorch / CUDA)",
    )
    subparsers = parser.add_subparsers(dest="subcommand", required=True)
    _add_gen_parser(subparsers)
    args = parser.parse_args(argv)
    try:
        return args.func(args)
    except Exception as e:  # main.rs:36-38 prints "ERROR: {}"
        if os.environ.get("ATM_RAYTRACER_TRACEBACK"):
            raise
        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
