"""output-atm: table of temperature / pressure / humidity vs altitude.

Counterpart of ``atm_raytracer_tpu/tools/atm_printer.py`` (reference
src/atm_printer.rs): rows ``alt T P humidity`` from the config's atmosphere
definition; ``--celsius`` subtracts 273.15 from T. Host numpy only.
"""

from __future__ import annotations

import numpy as np

from ..config import parse_config
from ..physics.atmosphere import Atmosphere


def run(args) -> int:
    config = parse_config(args.input)
    atm = Atmosphere(config.atmosphere)
    alts = np.arange(args.min_alt, args.max_alt + args.step * 0.5, args.step)
    temps = atm.temperature(alts) - (273.15 if args.celsius else 0.0)
    pressures = atm.pressure(alts)
    hums = atm.humidity(alts)
    for a, t, p, h in zip(alts, temps, pressures, hums):
        print(f"{a} {t} {p} {h}")
    return 0


def add_parser(subparsers):
    p = subparsers.add_parser(
        "output-atm", help="Print the atmospheric profile", add_help=False
    )
    p.add_argument("--help", action="help")
    p.add_argument("input", help="Path to the input file")
    p.add_argument("-a", "--min-alt", dest="min_alt", type=float, default=0.0)
    p.add_argument("-b", "--max-alt", dest="max_alt", type=float, default=1000.0)
    p.add_argument("-s", "--step", dest="step", type=float, default=0.2)
    p.add_argument("-c", "--celsius", action="store_true")
    p.set_defaults(func=run)
