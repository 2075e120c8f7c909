"""The readings a cell's correctness limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each of ``--seeds`` it renders the frames a run checks (the first
``check_frames`` views of the seed's sequence, one after another, after
the run's warm-up) through the program and compares each with the
reference: the program's readings. For each of ``--control-seeds`` it puts
the reference computed in the precision below the configuration's
(``reference.lowp``) in the program's place: the control's readings. One
JSON line a seed and side, then a summary: each number's largest program
reading and smallest control reading. The benchmark's own runs do not run
the control.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seeds, control_seeds, device, overrides=None, emit=print):
    """[{"seed", "side", numbers}] for the program on ``seeds`` and the
    control on ``control_seeds``."""
    import numpy as np
    import torch

    from portbench import compare, harness, scene, views
    from portbench.reference import Reference
    from portbench.reference.lowp import lower_precision

    device = torch.device(device)
    bench = harness.load_json(harness.BENCHMARK)
    _, _, config, traffic, _ = harness.find_cell(bench, workload)
    config = harness.shrunk(config, overrides)
    sc = config["scene"]
    generator, tilt = traffic["generator"], float(traffic["tilt_deg"])
    program = harness.Program()
    out = []
    for seed in list(dict.fromkeys(list(seeds) + list(control_seeds))):
        t0 = time.perf_counter()
        keys, tiles = scene.make_tiles(config, device)
        objects = None
        tex_dir = None
        if config.get("objects"):
            import tempfile
            tex_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
            scene.write_texture(tex_dir / "checker64.png")
            objects = harness.scene_objects(config, keys, tiles, tex_dir / "checker64.png",
                                            device)
        frame_of = lambda d: scene.frame_dict(sc, d, tilt, generator, objects)  # noqa: E731
        dirs = list(itertools.islice(views.directions(traffic, seed, 0),
                                     int(traffic["check_frames"])))
        served = {}
        if seed in seeds:
            terrain = scene.build_terrain(program.Terrain, program.Tile, keys, tiles)
            for d in itertools.islice(views.directions(traffic, seed, 1),
                                      int(traffic["warmup_frames"])):
                program.render(program.lower(frame_of(d), terrain), terrain, device)
            served["program"] = []
            for d in dirs:
                r = program.render(program.lower(frame_of(d), terrain), terrain, device)
                served["program"].append((np.array(r.image, copy=True), compare.host_fields(r.hits)))
                del r
            del terrain
        if seed in control_seeds:
            low = Reference(keys, tiles, device)
            served["control"] = []
            with lower_precision():
                for d in dirs:
                    r = low.render(frame_of(d))
                    served["control"].append((np.array(r.image, copy=True), compare.host_fields(r.hits)))
                    del r
            low.close()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = Reference(keys, tiles, device)
        refs = []
        for d in dirs:
            r = ref.render(frame_of(d))
            refs.append((np.array(r.image, copy=True), compare.host_fields(r.hits)))
            del r
        ref.close()
        for side, frames in served.items():
            per = [compare.frame_numbers(img, f, rimg, rf)
                   for (img, f), (rimg, rf) in zip(frames, refs)]
            row = {"workload": workload, "seed": int(seed), "side": side,
                   "directions": dirs, **compare.worst(per),
                   "seconds": time.perf_counter() - t0}
            emit(json.dumps(row))
            out.append(row)
        if tex_dir is not None:
            import shutil
            shutil.rmtree(tex_dir, ignore_errors=True)
    return out


def summary(rows) -> dict:
    from portbench.compare import NUMBERS

    prog = [r for r in rows if r["side"] == "program"]
    ctrl = [r for r in rows if r["side"] == "control"]
    return {k: {"program_max": max((r[k] for r in prog), default=None),
                "control_min": min((r[k] for r in ctrl), default=None)} for k in NUMBERS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control is read on a card", file=sys.stderr)
        return 1
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    rows = readings(args.workload, seeds, control, "cuda:0",
                    emit=lambda s: print(s, flush=True))
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
