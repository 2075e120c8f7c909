#!/usr/bin/env python3
"""Time the port's DTED decode against the JAX package's on 36 tiles.

    python3 scripts/tile_load_times.py [--tiles N] [--posts P]

Writes ``--tiles`` DTED tiles of ``--posts`` x ``--posts`` seeded integer
posts with the port's writer into a temporary folder, then prints one JSON
line with the medians of 7 runs of ``load_batch`` over them:

- ``decode_port_s``: the port's ``native/dted_loader.cpp`` (one read a
  file, a blocked transpose);
- ``decode_jax_source_s``: the JAX package's ``native/dted_loader.cpp`` (a
  post scattered a row a record), compiled by this script with the same
  g++ flags into the temporary folder, its output required bit-equal.

Host code only: no GPU is used. Run from the repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from atm_raytracer_tpu_torch import _kernels  # noqa: E402
from atm_raytracer_tpu_torch.terrain import native  # noqa: E402
from atm_raytracer_tpu_torch.terrain.dted import write_dted  # noqa: E402

THREADS = 8


def median_s(fn, runs=7):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=36)
    ap.add_argument("--posts", type=int, default=1201)
    args = ap.parse_args(argv)
    n, s = args.tiles, args.posts
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(n):
            paths.append(Path(tmp) / f"t{i}.dt2")
            write_dted(paths[-1], 45 + i // 9, 10 + i % 9,
                       rng.integers(-400, 3000, (s, s)).astype(np.int16))
        ours, _, status = native.load_batch(paths, s, s, max_threads=THREADS)
        if (status != 0).any():
            raise SystemExit(f"the port's loader failed: {status}")
        ref_lib = Path(tmp) / "libdted_reference.so"
        subprocess.run(["g++", *_kernels.GXX_FLAGS, "-o", str(ref_lib),
                        str(ROOT / "atm_raytracer_tpu" / "native" / "dted_loader.cpp")],
                       check=True)
        ref = ctypes.CDLL(str(ref_lib))
        blob = b"\0".join(str(p).encode() for p in paths) + b"\0"

        def reference():
            out = np.zeros((n, s, s), np.float32)
            origins = np.zeros((n, 2), np.float64)
            st = np.zeros(n, np.int32)
            ref.dted_load_batch(blob, n, out.ctypes.data_as(ctypes.c_void_p),
                                origins.ctypes.data_as(ctypes.c_void_p),
                                st.ctypes.data_as(ctypes.c_void_p), s, s, THREADS)
            return out, st

        theirs, st = reference()
        if (st != 0).any() or not np.array_equal(ours, theirs):
            raise SystemExit("the port's DTED decode differs from the JAX package's")
        print(json.dumps({
            "dted_tiles": n, "posts": s, "threads": THREADS, "cpu_count": os.cpu_count(),
            "decode_port_s": median_s(
                lambda: native.load_batch(paths, s, s, max_threads=THREADS)),
            "decode_jax_source_s": median_s(reference),
            "bit_equal": True,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
