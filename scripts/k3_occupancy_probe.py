#!/usr/bin/env python3
"""K3's occupancy on one NVIDIA GPU: ``__launch_bounds__(128, n)`` variants.

    python3 scripts/k3_occupancy_probe.py [n ...]

Builds ``csrc/rect_scan.cu`` (its header inlined) once for each minimum
number of CTAs an SM ``n`` (default 1, 4, 5, 6, 8; the shipped build asks
for ``MIN_CTAS``), put into its ``__launch_bounds__`` in a copy of the
source, with the port's nvcc flags, prints each build's
registers, spills and the occupancy they allow, and times the tilt-0 scan
(``rectilinear.tilt0_hits_cuda``) through each at the 1920x1080 headline of
chip_smoke.py (poly l(h), sphere) at K = 1 and 4: CUDA-event means of 10
scans after a warm-up, the variants in turns twice (1, 4, ..., 8, 8, ...,
1), and the kernel alone by the profiler (mean of 5 scans), keys and path
lengths torch.equal to the first variant's. Prints the
card's name and power limit, then one JSON line. Imports nothing of JAX.
The builds go to ``build/k3_probe`` (git-ignored).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

THREADS = 128
REGS_PER_SM = 65536
MAX_THREADS_PER_SM = 2048


def variant(n: int):
    """A CudaKernel of rect_scan.cu asking for n CTAs an SM."""
    from atm_raytracer_tpu_torch import _kernels

    src = (_kernels.CSRC / "rect_scan.cu").read_text().replace(
        '#include "ray_device.cuh"', (_kernels.CSRC / "ray_device.cuh").read_text())
    out = ROOT / "build" / "k3_probe"
    out.mkdir(parents=True, exist_ok=True)
    bounds = "__launch_bounds__(THREADS, MIN_CTAS)"
    if bounds not in src:
        raise RuntimeError(f"{bounds} is not in rect_scan.cu")
    path = out / f"rect_scan_mb{n}.cu"
    path.write_text(src.replace(bounds, f"__launch_bounds__(THREADS, {n})"))
    real = _kernels.RECT_SCAN
    return _kernels.CudaKernel(str(path.relative_to(_kernels.CSRC, walk_up=True)),
                               real.entry, real.argtypes)


def registers(log: str) -> dict:
    """Registers and spill bytes of each kernel instance in a ptxas log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(re.search(r"Used (\d+) registers",
                                                                  line).group(1))
        elif name and "spill" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            out.setdefault(name, {})["spill_bytes"] = sum(nums)
    return out


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.generators import rectilinear as rect

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this probe needs a GPU")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    mins = [int(a) for a in argv] or [1, 4, 5, 6, 8]
    kernels = {n: variant(n) for n in mins}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels.values()))
    result = {"card": smi.stdout.strip(), "variants": {}}
    for n, k in kernels.items():
        regs = registers(k.build_log)
        # the headline's instance: sphere, the fit's lows in registers
        k1 = next(v for name, v in regs.items() if "rect_scan_kernel" in name
                  and "ILb1ELi1ELb0E" in name)
        k4 = next(v for name, v in regs.items() if "rect_scan_kernel" in name
                  and "ILb1ELi1ELb1E" in name)
        occ = {kk: min(MAX_THREADS_PER_SM // THREADS,
                       REGS_PER_SM // (v["registers"] * THREADS)) * THREADS // 32
               for kk, v in (("k1", k1), ("k4", k4))}
        result["variants"][n] = {"k1": k1, "k4": k4, "warps_per_sm": occ, "ms": {}}
        print(f"[k3-probe] {n} CTAs an SM: K = 1 {k1}, K > 1 {k4}, warps an SM {occ}",
              flush=True)

    dev = torch.device("cuda:0")
    params = cs.headline_params()
    terrain = cs.headline_terrain(params)
    alt0, table, _, elev_hw, terr_pad, _, kw = cs.k3_inputs(dev, terrain, params)
    real = _kernels.RECT_SCAN
    ref = {}
    try:
        for n in mins + mins[::-1]:
            _kernels.RECT_SCAN = kernels[n]
            for k in (1, 4):
                scan_kw = dict(shape=params.model.to_shape(), table=table, straight=False,
                               max_hits=k, **kw)
                key, plh, _ = rect.tilt0_hits_cuda(elev_hw, terr_pad, alt0, **scan_kw)
                if k not in ref:
                    ref[k] = (key, plh)
                same = torch.equal(key, ref[k][0]) and torch.equal(plh, ref[k][1])
                ms = cs.cuda_ms(lambda: rect.tilt0_hits_cuda(elev_hw, terr_pad, alt0,
                                                             **scan_kw), 10)
                events = cs.trace_events(lambda: [rect.tilt0_hits_cuda(
                    elev_hw, terr_pad, alt0, **scan_kw) for _ in range(5)], "k3_probe")
                alone = sum(float(e["dur"]) for e in events
                            if "rect_scan_kernel" in e["name"]) / 5e3
                v = result["variants"][n]
                v["ms"].setdefault(f"k{k}", []).append(ms)
                v.setdefault("kernel_ms", {}).setdefault(f"k{k}", []).append(alone)
                v["equal"] = v.get("equal", True) and same
                print(f"[k3-probe] {n} CTAs an SM, K={k}: {ms:.4f} ms by CUDA events, "
                      f"kernel alone {alone:.4f} ms (profiler, mean of 5), equal to the "
                      f"first variant's {same}", flush=True)
    finally:
        _kernels.RECT_SCAN = real
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
