#!/usr/bin/env python3
"""Where the cycles of a K2 step go: clock64() probes on one NVIDIA GPU.

    python3 scripts/k2_clock_probe.py

Builds, with the port's nvcc flags, the first K2 march kernel (the one
thread a ray, nodes-only version that ``csrc/march.cu`` replaced) with a
clock64() stamp at the start of every RK4 step of thread 0, in ablated
variants, and times each at the Fast
headline shapes (1080 rays, 250 steps of 800 m, the headline's 4-segment
US-76 fit, sphere):

* ``first``    — the kernel as it was;
* ``npoly4``   — the segment search bounded by the constant 4 (unrolled);
* ``l_const``  — l(h) a constant: no segment search, division or Clenshaw;
* ``recip``    — ``/ u`` and ``/ width`` as products with the reciprocal
  (rounds differently: for the measurement only);
* ``one_block``— the first kernel on one block of 128 rays.

It also times dependent chains of single operations (the latencies the
chain floor of chip_smoke.py counts with), and the kernel of today,
``csrc/march.cu``, nodes only at the same shapes, as it is and with one
part of its step cut out by a textual substitution in a copy of the source
(``ABLATIONS``): the cycles a step each part costs. Prints one JSON line.
Imports nothing of JAX. The builds go to ``build/k2_probe`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
namespace {
constexpr int POLY_STRIDE = 10, CHEB_TERMS = 7, MAX_POLY = 64, BLOCK = 128;
struct LSpec { const float* poly; int n_poly; };
__device__ __forceinline__ float eval_l(const LSpec& s, float h) {
#ifdef L_CONST
  return 2.5e-8f;
#else
  const float* p = s.poly;
#ifdef NPOLY4
  const int n = 4;
#else
  const int n = s.n_poly;
#endif
  h = fminf(fmaxf(h, p[0]), p[(n - 1) * POLY_STRIDE + 1]);
  int k = -1;
#ifdef NPOLY4
#pragma unroll
#endif
  for (int i = 0; i < n; ++i) {
    const bool ge = h >= p[i * POLY_STRIDE];
    const bool lt = (i == n - 1) || (h < p[(i + 1) * POLY_STRIDE]);
    if (ge && lt) k = i;
  }
  if (k < 0) return 0.0f;
  const float* seg = p + k * POLY_STRIDE;
#ifdef RECIP
  float t = (h - seg[0]) * __frcp_rn(seg[2]) * 2.0f - 1.0f;
#else
  float t = (h - seg[0]) / seg[2] * 2.0f - 1.0f;
#endif
  t = fminf(fmaxf(t, -1.0f), 1.0f);
  float b1 = 0.0f, b2 = 0.0f;
  for (int c = CHEB_TERMS - 1; c >= 1; --c) {
    const float nb1 = seg[3 + c] + 2.0f * t * b1 - b2;
    b2 = b1;
    b1 = nb1;
  }
  return seg[3] + t * b1 - b2;
#endif
}
__device__ __forceinline__ float accel(float h, float v, float l, float inv_r) {
  const float u = 1.0f + h * inv_r;
#ifdef RECIP
  const float geom = (u * u + 2.0f * v * v) * __frcp_rn(u) * inv_r;
#else
  const float geom = (u * u + 2.0f * v * v) / u * inv_r;
#endif
  return l * (u * u + v * v) + geom;
}
__global__ void __launch_bounds__(BLOCK)
march(const float* alt, const float* v0, int B, float dx, int n_coarse,
      const float* poly, int n_poly, float inv_r, float* out_h,
      long long* clocks) {
  __shared__ float s_poly[MAX_POLY * POLY_STRIDE];
  for (int i = threadIdx.x; i < n_poly * POLY_STRIDE; i += blockDim.x) s_poly[i] = poly[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const LSpec spec{s_poly, n_poly};
  const float half = 0.5f * dx, sixth = dx / 6.0f;
  float h = alt[b], v = v0[b];
  const bool stamp = b == 0;
  for (int k = 0; k < n_coarse; ++k) {
    if (stamp) clocks[k] = clock64();
    const float l1 = eval_l(spec, h);
    const float l2 = eval_l(spec, h + half * v);
    const float l4 = eval_l(spec, h + dx * v);
    const float k1v = accel(h, v, l1, inv_r);
    const float k1h = v;
    const float k2h = v + half * k1v;
    const float k2v = accel(h + half * k1h, k2h, l2, inv_r);
    const float k3h = v + half * k2v;
    const float k3v = accel(h + half * k2h, k3h, l2, inv_r);
    const float k4h = v + dx * k3v;
    const float k4v = accel(h + dx * k3h, k4h, l4, inv_r);
    h = h + sixth * (k1h + 2.0f * k2h + 2.0f * k3h + k4h);
    v = v + sixth * (k1v + 2.0f * k2v + 2.0f * k3v + k4v);
    out_h[(long long)(k + 1) * B + b] = h;
  }
  if (stamp) clocks[n_coarse] = clock64();
}

// dependent chains of one operation, one thread: cycles[op] over n links
__global__ void latency(float a, float b, int n, long long* cycles, float* sink) {
  __shared__ int chase[256];
  for (int i = 0; i < 256; ++i) chase[i] = (i * 97 + 13) & 255;
  __syncthreads();
  float x = a;
  long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = x + b;
  long long t1 = clock64();
  cycles[0] = t1 - t0; sink[0] = x; x = a;
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = x * b;
  t1 = clock64();
  cycles[1] = t1 - t0; sink[1] = x; x = a;
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = x / b;
  t1 = clock64();
  cycles[2] = t1 - t0; sink[2] = x; x = a;
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = sqrtf(x);
  t1 = clock64();
  cycles[3] = t1 - t0; sink[3] = x;
  int j = (int)a & 255;
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) j = chase[j];
  t1 = clock64();
  cycles[4] = t1 - t0; sink[4] = (float)j; x = a;
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = fminf(fmaxf(x, -b), b);
  t1 = clock64();
  cycles[5] = t1 - t0; sink[5] = x;
}
}  // namespace

extern "C" int run_march(const void* alt, const void* v0, int B, float dx, int n_coarse,
                         const void* poly, int n_poly, float inv_r, void* out_h,
                         void* clocks, int block) {
  march<<<(B + block - 1) / block, block>>>(
      (const float*)alt, (const float*)v0, B, dx, n_coarse, (const float*)poly, n_poly,
      inv_r, (float*)out_h, (long long*)clocks);
  return (int)cudaGetLastError();
}
extern "C" int run_latency(float a, float b, int n, void* cycles, void* sink) {
  latency<<<1, 1>>>(a, b, n, (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
"""

VARIANTS = {"first": (), "npoly4": ("-DNPOLY4",), "l_const": ("-DL_CONST",),
            "recip": ("-DRECIP",)}


# (name, [(text in csrc/march.cu or ray_device.cuh, its replacement)]): each
# cuts one part of the step, for the measurement only (the results are wrong)
ABLATIONS = (
    ("as_is", []),
    ("no_clenshaw", [("  return seg[3] + t * b1 - b2;", "  return seg[3] + t * 1e-12f;"),
                     ("#pragma unroll\n  for (int c = CHEB_TERMS - 1", "  for (int c = 0")]),
    ("division_as_product", [("  const float q0 = __fmul_rn(a, y);",
                       "  return __fmul_rn(a, y);\n  const float q0 = __fmul_rn(a, y);")]),
    ("no_search", [("k += (__float_as_uint(h - s.lows[i]) >> 31) ^ 1u;", "k += 0;")]),
    ("no_l", [("  if (LF == L_TABLE) {\n    float t = (h - s.h0)",
               "  if (LF != L_TABLE) return -2.5e-8f + 1e-20f * h;\n"
               "  if (LF == L_TABLE) {\n    float t = (h - s.h0)")]),
)


def ablated_cycles(dev, alt, v0, table, n_coarse, dx, radius) -> dict:
    """Cycles a step of CTA 0 (clock64) of csrc/march.cu, nodes only, as it
    is and with each of ``ABLATIONS``."""
    import torch

    from atm_raytracer_tpu_torch import _kernels
    from atm_raytracer_tpu_torch.physics import ray as R

    # the header inlined, so the copy builds outside csrc/ and its l(h) and
    # step code can be cut like the rest
    src = (_kernels.CSRC / "march.cu").read_text().replace(
        '#include "ray_device.cuh"', (_kernels.CSRC / "ray_device.cuh").read_text())
    out = ROOT / "build" / "k2_probe"
    out.mkdir(parents=True, exist_ok=True)
    real = _kernels.MARCH
    result = {}
    try:
        for name, subs in ABLATIONS:
            text = src
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"ablation {name}: {old!r} is not in march.cu "
                                       "or ray_device.cuh")
                text = text.replace(old, new)
            path = out / f"march_{name}.cu"
            path.write_text(text)
            _kernels.MARCH = _kernels.CudaKernel(
                str(path.relative_to(_kernels.CSRC, walk_up=True)), real.entry, real.argtypes)
            n_cta = -(-alt.shape[0] // R.default_rays_per_cta(alt.shape[0], dev))
            clocks = torch.zeros(n_coarse + 1 + 2 * n_cta, dtype=torch.int64, device=dev)
            for _ in range(3):
                R.march_cuda(alt, v0, dx, n_coarse, table, radius, clocks=clocks)
            c = clocks.cpu()
            result[name] = float(c[n_coarse] - c[0]) / n_coarse
    finally:
        _kernels.MARCH = real
    return result


@functools.lru_cache(maxsize=None)
def build(name: str, defines: tuple) -> ctypes.CDLL:
    from atm_raytracer_tpu_torch import _kernels

    out = ROOT / "build" / "k2_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "probe.cu"
    src.write_text(SOURCE)
    lib = out / f"libprobe_{name}.so"
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *defines, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    from atm_raytracer_tpu_torch.physics import ray as R
    from atm_raytracer_tpu_torch.physics.atmosphere import Atmosphere, us_76

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this probe needs a GPU")
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    table = R.RefractionTable.build(Atmosphere(us_76()), 530e-9, h_hi=90_000.0, device=dev)
    rows = table.poly_rows()
    b, n_coarse, dx, radius = 1080, 250, 800.0, 6_371_000.0
    elev = torch.deg2rad(torch.linspace(-11.25, 11.25, b, device=dev))
    alt = torch.full_like(elev, 400.0)
    v0 = R.initial_slope(alt, elev, R.EarthShape(radius))
    out_h = torch.empty((n_coarse + 1, b), device=dev)
    clocks = torch.zeros(n_coarse + 1, dtype=torch.int64, device=dev)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    result = {"nvidia_smi": smi.stdout.strip(), "n_poly": len(table.poly), "steps": {}}
    for name, defines in [*VARIANTS.items(), ("one_block", ())]:
        lib = build("first", ()) if name == "one_block" else build(name, defines)
        lib.run_march.argtypes = [P, P, I, F, I, P, I, F, P, P, I]
        n_rays = 128 if name == "one_block" else b

        def go():
            err = lib.run_march(alt.data_ptr(), v0.data_ptr(), n_rays, dx, n_coarse,
                                rows.data_ptr(), len(table.poly), 1.0 / radius,
                                out_h.data_ptr(), clocks.data_ptr(), 128)
            if err:
                raise RuntimeError(f"{name}: launch failed with cudaError {err}")

        go()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            go()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 20
        c = clocks.cpu()
        per_step = float(c[-1] - c[0]) / n_coarse
        result["steps"][name] = {"ms": ms, "cycles_per_step": per_step,
                                 "clock_ghz": per_step * n_coarse / (ms * 1e6)}
    result["latency_cycles"] = measure_latencies(dev)
    result["march_cu_cycles_per_step"] = ablated_cycles(
        dev, alt, v0, table, n_coarse, R._f32(dx), radius)
    print(json.dumps(result), flush=True)
    return 0


def measure_latencies(dev, n: int = 4096) -> dict:
    """Cycles a link of dependent chains of one operation, one thread on
    ``dev``: float32 add, multiply, IEEE division and square root, a
    shared-memory pointer chase, a min-max pair."""
    import torch

    lib = build("first", ())
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.run_latency.argtypes = [F, F, I, P, P]
    cyc = torch.zeros(6, dtype=torch.int64, device=dev)
    sink = torch.zeros(6, device=dev)
    err = lib.run_latency(1.5, 1.0000001, n, cyc.data_ptr(), sink.data_ptr())
    if err:
        raise RuntimeError(f"latency probe: launch failed with cudaError {err}")
    torch.cuda.synchronize()
    return dict(zip(("fadd", "fmul", "div_rn", "sqrt_rn", "lds_chase", "fmnmx_pair"),
                    (float(x) / n for x in cyc.cpu())))


if __name__ == "__main__":
    sys.exit(main())
