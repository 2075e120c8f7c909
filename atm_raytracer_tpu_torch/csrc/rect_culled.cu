// K4: the capture scan of the tilted Rectilinear path, one thread a pixel. For
// every pixel of a tilted frame: march its ray window by window with RK4 and,
// block by block (BLOCK_WINDOWS coarse windows a block), hold the range of the
// ray's fine samples against the terrain envelope of the pixel's azimuth
// interval; a block whose ranges meet is a candidate, and its start state goes
// to the pixel's next slot.
//
// Replaces the JAX package's compiled device loop for this scan: the
// jax.lax.scan of atm_raytracer_tpu/physics/ray.py::march_scan (:509), fused
// by XLA with the consumer of
// atm_raytracer_tpu/generators/rectilinear.py::fused_culled_core's
// capture_round (:699-746). It has no Pallas counterpart. In this package it
// replaces the plain version's Python loop over windows
// (generators/rectilinear.py::culled_capture_plain: march_scan and its
// consumer, ~40 tensor ops a window over the whole frame).
//
// What a thread computes, in the plain version's operations and order:
//   start  h = alt, h' = v0[p] (the wrapper computes v0 with initial_slope,
//          the plain version's op), P = 0, dead = false;
//   window the RK4 stages of (h, h') with l(h) as the Chebyshev fit, the
//          table or none (ray_device.cuh, K2's and K3's code), the window's
//          end (h1, h1'), its fine samples j = 0..C by the cubic Hermite basis
//          (data: hermite_coeffs), b00 h + b10 h' dx + b01 h1 + b11 h1' dx
//          (hermite_window's operand order), and the C chords between them
//          (_seg_lengths); P advances by their sum. dead |= h_j <
//          DEATH_ALTITUDE for some j < C (march_scan's death rule);
//   block  at its first window: the start state (h, h', P) and a fresh range;
//          the range is the min and max of every fine sample j = 0..C of the
//          block's windows, NaN if any sample is NaN (torch.amin and
//          torch.minimum propagate NaN); at its last window, for b * b_len <
//          n_seg, the block is a candidate when
//          rmin <= env_hi[j_px[p], b] and rmax >= env_lo[j_px[p], b] and the
//          ray was alive at the block's start. A candidate goes to slot
//          cnt - skip when that is in [0, m_cand); cnt counts every candidate.
// Chords are summed within a window in double and rounded once, as PyTorch's
// CPU cumsum of float32 does (K3 sums them so too); the card's plain cumsum
// adds in float32, so path lengths agree with it within rounding, not
// bitwise.
//
// A thread stops at a block's start once the ray is dead: every later block's
// death flag is set, so none can be a candidate and cnt is final. Every other
// pixel marches all nb * BLOCK_WINDOWS windows, because the rounds' stopping
// test reads the whole count. windows[p], when asked for, receives the
// windows it marched. A candidate starts alive, so every captured death flag
// (the plain version's s_d) is false: the kernel does not write them.
//
// Bound. Bytes: v0 and j_px, the envelope [A-1, nb] twice, the count and the
// slots out, ~0.2 GB at the 1920x1080, 252-window headline (~0.06 ms at 3.35
// TB/s). Operations: for every window a pixel marches, the RK4 stages with
// three l(h) (209), the 17 Hermite samples (119), the 16 chords (160) and
// their sum (16 adds: the double-precision sum and its conversions are this
// kernel's choice, not counted), the min and max of the samples (34), their
// NaN and death tests (33): ~575 float32 operations, ~4.5 ms for the
// headline's 522 million pixel-windows at 67 TFLOP/s (chip_smoke.py::k4_ops). Design: one thread a pixel, all state in registers
// (the envelope row of the pixel read once a block, the slots written only
// when a block is captured); the Hermite basis and the fit's rows in shared
// memory. Rounding is the plain version's (-fmad=false, IEEE division and
// square root), so the RK4 states, and with them every captured h and h', are
// bit-equal to the plain scan's on the same card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_device.cuh"

namespace {

constexpr int THREADS = 128;
// CTAs an SM the registers are sized for: caps a thread at 128 registers
constexpr int MIN_CTAS = 4;

struct CulledArgs {
  const float* v0;
  long long n_pix;
  float alt;
  int n_seg, coarse, nb, block_windows, m_cand, skip;
  float dx;
  const float* poly;
  int n_poly;
  const float2* pairs;
  int n_table;
  float h0, inv_dh;
  float inv_r, radius, step, step_sq;
  const float* basis;
  const float* env_hi;  // [A-1, nb]
  const float* env_lo;  // [A-1, nb]
  const int* j_px;      // [n_pix]: each pixel's row of the envelope
  int* cnt;
  float* s_h;
  float* s_v;
  float* s_p;
  int* s_b;
  int* windows;  // null: not asked for
};

// fine sample j of a window (physics/ray.py::hermite_plane); b = [4][C + 1]
__device__ __forceinline__ float plane(const float* b, int c1, int j, float h0, float vdx,
                                       float h1, float v1dx) {
  return b[j] * h0 + b[c1 + j] * vdx + b[2 * c1 + j] * h1 + b[3 * c1 + j] * v1dx;
}

template <bool SPH, int LF>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) rect_culled_kernel(const CulledArgs a) {
  extern __shared__ float s_basis[];  // [4][C + 1]
  __shared__ float s_poly[MAX_POLY * POLY_STRIDE];
  __shared__ float s_inv_w[MAX_POLY];
  const int c = a.coarse, c1 = c + 1;
  stage_poly(a.poly, a.n_poly, s_poly, s_inv_w);
  for (int i = threadIdx.x; i < 4 * c1; i += blockDim.x) s_basis[i] = a.basis[i];
  __syncthreads();
  const long long pix = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (pix >= a.n_pix) return;

  const int m = a.m_cand;
  float* sh = a.s_h + pix * m;
  float* sv = a.s_v + pix * m;
  float* sp = a.s_p + pix * m;
  int* sb = a.s_b + pix * m;
  for (int k = 0; k < m; ++k) {
    sh[k] = 0.0f;
    sv[k] = 0.0f;
    sp[k] = 0.0f;
    sb[k] = a.nb;
  }
  const long long env_row = (long long)a.j_px[pix] * a.nb;
  const float* ehi = a.env_hi + env_row;
  const float* elo = a.env_lo + env_row;

  const LSpec ls = make_lspec(s_poly, s_inv_w, a.n_poly, a.pairs, a.n_table, a.h0, a.inv_dh);
  const float dx = a.dx, half = 0.5f * dx, sixth = dx / 6.0f;
  const long long b_len = (long long)a.block_windows * c;
  float h = a.alt, v = a.v0[pix], p = 0.0f;
  bool dead = false;
  int cnt = 0, windows = 0;
  // a block is entered only while the ray is alive: its death flag, the
  // plain version's bd, is false in every block marched
  for (int b = 0; b < a.nb && !dead; ++b) {
    const float bh = h, bv = v, bp = p;
    float rmin = 0.0f, rmax = 0.0f;
    bool rnan = false;
    for (int wb = 0; wb < a.block_windows; ++wb) {
      ++windows;
      const Stages k = rk4_stages<SPH, LF>(ls, dx, half, a.inv_r, h, v);
      const float h1 = rk4_combine(h, sixth, k.k1h, k.k2h, k.k3h, k.k4h);
      const float v1 = rk4_combine(v, sixth, k.k1v, k.k2v, k.k3v, k.k4v);
      const float vdx = v * dx, v1dx = v1 * dx;
      float hp = plane(s_basis, c1, 0, h, vdx, h1, v1dx);
      float wmin = hp, wmax = hp;
      bool nan = hp != hp, below = hp < DEATH_ALTITUDE;
      double cum = 0.0;
      for (int j = 1; j <= c; ++j) {
        const float hn = plane(s_basis, c1, j, h, vdx, h1, v1dx);
        cum += (double)chord<SPH>(hp, hn, a.step, a.step_sq, a.radius);
        wmin = fminf(wmin, hn);
        wmax = fmaxf(wmax, hn);
        nan = nan || hn != hn;
        if (j < c) below = below || hn < DEATH_ALTITUDE;
        hp = hn;
      }
      if (wb == 0) {
        rmin = wmin;
        rmax = wmax;
        rnan = nan;
      } else {
        rmin = fminf(rmin, wmin);
        rmax = fmaxf(rmax, wmax);
        rnan = rnan || nan;
      }
      dead = dead || below;
      p = p + (float)cum;
      h = h1;
      v = v1;
    }
    if ((long long)b * b_len < a.n_seg && !rnan && rmin <= ehi[b] && rmax >= elo[b]) {
      const int slot = cnt - a.skip;
      if (slot >= 0 && slot < m) {
        sh[slot] = bh;
        sv[slot] = bv;
        sp[slot] = bp;
        sb[slot] = b;
      }
      ++cnt;
    }
  }
  a.cnt[pix] = cnt;
  if (a.windows != nullptr) a.windows[pix] = windows;
}

template <bool SPH, int LF>
cudaError_t launch_k(const CulledArgs& a, int grid, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rect_culled_kernel<SPH, LF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rect_culled_kernel<SPH, LF><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool SPH>
cudaError_t launch_l(const CulledArgs& a, bool refract, int grid, size_t smem,
                     cudaStream_t st) {
  if (!refract) return launch_k<SPH, L_NONE>(a, grid, smem, st);
  if (a.n_poly == 0) return launch_k<SPH, L_TABLE>(a, grid, smem, st);
  if (a.n_poly <= REG_LOWS) return launch_k<SPH, L_POLY_REG>(a, grid, smem, st);
  return launch_k<SPH, L_POLY_SMEM>(a, grid, smem, st);
}

}  // namespace

// One round of the capture scan over n_pix pixels: v0 [n_pix] the start
// slopes, the march n_march = nb * block_windows * coarse steps of step
// (dx = coarse * step a window) covering n_seg segments; refract 0 marches
// without l(h) (straight rays), else n_poly > 0 fit rows or, with n_poly 0,
// the table pairs. env_hi and env_lo [A-1, nb] (contiguous) the envelope,
// j_px int [n_pix] each pixel's row of it. Slots skip .. skip + m_cand - 1
// are captured: cnt int [n_pix], s_h, s_v, s_p float and s_b int
// [n_pix, m_cand] (written whole: s_b is nb where no block was captured),
// windows int [n_pix] or null: the windows each pixel marched.
extern "C" int rect_culled(const void* v0, int n_pix, float alt, int n_seg, int coarse,
                           int n_march, int nb, int block_windows, int m_cand, int skip,
                           float dx, const void* poly, int n_poly, const void* pairs,
                           int n_table, float h0, float inv_dh, int refract, float inv_r,
                           float radius, int spherical, float step, float step_sq,
                           const void* basis, const void* env_hi, const void* env_lo,
                           const void* j_px, void* cnt, void* s_h, void* s_v, void* s_p,
                           void* s_b, void* windows, void* stream) {
  if (n_pix < 1 || n_seg < 1 || coarse < 1 || nb < 1 || block_windows < 1 ||
      (long long)nb * block_windows * coarse != n_march || n_seg > n_march ||
      m_cand < 1 || skip < 0 || n_poly < 0 || n_poly > MAX_POLY ||
      (refract && n_poly == 0 && (pairs == nullptr || n_table < 2)) ||
      (n_poly > 0 && poly == nullptr) || v0 == nullptr || basis == nullptr ||
      env_hi == nullptr || env_lo == nullptr || j_px == nullptr || cnt == nullptr ||
      s_h == nullptr || s_v == nullptr || s_p == nullptr || s_b == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const CulledArgs a{
      static_cast<const float*>(v0), n_pix, alt, n_seg, coarse, nb, block_windows, m_cand,
      skip, dx, static_cast<const float*>(poly), refract ? n_poly : 0,
      static_cast<const float2*>(pairs), n_table, h0, inv_dh, inv_r, radius, step, step_sq,
      static_cast<const float*>(basis), static_cast<const float*>(env_hi),
      static_cast<const float*>(env_lo), static_cast<const int*>(j_px),
      static_cast<int*>(cnt), static_cast<float*>(s_h), static_cast<float*>(s_v),
      static_cast<float*>(s_p), static_cast<int*>(s_b), static_cast<int*>(windows)};
  const int grid = (int)(((long long)n_pix + THREADS - 1) / THREADS);
  const size_t smem = 16 * (size_t)(coarse + 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = spherical ? launch_l<true>(a, refract != 0, grid, smem, st)
                                  : launch_l<false>(a, refract != 0, grid, smem, st);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
