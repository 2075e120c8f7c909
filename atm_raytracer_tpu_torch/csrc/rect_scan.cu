// K3: the tilt-0 Rectilinear scan, one thread a pixel. For every pixel (r, w)
// of an [R, W] grid: march its ray window by window with RK4 and test each
// coarse window's fine samples against its image column's terrain, until the
// pixel's crossings are found, it dies, it provably clears its column's
// terrain or the windows run out.
//
// Replaces the JAX package's compiled device loop for this scan: the
// jax.lax.scan of atm_raytracer_tpu/physics/ray.py::march_scan_light (:422)
// and ::march_scan (:509), fused by XLA with the window tests of
// atm_raytracer_tpu/generators/rectilinear.py::fused_shared_core (K = 1
// :181-270, K > 1 :314-378). It has no Pallas counterpart. In this package it
// replaces the plain version's Python loop over windows
// (generators/rectilinear.py::tilt0_hits_plain: first_window_scan +
// first_hit_retest for K = 1, _multi_hit_scan for K > 1), ~17 x 8 tensor ops a
// window over the whole grid.
//
// What a thread computes, in the plain version's operations and order:
//   start  h = alt, h' = v0[r, w] (the wrapper computes v0 with initial_slope,
//          the plain version's op), P = 0;
//   window k0 = i * C: the RK4 stages of (h, h') with l(h) as the Chebyshev
//          fit, the table or none (ray_device.cuh, K2's code), the window's
//          end (h1, h1'), and its fine samples j = 0..C by the cubic Hermite
//          basis (data: hermite_coeffs), b00 h + b10 h' dx + b01 h1 + b11 h1' dx;
//   K = 1  (march_scan_light + first_window_scan's consumer) P advances by
//          the RK4 quadrature of dP/dx (_rk4_step_quad). The window is flagged
//          when a product (h_j - t_j)(h_j+1 - t_j+1), j < C, is negative and
//          none is NaN (torch.minimum propagates NaN). At the FIRST flagged
//          window the thread runs first_hit_retest's exact test at once, from
//          the same registers: segment j crosses when its product is
//          negative, no sample before it in the window fell below
//          DEATH_ALTITUDE and k0 + j < n_seg; the first such j gives
//          key = (k0 + j) + prop, prop = d_j / (d_j - d_j+1) (utils.rs:232),
//          and the path length lerped between the window's chord sums. Then
//          the thread stops: the plain version decides by the first flagged
//          window too, and a false positive there (death inside it, or the
//          zero-padded terrain past the march) means no hit. The thread also
//          stops when a sample j < C of a window falls below DEATH_ALTITUDE
//          (no NaN among them): no later window can be flagged.
//   K > 1  (march_scan + _multi_hit_scan's consumer) every window marched runs
//          the exact test, P carried as the sum of the chords; the crossings come
//          in ascending key order, so the first K are the K smallest and each
//          goes to the next free slot. The thread stops at K hits or at death.
// Chords are summed within a window in double and rounded once, as PyTorch's
// CPU cumsum of float32 does. Empty slots keep key +inf and path length 0.
//
// Two exact rules (ray_device.cuh, argued there) cut the work without
// changing a value: at each window start a thread whose state proves that
// every later sample stays above smax[i, w], the highest terrain of windows
// >= i in its column, is done (terrain_clear_exit: v >= 0, h >= h_safe, the
// band's cap, h - margin > smax; its slots stay as they are); and a window
// whose samples are bounded from below, by the convex hull of its cubic's
// Bezier control points, above max(tmax[i, w], DEATH_ALTITUDE) skips the
// terrain loads, differences and products of its test (hull_clear): at K = 1
// the whole 17-sample test, the path length still advancing by the
// quadrature; at K > 1 the chords are still summed into P. tmax and smax
// ([n_coarse, W], row i at i * n_cols) come from the wrapper, h_safe and the
// cap from the table and the shape (generators/rectilinear.py::scan_rules).
//
// The scan runs in launches of windows [w0, w1): the wrapper launches once a
// progress stride (36 launches for 250 windows) and reports progress between
// them. The state of each pixel -- h, h', P in state [3, R * W] and flags[pix]
// = windows marched << 9 | hits << 1 | done -- stays in device memory between
// launches; the launch with w0 == 0 initialises it and the output slots. A
// pixel marches windows 0 .. windows - 1 and then stops (a flagged window,
// death, K hits or the exit), so the pixels live in launch [w0, w1) are
// those with windows > w0.
//
// Bound. Bytes: v0, the terrain rows [n_coarse * C + 1, W], tmax and smax,
// and the keys and path lengths out, ~59 MB at the 1920x1080, 4000-sample
// headline (~18 us at 3.35 TB/s). Operations: for the windows each pixel
// marches, the RK4 stages with three l(h) (209), the two rules' tests, and at
// K = 1 the quadrature of dP/dx and the 17-sample test where the hull does
// not clear it (~460 a window in all), at K > 1 the samples and chords and,
// unless the hull clears it, the exact test (~660): float32 operations bound
// it (chip_smoke.py::k3_ops). Before the rules every sky pixel marched all
// 250 windows: 98.7 % of the 258 million pixel-windows of the headline. Design:
// one thread a pixel, a warp on 32 adjacent columns of one row, so each
// terrain sample load is one coalesced 128-byte row segment (the terrain is
// [k, w]) and exits are nearly warp-uniform away from the skyline; all state
// in registers within a launch; the Hermite basis and the fit's rows in
// shared memory. Rounding is the plain version's (-fmad=false, IEEE division
// and square root), so the RK4 states are bit-equal to the plain scan's and
// the keys sit within float32 rounding of the plain version's on the same
// card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_device.cuh"

namespace {

constexpr int THREADS = 128;
// CTAs an SM the registers are sized for: 6 caps the headline's K = 1
// instance at 80 registers (92 uncapped), 24 warps an SM, with no spills
// (8 spills); scripts/k3_occupancy_probe.py times the choices
constexpr int MIN_CTAS = 6;
constexpr int DONE = 1;
constexpr int COUNT_SHIFT = 1;
constexpr int COUNT_MASK = 0xff;  // K <= 255
constexpr int WINDOWS_SHIFT = 9;

struct ScanArgs {
  const float* v0;
  int n_cols, v0_stride;
  float alt;
  const float* terr;
  int terr_stride;
  const float* tmax;  // [n_coarse, n_cols]
  const float* smax;  // [n_coarse, n_cols]
  ScanRules rules;
  int n_seg, coarse, w0, w1;
  float dx;
  const float* poly;
  int n_poly;
  const float2* pairs;
  int n_table;
  float h0, inv_dh;
  float inv_r, radius, step, step_sq;
  const float* basis;
  int max_hits;
  float* state;
  int* flags;
  float* key;
  float* plh;
  long long n_pix;
};

// fine sample j of a window (physics/ray.py::hermite_plane); b = [4][C + 1]
__device__ __forceinline__ float plane(const float* b, int c1, int j, float h0, float vdx,
                                       float h1, float v1dx) {
  return b[j] * h0 + b[c1 + j] * vdx + b[2 * c1 + j] * h1 + b[3 * c1 + j] * v1dx;
}

// The exact test of one window's C segments, from its node states and its
// start path length p; crossings go to key / plh from slot count on, until
// max_hits. cum receives the window's chord sum. Returns whether a sample
// j < C fell below DEATH_ALTITUDE (the window's death). Without test (the
// hull cleared the window: no crossing, no death) only the chords are summed.
template <bool SPH>
__device__ __forceinline__ bool segment_test(const ScanArgs& a, const float* b, int k0,
                                             const float* t, bool test, float h0, float vdx,
                                             float h1, float v1dx, float p, int& count,
                                             float* key, float* plh, double& cum) {
  const int c = a.coarse, c1 = c + 1;
  float hp = plane(b, c1, 0, h0, vdx, h1, v1dx);
  float dp = test ? hp - t[0] : 0.0f;
  float plp = p;
  bool dead = false;
  cum = 0.0;
  for (int j = 0; j < c; ++j) {
    const float hn = plane(b, c1, j + 1, h0, vdx, h1, v1dx);
    cum += (double)chord<SPH>(hp, hn, a.step, a.step_sq, a.radius);
    const float pln = p + (float)cum;
    if (test) {
      const float dn = hn - t[(long long)(j + 1) * a.terr_stride];
      if (dp * dn < 0.0f && !dead && k0 + j < a.n_seg) {
        const float denom = dp - dn;
        const float prop = dp / (denom == 0.0f ? 1.0f : denom);
        key[count] = ((float)k0 + (float)j) + prop;
        plh[count] = plp * (1.0f - prop) + pln * prop;
        if (++count == a.max_hits) return dead;
      }
      dead = dead || hp < DEATH_ALTITUDE;
      dp = dn;
    }
    hp = hn;
    plp = pln;
  }
  return dead;
}

template <bool SPH, int LF, bool MULTI>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) rect_scan_kernel(const ScanArgs a) {
  extern __shared__ float s_basis[];  // [4][C + 1]
  __shared__ float s_poly[MAX_POLY * POLY_STRIDE];
  __shared__ float s_inv_w[MAX_POLY];
  const int c = a.coarse, c1 = c + 1;
  const long long pix = (long long)blockIdx.x * THREADS + threadIdx.x;
  int flags = 0;
  if (a.w0 != 0 && pix < a.n_pix) flags = a.flags[pix];
  const bool live = pix < a.n_pix && !(flags & DONE);
  // a block whose pixels have all stopped returns before staging anything,
  // as most blocks of the later launches do (a launch with no live pixel
  // took 0.0208 ms staging every block, 0.0110 ms so, on an H100)
  if (!__syncthreads_or(live)) return;
  stage_poly(a.poly, a.n_poly, s_poly, s_inv_w);
  for (int i = threadIdx.x; i < 4 * c1; i += blockDim.x) s_basis[i] = a.basis[i];
  __syncthreads();
  if (!live) return;

  const int r = (int)(pix / a.n_cols);
  const int w = (int)(pix - (long long)r * a.n_cols);
  float* st_h = a.state;
  float* st_v = a.state + a.n_pix;
  float* st_p = a.state + 2 * a.n_pix;
  float* key = a.key + pix * a.max_hits;
  float* plh = a.plh + pix * a.max_hits;

  float h, v, p;
  if (a.w0 == 0) {
    h = a.alt;
    v = a.v0[(long long)r * a.v0_stride + w];
    p = 0.0f;
    for (int k = 0; k < a.max_hits; ++k) {
      key[k] = __int_as_float(0x7f800000);
      plh[k] = 0.0f;
    }
  } else {
    h = st_h[pix];
    v = st_v[pix];
    p = st_p[pix];
  }
  int count = (flags >> COUNT_SHIFT) & COUNT_MASK;
  int windows = flags >> WINDOWS_SHIFT;

  const LSpec ls = make_lspec(s_poly, s_inv_w, a.n_poly, a.pairs, a.n_table, a.h0, a.inv_dh);
  const float dx = a.dx, half = 0.5f * dx, sixth = dx / 6.0f;
  bool done = false;
  for (int wi = a.w0; wi < a.w1; ++wi) {
    const long long row = (long long)wi * a.n_cols + w;
    if (terrain_clear_exit(a.rules, h, v, dx, a.inv_r, a.smax[row])) {
      done = true;  // no later window can flag, cross or die
      break;
    }
    ++windows;
    const int k0 = wi * c;
    const Stages k = rk4_stages<SPH, LF>(ls, dx, half, a.inv_r, h, v);
    const float h1 = rk4_combine(h, sixth, k.k1h, k.k2h, k.k3h, k.k4h);
    const float v1 = rk4_combine(v, sixth, k.k1v, k.k2v, k.k3v, k.k4v);
    const float vdx = v * dx, v1dx = v1 * dx;
    const float* t = a.terr + (long long)k0 * a.terr_stride + w;
    const bool test = !hull_clear(h, vdx, h1, v1dx, a.tmax[row]);
    double cum;
    if (MULTI) {
      const bool dead = segment_test<SPH>(a, s_basis, k0, t, test, h, vdx, h1, v1dx, p,
                                          count, key, plh, cum);
      done = dead || count == a.max_hits;
      p = p + (float)cum;
    } else {
      const float p1 = rk4_combine(
          p, sixth, path_speed<SPH>(h, k.k1h, a.radius),
          path_speed<SPH>(h + half * k.k1h, k.k2h, a.radius),
          path_speed<SPH>(h + half * k.k2h, k.k3h, a.radius),
          path_speed<SPH>(h + dx * k.k3h, k.k4h, a.radius));
      if (test) {
        bool neg = false, nan_pr = false, below = false, nan_h = false;
        float d_prev = 0.0f;
        for (int j = 0; j <= c; ++j) {
          const float hj = plane(s_basis, c1, j, h, vdx, h1, v1dx);
          if (j < c) {
            below = below || hj < DEATH_ALTITUDE;
            nan_h = nan_h || hj != hj;
          }
          const float dj = hj - t[(long long)j * a.terr_stride];
          if (j > 0) {
            const float pr = d_prev * dj;
            neg = neg || pr < 0.0f;
            nan_pr = nan_pr || pr != pr;
          }
          d_prev = dj;
        }
        if (neg && !nan_pr) {  // the first flagged window decides
          segment_test<SPH>(a, s_basis, k0, t, true, h, vdx, h1, v1dx, p, count, key, plh,
                            cum);
          done = true;
        } else {
          done = below && !nan_h;
        }
      }
      p = p1;
    }
    h = h1;
    v = v1;
    if (done) break;
  }
  a.flags[pix] = (windows << WINDOWS_SHIFT) | (count << COUNT_SHIFT) | (done ? DONE : 0);
  if (!done) {
    st_h[pix] = h;
    st_v[pix] = v;
    st_p[pix] = p;
  }
}

template <bool SPH, int LF, bool MULTI>
cudaError_t launch_k(const ScanArgs& a, int grid, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rect_scan_kernel<SPH, LF, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  rect_scan_kernel<SPH, LF, MULTI><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool SPH, int LF>
cudaError_t launch_m(const ScanArgs& a, int grid, size_t smem, cudaStream_t st) {
  return a.max_hits > 1 ? launch_k<SPH, LF, true>(a, grid, smem, st)
                        : launch_k<SPH, LF, false>(a, grid, smem, st);
}

template <bool SPH>
cudaError_t launch_l(const ScanArgs& a, bool refract, int grid, size_t smem,
                     cudaStream_t st) {
  if (!refract) return launch_m<SPH, L_NONE>(a, grid, smem, st);
  if (a.n_poly == 0) return launch_m<SPH, L_TABLE>(a, grid, smem, st);
  if (a.n_poly <= REG_LOWS) return launch_m<SPH, L_POLY_REG>(a, grid, smem, st);
  return launch_m<SPH, L_POLY_SMEM>(a, grid, smem, st);
}

}  // namespace

// Windows [w0, w1) of the scan over the [n_rows, n_cols] pixels: v0 (row
// stride v0_stride) the start slopes, terr [n_coarse * coarse + 1, n_cols]
// (row stride terr_stride, zero past the march) the column terrain, dx the
// window length coarse * step. refract 0 marches without l(h) (straight
// rays); else n_poly > 0 fit rows or, with n_poly 0, the table pairs.
// state float [3, n_rows * n_cols], flags int [n_rows * n_cols], key and plh
// float [n_rows * n_cols, max_hits]; the launch with w0 == 0 initialises them.
// tmax and smax [n_coarse, n_cols] (contiguous): each window's terrain
// maximum and its suffix maximum; h_safe, h_top, k_cap and m_abs: the exit
// rule's band, cap and margin (ray_device.cuh::ScanRules).
extern "C" int rect_scan(const void* v0, int n_rows, int n_cols, int v0_stride, float alt,
                         const void* terr, int terr_stride, int n_seg, int coarse, int w0,
                         int w1, float dx, const void* poly, int n_poly, const void* pairs,
                         int n_table, float h0, float inv_dh, int refract, float inv_r,
                         float radius, int spherical, float step, float step_sq,
                         const void* basis, int max_hits, void* state, void* flags,
                         void* key, void* plh, const void* tmax, const void* smax,
                         float h_safe, float h_top, float k_cap, float m_abs,
                         void* stream) {
  if (n_rows < 1 || n_cols < 1 || v0_stride < n_cols || terr_stride < n_cols ||
      n_seg < 1 || coarse < 1 || w0 < 0 || w1 <= w0 ||
      (long long)(w1 - 1) * coarse >= n_seg || max_hits < 1 || max_hits > COUNT_MASK ||
      n_poly < 0 || n_poly > MAX_POLY ||
      (refract && n_poly == 0 && (pairs == nullptr || n_table < 2)) ||
      (n_poly > 0 && poly == nullptr) || v0 == nullptr || terr == nullptr ||
      tmax == nullptr || smax == nullptr ||
      basis == nullptr || state == nullptr || flags == nullptr || key == nullptr ||
      plh == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_pix = (long long)n_rows * n_cols;
  const ScanArgs a{
      static_cast<const float*>(v0), n_cols, v0_stride, alt,
      static_cast<const float*>(terr), terr_stride, static_cast<const float*>(tmax),
      static_cast<const float*>(smax), ScanRules{h_safe, h_top, k_cap, m_abs},
      n_seg, coarse, w0, w1, dx,
      static_cast<const float*>(poly), refract ? n_poly : 0,
      static_cast<const float2*>(pairs), n_table, h0, inv_dh, inv_r, radius, step, step_sq,
      static_cast<const float*>(basis), max_hits, static_cast<float*>(state),
      static_cast<int*>(flags), static_cast<float*>(key), static_cast<float*>(plh), n_pix};
  const long long grid = (n_pix + THREADS - 1) / THREADS;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 16 * (size_t)(coarse + 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = spherical ? launch_l<true>(a, refract != 0, (int)grid, smem, st)
                                  : launch_l<false>(a, refract != 0, (int)grid, smem, st);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
