// K5: the exact test of the tilted Rectilinear path, one thread a pixel. For
// every pixel of a round that has no hit yet: walk the candidate blocks K4
// captured (its slots, in capture order, which is increasing block order),
// re-integrate each block's BLOCK_WINDOWS windows from the captured state,
// sample the terrain at the pixel's own azimuth at every fine sample, and
// keep the first crossing: its key and path length replace the pixel's.
//
// Replaces, in this package, the eager version
// (generators/rectilinear.py::culled_exact_test in EXACT_TEST_ELEMS chunks,
// culled_test_round), which re-integrates every slot of every pixel, filled
// or empty, into [p, M_CAND, b_len + 1] tensors and finds the crossing by
// prefix scans; and in the JAX package fused_culled_core's exact_test
// (atm_raytracer_tpu/generators/rectilinear.py:748), which XLA compiled. It has
// no Pallas counterpart.
//
// What a thread computes, in the plain version's operations and order:
//   skip   a pixel whose key is not +inf: later rounds hold later blocks, whose
//          segments are larger, so the plain test's "keyc < key" never holds
//          there; a slot whose block is nb (empty) or whose start is dead;
//   block  from (s_h, s_v, s_p) at block b: per window the RK4 step
//          (ray_device.cuh, K4's code: bit-equal altitudes), the fine samples
//          j = 1..C by the Hermite basis, the chords (_seg_lengths) summed in
//          double and rounded once per sample onto the window's start path
//          length (PyTorch's CPU cumsum of float32 rounds so; the card's adds
//          in float32, so path lengths agree with it within rounding);
//          sample 0 is the captured state itself;
//   test   the distance b · b_len · step + j · step (two float32 products and a
//          sum, as the plain version's), the geodesic at the pixel's azimuth
//          and the bilinear terrain there (terrain_device.cuh); d_j = h_j -
//          terrain. Segment j of the block crosses when d_j · d_(j+1) < 0, no
//          sample before j fell below DEATH_ALTITUDE, and b · b_len + j <
//          n_seg; the death flag and the path length are carried along the
//          samples, with no prefix scan;
//   key    at the first crossing (the smallest segment: blocks increase along
//          the slots and segments along a block): prop = d_j / (d_j -
//          d_(j+1)) (1 in the denominator where it is 0), key = segment +
//          prop, path length p_j (1 - prop) + p_(j+1) prop, written where key <
//          the pixel's key (always, but for a NaN key). The pixel stops there.
//
// Bound. Operations: for every slot a thread walks, per fine sample the
// geodesic (the sphere's ~40 operations and four transcendental calls;
// Vincenty's twelve iterations more), the sample (~30 and four loads), the
// Hermite sample, chord and tests (~25), and per window the RK4 step (209).
// Design: one thread a pixel, all state in registers; a pixel with a hit, or
// with no filled slot, exits after its loads, so the work follows the filled
// slots of the pixels still without a hit, not P · M_CAND · (b_len + 1).
// Rounding is the plain version's (-fmad=false, IEEE division and square root)
// and PyTorch's on the card where that differs (terrain_device.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ray_device.cuh"
#include "terrain_device.cuh"

namespace {

constexpr int THREADS = 128;

struct ExactArgs {
  long long n_pix;
  int m_cand, nb, n_seg, coarse, block_windows;
  const float* s_h;         // [n_pix, m_cand]
  const float* s_v;
  const float* s_p;
  const uint8_t* s_d;       // [n_pix, m_cand] bool
  const int* s_b;           // [n_pix, m_cand]
  const float* az;          // [n_pix] degrees
  float* key;               // [n_pix] updated in place
  float* plh;               // [n_pix]
  float dx, step, step_sq, block_dist;
  const float* poly;
  int n_poly;
  const float2* pairs;
  int n_table;
  float h0, inv_dh;
  float inv_r, radius;
  const float* basis;       // [4][C + 1]
  TerrainSpec terrain;
  GeoSpec geo;
};

// fine sample j of a window (physics/ray.py::hermite_plane); b = [4][C + 1]
__device__ __forceinline__ float plane(const float* b, int c1, int j, float h0, float vdx,
                                       float h1, float v1dx) {
  return b[j] * h0 + b[c1 + j] * vdx + b[2 * c1 + j] * h1 + b[3 * c1 + j] * v1dx;
}

template <bool SPH, int LF, int FORM>
__global__ void __launch_bounds__(THREADS) rect_exact_kernel(const ExactArgs a) {
  extern __shared__ float s_basis[];  // [4][C + 1]
  __shared__ float s_poly[MAX_POLY * POLY_STRIDE];
  __shared__ float s_inv_w[MAX_POLY];
  const int c = a.coarse, c1 = c + 1;
  stage_poly(a.poly, a.n_poly, s_poly, s_inv_w);
  for (int i = threadIdx.x; i < 4 * c1; i += blockDim.x) s_basis[i] = a.basis[i];
  __syncthreads();
  const long long pix = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (pix >= a.n_pix) return;
  const float key0 = a.key[pix];
  if (!(key0 == INFINITY)) return;  // a hit already, or a NaN key: no change

  const LSpec ls = make_lspec(s_poly, s_inv_w, a.n_poly, a.pairs, a.n_table, a.h0, a.inv_dh);
  const float dx = a.dx, half = 0.5f * dx, sixth = dx / 6.0f;
  const int b_len = a.block_windows * c;
  const GeoRay ray = geo_ray<FORM>(a.geo, a.az[pix]);
  const long long row = pix * a.m_cand;

  for (int k = 0; k < a.m_cand; ++k) {
    const int b = a.s_b[row + k];
    if (b >= a.nb || a.s_d[row + k]) continue;  // empty, or dead at its start
    const float block_d = (float)b * a.block_dist;
    const int seg0 = b * b_len;
    float h = a.s_h[row + k], v = a.s_v[row + k];
    // sample j - 1 of the block: altitude, its difference to the terrain,
    // path length; dead: some sample before it fell below DEATH_ALTITUDE
    float hp = h, pp = a.s_p[row + k];
    float dlat, dlon;
    geo_delta<FORM>(a.geo, ray, block_d + 0.0f * a.step, dlat, dlon);
    float dp = hp - sample_elevation(a.terrain, dlat, dlon);
    bool dead = false;
    int j = 0;  // the segment from sample j to j + 1, in the block
    for (int w = 0; w < a.block_windows && !dead && seg0 + j < a.n_seg; ++w) {
      const Stages st = rk4_stages<SPH, LF>(ls, dx, half, a.inv_r, h, v);
      const float h1 = rk4_combine(h, sixth, st.k1h, st.k2h, st.k3h, st.k4h);
      const float v1 = rk4_combine(v, sixth, st.k1v, st.k2v, st.k3v, st.k4v);
      const float vdx = v * dx, v1dx = v1 * dx;
      const float p0 = pp;
      double cum = 0.0;
      float hw = plane(s_basis, c1, 0, h, vdx, h1, v1dx);  // for the chords
      for (int i = 1; i <= c; ++i, ++j) {
        if (dead || seg0 + j >= a.n_seg) break;
        const float hn = plane(s_basis, c1, i, h, vdx, h1, v1dx);
        cum += (double)chord<SPH>(hw, hn, a.step, a.step_sq, a.radius);
        hw = hn;
        const float pn = p0 + (float)cum;
        geo_delta<FORM>(a.geo, ray, block_d + (float)(j + 1) * a.step, dlat, dlon);
        const float dn = hn - sample_elevation(a.terrain, dlat, dlon);
        if (dp * dn < 0.0f) {
          const float denom = dp - dn;
          const float prop = dp / (denom == 0.0f ? 1.0f : denom);
          const float keyc = (float)(seg0 + j) + prop;
          if (keyc < key0) {
            a.key[pix] = keyc;
            a.plh[pix] = pp * (1.0f - prop) + pn * prop;
          }
          return;
        }
        dead = hp < DEATH_ALTITUDE;  // sample j, before segment j + 1
        hp = hn;
        pp = pn;
        dp = dn;
      }
      h = h1;
      v = v1;
    }
  }
}

template <bool SPH, int LF>
cudaError_t launch_g(const ExactArgs& a, int form, int grid, size_t smem, cudaStream_t st) {
  switch (form) {
    case GEO_FLAT:
      rect_exact_kernel<SPH, LF, GEO_FLAT><<<grid, THREADS, smem, st>>>(a);
      break;
    case GEO_AE:
      rect_exact_kernel<SPH, LF, GEO_AE><<<grid, THREADS, smem, st>>>(a);
      break;
    case GEO_SPHERE:
      rect_exact_kernel<SPH, LF, GEO_SPHERE><<<grid, THREADS, smem, st>>>(a);
      break;
    default:
      rect_exact_kernel<SPH, LF, GEO_VINCENTY><<<grid, THREADS, smem, st>>>(a);
      break;
  }
  return cudaGetLastError();
}

template <bool SPH>
cudaError_t launch_l(const ExactArgs& a, bool refract, int form, int grid, size_t smem,
                     cudaStream_t st) {
  if (!refract) return launch_g<SPH, L_NONE>(a, form, grid, smem, st);
  if (a.n_poly == 0) return launch_g<SPH, L_TABLE>(a, form, grid, smem, st);
  if (a.n_poly <= REG_LOWS) return launch_g<SPH, L_POLY_REG>(a, form, grid, smem, st);
  return launch_g<SPH, L_POLY_SMEM>(a, form, grid, smem, st);
}

}  // namespace

// One round's exact test over n_pix pixels: slots s_h, s_v, s_p float, s_d
// bool (uint8), s_b int [n_pix, m_cand] as the capture scan left them (s_b
// nb: empty), az float [n_pix] the pixels' azimuths in degrees, key and plh
// float [n_pix] the pixels' hits so far (key +inf: none), updated in place.
// A block is block_windows windows of coarse steps of step (dx = coarse *
// step a window, block_dist = float32(b_len * step)), n_seg segments in all;
// refract 0 marches without l(h) (straight rays), else n_poly > 0 fit rows
// or, with n_poly 0, the table pairs; spherical picks the ray ODE's shape.
// geo_form (GeoForm) and geo[GEO_CONSTS] the geodesic; the terrain: tiles
// [T, s, s] (int16, or float32 with tiles_f32), rows_m1 and cols_m1 [T],
// the grid n_rows x n_cols, the observer's tile offsets and fractions.
extern "C" int rect_exact(int n_pix, int m_cand, int nb, int n_seg, int coarse,
                          int block_windows, const void* s_h, const void* s_v, const void* s_p,
                          const void* s_d, const void* s_b, const void* az, void* key,
                          void* plh, float dx, float step, float step_sq, float block_dist,
                          const void* poly, int n_poly, const void* pairs, int n_table,
                          float h0, float inv_dh, int refract, float inv_r, float radius,
                          int spherical, const void* basis, const void* tiles, int tiles_f32,
                          const void* rows_m1, const void* cols_m1, int s, int n_rows,
                          int n_cols, int row_off, int col_off, float frac_lat,
                          float frac_lon, int geo_form, const void* geo, void* stream) {
  if (n_pix < 1 || m_cand < 1 || nb < 1 || n_seg < 1 || coarse < 1 || block_windows < 1 ||
      n_poly < 0 || n_poly > MAX_POLY || (refract && n_poly == 0 && (pairs == nullptr ||
      n_table < 2)) || (n_poly > 0 && poly == nullptr) || s < 2 || n_rows < 1 ||
      n_cols < 1 || geo_form < GEO_FLAT || geo_form > GEO_VINCENTY || geo == nullptr ||
      s_h == nullptr || s_v == nullptr || s_p == nullptr || s_d == nullptr ||
      s_b == nullptr || az == nullptr || key == nullptr || plh == nullptr ||
      basis == nullptr || tiles == nullptr || rows_m1 == nullptr || cols_m1 == nullptr ||
      (long long)nb * block_windows * coarse >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ExactArgs a{};
  a.n_pix = n_pix;
  a.m_cand = m_cand;
  a.nb = nb;
  a.n_seg = n_seg;
  a.coarse = coarse;
  a.block_windows = block_windows;
  a.s_h = static_cast<const float*>(s_h);
  a.s_v = static_cast<const float*>(s_v);
  a.s_p = static_cast<const float*>(s_p);
  a.s_d = static_cast<const uint8_t*>(s_d);
  a.s_b = static_cast<const int*>(s_b);
  a.az = static_cast<const float*>(az);
  a.key = static_cast<float*>(key);
  a.plh = static_cast<float*>(plh);
  a.dx = dx;
  a.step = step;
  a.step_sq = step_sq;
  a.block_dist = block_dist;
  a.poly = static_cast<const float*>(poly);
  a.n_poly = refract ? n_poly : 0;
  a.pairs = static_cast<const float2*>(pairs);
  a.n_table = n_table;
  a.h0 = h0;
  a.inv_dh = inv_dh;
  a.inv_r = inv_r;
  a.radius = radius;
  a.basis = static_cast<const float*>(basis);
  a.terrain = TerrainSpec{tiles, tiles_f32, static_cast<const float*>(rows_m1),
                          static_cast<const float*>(cols_m1), s, n_rows, n_cols,
                          (long long)row_off, (long long)col_off, frac_lat, frac_lon};
  // the constants, copied by value into the launch's parameters
  const float* g = static_cast<const float*>(geo);
  for (int i = 0; i < GEO_CONSTS; ++i) a.geo.c[i] = g[i];
  const int grid = (int)(((long long)n_pix + THREADS - 1) / THREADS);
  const size_t smem = 16 * (size_t)(coarse + 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = spherical
                            ? launch_l<true>(a, refract != 0, geo_form, grid, smem, st)
                            : launch_l<false>(a, refract != 0, geo_form, grid, smem, st);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
