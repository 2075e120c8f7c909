// K1: first terrain-crossing segments of the Fast generator's combine.
//
// Replaces the TPU kernel atm_raytracer_tpu/experimental/combine_pallas.py
// (_first_crossing_kernel / first_crossing_pallas) and serves the contract of
// the default combine, ops/combine.py::terrain_crossing_segments: for every
// pixel (ray row h, terrain column w) the first K segment indices k with
//   d1 = ray[h, k] - terr[w, k],  d2 = ray[h, k+1] - terr[w, k+1],  d1*d2 < 0,
// ascending, for k < min(n_seg, limit[h]); NO_HIT_SEG fills missing slots.
// limit[h] is the ray's death bound (first sample below -1000 m, plus 1),
// computed by the wrapper: samples are never clobbered, because a clobbered
// sample fabricates crossings against deep terrain.
//
// A sweep's F frames go in one call: ray [F, H, N+1], terr [F, W, N_t],
// limit [F, H] and out [F, H, W, K], frame-contiguous; frame f's rays meet
// only frame f's columns. Tiles never span two frames (blockIdx.z is the
// frame of a crossing block; an envelope entry is indexed frame-major), so
// the scratch below is per frame and F = 1 is the one-frame call.
//
// Two kernels, launched in turn on one stream:
//  1. chunk_envelopes_kernel, one warp per (tile, chunk): the min and max of
//     a block tile's TH ray rows (or TW terrain rows) over the samples
//     k0 .. k0+CH of a chunk, inclusive: the CH+1 samples the chunk's tests
//     read (chunks overlap by one sample, as the staged chunk below does),
//     cut at n_seg. Out: ray_lo / ray_hi [F, ceil(H/TH), n_chunks] and
//     terr_lo / terr_hi [F, ceil(W/TW), n_chunks].
//  2. crossing_segments_kernel, one thread per pixel, a block of TH rays x
//     TW columns: it walks the chunks in ascending order, skips (without
//     staging) every chunk whose ray and terrain envelopes do not overlap,
//     and stages the others in shared memory for the sign tests.
//
// The cull is exact. If min(ray) > max(terr) over a chunk's samples, every
// d = r - t of the tile is a difference of float32 values r > t, which is
// > 0 (no flush to zero: no --use_fast_math), and a product of two positive
// d is never < 0; likewise when max(ray) < min(terr). fminf / fmaxf drop a
// NaN sample, which is right: a NaN d never makes p < 0. Dead samples past
// limit[h] only widen an envelope.
//
// Cost: bounded by bytes. The function must read ray and terr once and
// write the keys: (H + W) * (n_seg + 1) * 4 + H * W * K * 4 bytes, 56.3 MB
// or 16.8 us at 3.35 TB/s at the headline (1920x1080 over 3999 segments,
// K = 1). The sign tests no longer bound it: the per-pixel early-exit scan
// needs 4.1e9 of them there, which kept the unculled kernel at ~3.2 ms, but
// the terrain lies far below a sky tile's rays and far above the rays of a
// tile that has already hit, so of the 133 226 block-chunks the blocks
// walked only 4 738 stay live (3.6 %) and the threads test 4.2e7 segments.
// What is left is latency: each block's limit and envelope loads, and per
// live chunk a staging round trip and up to CH dependent shared-memory
// steps. A staged chunk serves every loaded sample to TW (ray) or TH
// (terrain) threads; the terrain rows are strided CH+1 floats apart (odd),
// so the 32 columns of a warp read 32 distinct banks; the ray value of a
// warp's row is a broadcast. Segments are visited in ascending order, so
// the sorted top-K is an append into K registers, and a block stops once
// every one of its pixels holds K hits or is past its bound.
//
// Not yet done (later work): TMA / cp.async double buffering of the live
// chunks, register tiling, and a persistent grid.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;    // rays per block (threadIdx.y); ops/combine.py TILE_H
constexpr int TW = 32;   // columns per block (threadIdx.x, one warp); TILE_W
constexpr int CH = 128;  // segments per chunk; ops/combine.py CHUNK
constexpr int NO_HIT_SEG = 1 << 30;  // ops/combine.py NO_HIT_SEG
constexpr int ENV_WARPS = 8;         // (tile, chunk) entries per envelope block

__global__ void __launch_bounds__(ENV_WARPS * 32)
chunk_envelopes_kernel(const float* __restrict__ ray, int ray_stride, int H,
                       const float* __restrict__ terr, int terr_stride, int W,
                       int F, int n_seg, int n_chunks,
                       float* __restrict__ ray_lo, float* __restrict__ ray_hi,
                       float* __restrict__ terr_lo, float* __restrict__ terr_hi) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * ENV_WARPS + (threadIdx.x >> 5);
  // entries a frame: its ray tiles' chunks, then its terrain tiles'
  const long long n_ray = (long long)((H + TH - 1) / TH) * n_chunks;
  const long long n_terr = (long long)((W + TW - 1) / TW) * n_chunks;
  if (g >= (n_ray + n_terr) * F) return;  // whole warps only
  const long long fr = g / (n_ray + n_terr);
  const long long e = g - fr * (n_ray + n_terr);
  const bool is_ray = e < n_ray;
  const long long f = is_ray ? e : e - n_ray;
  const int tile = (int)(f / n_chunks);
  const int k0 = (int)(f - (long long)tile * n_chunks) * CH;
  const int k1 = min(k0 + CH, n_seg);  // last sample, inclusive
  const float* src = is_ray ? ray + fr * H * ray_stride : terr + fr * W * terr_stride;
  const int stride = is_ray ? ray_stride : terr_stride;
  const int rows = is_ray ? TH : TW;
  const int r0 = tile * rows;
  const int r1 = min(r0 + rows, is_ray ? H : W);

  float lo = __int_as_float(0x7f800000);  // +inf: an all-NaN entry is culled
  float hi = -lo;
  for (int r = r0; r < r1; ++r) {
    const float* row = src + (long long)r * stride;
    for (int k = k0 + lane; k <= k1; k += 32) {
      const float x = row[k];
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    const long long o = fr * (is_ray ? n_ray : n_terr) + f;
    (is_ray ? ray_lo : terr_lo)[o] = lo;
    (is_ray ? ray_hi : terr_hi)[o] = hi;
  }
}

template <int K>
__global__ void __launch_bounds__(TH * TW)
crossing_segments_kernel(const float* __restrict__ ray, int ray_stride,
                         const float* __restrict__ terr, int terr_stride,
                         const int* __restrict__ limit, int H, int W, int n_seg,
                         int n_chunks,
                         const float* __restrict__ ray_lo,
                         const float* __restrict__ ray_hi,
                         const float* __restrict__ terr_lo,
                         const float* __restrict__ terr_hi,
                         int* __restrict__ out) {
  __shared__ float s_ray[TH][CH + 1];
  __shared__ float s_terr[TW][CH + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int w = w0 + tx;
  const int h = h0 + ty;
  const long long fr = blockIdx.z;  // the frame
  ray += fr * H * ray_stride;
  terr += fr * W * terr_stride;
  limit += fr * H;
  out += fr * H * W * K;
  const bool inside = (h < H) && (w < W);
  // segments k < lim are tested; ragged-edge threads test none
  const int lim = inside ? min(limit[h], n_seg) : 0;
  // this block's envelopes, one float per chunk
  const long long re = (fr * gridDim.y + blockIdx.y) * n_chunks;
  const long long te = (fr * gridDim.x + blockIdx.x) * n_chunks;

  int keys[K];
#pragma unroll
  for (int s = 0; s < K; ++s) keys[s] = NO_HIT_SEG;
  int cnt = 0;

  const int tid = ty * TW + tx;
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * CH;
    // block-wide early exit; also the barrier before the chunk is reused
    if (__syncthreads_and(cnt == K || k0 >= lim)) break;
    // the envelope cull: the same four floats in every thread, so the
    // branch is block-uniform and every thread reaches the next barrier
    if (ray_lo[re + c] > terr_hi[te + c] || ray_hi[re + c] < terr_lo[te + c])
      continue;
    // samples k0 .. k0+CH (CH+1 of them) of every row, zero past n_seg
    const int n_samp = min(CH + 1, n_seg + 1 - k0);
    for (int i = tid; i < TH * (CH + 1); i += TH * TW) {
      const int r = i / (CH + 1);
      const int j = i - r * (CH + 1);
      const int hr = h0 + r;
      s_ray[r][j] = (hr < H && j < n_samp)
                        ? ray[(long long)hr * ray_stride + k0 + j] : 0.0f;
    }
    for (int i = tid; i < TW * (CH + 1); i += TH * TW) {
      const int r = i / (CH + 1);
      const int j = i - r * (CH + 1);
      const int wr = w0 + r;
      s_terr[r][j] = (wr < W && j < n_samp)
                         ? terr[(long long)wr * terr_stride + k0 + j] : 0.0f;
    }
    __syncthreads();

    const int k_end = min(CH, lim - k0);  // may be <= 0: nothing to test
    float d_prev = s_ray[ty][0] - s_terr[tx][0];
    for (int j = 0; j < k_end && cnt < K; ++j) {
      const float d_new = s_ray[ty][j + 1] - s_terr[tx][j + 1];
      const float p = d_prev * d_new;
      if (p < 0.0f) {
#pragma unroll
        for (int s = 0; s < K; ++s)
          if (s == cnt) keys[s] = k0 + j;
        ++cnt;
      }
      d_prev = d_new;
    }
  }

  if (inside) {
    int* o = out + ((long long)h * W + w) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) o[s] = keys[s];
  }
}

template <int K>
void launch(const float* ray, int ray_stride, const float* terr,
            int terr_stride, const int* limit, int F, int H, int W, int n_seg,
            int n_chunks, const float* ray_lo, const float* ray_hi,
            const float* terr_lo, const float* terr_hi, int* out,
            cudaStream_t stream) {
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, F);
  crossing_segments_kernel<K><<<grid, block, 0, stream>>>(
      ray, ray_stride, terr, terr_stride, limit, H, W, n_seg, n_chunks,
      ray_lo, ray_hi, terr_lo, terr_hi, out);
}

}  // namespace

// F frames (1 for one frame) of ray [H, N+1] rows ray_stride floats apart,
// terr [W, N_t] rows terr_stride apart and limit [H], frame after frame;
// out [F, H, W, K]. ray_lo, ray_hi: [F, ceil(H/TH), ceil(n_seg/CH)] float32
// scratch; terr_lo, terr_hi: [F, ceil(W/TW), ceil(n_seg/CH)]. Both kernels
// go on `stream`.
extern "C" int crossing_segments(const void* ray, int ray_stride,
                                 const void* terr, int terr_stride,
                                 const void* limit, int F, int H, int W,
                                 int n_seg, int K, void* ray_lo, void* ray_hi,
                                 void* terr_lo, void* terr_hi, void* out,
                                 void* stream) {
  if (K < 1 || K > 4 || F < 1 || F > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* r = static_cast<const float*>(ray);
  const float* t = static_cast<const float*>(terr);
  const int* l = static_cast<const int*>(limit);
  float* rlo = static_cast<float*>(ray_lo);
  float* rhi = static_cast<float*>(ray_hi);
  float* tlo = static_cast<float*>(terr_lo);
  float* thi = static_cast<float*>(terr_hi);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n_seg + CH - 1) / CH;
  if (n_chunks > 0) {
    const long long entries =
        (long long)((H + TH - 1) / TH + (W + TW - 1) / TW) * n_chunks * F;
    const unsigned blocks = (unsigned)((entries + ENV_WARPS - 1) / ENV_WARPS);
    chunk_envelopes_kernel<<<blocks, ENV_WARPS * 32, 0, s>>>(
        r, ray_stride, H, t, terr_stride, W, F, n_seg, n_chunks, rlo, rhi, tlo, thi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (K) {
    case 1: launch<1>(r, ray_stride, t, terr_stride, l, F, H, W, n_seg, n_chunks, rlo, rhi, tlo, thi, o, s); break;
    case 2: launch<2>(r, ray_stride, t, terr_stride, l, F, H, W, n_seg, n_chunks, rlo, rhi, tlo, thi, o, s); break;
    case 3: launch<3>(r, ray_stride, t, terr_stride, l, F, H, W, n_seg, n_chunks, rlo, rhi, tlo, thi, o, s); break;
    case 4: launch<4>(r, ray_stride, t, terr_stride, l, F, H, W, n_seg, n_chunks, rlo, rhi, tlo, thi, o, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
