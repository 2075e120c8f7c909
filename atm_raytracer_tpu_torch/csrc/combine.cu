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
// Cost: compute-bound. At 1920x1080 over 4000 segments the sign tests number
// H*W*N ~ 8.3e9; the inputs are only (H + W) rows of N floats. One thread per
// pixel; a block of TH rays x TW columns stages CH-sample chunks of its TH ray
// rows and TW terrain rows in shared memory, so every loaded sample serves TW
// (ray) or TH (terrain) threads. The terrain rows are strided CH+1 floats
// apart (odd), so the 32 columns of a warp read 32 distinct banks; the ray
// value of a warp's row is a broadcast. Segments are visited in ascending
// order, so the sorted top-K is an append into K registers, and a block stops
// streaming once every one of its pixels holds K hits or is past its bound.
//
// Not yet done (later work): TMA / cp.async double buffering of the chunks,
// and a persistent grid.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;    // rays per block (threadIdx.y)
constexpr int TW = 32;   // columns per block (threadIdx.x, one warp)
constexpr int CH = 128;  // segments per staged chunk
constexpr int NO_HIT_SEG = 1 << 30;  // ops/combine.py NO_HIT_SEG

template <int K>
__global__ void __launch_bounds__(TH * TW)
crossing_segments_kernel(const float* __restrict__ ray, int ray_stride,
                         const float* __restrict__ terr, int terr_stride,
                         const int* __restrict__ limit, int H, int W, int n_seg,
                         int* __restrict__ out) {
  __shared__ float s_ray[TH][CH + 1];
  __shared__ float s_terr[TW][CH + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int w = w0 + tx;
  const int h = h0 + ty;
  const bool inside = (h < H) && (w < W);
  // segments k < lim are tested; ragged-edge threads test none
  const int lim = inside ? min(limit[h], n_seg) : 0;

  int keys[K];
#pragma unroll
  for (int s = 0; s < K; ++s) keys[s] = NO_HIT_SEG;
  int cnt = 0;

  const int tid = ty * TW + tx;
  for (int k0 = 0; k0 < n_seg; k0 += CH) {
    // block-wide early exit; also the barrier before the chunk is reused
    if (__syncthreads_and(cnt == K || k0 >= lim)) break;
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
            int terr_stride, const int* limit, int H, int W, int n_seg,
            int* out, cudaStream_t stream) {
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  crossing_segments_kernel<K><<<grid, block, 0, stream>>>(
      ray, ray_stride, terr, terr_stride, limit, H, W, n_seg, out);
}

}  // namespace

extern "C" int crossing_segments(const void* ray, int ray_stride,
                                 const void* terr, int terr_stride,
                                 const void* limit, int H, int W, int n_seg,
                                 int K, void* out, void* stream) {
  const float* r = static_cast<const float*>(ray);
  const float* t = static_cast<const float*>(terr);
  const int* l = static_cast<const int*>(limit);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch<1>(r, ray_stride, t, terr_stride, l, H, W, n_seg, o, s); break;
    case 2: launch<2>(r, ray_stride, t, terr_stride, l, H, W, n_seg, o, s); break;
    case 3: launch<3>(r, ray_stride, t, terr_stride, l, H, W, n_seg, o, s); break;
    case 4: launch<4>(r, ray_stride, t, terr_stride, l, H, W, n_seg, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
