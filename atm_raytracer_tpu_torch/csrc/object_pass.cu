// K6: the separable object pass of the Fast generator and the
// Interpolating grid (ops/objects.py::apply_objects_planes).
//
// Replaces no Pallas kernel. The JAX package runs this pass as an XLA
// lax.scan over the objects (atm_raytracer_tpu/ops/objects.py::
// _apply_objects_planes_unrolled); the port ran it as eager PyTorch, kept as
// apply_objects_planes_plain, this kernel's oracle on the card. Its
// semantics, for every pixel (ray row h, column w):
//   * the planes widen from k_in to k_out slots (key +inf, payload 0);
//   * each object whose column window holds w, in object order, tests the
//     seg_window segments of its window (march steps min(k_lo + j, N - 1),
//     j = 0 .. kw) against the row's ray: a segment takes part if either end
//     is within the cull radius at the object's altitude (seg_close), and if
//     its step k <= the ray's first dead sample (death); a frustum gives two
//     side roots and two caps, a billboard its facing rectangle with a
//     bilinear texel; fully transparent hits drop out (alpha > 0);
//   * the object's k_per_object smallest distinct keys k + clamp(prop, 0,
//     0.999999) are its hits; equal keys average their normals and colours
//     over the match count; the other payloads are read at the key (dlat,
//     dlon lerped along the column, elevation and path length along the ray,
//     distance = key * step, kind 1), the normal rotated by the basis;
//   * the hits merge into the slots: the k_out smallest distinct keys stay,
//     an object key equal to a slot's averages with it pairwise, later hits
//     drop. A pixel's slots are sorted and distinct once its first window
//     merges: slots that are not (equal terrain keys) are first sorted
//     stably and their equal keys averaged, as the one-hot merge does.
// Invalid slots keep key +inf and payload 0, as the input planes hold them.
//
// Every floating-point operation is the plain pass's, in its order, built
// with -fmad=false, and its transcendental functions are the ones PyTorch's
// CUDA operators call (sinf, cosf, atan2f), so that K6 rounds as the eager
// pass does and decides the same hits. Sums of three or more equal keys may
// round in another order than torch.sum.
//
// Cost: the pass must read the input planes (14 * k_in floats a pixel) and
// write 14 * k_out floats a pixel once: at 1080p, k_in = 4 and k_out = 10,
// 1.63 GB, 0.49 ms at 3.35 TB/s. The culling scan evaluates the ENU terms
// at every march step of every window column (2879 x 2000 at the
// translucent benchmark's view, ~5.8 M points of four sines); the segment
// tests are H * (sum of window widths) * seg_window of them, a few hundred
// flops each (3.1 M pixel-windows of 15 segments there): ~5 GFLOP, ~0.1 ms
// at 67 TFLOP/s. So it is bound by bytes.
//
// Design: four steps on one stream, one launch of the entry point.
//  1. cull_scan_kernel, one thread a (window column, march step): the
//     culling test of ops/objects.py::object_column_tables (the distance^2
//     of the column's point at the object's altitude against its cull
//     radius^2); the first close step of a column is an atomicMax of
//     n_t - k into a zeroed word, so no step needs a start value.
//  2. window_tables_kernel, one thread a (window step, window column): the
//     window's first step, the close flags of its segments and the
//     EarthModel.enu_terms of its points ([kw+1, 3, n_cols], column-fastest
//     so that a warp's loads in step 4 are coalesced). A ray point at
//     altitude h is then (R + h) * terms (+ h - elev on the up axis): no
//     trigonometry a pixel.
//  3. widen_kernel copies the input slots into the output planes and pads
//     them, one thread an output float, so that a warp's stores are
//     contiguous (a thread a pixel would store k_out floats at a stride of
//     k_out floats, a sector a float).
//  4. object_pass_kernel, one thread a pixel, a block of 32 columns x 4
//     rows, walks the objects whose window holds its column: the windows
//     are uniform across the block, so the kind branch is too. The best two
//     keys of an object, with their normal and colour sums, stay in
//     registers. Only a pixel that an object hits touches its slot list,
//     which lives in the output planes themselves: an insertion shifts the
//     slots after it. So the list costs no registers and no local memory,
//     and k_out has no bound but the planes' 2^31 floats of 32-bit
//     indexing. A warp's 32 columns share a row: their window steps lie
//     close together, so its ray samples come through L1.

#include <cuda_runtime.h>

namespace {

constexpr int N_CH = 13;  // payload channels, ops/objects.py PLANE_CHANNELS
enum { DLAT, DLON, DIST, ELEV, PLEN, KIND, NX, NY, NZ, CR, CG, CB, CA };
constexpr int BW = 32;  // columns a block (threadIdx.x)
constexpr int BH = 4;   // rows a block (threadIdx.y)
constexpr int WIDEN_THREADS = 256;
constexpr unsigned WIDEN_BLOCKS = 4096;  // per plane, grid-stride beyond
constexpr int TABLE_THREADS = 256;
// torch.deg2rad's factor and models/earth.py DEGREE_DISTANCE, as float32
constexpr float D2R = static_cast<float>(0.017453292519943295769236907684886);
constexpr float DEGREE_DISTANCE = static_cast<float>(10000000.0 / 90.0);

struct Args {
  const float* key_in;    // [H, W, k_in]
  const float* vals_in;   // [13, H, W, k_in]
  int k_in;
  float* key_out;         // [H, W, k_out]
  float* vals_out;        // [13, H, W, k_out]
  int k_out, H, W;
  const float* ray_h;     // [H, n_path]
  const float* path_len;  // [H, n_path]
  int n_path;
  const float* dlat;      // [W, n_t] each column's geodesic
  const float* dlon;      // [W, n_t]
  int n_t;
  const float* death;     // [H] first dead sample, n_path if none
  const int* windows;     // [n_obj, 3]: col_lo, n_cols, first table column
  int n_obj, n_cols, kw;
  int* scan;              // [n_cols] scratch: n_t - the first close step, 0 if none
  int* k_lo;              // [n_cols] out of step 2: the window's first step
  float* terms;           // [kw+1, 3, n_cols] out of step 2
  unsigned char* seg_close;  // [kw, n_cols] out of step 2
  const int* kind;        // [n_obj] 0 frustum, 1 billboard
  const float* obj_dlat;  // [n_obj] relative to the observer
  const float* obj_dlon;
  const float* elev;      // [n_obj]
  const float* cull_r2;
  const float* r1;
  const float* r2;
  const float* height;
  const float* width;
  const float* rgba;      // [n_obj, 4]
  const float* basis;     // [n_obj, 3, 3] rows east, north, up
  const int* tex_id;      // [n_obj], -1 untextured
  const float* textures;  // [n_tex, tex_h, tex_w, 4]
  const float* tex_hw;    // [n_tex, 2]
  int n_tex, tex_h, tex_w;
  float lat0;             // the observer's latitude
  float radius;           // enu sphere radius (unused when flat)
  int flat;
  float f_step;
  int k_per_object;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
// p + w * x, as `p1 + w * x[..., None]`
__device__ __forceinline__ V3 lerp3(V3 p, V3 w, float x) {
  return {p.x + w.x * x, p.y + w.y * x, p.z + w.z * x};
}
// ops/objects.py::_dot: left to right
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
// torch.linalg.cross
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
// torch.where(torch.abs(x) < tiny, tiny, x)
__device__ __forceinline__ float away_from_zero(float x, float tiny) {
  return fabsf(x) < tiny ? tiny : x;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// An object's k_per_object smallest distinct keys, with the sums of the
// normals (object frame) and colours of the candidates at each key.
struct Best {
  float key[2];
  float sum[2][7];  // nx, ny, nz, r, g, b, a
  int count[2];
};

__device__ __forceinline__ void offer(Best& b, float key, V3 n, const float* c) {
  const float v[7] = {n.x, n.y, n.z, c[0], c[1], c[2], c[3]};
  if (key < b.key[0]) {
    b.key[1] = b.key[0];
    b.count[1] = b.count[0];
#pragma unroll
    for (int i = 0; i < 7; ++i) b.sum[1][i] = b.sum[0][i];
    b.key[0] = key;
    b.count[0] = 1;
#pragma unroll
    for (int i = 0; i < 7; ++i) b.sum[0][i] = v[i];
  } else if (key == b.key[0]) {
    ++b.count[0];
#pragma unroll
    for (int i = 0; i < 7; ++i) b.sum[0][i] += v[i];
  } else if (key < b.key[1]) {
    b.key[1] = key;
    b.count[1] = 1;
#pragma unroll
    for (int i = 0; i < 7; ++i) b.sum[1][i] = v[i];
  } else if (key == b.key[1]) {
    ++b.count[1];
#pragma unroll
    for (int i = 0; i < 7; ++i) b.sum[1][i] += v[i];
  }
}

// ops/objects.py::_sample_texture for one (u, v) of a valid hit
__device__ void sample_texture(const Args& a, int tex_id, float u, float v, float* out) {
  const int t = tex_id > 0 ? tex_id : 0;
  const float th = a.tex_hw[2 * t], tw = a.tex_hw[2 * t + 1];
  const float x = u * tw - 0.5f;
  const float x1 = fminf(fmaxf(floorf(x), 0.0f), tw - 2.0f);
  const float y = (1.0f - v) * th - 0.5f;
  const float y1 = fminf(fmaxf(floorf(y), 0.0f), th - 2.0f);
  const float px = x - x1, py = y - y1;
  const long long hw = (long long)a.tex_h * a.tex_w;
  long long base = t * hw + (long long)y1 * a.tex_w + (long long)x1;
  const long long top = a.n_tex * hw - a.tex_w - 2;
  base = base < 0 ? 0 : (base > top ? top : base);
  const float* p00 = a.textures + 4 * base;
  const float* p01 = a.textures + 4 * (base + a.tex_w);
  const float* p10 = a.textures + 4 * (base + 1);
  const float* p11 = a.textures + 4 * (base + a.tex_w + 1);
  const float qx = 1.0f - px, qy = 1.0f - py;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out[c] = p00[c] * qx * qy + p01[c] * qx * py + p10[c] * px * qy + p11[c] * px * py;
}

// The point at window step j of table column col, on ray row h:
// EarthModel.enu_from_terms at the ray's altitude.
__device__ __forceinline__ V3 window_point(const Args& a, int col, int k0, int h, int j,
                                           float elev_o) {
  int k = k0 + j;
  k = k < a.n_t - 1 ? k : a.n_t - 1;
  k = k < a.n_path - 1 ? k : a.n_path - 1;
  const float hh = __ldg(a.ray_h + (long long)h * a.n_path + k);
  const float* t = a.terms + (long long)j * 3 * a.n_cols + col;
  const float t0 = __ldg(t), t1 = __ldg(t + a.n_cols), t2 = __ldg(t + 2 * a.n_cols);
  if (a.flat) return {t0, t1, hh - elev_o};
  const float rp = a.radius + hh;
  return {rp * t0, rp * t1, (hh - elev_o) + rp * t2};
}

// ops/objects.py::_frustum_hits on one segment, its valid roots offered
__device__ void frustum_segment(const Args& a, int o, V3 p1, V3 p2, float seg_k, Best& b) {
  const V3 up = {0.0f, 0.0f, 1.0f};
  const float r1 = a.r1[o], r2 = a.r2[o], height = a.height[o];
  const float aa = (r2 - r1) / height;
  const float aa1 = 1.0f + aa * aa;
  const float* rgba = a.rgba + 4 * o;
  if (!(rgba[3] > 0.0f)) return;
  const V3 w = sub3(p2, p1);
  const float wsq = dot3(w, w);
  const float p1sq = dot3(p1, p1);
  const float p1v = p1.z;
  const float p1w = dot3(p1, w);
  const float wv = w.z;
  const float qa = wsq - wv * wv * aa1;
  const float qb = 2.0f * (p1w - wv * (p1v * aa1 + aa * r1));
  const float qc = p1sq - p1v * p1v * aa1 - r1 * r1 - 2.0f * aa * r1 * p1v;
  const float delta = qb * qb - 4.0f * qa * qc;
  const float sq = sqrtf(clamp_min(delta, 0.0f));
  const float safe_a = away_from_zero(qa, 1e-12f);
  const float x1 = (-qb - sq) / (2.0f * safe_a);
  const float x2 = (-qb + sq) / (2.0f * safe_a);
  const float roots[2] = {qa < 0.0f ? x2 : x1, qa < 0.0f ? x1 : x2};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float x = roots[s];
    const V3 inter = lerp3(p1, w, x);
    const float hgt = inter.z;
    if (delta >= 0.0f && x >= 0.0f && x < 1.0f && hgt >= 0.0f && hgt < height) {
      const V3 outward = {inter.x - hgt * up.x, inter.y - hgt * up.y, inter.z - hgt * up.z};
      const float den = clamp_min(sqrtf(dot3(outward, outward)), 1e-30f);
      const float ang = atan2f(r1 - r2, height);
      const float cos_a = cosf(ang), sin_a = sinf(ang);
      const V3 n = {outward.x / den * cos_a + up.x * sin_a,
                    outward.y / den * cos_a + up.y * sin_a,
                    outward.z / den * cos_a + up.z * sin_a};
      offer(b, seg_k + fminf(fmaxf(x, 0.0f), 0.999999f), n, rgba);
    }
  }
  const float safe_wv = away_from_zero(wv, 1e-12f);
#pragma unroll
  for (int s = 0; s < 2; ++s) {  // the bottom cap (h 0, r1, normal -up), the top
    const float h_cap = s ? height : 0.0f;
    const float r_cap = s ? r2 : r1;
    const float sign = s ? 1.0f : -1.0f;
    const float x = (h_cap - p1v) / safe_wv;
    const V3 at = lerp3(p1, w, x);
    const V3 out = {at.x - h_cap * up.x, at.y - h_cap * up.y, at.z - h_cap * up.z};
    if (dot3(out, out) < r_cap * r_cap && x >= 0.0f && x < 1.0f) {
      const V3 n = {up.x * sign, up.y * sign, up.z * sign};
      offer(b, seg_k + fminf(fmaxf(x, 0.0f), 0.999999f), n, rgba);
    }
  }
}

// ops/objects.py::_billboard_hit (and the texel) on one segment
__device__ void billboard_segment(const Args& a, int o, V3 p1, V3 p2, float seg_k, Best& b) {
  const V3 up = {0.0f, 0.0f, 1.0f};
  const float height = a.height[o], width = a.width[o];
  const V3 ray = sub3(p2, p1);
  V3 right = cross3(ray, up);
  const float rden = clamp_min(sqrtf(dot3(right, right)), 1e-30f);
  right = {right.x / rden, right.y / rden, right.z / rden};
  const V3 front = cross3(right, up);
  const float safe = away_from_zero(dot3(ray, front), 1e-30f);
  const float prop = -dot3(p1, front) / safe;
  const V3 inter = lerp3(p1, ray, prop);
  const float y = inter.z;
  const float x = dot3(inter, right);
  const float half = width * 0.5f;
  if (!(prop >= 0.0f && prop < 1.0f && y >= 0.0f && y < height && x >= -width * 0.5f &&
        x < half))
    return;
  float c[4];
  const int tex = a.tex_id[o];
  if (tex >= 0) {
    sample_texture(a, tex, (x + half) / width, y / height, c);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = a.rgba[4 * o + i];
  }
  if (c[3] > 0.0f) offer(b, seg_k + fminf(fmaxf(prop, 0.0f), 0.999999f), front, c);
}

// a per-column or per-ray field [rows, n] lerped at key k + prop
__device__ __forceinline__ float lerp_field(const float* row, int n, float key) {
  const float kf = floorf(key);
  const float prop = key - kf;
  long long k = (long long)kf;
  k = k < 0 ? 0 : (k > n - 2 ? n - 2 : k);
  return row[k] * (1.0f - prop) + row[k + 1] * prop;
}

// The 13 payload channels of an object's hit r at its key.
__device__ void hit_payload(const Args& a, int o, int h, int w, const Best& b, int r,
                            float* p) {
  const float key = b.key[r];
  const float inv = 1.0f / (float)b.count[r];
  const float n0 = b.sum[r][0] * inv, n1 = b.sum[r][1] * inv, n2 = b.sum[r][2] * inv;
  const float* m = a.basis + 9 * o;
  p[DLAT] = lerp_field(a.dlat + (long long)w * a.n_t, a.n_t, key);
  p[DLON] = lerp_field(a.dlon + (long long)w * a.n_t, a.n_t, key);
  p[DIST] = key * a.f_step;
  p[ELEV] = lerp_field(a.ray_h + (long long)h * a.n_path, a.n_path, key);
  p[PLEN] = lerp_field(a.path_len + (long long)h * a.n_path, a.n_path, key);
  p[KIND] = 1.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) p[NX + d] = n0 * m[d] + n1 * m[3 + d] + n2 * m[6 + d];
#pragma unroll
  for (int c = 0; c < 4; ++c) p[CR + c] = b.sum[r][3 + c] * inv;
}

// Merge one hit (key, payload) into a pixel's sorted, distinct slots.
__device__ void insert_hit(float* key, float* vals, long long ch, int k_out, float k,
                           const float* p) {
  int pos = 0;
  while (pos < k_out && key[pos] < k) ++pos;
  if (pos == k_out) return;
  if (key[pos] == k) {  // two inputs at one key: their average
#pragma unroll
    for (int c = 0; c < N_CH; ++c) vals[c * ch + pos] = (vals[c * ch + pos] + p[c]) * 0.5f;
    return;
  }
  for (int s = k_out - 1; s > pos; --s) {
    key[s] = key[s - 1];
#pragma unroll
    for (int c = 0; c < N_CH; ++c) vals[c * ch + s] = vals[c * ch + s - 1];
  }
  key[pos] = k;
#pragma unroll
  for (int c = 0; c < N_CH; ++c) vals[c * ch + pos] = p[c];
}

// Sort a pixel's slots stably by key, then average each run of equal
// finite keys (their payloads summed in slot order, times one over the
// count); +inf slots get payload 0.
__device__ void canonicalize(float* key, float* vals, long long ch, int k_out) {
  for (int i = 1; i < k_out; ++i) {
    for (int j = i; j > 0 && key[j - 1] > key[j]; --j) {
      const float t = key[j];
      key[j] = key[j - 1];
      key[j - 1] = t;
      for (int c = 0; c < N_CH; ++c) {
        const float v = vals[c * ch + j];
        vals[c * ch + j] = vals[c * ch + j - 1];
        vals[c * ch + j - 1] = v;
      }
    }
  }
  int out = 0, s = 0;
  while (s < k_out && key[s] < inf()) {
    int e = s + 1;
    while (e < k_out && key[e] == key[s]) ++e;
    const float inv = 1.0f / (float)(e - s);
    for (int c = 0; c < N_CH; ++c) {
      float acc = vals[c * ch + s];
      for (int t = s + 1; t < e; ++t) acc += vals[c * ch + t];
      vals[c * ch + out] = acc * inv;
    }
    key[out++] = key[s];
    s = e;
  }
  for (; out < k_out; ++out) {
    key[out] = inf();
    for (int c = 0; c < N_CH; ++c) vals[c * ch + out] = 0.0f;
  }
}

// EarthModel.enu_terms of the point (dlat_p, dlon_p) in object o's frame
__device__ V3 enu_terms(const Args& a, int o, float dlat_p, float dlon_p) {
  const float dlat_o = a.obj_dlat[o], dlon_o = a.obj_dlon[o];
  if (a.flat) {
    const float r_o = (90.0f - (dlat_o + a.lat0)) * DEGREE_DISTANCE;
    const float dr = -(dlat_p - dlat_o) * DEGREE_DISTANCE;
    const float dlon_r = (dlon_p - dlon_o) * D2R;
    const float r_p = r_o + dr;
    const float s = sinf(dlon_r * 0.5f);
    return {r_p * sinf(dlon_r), -dr + r_p * 2.0f * (s * s), 0.0f};
  }
  const float lo = (dlat_o + a.lat0) * D2R;
  const float sin_o = sinf(lo), cos_o = cosf(lo);
  const float dlat_r = (dlat_p - dlat_o) * D2R;
  const float dlon_r = (dlon_p - dlon_o) * D2R;
  const float cos_p = cosf((dlat_p + a.lat0) * D2R);
  const float s = sinf(dlon_r * 0.5f);
  const float two_s2_lon = 2.0f * (s * s);
  const float t = sinf(dlat_r * 0.5f);
  return {cos_p * sinf(dlon_r), sinf(dlat_r) + cos_p * sin_o * two_s2_lon,
          -2.0f * (t * t) - cos_p * cos_o * two_s2_lon};
}

// The culling test of column w's step k for object o: its point at the
// object's altitude within the cull radius (EarthModel.enu_from_terms).
__device__ bool close_at(const Args& a, int o, int w, int k) {
  const long long i = (long long)w * a.n_t + k;
  const V3 t = enu_terms(a, o, a.dlat[i], a.dlon[i]);
  const float e = a.elev[o];
  V3 rel = {t.x, t.y, e - e};
  if (!a.flat) {
    const float rp = a.radius + e;
    rel = {rp * t.x, rp * t.y, (e - e) + rp * t.z};
  }
  return dot3(rel, rel) < a.cull_r2[o];
}

// The object and frame column of table column c.
__device__ __forceinline__ void column_of(const Args& a, int c, int& o, int& w) {
  o = 0;
  while (c >= a.windows[3 * o + 2] + a.windows[3 * o + 1]) ++o;
  w = a.windows[3 * o] + (c - a.windows[3 * o + 2]);
}

__global__ void __launch_bounds__(TABLE_THREADS) cull_scan_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * TABLE_THREADS + threadIdx.x;
  if (i >= (long long)a.n_cols * a.n_t) return;
  const int c = (int)(i / a.n_t), k = (int)(i - (long long)c * a.n_t);
  int o, w;
  column_of(a, c, o, w);
  if (close_at(a, o, w, k)) atomicMax(a.scan + c, a.n_t - k);
}

__global__ void __launch_bounds__(TABLE_THREADS) window_tables_kernel(const Args a) {
  const int i = blockIdx.x * TABLE_THREADS + threadIdx.x;
  if (i >= a.n_cols * (a.kw + 1)) return;
  const int j = i / a.n_cols, c = i - j * a.n_cols;
  int o, w;
  column_of(a, c, o, w);
  // one step before the first close one, the window inside the march
  const int top = a.n_t - a.kw - 1 > 0 ? a.n_t - a.kw - 1 : 0;
  int k0 = a.n_t - a.scan[c] - 1;
  k0 = k0 < 0 ? 0 : (k0 > top ? top : k0);
  if (j == 0) a.k_lo[c] = k0;
  const int k = k0 + j < a.n_t - 1 ? k0 + j : a.n_t - 1;
  const long long p = (long long)w * a.n_t + k;
  const V3 t = enu_terms(a, o, a.dlat[p], a.dlon[p]);
  float* out = a.terms + (long long)j * 3 * a.n_cols + c;
  out[0] = t.x;
  out[a.n_cols] = t.y;
  out[2 * a.n_cols] = t.z;
  if (j < a.kw) {  // a segment takes part if either end is close
    const int k2 = k + 1 < a.n_t - 1 ? k + 1 : a.n_t - 1;
    a.seg_close[(long long)j * a.n_cols + c] = close_at(a, o, w, k) || close_at(a, o, w, k2);
  }
}

// The input slots widened into the output planes: plane 0 the keys (padded
// with +inf), planes 1..13 the payload channels (padded with 0).
__global__ void __launch_bounds__(WIDEN_THREADS) widen_kernel(const Args a) {
  const unsigned n_pix = (unsigned)a.H * a.W;
  const unsigned per = n_pix * a.k_out;  // floats an output plane
  const int c = blockIdx.y;
  const float* in = c ? a.vals_in + (size_t)(c - 1) * n_pix * a.k_in : a.key_in;
  float* out = c ? a.vals_out + (size_t)(c - 1) * per : a.key_out;
  const float pad = c ? 0.0f : inf();
  for (unsigned r = blockIdx.x * WIDEN_THREADS + threadIdx.x; r < per;
       r += gridDim.x * WIDEN_THREADS) {
    const unsigned pix = r / a.k_out, s = r - pix * a.k_out;
    out[r] = s < (unsigned)a.k_in ? in[(size_t)pix * a.k_in + s] : pad;
  }
}

// Whether a pixel's input slots are sorted and distinct (+inf repeats).
__device__ bool sorted_input(const Args& a, long long pix) {
  const float* kin = a.key_in + pix * a.k_in;
  float prev = -inf();
  for (int s = 0; s < a.k_in; ++s) {
    const float k = kin[s];
    if (!(k > prev || (k == inf() && prev == inf()))) return false;
    prev = k;
  }
  return true;
}

__global__ void __launch_bounds__(BW * BH) object_pass_kernel(const Args a) {
  const int w = blockIdx.x * BW + threadIdx.x;
  const int h = blockIdx.y * BH + threadIdx.y;
  if (w >= a.W || h >= a.H) return;
  const long long pix = (long long)h * a.W + w;
  float* key = a.key_out + pix * a.k_out;
  float* vals = a.vals_out + pix * a.k_out;
  const long long ch = (long long)a.H * a.W * a.k_out;  // channel stride
  const float death = a.death[h];
  bool first = true;
  for (int o = 0; o < a.n_obj; ++o) {
    const int lo = a.windows[3 * o], n = a.windows[3 * o + 1];
    if (w < lo || w >= lo + n) continue;
    if (first) {  // the first merge sorts the slots and averages equal keys
      first = false;
      if (!sorted_input(a, pix)) canonicalize(key, vals, ch, a.k_out);
    }
    const int col = a.windows[3 * o + 2] + (w - lo);
    const int k0 = a.k_lo[col];
    const float elev_o = a.elev[o];
    const bool frustum = a.kind[o] == 0;
    Best b;
    b.key[0] = b.key[1] = inf();
    b.count[0] = b.count[1] = 0;
    V3 p1 = {0.0f, 0.0f, 0.0f}, p2 = p1;
    int have = -1;  // the window step p2 holds
    for (int j = 0; j < a.kw; ++j) {
      if (!a.seg_close[(long long)j * a.n_cols + col]) continue;
      int k = k0 + j;
      k = k < a.n_t - 1 ? k : a.n_t - 1;
      const float seg_k = (float)k;
      if (!(seg_k <= death)) continue;
      p1 = have == j ? p2 : window_point(a, col, k0, h, j, elev_o);
      p2 = window_point(a, col, k0, h, j + 1, elev_o);
      have = j + 1;
      if (frustum)
        frustum_segment(a, o, p1, p2, seg_k, b);
      else
        billboard_segment(a, o, p1, p2, seg_k, b);
    }
    if (!(b.key[0] < inf())) continue;
    float p[N_CH];
    if (a.k_per_object > 1 && b.key[1] < inf()) {
      hit_payload(a, o, h, w, b, 1, p);
      insert_hit(key, vals, ch, a.k_out, b.key[1], p);
    }
    hit_payload(a, o, h, w, b, 0, p);
    insert_hit(key, vals, ch, a.k_out, b.key[0], p);
  }
}

}  // namespace

// One frame: the planes key_in [H, W, k_in] and vals_in [13, H, W, k_in]
// widened to key_out [H, W, k_out] and vals_out [13, H, W, k_out], every
// object merged in (see the note above). windows [n_obj, 3] lays the
// objects' column windows out as n_cols table columns; scan, k_lo, terms and
// seg_close are scratch of n_cols columns that steps 1 and 2 fill (the
// outputs of ops/objects.py::object_column_tables). Every pointer is a
// contiguous device array; everything goes on `stream`.
extern "C" int object_pass(const void* key_in, const void* vals_in, int k_in,
                           void* key_out, void* vals_out, int k_out, int H, int W,
                           const void* ray_h, const void* path_len, int n_path,
                           const void* dlat, const void* dlon, int n_t,
                           const void* death, const void* windows, int n_obj,
                           int n_cols, int kw, void* scan, void* k_lo,
                           void* terms, void* seg_close, const void* kind,
                           const void* obj_dlat, const void* obj_dlon,
                           const void* elev, const void* cull_r2, const void* r1,
                           const void* r2, const void* height, const void* width,
                           const void* rgba, const void* basis,
                           const void* tex_id, const void* textures,
                           const void* tex_hw, int n_tex, int tex_h, int tex_w,
                           float lat0, float radius, int flat, float f_step,
                           int k_per_object, void* stream) {
  if (k_in < 1 || k_out < k_in || H < 0 || W < 0 || n_path < 2 || n_t < 2 ||
      kw < 1 || n_obj < 1 || n_cols < 0 || n_tex < 1 || k_per_object < 1 ||
      k_per_object > 2 || (H + BH - 1) / BH > 65535 ||
      (long long)H * W * k_out >= (1LL << 31) || (long long)n_cols * (kw + 1) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.key_in = static_cast<const float*>(key_in);
  a.vals_in = static_cast<const float*>(vals_in);
  a.k_in = k_in;
  a.key_out = static_cast<float*>(key_out);
  a.vals_out = static_cast<float*>(vals_out);
  a.k_out = k_out;
  a.H = H;
  a.W = W;
  a.ray_h = static_cast<const float*>(ray_h);
  a.path_len = static_cast<const float*>(path_len);
  a.n_path = n_path;
  a.dlat = static_cast<const float*>(dlat);
  a.dlon = static_cast<const float*>(dlon);
  a.n_t = n_t;
  a.death = static_cast<const float*>(death);
  a.windows = static_cast<const int*>(windows);
  a.n_obj = n_obj;
  a.n_cols = n_cols;
  a.kw = kw;
  a.scan = static_cast<int*>(scan);
  a.k_lo = static_cast<int*>(k_lo);
  a.terms = static_cast<float*>(terms);
  a.seg_close = static_cast<unsigned char*>(seg_close);
  a.kind = static_cast<const int*>(kind);
  a.obj_dlat = static_cast<const float*>(obj_dlat);
  a.obj_dlon = static_cast<const float*>(obj_dlon);
  a.elev = static_cast<const float*>(elev);
  a.cull_r2 = static_cast<const float*>(cull_r2);
  a.r1 = static_cast<const float*>(r1);
  a.r2 = static_cast<const float*>(r2);
  a.height = static_cast<const float*>(height);
  a.width = static_cast<const float*>(width);
  a.rgba = static_cast<const float*>(rgba);
  a.basis = static_cast<const float*>(basis);
  a.tex_id = static_cast<const int*>(tex_id);
  a.textures = static_cast<const float*>(textures);
  a.tex_hw = static_cast<const float*>(tex_hw);
  a.n_tex = n_tex;
  a.tex_h = tex_h;
  a.tex_w = tex_w;
  a.lat0 = lat0;
  a.radius = radius;
  a.flat = flat;
  a.f_step = f_step;
  a.k_per_object = k_per_object;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n_cols > 0) {
    err = cudaMemsetAsync(scan, 0, sizeof(int) * n_cols, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long points = (long long)n_cols * n_t;
    const unsigned scan_grid = (unsigned)((points + TABLE_THREADS - 1) / TABLE_THREADS);
    cull_scan_kernel<<<scan_grid, TABLE_THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned table_grid = (unsigned)((n_cols * (kw + 1) + TABLE_THREADS - 1) / TABLE_THREADS);
    window_tables_kernel<<<table_grid, TABLE_THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned per = (unsigned)(H * W) * k_out;
  const unsigned widen_blocks = (per + WIDEN_THREADS - 1) / WIDEN_THREADS;
  dim3 widen_grid(widen_blocks < WIDEN_BLOCKS ? widen_blocks : WIDEN_BLOCKS, 1 + N_CH);
  widen_kernel<<<widen_grid, WIDEN_THREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(BW, BH);
  dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH);
  object_pass_kernel<<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
