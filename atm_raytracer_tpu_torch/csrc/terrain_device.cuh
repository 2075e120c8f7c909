// Device code of the terrain along a ray's own geodesic, shared by kernels
// that test a ray against the terrain at its own azimuth (K5, rect_exact.cu):
// the four geodesic forms of models/earth.py::EarthModel.geodesic_delta and
// the bilinear sample of terrain/sample.py::sample_elevation (_locate and
// _combine_taps), each in the operations and the order of the PyTorch ops it
// mirrors, one value at a time.
//
// Rounding is the plain version's as PyTorch computes it on the card: no
// contraction (-fmad=false), IEEE division and square root, the CUDA math
// library's sinf, cosf, asinf, atanf and atan2f (PyTorch's CUDA kernels call
// the same functions). Two rules of PyTorch's CUDA arithmetic are mirrored:
// a tensor divided by a host scalar b is multiplied by float(1 / float(b))
// (div_scalar), and a product with a host scalar rounds the scalar to float
// first. The host passes every scalar the plain expressions hold, rounded to
// float32 as they are (generators/rectilinear.py::geodesic_form).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// the geodesic forms, by the model's kind (EarthModel._canonical().kind)
enum GeoForm {
  GEO_FLAT = 0,      // FlatDistorted: lat-scaled flat
  GEO_AE = 1,        // AzimuthalEquidistant: the line in the polar projection
  GEO_SPHERE = 2,    // Spherical, ObserverAe: the great circle in delta form
  GEO_VINCENTY = 3,  // Ellipsoid: Vincenty direct, 12 fixed iterations
};

constexpr int GEO_CONSTS = 12;
// the float32 constants of each form, in this order:
//   FLAT      0 DEGREE_DISTANCE, 1 cos(lat0)
//   AE        0 DEGREE_DISTANCE, 1 r0 = (90 - lat0) DEGREE_DISTANCE
//   SPHERE    0 radius, 1 z0 = sin(lat0), 2 c0 = cos(lat0)
//   VINCENTY  0 b, 1 z0 = sin(U1), 2 c0 = cos(U1), 3 tan(U1), 4 delta(U1),
//             5 f, 6 (a^2 - b^2) / b^2, 7 f / 16, 8 U1
struct GeoSpec {
  float c[GEO_CONSTS];
};

// torch.rad2deg and torch.deg2rad: products with these doubles as float
constexpr double GEO_180_PI = 57.295779513082320876798154814105170332405472466564;
constexpr double GEO_PI_180 = 0.017453292519943295769236907684886127134428718885417;

// x / b for a host scalar b, as PyTorch's CUDA division computes it
__device__ __forceinline__ float div_scalar(float x, float b) { return x * (1.0f / b); }

// torch.clamp(min=lo) and torch.clamp(lo, hi): NaN passes through
__device__ __forceinline__ float clamp_min_nan(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// what a form needs of the azimuth, computed once a ray
struct GeoRay {
  float cos_az, sin_az;
  // Vincenty: sigma1, sin(alpha), A, B, C, (1 - C) f sin(alpha)
  float sig1, sin_alfa, cap_a, cap_b, cap_c, dl_scale;
};

template <int FORM>
__device__ __forceinline__ GeoRay geo_ray(const GeoSpec& g, float az_deg) {
  GeoRay r;
  const float az = az_deg * (float)GEO_PI_180;
  r.cos_az = cosf(az);
  r.sin_az = sinf(az);
  r.sig1 = r.sin_alfa = r.cap_a = r.cap_b = r.cap_c = r.dl_scale = 0.0f;
  if (FORM == GEO_VINCENTY) {
    const float c0 = g.c[2], tan_u1 = g.c[3], ff = g.c[5], k_u2 = g.c[6], f16 = g.c[7];
    r.sig1 = atan2f(tan_u1, r.cos_az);
    r.sin_alfa = c0 * r.sin_az;
    const float cos2 = 1.0f - r.sin_alfa * r.sin_alfa;
    const float u2c = cos2 * k_u2;
    r.cap_a = 1.0f + div_scalar(u2c, 256.0f) * (64.0f + u2c * (-12.0f + 5.0f * u2c));
    r.cap_b = div_scalar(u2c, 512.0f) * (128.0f + u2c * (-64.0f + 37.0f * u2c));
    r.cap_c = f16 * cos2 * (4.0f + ff * (4.0f - 3.0f * cos2));
    r.dl_scale = (1.0f - r.cap_c) * ff * r.sin_alfa;
  }
  return r;
}

// sin(dlat) of the great-circle delta form (models/earth.py::_sphere_delta_device
// and the auxiliary sphere of _vincenty_delta_device)
__device__ __forceinline__ float sphere_sin_dlat(float z0, float c0, float two_s2, float sin_s,
                                                 float cos_az) {
  const float dz = -z0 * two_s2 + c0 * sin_s * cos_az;
  float eps = div_scalar((2.0f * z0 + dz) * dz, c0 * c0);
  eps = clamp_min_nan(eps, -1.0f);
  return c0 * dz + z0 * c0 * eps / (1.0f + sqrtf(clamp_min_nan(1.0f - eps, 0.0f)));
}

// (dlat, dlon) in degrees from the observer along the ray's azimuth at dist
template <int FORM>
__device__ __forceinline__ void geo_delta(const GeoSpec& g, const GeoRay& r, float dist,
                                          float& dlat, float& dlon) {
  const float r2d = (float)GEO_180_PI;
  if (FORM == GEO_FLAT) {
    dlat = div_scalar(r.cos_az * dist, g.c[0]);
    dlon = div_scalar(div_scalar(r.sin_az * dist, g.c[0]), g.c[1]);
  } else if (FORM == GEO_AE) {
    const float r0 = g.c[1];
    const float dxr = -r.cos_az * dist;
    const float dxt = r.sin_az * dist;
    const float s = r0 + dxr;
    const float r2 = sqrtf(s * s + dxt * dxt);
    const float dr = (2.0f * r0 * dxr + dxr * dxr + dxt * dxt) / (r2 + r0);
    dlat = div_scalar(-dr, g.c[0]);
    dlon = atan2f(dxt, r0 + dxr) * r2d;
  } else if (FORM == GEO_SPHERE) {
    const float z0 = g.c[1], c0 = g.c[2];
    const float sigma = div_scalar(dist, g.c[0]);
    const float sin_s = sinf(sigma);
    const float sh = sinf(sigma * 0.5f);
    const float two_s2 = 2.0f * (sh * sh);
    const float sin_dlat = sphere_sin_dlat(z0, c0, two_s2, sin_s, r.cos_az);
    dlat = asinf(clamp_nan(sin_dlat, -1.0f, 1.0f)) * r2d;
    const float denom = c0 * (1.0f - two_s2) - z0 * sin_s * r.cos_az;
    dlon = atan2f(sin_s * r.sin_az, denom) * r2d;
  } else {  // GEO_VINCENTY
    const float z0 = g.c[1], c0 = g.c[2], delta1 = g.c[4], ff = g.c[5], u1 = g.c[8];
    const float base = div_scalar(dist, g.c[0]) / r.cap_a;
    float sig = base;
    for (int i = 0; i < 12; ++i) {
      const float cm = cosf(2.0f * r.sig1 + sig);
      const float dsig = r.cap_b * sinf(sig) *
                         (cm + div_scalar(r.cap_b, 4.0f) * cosf(sig) * (-1.0f + 2.0f * (cm * cm)));
      sig = base + dsig;
    }
    const float sin_s = sinf(sig);
    const float cos_s = cosf(sig);
    const float sh = sinf(sig * 0.5f);
    const float two_s2 = 2.0f * (sh * sh);
    const float sin_du = sphere_sin_dlat(z0, c0, two_s2, sin_s, r.cos_az);
    const float du = asinf(clamp_nan(sin_du, -1.0f, 1.0f));
    const float u2_abs = u1 + du;
    const float cu = cosf(u2_abs);
    const float delta2 = atanf(ff * sinf(u2_abs) * cu / (1.0f - ff * (cu * cu)));
    dlat = (du + (delta2 - delta1)) * r2d;
    const float cm = cosf(2.0f * r.sig1 + sig);
    const float lam = atanf(sin_s * r.sin_az / (c0 * cos_s - z0 * sin_s * r.cos_az));
    const float dl =
        lam - r.dl_scale * (sig + r.cap_c * sin_s *
                                      (cm + r.cap_c * cos_s * (-1.0f + 2.0f * (cm * cm))));
    dlon = dl * r2d;
  }
}

// the terrain mosaic (terrain/store.py::TerrainPack) as the sampler reads it
struct TerrainSpec {
  const void* tiles;  // [T, S, S] int16 or float32
  int tiles_f32;
  const float* rows_m1;  // [T]
  const float* cols_m1;  // [T]
  int s;
  int n_rows, n_cols;
  long long row_off, col_off;  // floor(lat0) - lat_min, floor(lon0) - lon_min
  float frac_lat, frac_lon;    // float32(lat0 - floor(lat0)), likewise lon0
};

__device__ __forceinline__ float tile_post(const TerrainSpec& t, long long i) {
  return t.tiles_f32 ? __ldg(static_cast<const float*>(t.tiles) + i)
                     : (float)__ldg(static_cast<const short*>(t.tiles) + i);
}

// bilinear elevation at (lat0 + dlat, lon0 + dlon); 0 outside the mosaic
// (terrain/sample.py::sample_elevation without the gradient)
__device__ __forceinline__ float sample_elevation(const TerrainSpec& t, float dlat, float dlon) {
  const float a_lat = dlat + t.frac_lat;
  const float a_lon = dlon + t.frac_lon;
  const float cell_lat = floorf(a_lat);
  const float cell_lon = floorf(a_lon);
  const float local_lat = a_lat - cell_lat;
  const float local_lon = a_lon - cell_lon;
  const long long row = (long long)cell_lat + t.row_off;
  const long long col = (long long)cell_lon + t.col_off;
  const bool valid = row >= 0 && row < t.n_rows && col >= 0 && col < t.n_cols;
  const long long tile = min(max(row, 0LL), (long long)t.n_rows - 1) * t.n_cols +
                         min(max(col, 0LL), (long long)t.n_cols - 1);
  const float rm1 = __ldg(t.rows_m1 + tile);
  const float cm1 = __ldg(t.cols_m1 + tile);
  const float r = local_lat * rm1;
  const float c = local_lon * cm1;
  // torch.minimum(floor(r), rows - 1) as an index; kept inside the tile so
  // that a NaN position (no valid sample either way) reads no stray address
  const long long ri = min(max((long long)fminf(floorf(r), rm1 - 1.0f), 0LL), (long long)t.s - 2);
  const long long ci = min(max((long long)fminf(floorf(c), cm1 - 1.0f), 0LL), (long long)t.s - 2);
  const float rf = r - (float)ri;
  const float cf = c - (float)ci;
  const long long base = tile * t.s * t.s + ri * t.s + ci;
  const float e00 = tile_post(t, base);
  const float e10 = tile_post(t, base + t.s);
  const float e01 = tile_post(t, base + 1);
  const float e11 = tile_post(t, base + t.s + 1);
  const float elev = e00 * (1.0f - rf) * (1.0f - cf) + e10 * rf * (1.0f - cf) +
                     e01 * (1.0f - rf) * cf + e11 * rf * cf;
  return valid ? elev : 0.0f;
}
