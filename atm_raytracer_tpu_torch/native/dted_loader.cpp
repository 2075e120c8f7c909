// Native terrain tile loader: threaded DTED parsing into caller buffers.
//
// Replaces the reference's data-loading layer (the `dted` crate,
// src/terrain/mod.rs:4,24,86) with a C++ equivalent: parse of
// MIL-PRF-89020B tiles, signed-magnitude elevation decode, void (-32767)
// -> 0 mapping, south-first row output, one worker thread per tile (up to
// a cap). Output is bit-equal to terrain/dted.py's read_dted. Exposed
// through ctypes (terrain/native.py).
//
// Built at first use by atm_raytracer_tpu_torch/_kernels.py (g++ -O3
// -shared -fPIC -std=c++17 -pthread) into atm_raytracer_tpu_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kUhlLen = 80;
constexpr int kDsiLen = 648;
constexpr int kAccLen = 2700;
constexpr int kDataOffset = kUhlLen + kDsiLen + kAccLen;
constexpr int16_t kVoid = -32767;

int parse_int(const char* p, int len) {
  int v = 0;
  for (int i = 0; i < len; ++i) {
    if (p[i] < '0' || p[i] > '9') return -1;
    v = v * 10 + (p[i] - '0');
  }
  return v;
}

double parse_angle(const char* p, int len) {
  // DDDMMSS + hemisphere (len includes the hemisphere char)
  int digits = len - 1;
  int sec = parse_int(p + digits - 2, 2);
  int min = parse_int(p + digits - 4, 2);
  int deg = parse_int(p, digits - 4);
  if (sec < 0 || min < 0 || deg < 0) return -9999.0;
  double v = deg + min / 60.0 + sec / 3600.0;
  char hemi = p[len - 1];
  if (hemi == 'S' || hemi == 'W') v = -v;
  return v;
}

struct Header {
  double lat, lon;
  int n_lon, n_lat;
  bool ok;
};

Header read_header(FILE* f) {
  Header h{0, 0, 0, 0, false};
  char uhl[kUhlLen];
  if (fread(uhl, 1, kUhlLen, f) != kUhlLen) return h;
  if (memcmp(uhl, "UHL1", 4) != 0) return h;
  h.lon = parse_angle(uhl + 4, 8);
  h.lat = parse_angle(uhl + 12, 8);
  h.n_lon = parse_int(uhl + 47, 4);
  h.n_lat = parse_int(uhl + 51, 4);
  h.ok = h.lon > -9000 && h.lat > -9000 && h.n_lon > 0 && h.n_lat > 0;
  return h;
}

// Parse one tile into out[n_lat * stride] (row 0 = south), returns 0 on ok.
int load_one(const char* path, float* out, int64_t stride, int expect_rows,
             int expect_cols, double* origin) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  Header h = read_header(f);
  if (!h.ok || h.n_lat > expect_rows || h.n_lon > expect_cols) {
    fclose(f);
    return 2;
  }
  origin[0] = h.lat;
  origin[1] = h.lon;
  const int rec_len = 12 + 2 * h.n_lat;
  if (fseek(f, kDataOffset, SEEK_SET) != 0) {
    fclose(f);
    return 3;
  }
  // the whole data section in one read; a record is one longitude line
  // (south -> north), an output row one latitude, so the decode transposes
  // in blocks of kBlock latitudes: rows are written kBlock at a time
  // instead of one post per row per record
  std::vector<uint8_t> data(static_cast<size_t>(rec_len) * h.n_lon);
  const size_t got = fread(data.data(), 1, data.size(), f);
  fclose(f);
  for (int j = 0; j < h.n_lon; ++j) {
    if (got < static_cast<size_t>(rec_len) * (j + 1)) return 4;
    if (data[static_cast<size_t>(rec_len) * j] != 0xAA) return 5;
  }
  constexpr int kBlock = 32;
  for (int i0 = 0; i0 < h.n_lat; i0 += kBlock) {
    const int i1 = i0 + kBlock < h.n_lat ? i0 + kBlock : h.n_lat;
    for (int j = 0; j < h.n_lon; ++j) {
      const uint8_t* d = data.data() + static_cast<size_t>(rec_len) * j + 8;
      for (int i = i0; i < i1; ++i) {
        uint16_t w = (static_cast<uint16_t>(d[2 * i]) << 8) | d[2 * i + 1];
        int16_t v = (w & 0x8000) ? -static_cast<int16_t>(w & 0x7FFF)
                                 : static_cast<int16_t>(w);
        if (v == kVoid) v = 0;
        out[static_cast<int64_t>(i) * stride + j] = static_cast<float>(v);
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Header probe: fills lat/lon/n_lat/n_lon; returns 0 on success.
int dted_probe(const char* path, double* lat, double* lon, int* n_lat,
               int* n_lon) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  Header h = read_header(f);
  fclose(f);
  if (!h.ok) return 2;
  *lat = h.lat;
  *lon = h.lon;
  *n_lat = h.n_lat;
  *n_lon = h.n_lon;
  return 0;
}

// Batch load: n tiles into out[n, rows, cols] (padded, row 0 = south).
// paths: concatenated NUL-separated strings. origins: [n, 2] (lat, lon).
// status: [n] per-tile return code. Runs one thread per tile (capped).
void dted_load_batch(const char* paths, int n, float* out, double* origins,
                     int* status, int rows, int cols, int max_threads) {
  std::vector<const char*> ptrs(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    ptrs[i] = p;
    p += strlen(p) + 1;
  }
  const int64_t tile_elems = static_cast<int64_t>(rows) * cols;
  int n_threads = max_threads > 0 ? max_threads : 8;
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> workers;
  auto work = [&](int t) {
    for (int i = t; i < n; i += n_threads) {
      status[i] = load_one(ptrs[i], out + i * tile_elems, cols, rows, cols,
                           origins + 2 * i);
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();
}

}  // extern "C"
