// Native GeoTIFF tile decoder: threaded baseline-TIFF parsing into caller
// buffers.
//
// Replaces the reference's `geotiff-rs` crate (src/terrain/geotiff.rs) data
// path with a C++ equivalent covering exactly the feature set SRTM-style
// tiles use (mirrors terrain/geotiff.py): both byte orders, strip storage,
// compression none/Deflate (zlib), samples i16/u16/i32/f32. Output is
// float32 with SOUTH-first rows (the store's Tile orientation — the image
// is north-first on disk, flipped here instead of in Python). One worker
// thread per tile, like dted_loader.
//
// Anything outside that feature set sets a nonzero per-tile status and the
// Python caller hands the file to terrain/geotiff.py (which raises the
// clear message). Output is bit-equal to terrain/geotiff.py's read_geotiff,
// flipped.
//
// Built at first use by atm_raytracer_tpu_torch/_kernels.py (g++ -O3
// -shared -fPIC -std=c++17 -pthread -lz) into
// atm_raytracer_tpu_torch/_build/.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  bool big;  // MM byte order

  uint16_t u16(size_t off) const {
    if (off + 2 > n) return 0;
    return big ? (p[off] << 8) | p[off + 1] : p[off] | (p[off + 1] << 8);
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) return 0;
    return big ? (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                     (uint32_t(p[off + 2]) << 8) | p[off + 3]
               : uint32_t(p[off]) | (uint32_t(p[off + 1]) << 8) |
                     (uint32_t(p[off + 2]) << 16) | (uint32_t(p[off + 3]) << 24);
  }
};

constexpr int kTypeSizes[13] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8};

struct Tiff {
  uint32_t width = 0, height = 0;
  uint32_t bits = 16, compression = 1, sample_format = 2;
  std::vector<uint64_t> offsets, counts;
  bool ok = false;
};

// Read one IFD entry's values as unsigned integers (SHORT/LONG only — the
// tags we consume are counts and offsets).
bool read_values(const Reader& r, size_t entry, std::vector<uint64_t>* out) {
  uint16_t type = r.u16(entry + 2);
  uint32_t count = r.u32(entry + 4);
  if (type < 1 || type > 12 || count == 0) return false;
  size_t size = size_t(kTypeSizes[type]) * count;
  size_t data = (size <= 4) ? entry + 8 : r.u32(entry + 8);
  if (data + size > r.n) return false;
  out->clear();
  out->reserve(count);
  for (uint32_t i = 0; i < count; ++i) {
    switch (type) {
      case 1: out->push_back(r.p[data + i]); break;          // BYTE
      case 3: out->push_back(r.u16(data + i * 2)); break;    // SHORT
      case 4: out->push_back(r.u32(data + i * 4)); break;    // LONG
      default: return false;
    }
  }
  return true;
}

Tiff parse_header(const Reader& r) {
  Tiff t;
  uint16_t magic = r.u16(2);
  if (magic != 42) return t;
  uint32_t ifd = r.u32(4);
  uint16_t n_entries = r.u16(ifd);
  std::vector<uint64_t> vals;
  bool have_counts = false;
  for (uint16_t i = 0; i < n_entries; ++i) {
    size_t e = ifd + 2 + size_t(12) * i;
    uint16_t tag = r.u16(e);
    switch (tag) {
      case 256: if (read_values(r, e, &vals)) t.width = vals[0]; break;
      case 257: if (read_values(r, e, &vals)) t.height = vals[0]; break;
      case 258: if (read_values(r, e, &vals)) t.bits = vals[0]; break;
      case 259: if (read_values(r, e, &vals)) t.compression = vals[0]; break;
      case 273: read_values(r, e, &t.offsets); break;
      case 279: if (read_values(r, e, &t.counts)) have_counts = true; break;
      case 339: if (read_values(r, e, &vals)) t.sample_format = vals[0]; break;
      default: break;
    }
  }
  if (!have_counts && t.width && t.height)
    t.counts.assign(1, uint64_t(t.width) * t.height * (t.bits / 8));
  t.ok = t.width > 0 && t.height > 0 && !t.offsets.empty() &&
         t.offsets.size() == t.counts.size();
  return t;
}

bool inflate_strip(const uint8_t* src, size_t src_len, std::vector<uint8_t>* dst) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = uInt(src_len);
  uint8_t buf[1 << 16];
  int rc;
  do {
    zs.next_out = buf;
    zs.avail_out = sizeof(buf);
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    dst->insert(dst->end(), buf, buf + (sizeof(buf) - zs.avail_out));
  } while (rc != Z_STREAM_END && zs.avail_in > 0);
  inflateEnd(&zs);
  return rc == Z_STREAM_END || zs.avail_in == 0;
}

// Decode one tile into out[rows*cols] float32, SOUTH-first rows. Tiles
// smaller than (rows, cols) land at the south/west corner; larger fail.
int load_one(const std::string& path, float* out, int rows, int cols) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (len < 8) { std::fclose(f); return 2; }
  std::vector<uint8_t> buf(len);
  if (std::fread(buf.data(), 1, len, f) != size_t(len)) { std::fclose(f); return 3; }
  std::fclose(f);

  Reader r{buf.data(), buf.size(), false};
  if (buf[0] == 'M' && buf[1] == 'M') r.big = true;
  else if (!(buf[0] == 'I' && buf[1] == 'I')) return 4;

  Tiff t = parse_header(r);
  if (!t.ok) return 5;
  if (int(t.height) > rows || int(t.width) > cols) return 6;

  std::vector<uint8_t> raw;
  raw.reserve(size_t(t.width) * t.height * (t.bits / 8));
  for (size_t s = 0; s < t.offsets.size(); ++s) {
    uint64_t o = t.offsets[s], c = t.counts[s];
    if (o + c > buf.size()) return 7;
    if (t.compression == 1) {
      raw.insert(raw.end(), buf.data() + o, buf.data() + o + c);
    } else if (t.compression == 8 || t.compression == 32946) {
      if (!inflate_strip(buf.data() + o, c, &raw)) return 8;
    } else {
      return 9;  // unsupported compression -> the Python parser raises
    }
  }
  size_t need = size_t(t.width) * t.height * (t.bits / 8);
  if (raw.size() < need) return 10;

  Reader d{raw.data(), raw.size(), r.big};
  const uint32_t h = t.height, w = t.width;
  for (uint32_t img_row = 0; img_row < h; ++img_row) {
    // disk row 0 = north edge; output row 0 = south edge
    float* dst = out + size_t(h - 1 - img_row) * cols;
    size_t src = size_t(img_row) * w * (t.bits / 8);
    if (t.sample_format == 2 && t.bits == 16) {
      for (uint32_t j = 0; j < w; ++j)
        dst[j] = float(int16_t(d.u16(src + j * 2)));
    } else if (t.sample_format == 1 && t.bits == 16) {
      for (uint32_t j = 0; j < w; ++j) dst[j] = float(d.u16(src + j * 2));
    } else if (t.sample_format == 2 && t.bits == 32) {
      for (uint32_t j = 0; j < w; ++j)
        dst[j] = float(int32_t(d.u32(src + j * 4)));
    } else if (t.sample_format == 3 && t.bits == 32) {
      for (uint32_t j = 0; j < w; ++j) {
        uint32_t bits = d.u32(src + j * 4);
        float v;
        std::memcpy(&v, &bits, 4);
        dst[j] = v;
      }
    } else {
      return 11;  // unsupported sample format -> the Python parser raises
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// rows/cols of the image, or nonzero if not a readable baseline TIFF.
// Reads only the 8-byte header plus the IFD block (width/height are inline
// SHORT/LONG values in every real SRTM tile) — probing must not cost a
// whole-file read when the caller is about to decode the file anyway
// (Terrain.preload probes for buffer sizing, then batch-decodes).
int gtif_probe(const char* path, int* rows, int* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  uint8_t head[8];
  if (std::fread(head, 1, 8, f) != 8) { std::fclose(f); return 2; }
  Reader hr{head, 8, false};
  if (head[0] == 'M' && head[1] == 'M') hr.big = true;
  else if (!(head[0] == 'I' && head[1] == 'I')) { std::fclose(f); return 4; }
  if (hr.u16(2) != 42) { std::fclose(f); return 4; }
  uint32_t ifd = hr.u32(4);
  if (std::fseek(f, long(ifd), SEEK_SET) != 0) { std::fclose(f); return 5; }
  uint8_t cnt_buf[2];
  if (std::fread(cnt_buf, 1, 2, f) != 2) { std::fclose(f); return 5; }
  Reader cr{cnt_buf, 2, hr.big};
  uint16_t n_entries = cr.u16(0);
  std::vector<uint8_t> entries(size_t(12) * n_entries);
  if (n_entries == 0 ||
      std::fread(entries.data(), 1, entries.size(), f) != entries.size()) {
    std::fclose(f);
    return 5;
  }
  std::fclose(f);
  Reader r{entries.data(), entries.size(), hr.big};
  uint32_t width = 0, height = 0;
  for (uint16_t i = 0; i < n_entries; ++i) {
    size_t e = size_t(12) * i;
    uint16_t tag = r.u16(e);
    if (tag != 256 && tag != 257) continue;
    uint16_t type = r.u16(e + 2);
    uint32_t count = r.u32(e + 4);
    if (count != 1) return 5;
    uint64_t v;
    if (type == 3) v = r.u16(e + 8);        // SHORT, inline
    else if (type == 4) v = r.u32(e + 8);   // LONG, inline
    else return 5;                          // out-of-line -> not SRTM-shaped
    if (tag == 256) width = uint32_t(v);
    else height = uint32_t(v);
  }
  if (width == 0 || height == 0) return 5;
  *rows = int(height);
  *cols = int(width);
  return 0;
}

// Decode n tiles (NUL-joined paths) in parallel into out[n, rows, cols]
// (float32, south-first rows); status[i] = 0 on success.
void gtif_load_batch(const char* paths_blob, int n, float* out, int* status,
                     int rows, int cols, int max_threads) {
  std::vector<std::string> paths;
  const char* p = paths_blob;
  for (int i = 0; i < n; ++i) {
    paths.emplace_back(p);
    p += paths.back().size() + 1;
  }
  int workers = max_threads < 1 ? 1 : max_threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < workers && t < n; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += workers) {
        status[i] = load_one(paths[i], out + size_t(i) * rows * cols, rows, cols);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
