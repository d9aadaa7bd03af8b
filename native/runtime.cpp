// pathtracer_tpu native runtime: the host-side presentation layer.
//
// Host-side equivalent of the reference's Rust presentation path
// (rust-pathtracer/src/buffer.rs:37-102 + renderer/src/main.rs:113-131):
// where the reference tonemaps + blits the accumulation buffer with rayon
// threads before handing it to the `pixels` GPU surface, this library does
// the same work with std::thread fan-out on the host CPU, plus the PNG
// encode the reference never implemented ("Write images to disk" TODO,
// Readme.md:74).
//
// Exposed as a plain C ABI consumed via ctypes
// (pathtracer_tpu/utils/native.py) — no pybind11 dependency.
//
// Build: make -C native   (g++ + zlib; see native/Makefile)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// Rust `as u8` semantics: truncate toward zero, saturate at the ends,
// NaN -> 0 (buffer.rs:46-50 casts `(value.powf(0.4545) * 255.0) as u8`).
inline uint8_t as_u8(double v) {
  if (!(v > 0.0)) return 0;  // also catches NaN
  if (v >= 255.0) return 255;
  return static_cast<uint8_t>(v);
}

void fan_out(int64_t n, const std::function<void(int64_t, int64_t)>& body) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n));
  if (n_threads == 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(body, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Gamma-encode a linear [n_px, 4] RGBA float buffer to u8.
// gamma != 0: rgb^0.4545 * 255, alpha linear (buffer.rs:37-64).
// gamma == 0: all channels linear * 255 (convert_to_u8_at, buffer.rs:85).
// Threaded over pixel ranges — the rayon par_rchunks analog.
void pt_tonemap_u8(const float* rgba, int64_t n_px, int gamma, uint8_t* out) {
  fan_out(n_px, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* p = rgba + i * 4;
      uint8_t* q = out + i * 4;
      if (gamma) {
        q[0] = as_u8(std::pow(std::max(0.0, (double)p[0]), 0.4545) * 255.0);
        q[1] = as_u8(std::pow(std::max(0.0, (double)p[1]), 0.4545) * 255.0);
        q[2] = as_u8(std::pow(std::max(0.0, (double)p[2]), 0.4545) * 255.0);
        q[3] = as_u8((double)p[3] * 255.0);
      } else {
        q[0] = as_u8((double)p[0] * 255.0);
        q[1] = as_u8((double)p[1] * 255.0);
        q[2] = as_u8((double)p[2] * 255.0);
        q[3] = as_u8((double)p[3] * 255.0);
      }
    }
  });
}

// Blit a linear [h, w, 4] float buffer into a u8 RGBA frame of size
// [fh, fw, 4] at offset (x0, y0) WITHOUT gamma — convert_to_u8_at parity
// (buffer.rs:67-102). Out-of-bounds rows/cols are clipped.
void pt_blit_u8(const float* src, int64_t h, int64_t w, uint8_t* frame,
                int64_t fh, int64_t fw, int64_t x0, int64_t y0) {
  int64_t y_lo = std::max<int64_t>(0, -y0), y_hi = std::min(h, fh - y0);
  if (y_hi <= y_lo) return;
  fan_out(y_hi - y_lo, [&](int64_t lo, int64_t hi) {
    for (int64_t yy = y_lo + lo; yy < y_lo + hi; ++yy) {
      int64_t x_lo = std::max<int64_t>(0, -x0), x_hi = std::min(w, fw - x0);
      const float* s = src + (yy * w) * 4;
      uint8_t* d = frame + ((yy + y0) * fw + x0) * 4;
      for (int64_t xx = x_lo; xx < x_hi; ++xx)
        for (int c = 0; c < 4; ++c)
          d[xx * 4 + c] = as_u8((double)s[xx * 4 + c] * 255.0);
    }
  });
}

// PNG-encode an [h, w, c] u8 image (c = 3 RGB or 4 RGBA, 8-bit, filter 0).
// Writes at most out_cap bytes into out; returns the encoded length, or -1
// if out_cap is too small / inputs invalid. Use pt_png_bound for sizing.
int64_t pt_png_bound(int64_t h, int64_t w, int64_t c) {
  int64_t raw = h * (w * c + 1);
  return (int64_t)compressBound((uLong)raw) + 1024;
}

int64_t pt_encode_png(const uint8_t* data, int64_t h, int64_t w, int64_t c,
                      uint8_t* out, int64_t out_cap) {
  if (c != 3 && c != 4) return -1;
  const int64_t stride = w * c;
  // raw scanlines with filter byte 0
  std::vector<uint8_t> raw((size_t)(h * (stride + 1)));
  fan_out(h, [&](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      uint8_t* row = raw.data() + (size_t)(y * (stride + 1));
      row[0] = 0;
      std::memcpy(row + 1, data + (size_t)(y * stride), (size_t)stride);
    }
  });
  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<uint8_t> z((size_t)zcap);
  if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -1;

  auto put_u32 = [](uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24); p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);  p[3] = (uint8_t)v;
  };
  auto chunk = [&](uint8_t* p, const char tag[4], const uint8_t* body,
                   uint32_t len) -> int64_t {
    put_u32(p, len);
    std::memcpy(p + 4, tag, 4);
    if (len) std::memcpy(p + 8, body, len);
    uLong crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, p + 4, len + 4);
    put_u32(p + 8 + len, (uint32_t)crc);
    return 12 + (int64_t)len;
  };

  uint8_t ihdr[13];
  put_u32(ihdr, (uint32_t)w);
  put_u32(ihdr + 4, (uint32_t)h);
  ihdr[8] = 8;                       // bit depth
  ihdr[9] = (c == 3) ? 2 : 6;        // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;

  int64_t need = 8 + 12 + 13 + 12 + (int64_t)zcap + 12;
  if (out_cap < need) return -1;
  uint8_t* p = out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  std::memcpy(p, sig, 8); p += 8;
  p += chunk(p, "IHDR", ihdr, 13);
  p += chunk(p, "IDAT", z.data(), (uint32_t)zcap);
  p += chunk(p, "IEND", nullptr, 0);
  return p - out;
}

// Fused tonemap + PNG encode: linear [h, w, 4] float RGBA -> PNG bytes.
int64_t pt_tonemap_encode_png(const float* rgba, int64_t h, int64_t w,
                              int gamma, uint8_t* out, int64_t out_cap) {
  std::vector<uint8_t> u8((size_t)(h * w * 4));
  pt_tonemap_u8(rgba, h * w, gamma, u8.data());
  return pt_encode_png(u8.data(), h, w, 4, out, out_cap);
}

}  // extern "C"
