// Host fast ops of the data loader's hot path: resizes with exact PyTorch
// F.interpolate semantics, the inverse-affine warp (scipy's
// affine_transform in constant mode), uint8 scaling and per-plane min-max,
// each batched over planes on a thread pool.
//
// A copy of native/fastops.cpp: the same code, compiled with the same flags
// (-O3 -std=c++17 -fPIC -march=native -pthread), so the two libraries give
// the same bits. Built by mirage_tpu_torch/ops/_build.py:build_host with
// the host compiler and bound with ctypes in mirage_tpu_torch/utils/native.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// torch area_pixel_compute_source_index (align_corners=false)
inline float src_index(float scale, long dst, bool align_corners) {
  if (align_corners) return scale * dst;
  float s = scale * (dst + 0.5f) - 0.5f;
  return s < 0.f ? 0.f : s;
}

struct LinearTap {
  long i0, i1;
  float w0, w1;
};

void build_linear_taps(long in_size, long out_size, bool align_corners,
                       std::vector<LinearTap>& taps) {
  taps.resize(out_size);
  float scale;
  if (align_corners)
    scale = out_size > 1 ? float(in_size - 1) / float(out_size - 1) : 0.f;
  else
    scale = float(in_size) / float(out_size);
  for (long d = 0; d < out_size; ++d) {
    float s = src_index(scale, d, align_corners);
    long i0 = std::min<long>((long)s, in_size - 1);
    long i1 = std::min<long>(i0 + 1, in_size - 1);
    float w1 = s - i0;
    taps[d] = {i0, i1, 1.f - w1, w1};
  }
}

void build_nearest_taps(long in_size, long out_size, std::vector<long>& taps) {
  taps.resize(out_size);
  double scale = double(in_size) / double(out_size);
  for (long d = 0; d < out_size; ++d)
    taps[d] = std::min<long>((long)std::floor(d * scale), in_size - 1);
}

template <typename F>
void parallel_for(long n, F&& f) {
  unsigned hw = std::thread::hardware_concurrency();
  long n_threads = std::min<long>(n, hw ? hw : 4);
  if (n_threads <= 1) {
    for (long i = 0; i < n; ++i) f(i);
    return;
  }
  std::atomic<long> next{0};
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (long t = 0; t < n_threads; ++t)
    pool.emplace_back([&] {
      for (long i = next.fetch_add(1); i < n; i = next.fetch_add(1)) f(i);
    });
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Batched bilinear resize, torch semantics. in: (B, H, W) f32 contiguous,
// out: (B, oh, ow) f32. Planes are processed across a thread pool.
void resize_bilinear_f32(const float* in, float* out, long b, long ih, long iw,
                         long oh, long ow, int align_corners) {
  std::vector<LinearTap> ty, tx;
  build_linear_taps(ih, oh, align_corners, ty);
  build_linear_taps(iw, ow, align_corners, tx);
  parallel_for(b, [&](long p) {
    const float* src = in + p * ih * iw;
    float* dst = out + p * oh * ow;
    std::vector<float> row(ow);
    for (long y = 0; y < oh; ++y) {
      const LinearTap& vy = ty[y];
      const float* r0 = src + vy.i0 * iw;
      const float* r1 = src + vy.i1 * iw;
      float* d = dst + y * ow;
      for (long x = 0; x < ow; ++x) {
        const LinearTap& vx = tx[x];
        float a = r0[vx.i0] * vx.w0 + r0[vx.i1] * vx.w1;
        float c = r1[vx.i0] * vx.w0 + r1[vx.i1] * vx.w1;
        d[x] = a * vy.w0 + c * vy.w1;
      }
    }
  });
}

// Batched nearest resize for integer label maps. in/out: int32 planes.
void resize_nearest_i32(const int32_t* in, int32_t* out, long b, long ih,
                        long iw, long oh, long ow) {
  std::vector<long> ty, tx;
  build_nearest_taps(ih, oh, ty);
  build_nearest_taps(iw, ow, tx);
  parallel_for(b, [&](long p) {
    const int32_t* src = in + p * ih * iw;
    int32_t* dst = out + p * oh * ow;
    for (long y = 0; y < oh; ++y) {
      const int32_t* r = src + ty[y] * iw;
      int32_t* d = dst + y * ow;
      for (long x = 0; x < ow; ++x) d[x] = r[tx[x]];
    }
  });
}

// uint8 -> float32 with scale (e.g. 1/255), batched.
void u8_to_f32_scaled(const uint8_t* in, float* out, long n, float scale) {
  parallel_for((n + (1 << 20) - 1) >> 20, [&](long blk) {
    long lo = blk << 20;
    long hi = std::min(n, lo + (1 << 20));
    for (long i = lo; i < hi; ++i) out[i] = in[i] * scale;
  });
}

// Per-plane min-max normalize to [0, 1]. data: (B, H*W) f32, in place.
void minmax_norm_f32(float* data, long b, long plane) {
  parallel_for(b, [&](long p) {
    float* d = data + p * plane;
    float lo = d[0], hi = d[0];
    for (long i = 1; i < plane; ++i) {
      lo = std::min(lo, d[i]);
      hi = std::max(hi, d[i]);
    }
    float denom = std::max(hi - lo, 1e-12f);
    for (long i = 0; i < plane; ++i) d[i] = (d[i] - lo) / denom;
  });
}

// Batched inverse-affine warp (torchvision TF.affine semantics; matches
// scipy.ndimage.affine_transform with the same matrix/offset).
// matrix/offset per batch element: in_y = m[0]*y + m[1]*x + off[0],
//                                  in_x = m[2]*y + m[3]*x + off[1].
// order: 0 = nearest, 1 = bilinear. Out-of-range samples get cval
// (no edge blending, matching scipy's constant mode).
void affine_warp_f32(const float* in, float* out, long b, long h, long w,
                     const double* matrices /* (b,4) */,
                     const double* offsets /* (b,2) */, int order,
                     float cval) {
  parallel_for(b, [&](long p) {
    const float* src = in + p * h * w;
    float* dst = out + p * h * w;
    const double m0 = matrices[p * 4 + 0], m1 = matrices[p * 4 + 1];
    const double m2 = matrices[p * 4 + 2], m3 = matrices[p * 4 + 3];
    const double o0 = offsets[p * 2 + 0], o1 = offsets[p * 2 + 1];
    for (long y = 0; y < h; ++y) {
      double yin0 = m0 * y + o0;
      double xin0 = m2 * y + o1;
      float* d = dst + y * w;
      for (long x = 0; x < w; ++x) {
        double yin = yin0 + m1 * x;
        double xin = xin0 + m3 * x;
        if (order == 0) {
          // scipy constant mode rejects coords outside [0, n-1] BEFORE
          // the nearest rounding
          if (yin < 0.0 || yin > h - 1 || xin < 0.0 || xin > w - 1) {
            d[x] = cval;
            continue;
          }
          long yi = (long)std::floor(yin + 0.5);
          long xi = (long)std::floor(xin + 0.5);
          d[x] = src[yi * w + xi];
        } else {
          if (yin < 0.0 || yin > h - 1 || xin < 0.0 || xin > w - 1) {
            d[x] = cval;
            continue;
          }
          long y0 = (long)yin, x0 = (long)xin;
          long y1 = std::min(y0 + 1, h - 1), x1 = std::min(x0 + 1, w - 1);
          float fy = (float)(yin - y0), fx = (float)(xin - x0);
          float a = src[y0 * w + x0] * (1 - fx) + src[y0 * w + x1] * fx;
          float c = src[y1 * w + x0] * (1 - fx) + src[y1 * w + x1] * fx;
          d[x] = a * (1 - fy) + c * fy;
        }
      }
    }
  });
}

int fastops_version() { return 1; }

}  // extern "C"
