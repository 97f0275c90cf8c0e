// fastpre: batched image pre-processing for the host data pipeline (the
// PyTorch port's copy of native/fastpre.cpp, same arithmetic).
//
// letterbox_batch: aspect-preserving bilinear resize + grey pad + BGR->RGB
// over a whole batch with OpenMP, written straight into the final NHWC
// uint8 batch buffer: one pass, no per-image numpy temporaries.
//
// Semantics follow data/transforms.py::letterbox: r = min(dst/src),
// optional no-scaleup, centred padding with a round(dh -/+ 0.1) split,
// pad value 114. The bilinear weights are float, not cv2's fixed-point
// INTER_LINEAR, so pixels may differ from the cv2 path by a unit or two.
//
// Build (yolo_tpu_torch/_build.py): g++ -O3 -fopenmp -shared -fPIC
// fastpre.cpp -o libfastpre.so. No -march=native: with FMA the compiler
// would contract the four-term bilinear sum, and values that lie on a .5
// would round apart from the JAX package's library.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Bilinear sample matching cv2 INTER_LINEAR (half-pixel centers).
inline void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                               uint8_t* dst, int dh, int dw,
                               int dst_stride_w, bool bgr2rgb) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * c;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * c;
    uint8_t* drow = dst + static_cast<size_t>(y) * dst_stride_w * c;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      for (int ch = 0; ch < c; ++ch) {
        int sc = (bgr2rgb && c == 3) ? (2 - ch) : ch;
        float v00 = row0[x0 * c + sc], v01 = row0[x1 * c + sc];
        float v10 = row1[x0 * c + sc], v11 = row1[x1 * c + sc];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        drow[x * c + ch] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// srcs: n pointers to HWC uint8 images; dst: (n, dst_h, dst_w, c) buffer.
// ratios: (n,) out; pads: (n, 2) out (dw, dh halves as in the reference).
void letterbox_batch(const uint8_t** srcs, const int32_t* src_h,
                     const int32_t* src_w, int32_t n, int32_t c,
                     uint8_t* dst, int32_t dst_h, int32_t dst_w,
                     float* ratios, float* pads, int32_t pad_value,
                     int32_t scaleup, int32_t bgr2rgb) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    const int sh = src_h[i], sw = src_w[i];
    float r = std::min(static_cast<float>(dst_h) / sh,
                       static_cast<float>(dst_w) / sw);
    if (!scaleup) r = std::min(r, 1.0f);
    const int nw = static_cast<int>(std::lround(sw * r));
    const int nh = static_cast<int>(std::lround(sh * r));
    const float dwf = (dst_w - nw) / 2.0f;
    const float dhf = (dst_h - nh) / 2.0f;
    const int top = static_cast<int>(std::lround(dhf - 0.1f));
    const int left = static_cast<int>(std::lround(dwf - 0.1f));
    uint8_t* img = dst + static_cast<size_t>(i) * dst_h * dst_w * c;
    std::memset(img, pad_value, static_cast<size_t>(dst_h) * dst_w * c);
    resize_bilinear_u8(srcs[i], sh, sw, c,
                       img + (static_cast<size_t>(top) * dst_w + left) * c,
                       nh, nw, dst_w, bgr2rgb != 0);
    ratios[i] = r;
    pads[i * 2] = dwf;
    pads[i * 2 + 1] = dhf;
  }
}

// uint8 NHWC -> float32 NHWC with /256 (optionally *2-1 maxabs) — the input
// normalisation (reference train.py:345-348) done on host threads so the
// device transfer is already float.
void normalize_batch(const uint8_t* src, float* dst, int64_t count,
                     int32_t maxabs) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < count; ++i) {
    float v = src[i] / 256.0f;
    dst[i] = maxabs ? v * 2.0f - 1.0f : v;
  }
}

int32_t fastpre_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
