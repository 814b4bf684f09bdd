// The two 8-bit passes of Pillow's resampling (Resample.c,
// ImagingResampleHorizontal_8bpc / ImagingResampleVertical_8bpc): each output
// sample is clip8((2^21 + sum_i in[xmin + i] * k[i]) >> 22) over its window,
// with the 22-bit fixed-point coefficients that data/resize.py computes in
// float64 as Resample.c does (so no floating point runs here, and the
// compiler's contractions cannot change a bit). Samples are (rows, cols,
// channels) uint8, channels innermost.

#include <cstdint>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int32_t v) {
  v >>= kPrecisionBits;
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

}  // namespace

extern "C" {

// in (h, w, c) -> out (h, out_w, c); bounds holds (xmin, xmax) per output
// column, kk ksize coefficients per output column.
void resample_horizontal(const uint8_t* in, int64_t h, int64_t w, int64_t c, uint8_t* out,
                         int64_t out_w, const int32_t* bounds, const int32_t* kk,
                         int32_t ksize) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = in + y * w * c;
    uint8_t* o = out + y * out_w * c;
    for (int64_t xx = 0; xx < out_w; ++xx) {
      const int32_t xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
      const int32_t* k = kk + xx * ksize;
      for (int64_t ch = 0; ch < c; ++ch) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int32_t x = 0; x < xmax; ++x) ss += int32_t(row[(xmin + x) * c + ch]) * k[x];
        o[xx * c + ch] = clip8(ss);
      }
    }
  }
}

// in (h, w, c) -> out (out_h, w, c); bounds and kk per output row.
void resample_vertical(const uint8_t* in, int64_t h, int64_t w, int64_t c, uint8_t* out,
                       int64_t out_h, const int32_t* bounds, const int32_t* kk,
                       int32_t ksize) {
  (void)h;
  const int64_t n = w * c;
  for (int64_t yy = 0; yy < out_h; ++yy) {
    const int32_t ymin = bounds[2 * yy], ymax = bounds[2 * yy + 1];
    const int32_t* k = kk + yy * ksize;
    uint8_t* o = out + yy * n;
    for (int64_t i = 0; i < n; ++i) {
      int32_t ss = 1 << (kPrecisionBits - 1);
      for (int32_t y = 0; y < ymax; ++y) ss += int32_t(in[(ymin + y) * n + i]) * k[y];
      o[i] = clip8(ss);
    }
  }
}

}  // extern "C"
