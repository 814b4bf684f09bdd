// PNG's scanline filters undone (the PNG specification, section 9): each row
// of the inflated stream starts with its filter byte, 0 None, 1 Sub, 2 Up,
// 3 Average, 4 Paeth, each predicting a byte from the byte `bpp` to its left
// (a), the byte above (b) and the one above that left byte (c). Sub, Average
// and Paeth chain along a row, so the loop is sequential; data/codecs.py
// inflates with zlib and calls this once per image (or once per Adam7 pass).

#include <cstdint>
#include <cstdlib>

extern "C" {

// `src` holds `rows` rows of (1 + row_bytes) bytes; `dst` receives rows *
// row_bytes bytes. Returns 0, or -1 for a filter byte past 4.
int32_t png_unfilter(const uint8_t* src, uint8_t* dst, int64_t rows, int64_t row_bytes,
                     int32_t bpp) {
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* in = src + r * (row_bytes + 1);
    uint8_t* out = dst + r * row_bytes;
    const uint8_t* up = r ? out - row_bytes : nullptr;
    const int ft = in[0];
    ++in;
    switch (ft) {
      case 0:
        for (int64_t i = 0; i < row_bytes; ++i) out[i] = in[i];
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          out[i] = uint8_t(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i) out[i] = uint8_t(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          out[i] = uint8_t(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = uint8_t(in[i] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

}  // extern "C"
