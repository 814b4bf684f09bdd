// A JPEG decoder that gives libjpeg-turbo's output bit for bit, as PIL's
// `Image.open(...).convert("RGB")` reads it: baseline and extended-sequential
// Huffman JPEG, 8-bit samples, any Huffman tables, restart intervals, one
// component (grey) or three (YCbCr, or RGB where an Adobe marker or the
// component ids say so) at sampling factors whose ratios to the largest are
// integers, and four (Adobe CMYK or YCCK, turned into RGB as Pillow turns its
// inverted CMYK into RGB).
//
// What decides the bits, after libjpeg-turbo:
//   - the IDCT is jidctint.c's `jpeg_idct_islow` (13-bit constants, two passes
//     of 2 extra bits, the post-IDCT range-limit table indexed by x & 1023);
//   - upsampling is jdsample.c's "fancy" triangle filter: h2v1 with biases 1
//     and 2, h1v2 with biases 1 and 2, h2v2 over column sums with biases 8 and
//     7, where the component's downsampled width exceeds 2 (h1v2 always); box
//     replication otherwise. Edges repeat the component's last real sample:
//     the downsampled width and height are ceil(image size * factor / max);
//   - colour conversion is jdcolor.c's tables (16-bit fixed point, ONE_HALF
//     rounding on R and B, the G terms summed before the shift).
// Progressive, arithmetic-coded, lossless and 12-bit files are refused with
// their own codes: the caller names them.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  kOk = 0,
  kCorrupt = -1,
  kProgressive = -2,
  kArithmetic = -3,
  kPrecision = -4,
  kLossless = -5,
  kSampling = -6,
  kComponents = -7,
  kTooLarge = -8,
  kNoFrame = -9,
};

// jpeg_natural_order with libjpeg's 16 guard entries past the end
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoff[17];
  uint16_t look[1 << 9];  // (nbits << 8) | symbol for codes of <= 9 bits; 0: slow path
};

bool build_huff(Huff& h, const uint8_t* bits, const uint8_t* vals, int nvals) {
  memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  memset(h.look, 0, sizeof(h.look));
  for (int l = 1; l <= 16; ++l) {
    h.valoff[l] = k - code;
    for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
      if (l <= 9) {
        int shift = 9 - l;
        for (int j = 0; j < (1 << shift); ++j)
          h.look[(code << shift) | j] = uint16_t((l << 8) | vals[k]);
      }
    }
    h.maxcode[l] = bits[l] ? code - 1 : -1;
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
  return true;
}

struct Component {
  int id, h, v, tq;
  int bw, bh;        // blocks in the padded grid
  int cw, ch;        // downsampled width and height in samples
  int dc_pred;
  int td, ta;
  std::vector<int16_t> coef;
};

struct Reader {
  const uint8_t* p;
  int64_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!hit_marker && pos < n) {
        byte = p[pos];
        if (byte == 0xFF) {
          int64_t q = pos + 1;
          while (q < n && p[q] == 0xFF) ++q;   // fill bytes
          if (q < n && p[q] == 0x00) {
            pos = q + 1;
          } else {
            hit_marker = true;   // a marker: zeros from here, as libjpeg feeds
            byte = 0;
            pos = q - 1;
          }
        } else {
          ++pos;
        }
      }
      acc |= uint64_t(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int k) {
    if (nbits < k) fill();
    return int(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    nbits -= k;
  }
  int bits(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  void reset() {
    acc = 0;
    nbits = 0;
  }
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

inline int decode_sym(Reader& r, const Huff& h, bool& bad) {
  int look = h.look[r.peek(9)];
  if (look) {
    r.skip(look >> 8);
    return look & 0xFF;
  }
  int code = r.bits(1), l = 1;
  while (code > h.maxcode[l]) {
    code = (code << 1) | r.bits(1);
    if (++l > 16) {
      bad = true;
      return 0;
    }
  }
  return h.vals[code + h.valoff[l]];
}

// jidctint.c, jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t post[1024];   // IDCT_range_limit, indexed by x & 1023
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      post[i] = uint8_t(v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = int64_t(ip[16]) * qp[16];
    z3 = int64_t(ip[48]) * qp[48];
    z1 = (z2 + z3) * F0541;
    t2 = z1 + z3 * -F1847;
    t3 = z1 + z2 * F0765;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    t0 = (z2 + z3) * (1 << kConstBits);
    t1 = (z2 - z3) * (1 << kConstBits);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = int64_t(ip[56]) * qp[56];
    t1 = int64_t(ip[40]) * qp[40];
    t2 = int64_t(ip[24]) * qp[24];
    t3 = int64_t(ip[8]) * qp[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F1175;
    t0 *= F0298;
    t1 *= F2053;
    t2 *= F3072;
    t3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    ws[c + 0] = int(descale(t10 + t3, s));
    ws[c + 56] = int(descale(t10 - t3, s));
    ws[c + 8] = int(descale(t11 + t2, s));
    ws[c + 48] = int(descale(t11 - t2, s));
    ws[c + 16] = int(descale(t12 + t1, s));
    ws[c + 40] = int(descale(t12 - t1, s));
    ws[c + 24] = int(descale(t13 + t0, s));
    ws[c + 32] = int(descale(t13 - t0, s));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * F0541;
    t2 = z1 + z3 * -F1847;
    t3 = z1 + z2 * F0765;
    t0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    t1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = w[7];
    t1 = w[5];
    t2 = w[3];
    t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F1175;
    t0 *= F0298;
    t1 *= F2053;
    t2 *= F3072;
    t3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int s = kConstBits + kPass1Bits + 3;
    o[0] = kRange.post[int(descale(t10 + t3, s)) & 1023];
    o[7] = kRange.post[int(descale(t10 - t3, s)) & 1023];
    o[1] = kRange.post[int(descale(t11 + t2, s)) & 1023];
    o[6] = kRange.post[int(descale(t11 - t2, s)) & 1023];
    o[2] = kRange.post[int(descale(t12 + t1, s)) & 1023];
    o[5] = kRange.post[int(descale(t12 - t1, s)) & 1023];
    o[3] = kRange.post[int(descale(t13 + t0, s)) & 1023];
    o[4] = kRange.post[int(descale(t13 - t0, s)) & 1023];
  }
}

// jdcolor.c's tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// One component's samples upsampled to (width, height): jdsample.c's methods.
void upsample(const std::vector<uint8_t>& plane, int stride, const Component& c, int hx, int vx,
              int width, int height, std::vector<uint8_t>& out) {
  const int cw = c.cw, ch = c.ch;
  const int ow = cw * hx, oh = ch * vx;
  std::vector<uint8_t> full(size_t(ow) * oh);
  auto row = [&](int r) { return plane.data() + size_t(r < 0 ? 0 : r >= ch ? ch - 1 : r) * stride; };
  const bool fancy_h = (hx == 2 && cw > 2);
  if (hx == 1 && vx == 1) {
    for (int r = 0; r < ch; ++r) memcpy(&full[size_t(r) * ow], row(r), cw);
  } else if (hx == 2 && vx == 1 && fancy_h) {
    for (int r = 0; r < ch; ++r) {
      const uint8_t* in = row(r);
      uint8_t* o = &full[size_t(r) * ow];
      o[0] = in[0];
      o[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < cw - 1; ++i) {
        int v = in[i] * 3;
        o[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
        o[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
      }
      int i = cw - 1;
      o[2 * i] = uint8_t((in[i] * 3 + in[i - 1] + 1) >> 2);
      o[2 * i + 1] = in[i];
    }
  } else if (hx == 1 && vx == 2) {
    for (int r = 0; r < ch; ++r) {
      const uint8_t* in0 = row(r);
      for (int v = 0; v < 2; ++v) {
        const uint8_t* in1 = row(v == 0 ? r - 1 : r + 1);
        const int bias = v == 0 ? 1 : 2;
        uint8_t* o = &full[size_t(2 * r + v) * ow];
        for (int i = 0; i < cw; ++i) o[i] = uint8_t((in0[i] * 3 + in1[i] + bias) >> 2);
      }
    }
  } else if (hx == 2 && vx == 2 && fancy_h) {
    for (int r = 0; r < ch; ++r) {
      const uint8_t* in0 = row(r);
      for (int v = 0; v < 2; ++v) {
        const uint8_t* in1 = row(v == 0 ? r - 1 : r + 1);
        uint8_t* o = &full[size_t(2 * r + v) * ow];
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        o[0] = uint8_t((this_sum * 4 + 8) >> 4);
        o[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int i = 1; i < cw - 1; ++i) {
          next_sum = in0[i + 1] * 3 + in1[i + 1];
          o[2 * i] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
          o[2 * i + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        int i = cw - 1;
        o[2 * i] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * i + 1] = uint8_t((this_sum * 4 + 7) >> 4);
      }
    }
  } else {   // box replication (jdsample.c h2v1/h2v2/int_upsample)
    for (int r = 0; r < oh; ++r) {
      const uint8_t* in = row(r / vx);
      uint8_t* o = &full[size_t(r) * ow];
      for (int i = 0; i < ow; ++i) o[i] = in[i / hx];
    }
  }
  out.assign(size_t(width) * height, 0);
  for (int r = 0; r < height; ++r) {
    const uint8_t* src = &full[size_t(r < oh ? r : oh - 1) * ow];
    uint8_t* o = &out[size_t(r) * width];
    for (int i = 0; i < width; ++i) o[i] = src[i < ow ? i : ow - 1];
  }
}

struct Frame {
  int width = 0, height = 0, ncomp = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart = 0;
  Component comp[4];
  Huff dc[4], ac[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  bool have_frame = false;
};

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

int parse_sof(Frame& f, const uint8_t* s, int len) {
  if (len < 6) return kCorrupt;
  if (s[0] != 8) return kPrecision;
  f.height = u16(s + 1);
  f.width = u16(s + 3);
  f.ncomp = s[5];
  if (f.ncomp != 1 && f.ncomp != 3 && f.ncomp != 4) return kComponents;
  if (len < 6 + 3 * f.ncomp || f.width == 0 || f.height == 0) return kCorrupt;
  if (int64_t(f.width) * f.height > (int64_t(1) << 28)) return kTooLarge;
  f.maxh = f.maxv = 1;
  for (int i = 0; i < f.ncomp; ++i) {
    Component& c = f.comp[i];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i] & 3;
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kSampling;
    f.maxh = c.h > f.maxh ? c.h : f.maxh;
    f.maxv = c.v > f.maxv ? c.v : f.maxv;
  }
  f.mcux = (f.width + 8 * f.maxh - 1) / (8 * f.maxh);
  f.mcuy = (f.height + 8 * f.maxv - 1) / (8 * f.maxv);
  for (int i = 0; i < f.ncomp; ++i) {
    Component& c = f.comp[i];
    if (f.maxh % c.h || f.maxv % c.v) return kSampling;
    c.cw = int((int64_t(f.width) * c.h + f.maxh - 1) / f.maxh);
    c.ch = int((int64_t(f.height) * c.v + f.maxv - 1) / f.maxv);
    c.bw = f.mcux * c.h;
    c.bh = f.mcuy * c.v;
    c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
  }
  f.have_frame = true;
  return kOk;
}

int decode_scan(Frame& f, const uint8_t* data, int64_t n, int64_t& pos, const uint8_t* s,
                int len) {
  if (!f.have_frame) return kCorrupt;
  int ns = s[0];
  if (ns < 1 || ns > 4 || len < 1 + 2 * ns + 3) return kCorrupt;
  Component* sc[4];
  for (int i = 0; i < ns; ++i) {
    int id = s[1 + 2 * i], k = -1;
    for (int j = 0; j < f.ncomp; ++j)
      if (f.comp[j].id == id) k = j;
    if (k < 0) return kCorrupt;
    sc[i] = &f.comp[k];
    sc[i]->td = s[2 + 2 * i] >> 4;
    sc[i]->ta = s[2 + 2 * i] & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3 || !f.dc[sc[i]->td].defined ||
        !f.ac[sc[i]->ta].defined)
      return kCorrupt;
    sc[i]->dc_pred = 0;
  }
  Reader r{data, n, pos};
  bool bad = false;
  auto block = [&](Component& c, int bx, int by) {
    int16_t* blk = &c.coef[(size_t(by) * c.bw + bx) * 64];
    int t = decode_sym(r, f.dc[c.td], bad);
    int diff = t ? extend(r.bits(t), t) : 0;
    c.dc_pred += diff;
    blk[0] = int16_t(c.dc_pred);
    const Huff& ac = f.ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = decode_sym(r, ac, bad);
      int run = rs >> 4, sz = rs & 15;
      if (sz) {
        k += run;
        blk[kNatural[k]] = int16_t(extend(r.bits(sz), sz));
      } else {
        if (run != 15) break;
        k += 15;
      }
    }
  };
  auto restart = [&]() {
    // discard the bits left, find the RSTn marker, reset the predictors
    r.reset();
    int64_t q = r.pos;
    while (q + 1 < n && !(data[q] == 0xFF && data[q + 1] >= 0xD0 && data[q + 1] <= 0xD7)) {
      if (data[q] == 0xFF && data[q + 1] != 0 && data[q + 1] != 0xFF) break;  // another marker
      ++q;
    }
    if (q + 1 < n && data[q] == 0xFF && data[q + 1] >= 0xD0 && data[q + 1] <= 0xD7) q += 2;
    r.pos = q;
    r.hit_marker = false;
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
  };
  int64_t count = 0;
  if (ns == 1) {
    Component& c = *sc[0];
    int bw = (c.cw + 7) / 8, bh = (c.ch + 7) / 8;
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx) {
        if (f.restart && count && count % f.restart == 0) restart();
        block(c, bx, by);
        ++count;
        if (bad) return kCorrupt;
      }
  } else {
    for (int my = 0; my < f.mcuy; ++my)
      for (int mx = 0; mx < f.mcux; ++mx) {
        if (f.restart && count && count % f.restart == 0) restart();
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) block(c, mx * c.h + h, my * c.v + v);
        }
        ++count;
        if (bad) return kCorrupt;
      }
  }
  // continue after the scan's entropy-coded data: at the next marker that
  // is not a restart marker
  int64_t q = pos;
  while (q + 1 < n) {
    if (data[q] == 0xFF && data[q + 1] != 0 && !(data[q + 1] >= 0xD0 && data[q + 1] <= 0xD7) &&
        data[q + 1] != 0xFF)
      break;
    ++q;
  }
  pos = q;
  return kOk;
}

// Walks the markers. With `out` null it stops after the frame header.
int run(const uint8_t* data, int64_t n, Frame& f, bool headers_only) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return kCorrupt;
  int64_t pos = 2;
  bool scanned = false;
  while (pos < n) {
    while (pos < n && data[pos] != 0xFF) ++pos;   // garbage between markers
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) break;
    int m = data[pos++];
    if (m == 0xD9) break;              // EOI
    if (m >= 0xD0 && m <= 0xD7) continue;
    if (m == 0x01) continue;           // TEM
    if (pos + 2 > n) return kCorrupt;
    int len = u16(data + pos);
    if (len < 2 || pos + len > n) return kCorrupt;
    const uint8_t* s = data + pos + 2;
    int sl = len - 2;
    pos += len;
    if (m == 0xC0 || m == 0xC1) {
      int e = parse_sof(f, s, sl);
      if (e) return e;
      if (headers_only) return kOk;
    } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
      return kProgressive;
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      return kLossless;
    } else if (m == 0xC5 || m == 0xC9 || m == 0xCD) {
      return kArithmetic;
    } else if (m == 0xCC) {
      return kArithmetic;   // DAC
    } else if (m == 0xC4) {
      int k = 0;
      while (k < sl) {
        if (k + 17 > sl) return kCorrupt;
        int tc = s[k] >> 4, th = s[k] & 15;
        uint8_t bits[17] = {0};
        int total = 0;
        for (int i = 1; i <= 16; ++i) total += (bits[i] = s[k + i]);
        if (th > 3 || tc > 1 || total > 256 || k + 17 + total > sl) return kCorrupt;
        if (!build_huff(tc ? f.ac[th] : f.dc[th], bits, s + k + 17, total)) return kCorrupt;
        k += 17 + total;
      }
    } else if (m == 0xDB) {
      int k = 0;
      while (k < sl) {
        int pq = s[k] >> 4, tq = s[k] & 15;
        if (tq > 3 || pq > 1 || k + 1 + 64 * (pq + 1) > sl) return kCorrupt;
        for (int i = 0; i < 64; ++i)
          f.qt[tq][kNatural[i]] = pq ? uint16_t(u16(s + k + 1 + 2 * i)) : s[k + 1 + i];
        f.qt_defined[tq] = true;
        k += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xDD) {
      if (sl < 2) return kCorrupt;
      f.restart = u16(s);
    } else if (m == 0xDA) {
      if (!f.have_frame) return kNoFrame;
      int e = decode_scan(f, data, n, pos, s, sl);
      if (e) return e;
      scanned = true;
    } else if (m == 0xE0) {
      if (sl >= 5 && memcmp(s, "JFIF\0", 5) == 0) f.jfif = true;
    } else if (m == 0xEE) {
      if (sl >= 12 && memcmp(s, "Adobe", 5) == 0) {
        f.adobe = true;
        f.adobe_transform = s[11];
      }
    }
  }
  if (!f.have_frame) return kNoFrame;
  if (!scanned && !headers_only) return kCorrupt;
  return kOk;
}

}  // namespace

extern "C" {

// info[0..2] = width, height, number of components. Returns 0 or a code < 0.
int32_t jpeg_info(const uint8_t* data, int64_t n, int32_t* info) {
  Frame* f = new Frame();
  int e = run(data, n, *f, true);
  if (!e) {
    info[0] = f->width;
    info[1] = f->height;
    info[2] = f->ncomp;
  }
  delete f;
  return e;
}

// Decodes into `out`, (height, width, 3) uint8 RGB as Pillow's convert("RGB")
// gives it. Returns 0 or a code < 0.
int32_t jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap) {
  Frame* fp = new Frame();
  Frame& f = *fp;
  int e = run(data, n, f, false);
  if (e) {
    delete fp;
    return e;
  }
  const int W = f.width, H = f.height;
  if (cap < int64_t(W) * H * 3) {
    delete fp;
    return kCorrupt;
  }
  std::vector<uint8_t> planes[4];
  for (int i = 0; i < f.ncomp; ++i) {
    Component& c = f.comp[i];
    if (!f.qt_defined[c.tq]) {
      delete fp;
      return kCorrupt;
    }
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane(size_t(stride) * c.bh * 8);
    const int bw = (c.cw + 7) / 8, bh = (c.ch + 7) / 8;
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx)
        idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], f.qt[c.tq],
                   &plane[size_t(by) * 8 * stride + bx * 8], stride);
    upsample(plane, stride, c, f.maxh / c.h, f.maxv / c.v, W, H, planes[i]);
  }
  const size_t np = size_t(W) * H;
  if (f.ncomp == 1) {
    for (size_t k = 0; k < np; ++k) out[3 * k] = out[3 * k + 1] = out[3 * k + 2] = planes[0][k];
  } else if (f.ncomp == 3) {
    bool rgb;
    if (f.jfif) rgb = false;
    else if (f.adobe) rgb = f.adobe_transform == 0;
    else rgb = f.comp[0].id == 82 && f.comp[1].id == 71 && f.comp[2].id == 66;
    for (size_t k = 0; k < np; ++k) {
      int y = planes[0][k], cb = planes[1][k], cr = planes[2][k];
      if (rgb) {
        out[3 * k] = uint8_t(y);
        out[3 * k + 1] = uint8_t(cb);
        out[3 * k + 2] = uint8_t(cr);
      } else {
        out[3 * k] = clamp8(y + kYcc.cr_r[cr]);
        out[3 * k + 1] = clamp8(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        out[3 * k + 2] = clamp8(y + kYcc.cb_b[cb]);
      }
    }
  } else {
    // libjpeg gives CMYK (YCCK converted with jdcolor.c's ycck_cmyk_convert);
    // Pillow reads it as inverted CMYK ("CMYK;I") and converts with
    // Convert.c's cmyk2rgb.
    const bool ycck = f.adobe && f.adobe_transform != 0;
    for (size_t k = 0; k < np; ++k) {
      int c0 = planes[0][k], c1 = planes[1][k], c2 = planes[2][k], kk = planes[3][k];
      if (ycck) {
        int y = c0, cb = c1, cr = c2;
        c0 = clamp8(255 - (y + kYcc.cr_r[cr]));
        c1 = clamp8(255 - (y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
        c2 = clamp8(255 - (y + kYcc.cb_b[cb]));
      }
      int cmyk[4] = {255 - c0, 255 - c1, 255 - c2, 255 - kk};
      int nk = 255 - cmyk[3];
      for (int ch = 0; ch < 3; ++ch) {
        int tmp = cmyk[ch] * nk + 128;
        int v = nk - (((tmp >> 8) + tmp) >> 8);
        out[3 * k + ch] = clamp8(v);
      }
    }
  }
  delete fp;
  return kOk;
}

}  // extern "C"
