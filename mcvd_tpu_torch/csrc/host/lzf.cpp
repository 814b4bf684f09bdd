// The LZF codec of the HDF5 store's chunks (HDF5 filter 32000), written from
// the format:
//
//   ctrl < 32:   a literal run of ctrl + 1 bytes follows;
//   ctrl >= 32:  a back reference: len = ctrl >> 5 (7 means one more byte
//                adds to it), then the low byte of the distance; it copies
//                len + 2 bytes from (ctrl & 31) * 256 + low + 1 bytes back,
//                byte by byte, so a reference may overlap what it writes.
//
// The encoder is greedy over a hash of each position's next three bytes (one
// candidate a bucket, no insertions inside a match); data/lzf.py's plain
// encoder is the same algorithm, so the two give the same bytes.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kHashLog = 14;
constexpr int64_t kMaxOff = 1 << 13;   // distances 1 .. 8192
constexpr int64_t kMaxLen = 264;       // lengths 3 .. 264
constexpr int64_t kMaxLit = 32;

inline uint32_t hash3(const uint8_t* p) {
  uint32_t v = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | uint32_t(p[2]);
  return (v * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

// Decodes `n` bytes of `in` into `out`, which holds `cap` bytes. Returns the
// number of bytes written, or -1 if the input ends inside a command, -2 if
// the output would pass `cap`, -3 if a reference points before the start.
int64_t lzf_decompress(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    const int64_t ctrl = in[ip++];
    if (ctrl < 32) {
      const int64_t len = ctrl + 1;
      if (ip + len > n) return -1;
      if (op + len > cap) return -2;
      std::memcpy(out + op, in + ip, len);
      ip += len;
      op += len;
    } else {
      int64_t len = ctrl >> 5;
      if (len == 7) {
        if (ip >= n) return -1;
        len += in[ip++];
      }
      if (ip >= n) return -1;
      const int64_t ref = op - ((ctrl & 31) << 8) - 1 - in[ip++];
      len += 2;
      if (ref < 0) return -3;
      if (op + len > cap) return -2;
      for (int64_t i = 0; i < len; ++i) out[op + i] = out[ref + i];
      op += len;
    }
  }
  return op;
}

// Encodes `n` bytes of `in` into `out` (`cap` bytes). Returns the encoded
// length, or 0 if it would pass `cap`.
int64_t lzf_compress(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  static thread_local int64_t table[1 << kHashLog];
  std::memset(table, 0, sizeof(table));
  int64_t ip = 0, lit = 0, op = 0;
  auto flush = [&](int64_t end) -> bool {
    while (lit < end) {
      const int64_t k = end - lit < kMaxLit ? end - lit : kMaxLit;
      if (op + 1 + k > cap) return false;
      out[op++] = static_cast<uint8_t>(k - 1);
      std::memcpy(out + op, in + lit, k);
      op += k;
      lit += k;
    }
    return true;
  };
  while (ip + 2 < n) {
    const uint32_t h = hash3(in + ip);
    const int64_t ref = table[h] - 1;
    table[h] = ip + 1;
    if (ref >= 0 && ip - ref - 1 < kMaxOff && in[ref] == in[ip] && in[ref + 1] == in[ip + 1] &&
        in[ref + 2] == in[ip + 2]) {
      const int64_t max_len = n - ip < kMaxLen ? n - ip : kMaxLen;
      int64_t len = 3;
      while (len < max_len && in[ref + len] == in[ip + len]) ++len;
      if (!flush(ip)) return 0;
      const int64_t off = ip - ref - 1;
      const int64_t l = len - 2;
      if (l < 7) {
        if (op + 2 > cap) return 0;
        out[op++] = static_cast<uint8_t>((l << 5) | (off >> 8));
      } else {
        if (op + 3 > cap) return 0;
        out[op++] = static_cast<uint8_t>((7 << 5) | (off >> 8));
        out[op++] = static_cast<uint8_t>(l - 7);
      }
      out[op++] = static_cast<uint8_t>(off & 255);
      ip += len;
      lit = ip;
    } else {
      ++ip;
    }
  }
  if (!flush(n)) return 0;
  return op;
}

}  // extern "C"
