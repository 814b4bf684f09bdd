// Softmax attention for NVIDIA Hopper (sm_90a), head dims 64, 96, 128 and 192, on
// the tensor cores: the forward attention_fwd and its VJP attention_bwd (two
// launches, see "backward" below), each in bf16 and fp32. Every kernel is a
// template over the element type and the head dim D; the C entry points
// dispatch on D and refuse any other.
//
// Replaces mcvd_tpu/ops/lab/attention.py: fused_attention (_kernel) and
// fused_attention_packed (_packed_kernel), and their custom VJPs _fa_bwd and
// _packed_bwd (:78, :187; einsums there, no Pallas body). The Pallas
// kernels hold the whole (T, T) score block of one (batch, head) in VMEM;
// here a block owns 64 rows (queries, or keys in the dK/dV launch) of one
// (batch, head) and walks the other side in tiles of 64, so no (T, T) block
// exists anywhere and T has no limit.
//
// What bounds them on this card: operations. At T = 1024, D = 64 a (batch,
// head) of the forward is 4*T*T*D = 268 MFLOP against ~0.5 MB of q, k, v
// and o, far above the card's bytes-per-FLOP line; beside the products, the
// exponentials of the softmax at D = 64. The design, shared by every body:
// four warps own 16 rows each; the block's own rows are staged once; the
// walked tiles come through a 2-stage ring of cp.async 16-byte copies, so
// the next tile's copy overlaps this tile's math. The forward gives Q a
// tile of its own, so that tile 1's copy is issued before Q lands, and
// holds Q in registers as fragments for the whole walk at every D. The
// backward holds its two own-row operands (Q and dO, or K and V) in
// registers only at D = 64, passing them through the rings' second stages
// before the walk, which keeps it at four tiles of shared memory. At D = 96
// and 128 a thread's two held operands and two 16 x D accumulators would
// pass the 255 registers a thread may have (the fp32 dK/dV launch would
// need ~320 at D = 128), so there the own rows keep tiles of their own
// (six tiles) and each product reads its A fragments from them as it goes
// (fp32 splits them as read), at a quarter more shared-memory reads than
// the walked tile alone. At D = 192 two more limits bind:
//   registers: a 16 x 192 fp32 accumulator is 96 a thread, so the forward
//   reads Q from its tile as the backward reads its own rows, and each
//   backward block owns half of the D output columns (kColSplit; a block
//   pair shares its 64 rows and repeats the S and dP products, which take
//   all of D), so dK and dV are two 16 x 96 accumulators, as at D = 96;
//   shared memory: a 64 x 196 fp32 tile is 49 KB, so five (forward) or six
//   (backward) pass the 227 KB a block may opt in to; fp32 at D = 192
//   walks its tiles through one stage instead of a 2-stage ring (kStages:
//   the copy of tile j + 1 waits for tile j's math), three tiles forward
//   and four backward.
// Each product runs on
// mma.sync with fp32 accumulators, and an accumulator (scores, p or ds) is
// reused from registers as the A operand of the next product, so no
// (64, 64) block of p or ds passes through shared memory. wgmma with
// TMA-fed tiles is the route to the card's full rate and later work.
//
// Two element types, one body each (the tile traits below):
//
// bf16 on mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Tiles are [64][D]
// bf16 with each row's 16-byte chunks permuted by chunk ^ (row % 8) at D =
// 64, 128 and 192 (24 chunks: the permutation stays within each group of
// eight), so ldmatrix's eight row reads (eight rows, one chunk) hit
// eight distinct bank groups; a 96-wide row's last four chunks have no such
// permutation within the row, so at D = 96 rows are padded to 13 chunks, an
// odd count, which spreads eight rows over the eight groups as well (the
// padded layout at D = 64 ran the forward ~11% slower on an H100, PERF.md);
// a tile whose
// rows are a product's n side is read with ldmatrix, one whose rows are the
// k side with ldmatrix.trans. An accumulator is rounded to bf16 as the A
// operand of the next product. Bound: 989 TFLOP/s.
//
// fp32 as 3xTF32 on mma.sync.m16n8k8 (tf32 in, fp32 accumulate): each
// operand x is split as hi = cvt.rna.tf32(x), lo = tf32(x - hi), and a
// product accumulates lo*hi + hi*lo, then hi*hi; lo*lo is dropped. That
// keeps ~21-22 bits of each product against fp32's 24 (fp32-class, not
// TF32), at three TF32 products for one: bound 495/3 = 165 TFLOP/s, beside
// the CUDA cores' 67. Tiles are [64][D+4] fp32 (rows padded by 4 words: D is
// a multiple of 32, so a fragment read of a warp, rows as n or rows as k,
// hits 32 distinct banks) read by 32-bit loads: no
// ldmatrix for 32-bit types. The accumulator of m16n8k8 holds columns 2t
// and 2t+1 where the A operand wants t and t+4, so a product whose A is an
// accumulator takes its k order permuted: position t of an 8-wide k slice
// is element 2t and position t+4 is element 2t+1, in A and in B alike, and
// the accumulator is A with no shuffle. Held fragments are kept as fp32 and
// split once per tile (each split serves eight products); a staged tile's
// element is split where a fragment read takes it, since splitting tiles in
// shared memory would double the shared-memory reads, which this body
// already spends at about the tensor cores' rate.
//
// The forward (attention_fwd_kernel), FlashAttention-2 form: S = Q K^T,
// online softmax in fp32 registers with scale*log2(e) folded into exp2f
// (a running max m and sum l of exp2(s - m)), O += P V, O / l rounded once.
// A ragged last key tile is zero-filled and masked to -inf; a ragged last
// query tile is zero-filled and not stored. bf16 rounds the unnormalised
// p to bf16 before P V, as the Pallas kernel rounds p to v's dtype (there
// after normalising); l sums the unrounded p. Against a version that keeps
// p in fp32 this moves each output by at most 2^-8 * sum_j p_j |v_j| / l
// (2^-8: bf16's unit roundoff) before the last rounding. fp32 splits p.
//
// Layout: q, k, v are read at ptr + b*bs + t*ts + h*D + d, o written at
// o + b*o_bs + t*o_ts + h*D + d. The packed (B, T, 3C) qkv of AttnBlock is
// q = qkv, k = qkv + C, v = qkv + 2C with ts = 3C; the (BH, T, D) layout is
// H = 1, ts = D. Every pointer must be 16-byte aligned and every stride a
// multiple of 16 bytes (the wrapper checks; the entry points refuse).
//
// With a non-null lse pointer the forward also writes each row's logsumexp
// (B, H, T) in fp32, natural log of the scaled scores, for attention_bwd,
// whose two launches recompute p from it.
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launches; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // rows a block owns, and rows of a walked tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; valid == false fills zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8, row) * b (8x8, col), tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x = hi + lo: hi = x rounded to tf32 (ties away), lo = the rest rounded.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a * b as 3xTF32: the small terms first (lo(a) hi(b), then hi(a)
// lo(b); the other way round with kBLoFirst), then hi * hi.
template <bool kBLoFirst>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  if (kBLoFirst) {
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, al, bh0, bh1);
  } else {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------ tile traits
//
// Fragment layouts (lane = 4*g + t). Accumulator, both types: rows g (c0,
// c1) and g+8 (c2, c3), columns 2t, 2t+1 of an n block of 8; a 16 x 64
// accumulator is c[8][4], one entry per n block, a 16 x D one c[D/8][4].
// Each trait Tile<T, D> gives:
//   load(dst, src, row0, ...)  rows [row0, row0 + 64) of a (token, D)
//       slice into a tile by cp.async; rows >= T_len are zero-filled;
//   Held / Staged              the A operand of tile rows row0..row0+15:
//       Held loads its fragments into registers once, Staged reads them from
//       the tile at each product; slice(kk, f) gives k slice kk of either
//       (fp32: split(kk, hi, lo), the slice split into tf32 parts);
//   mma_abt<swap>(c, a, tile, lane)  c += A tile^T: the tile's 64 rows
//       are c's columns, the D dims the k side; with swap, the fp32 body
//       takes its two small terms in the other order, so that C^T = B A^T
//       takes the same products in the same order as C = A B^T and gives
//       the same bits (bf16 takes one product, the same either way);
//   mma_pb(c, p, tile, lane, c0)  c += P tile[:, c0:c0 + 8 NB]: P (16 x
//       64) in accumulator layout, its 64 columns the tile's rows (the k
//       side), c NB blocks of 8 output columns;
//   store2(ptr, a, b)          two adjacent outputs.
template <typename T, int D> struct Tile;

// bf16: m16n8k16; A holds rows g, g+8, columns 2t, 2t+1 (+8); B holds
// k = 2t, 2t+1 (+8), column g.
template <int D> struct Tile<bf16, D> {
  static_assert(D % 32 == 0, "head dim: a multiple of 32");
  // rows of D/8 16-byte chunks, permuted by chunk ^ (row % 8) where D is a
  // multiple of 64; a 96-wide row is padded to 13 chunks instead
  static constexpr bool kSwizzle = D % 64 == 0;
  static constexpr int kPitch = kSwizzle ? D : D + 8;
  static constexpr int kElems = kRows * kPitch;
  static constexpr int kK = D / 16;      // k slices of a row

  static __device__ __forceinline__ int at(int row, int col) {
    return kSwizzle ? row * D + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7))
                    : row * kPitch + col;
  }
  static __device__ __forceinline__ void load(bf16* dst, const bf16* src, int row0, int T_len,
                                              int64_t ts, int tid) {
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kChunks, ch = idx % kChunks;
      const bool valid = row0 + row < T_len;
      const bf16* g = src + (valid ? (int64_t)(row0 + row) * ts + ch * 8 : 0);
      cp_async16(smem_u32(dst + at(row, ch * 8)), g, valid);
    }
  }
  struct Held {   // 16 rows x D, kK slices of 16
    uint32_t a[kK][4];
    __device__ __forceinline__ void load(const bf16* t, int row0, int lane) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        ldsm_x4(smem_u32(t + at(row0 + (lane & 15), kk * 16 + (lane >> 4) * 8)), a[kk][0],
                a[kk][1], a[kk][2], a[kk][3]);
    }
    __device__ __forceinline__ void slice(int kk, uint32_t (&f)[4]) const {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = a[kk][e];
    }
  };
  struct Staged {
    const bf16* t;
    int row, col;   // lane's ldmatrix row and column of slice 0
    __device__ __forceinline__ void load(const bf16* t_, int row0, int lane) {
      t = t_;
      row = row0 + (lane & 15);
      col = (lane >> 4) * 8;
    }
    __device__ __forceinline__ void slice(int kk, uint32_t (&f)[4]) const {
      ldsm_x4(smem_u32(t + at(row, kk * 16 + col)), f[0], f[1], f[2], f[3]);
    }
  };
  template <bool kSwap = false, class A>
  static __device__ __forceinline__ void mma_abt(float (&c)[8][4], const A& a, const bf16* t,
                                                 int lane) {
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t af[4];
      a.slice(kk, af);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(t + at(np * 16 + (lane & 7) + (mi >> 1) * 8, kk * 16 + (mi & 1) * 8)),
                b0, b1, b2, b3);
        mma_bf16(c[2 * np], af, b0, b1);
        mma_bf16(c[2 * np + 1], af, b2, b3);
      }
    }
  }
  template <int NB>
  static __device__ __forceinline__ void mma_pb(float (&c)[NB][4], const float (&p)[8][4],
                                                const bf16* t, int lane, int c0) {
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NB / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(t + at(kk * 16 + (lane & 7) + (mi & 1) * 8,
                                      c0 + dp * 16 + (mi >> 1) * 8)),
                      b0, b1, b2, b3);
        mma_bf16(c[2 * dp], pa, b0, b1);
        mma_bf16(c[2 * dp + 1], pa, b2, b3);
      }
    }
  }
  static __device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  }
};

// fp32: m16n8k8 tf32; A holds (row g, k t), (g+8, t), (g, t+4), (g+8, t+4);
// B holds (k t, column g), (k t+4, column g).
template <int D> struct Tile<float, D> {
  static_assert(D % 32 == 0, "head dim: a multiple of 32");
  static constexpr int kPitch = D + 4;   // 4g + t: 32 distinct banks
  static constexpr int kElems = kRows * kPitch;
  static constexpr int kK = D / 8;       // k slices of a row

  static __device__ __forceinline__ void load(float* dst, const float* src, int row0,
                                              int T_len, int64_t ts, int tid) {
    constexpr int kChunks = D / 4;
#pragma unroll
    for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kChunks, ch = idx % kChunks;
      const bool valid = row0 + row < T_len;
      const float* g = src + (valid ? (int64_t)(row0 + row) * ts + ch * 4 : 0);
      cp_async16(smem_u32(dst + row * kPitch + ch * 4), g, valid);
    }
  }
  struct Held {   // 16 rows x D, kK slices of 8, unsplit
    float a[kK][4];
    __device__ __forceinline__ void load(const float* t, int row0, int lane) {
      const float* r = t + (row0 + (lane >> 2)) * kPitch + (lane & 3);
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        a[kk][0] = r[kk * 8];
        a[kk][1] = r[8 * kPitch + kk * 8];
        a[kk][2] = r[kk * 8 + 4];
        a[kk][3] = r[8 * kPitch + kk * 8 + 4];
      }
    }
    // k slice kk split into tf32 hi and lo parts
    __device__ __forceinline__ void split(int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[kk][e], hi[e], lo[e]);
    }
  };
  struct Staged {
    const float* r;   // lane's first element
    __device__ __forceinline__ void load(const float* t, int row0, int lane) {
      r = t + (row0 + (lane >> 2)) * kPitch + (lane & 3);
    }
    __device__ __forceinline__ void split(int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
      split_tf32(r[kk * 8], hi[0], lo[0]);
      split_tf32(r[8 * kPitch + kk * 8], hi[1], lo[1]);
      split_tf32(r[kk * 8 + 4], hi[2], lo[2]);
      split_tf32(r[8 * kPitch + kk * 8 + 4], hi[3], lo[3]);
    }
  };
  template <bool kSwap = false, class A>
  static __device__ __forceinline__ void mma_abt(float (&c)[8][4], const A& a, const float* t,
                                                 int lane) {
    const float* r = t + (lane >> 2) * kPitch + (lane & 3);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t ah[4], al[4];
      a.split(kk, ah, al);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mma_3xtf32<kSwap>(c[nb], ah, al, r[nb * 8 * kPitch + kk * 8],
                          r[nb * 8 * kPitch + kk * 8 + 4]);
    }
  }
  // k permuted within each slice of 8: position t is column 2t of P, t + 4
  // is 2t + 1, so P's accumulator is the A operand as it stands.
  template <int NB>
  static __device__ __forceinline__ void mma_pb(float (&c)[NB][4], const float (&p)[8][4],
                                                const float* t, int lane, int c0) {
    const float* r = t + 2 * (lane & 3) * kPitch + (lane >> 2) + c0;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(p[kk][0], ah[0], al[0]);
      split_tf32(p[kk][2], ah[1], al[1]);
      split_tf32(p[kk][1], ah[2], al[2]);
      split_tf32(p[kk][3], ah[3], al[3]);
      const float* rk = r + kk * 8 * kPitch;
#pragma unroll
      for (int dn = 0; dn < NB; ++dn)
        mma_3xtf32<false>(c[dn], ah, al, rk[dn * 8], rk[kPitch + dn * 8]);
    }
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// The backward holds its own rows' fragments in registers only at D = 64,
// the forward its Q up to D = 128 (see the note at the top); above, they
// are read from their tiles.
template <int D> constexpr bool kHeldRows = D == 64;
template <typename T, int D>
using OwnRows = std::conditional_t<kHeldRows<D>, typename Tile<T, D>::Held,
                                   typename Tile<T, D>::Staged>;
template <typename T, int D>
using QRows = std::conditional_t<(D <= 128), typename Tile<T, D>::Held,
                                 typename Tile<T, D>::Staged>;

constexpr int kSmemLimit = 232448;   // 227 KB, the most a block may opt in to
template <typename T, int D> constexpr int kTileBytes = Tile<T, D>::kElems * (int)sizeof(T);
// Stages of the walked tiles' ring: two where the backward's tiles (four
// with held rows, else six) and its row values fit, else one.
template <typename T, int D>
constexpr int kStages =
    (kHeldRows<D> ? 4 : 6) * kTileBytes<T, D> + 4 * kRows * 4 <= kSmemLimit ? 2 : 1;
// Tiles of shared memory a backward block takes: its ring's stages, and two
// tiles of its own rows where it does not hold them in registers.
template <typename T, int D>
constexpr int kBwdTiles = kHeldRows<D> ? 4 : 2 * kStages<T, D> + 2;
static_assert(!kHeldRows<64> || (kStages<bf16, 64> == 2 && kStages<float, 64> == 2),
              "held rows pass through the rings' second stages");
// Blocks that share a backward block's rows, each owning D / kColSplit of
// the output columns.
template <int D> constexpr int kColSplit = D > 128 ? 2 : 1;

// Brings tile j of a walk into its ring stage and returns the stage; tile 0
// was issued before the walk, and load(stage, tile) issues a tile's copies.
// Two stages: tile j + 1's copy is issued first, so it overlaps tile j's
// math. One: tile j's copy is issued now, after the walk's __syncthreads()
// has seen the stage read out.
template <int kSt, class F>
__device__ __forceinline__ int ring_next(int j, int n_tiles, const F& load) {
  if constexpr (kSt == 2) {
    if (j + 1 < n_tiles) {
      load((j + 1) & 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    return j & 1;
  } else {
    if (j > 0) {
      load(0, j);
      cp_async_commit();
    }
    cp_async_wait<0>();
    return 0;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
}

// Column of accumulator entry (nb, e) within its 64-wide tile.
__device__ __forceinline__ int acc_col(int lane, int nb, int e) {
  return nb * 8 + (lane & 3) * 2 + (e & 1);
}

// ------------------------------------------------------------------ forward

// The minimum of one block an SM is no limit (registers allow three, the
// same count either way), but with it ptxas gives the forward ~150
// registers instead of ~130 and the bf16 body ran ~17% faster on an H100
// (PERF.md).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int T_len, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts,
                     int64_t o_bs, int64_t o_ts, float scale_log2) {
  using Tl = Tile<T, D>;
  constexpr int kSt = kStages<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);   // [tile]
  T* sK = sQ + Tl::kElems;              // [kSt][tile]
  T* sV = sK + kSt * Tl::kElems;        // [kSt][tile]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kRows;
  const int64_t h_off = (int64_t)blockIdx.y * D;
  const int64_t b = blockIdx.z;
  const T* qb = q + b * q_bs + h_off;
  const T* kb = k + b * kv_bs + h_off;
  const T* vb = v + b * kv_bs + h_off;
  T* ob = o + b * o_bs + h_off;
  const int n_tiles = (T_len + kRows - 1) / kRows;
  const auto load_kv = [&](int st, int j) {
    Tl::load(sK + st * Tl::kElems, kb, j * kRows, T_len, kv_ts, tid);
    Tl::load(sV + st * Tl::kElems, vb, j * kRows, T_len, kv_ts, tid);
  };

  // Q has a tile of its own, so tile 1's copy starts before Q has landed
  Tl::load(sQ, qb, m0, T_len, q_ts, tid);
  load_kv(0, 0);
  cp_async_commit();

  QRows<T, D> qf;         // this warp's 16 query rows, read after tile 0 lands
  float acc[D / 8][4];    // O: 16 rows x D
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (scaled)
  float l_r[2] = {0.f, 0.f};              // this thread's share of the running sums
  zero(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = ring_next<kSt>(j, n_tiles, load_kv);
    __syncthreads();
    if (j == 0) qf.load(sQ, warp * 16, lane);
    const T* tK = sK + st * Tl::kElems;
    const T* tV = sV + st * Tl::kElems;

    float s[8][4];   // S = Q K^T: 16 rows x 64 keys
    zero(s);
    Tl::mma_abt(s, qf, tK, lane);

    // online softmax over this tile, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const int n0 = j * kRows;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nb][e] = n0 + acc_col(lane, nb, e) < T_len ? s[nb][e] * scale_log2 : -INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_r[r];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // the four lanes of a row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // finite: key n0 of every tile is a valid key
      const float alpha = exp2f(m_r[r] - mx);  // 0 on the first tile
      m_r[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        s[nb][2 * r] = exp2f(s[nb][2 * r] - mx);
        s[nb][2 * r + 1] = exp2f(s[nb][2 * r + 1] - mx);
        sum += s[nb][2 * r] + s[nb][2 * r + 1];
      }
      l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        acc[nb][2 * r] *= alpha;
        acc[nb][2 * r + 1] *= alpha;
      }
    }

    Tl::mma_pb(acc, s, tV, lane, 0);   // O += P V, P from the score registers
    __syncthreads();  // this stage is read out before the next copy into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = m0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row < T_len) {
      T* orow = ob + (int64_t)row * o_ts + (lane & 3) * 2;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        Tl::store2(orow + nb * 8, acc[nb][2 * r] * inv, acc[nb][2 * r + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)   // natural log: (m + log2 l) * ln 2
        lse[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * T_len + row] =
            (m_r[r] + log2f(l)) * kLn2;
    }
  }
}

// ----------------------------------------------------------------- backward
//
// attention_bwd: the VJP of _fa_bwd / _packed_bwd in the FlashAttention-2
// form. The forward saved each row's logsumexp (lse, natural log of the
// scaled scores), so p = exp2(s*scale*log2(e) - lse*log2(e)) is recomputed
// tile by tile and neither P, dP nor dS reaches device memory:
//   D_i = rowsum(dO_i * O_i)   (= rowsum(dp * p), the VJP's row term);
//   ds = p * (dp - D), dp = dO V^T;
//   dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO.
// Two launches on the same stream, no atomics, so the result is
// deterministic (bit-identical from call to call):
//   attention_bwd_dq_kernel, query-major: a block owns 64 query rows, holds
//   (D = 64) or stages their Q and dO, computes their D_i, and walks the keys in
//   tiles of 64: S = Q K^T and dP = dO V^T, then p and ds in fp32
//   registers, then dQ += dS K with dS as A. Three products a tile.
//   attention_bwd_dkv_kernel, key-major, after it: a block owns 64 keys,
//   holds or stages their K and V, and walks the queries in tiles of 64
//   (Q, dO and the tile's lse and D'): S^T = K Q^T, P^T, dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - D'), dK += dS^T Q. Four products.
// The row terms. The dQ launch needs D before its walk and takes
// rowsum(dO * O) from the forward's output; on the way it sums
// D' = rowsum(p * dp) from its own p and dp (the JAX VJP's own row term) and
// stores that for the dK/dV launch, whose S^T and dP^T take the same
// products in the same order (mma_abt<true>) and so are the dQ launch's S
// and dP bit for bit. Each row of the dS that dK sees then sums to zero to
// fp32 rounding, as in the plain VJP: sum_j dK_j, which is exactly zero (the
// key bias's gradient), stays at fp32 noise. With D from O it would carry
// the forward's and backward's product errors, 2^-21 with 3xTF32, coherent
// over all keys.
// bf16 rounds P^T and dS (as A operands) to bf16; the gradients are fp32
// accumulators, scaled and rounded once. fp32 splits them as every operand.
//
// What bounds it: operations. The VJP needs 5 products of 2*T*T*D FLOPs
// per (batch, head); S and dP are computed in both launches, so this does
// 7 and reaches at most 5/7 of the bound (989 TFLOP/s bf16, 165 3xTF32).
// One launch with dQ summed by atomics would do 5, at the price of an order
// that changes from run to run.

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;
  void* dq; void* dk; void* dv;
  float* delta;            // (B, H, T) row sums D' = rowsum(p * dp), from the dQ launch
  int T_len;
  int64_t bs, ts;          // q, k, v and dq, dk, dv: batch and token strides
  int64_t o_bs, o_ts;      // o and dO
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(const BwdArgs a) {
  using Tl = Tile<T, D>;
  constexpr int kSt = kStages<T, D>, kSplit = kColSplit<D>, NB = D / 8 / kSplit;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);                        // [kSt][tile]
  T* sV = sK + kSt * Tl::kElems;                             // [kSt][tile]
  // Q and dO: the rings' second stages when held, else tiles of their own
  T* sQ = kHeldRows<D> ? sK + Tl::kElems : sV + kSt * Tl::kElems;
  T* sG = kHeldRows<D> ? sV + Tl::kElems : sQ + Tl::kElems;
  float* sD = reinterpret_cast<float*>(sK + kBwdTiles<T, D> * Tl::kElems);   // [64]: row terms

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (blockIdx.x / kSplit) * kRows;
  const int c0 = (blockIdx.x % kSplit) * (D / kSplit);   // this block's dQ columns
  const int64_t h_off = (int64_t)blockIdx.y * D;
  const int64_t b = blockIdx.z;
  const int64_t bh = b * gridDim.y + blockIdx.y;
  const T* qb = static_cast<const T*>(a.q) + b * a.bs + h_off;
  const T* kb = static_cast<const T*>(a.k) + b * a.bs + h_off;
  const T* vb = static_cast<const T*>(a.v) + b * a.bs + h_off;
  const T* ob = static_cast<const T*>(a.o) + b * a.o_bs + h_off;
  const T* gb = static_cast<const T*>(a.dout) + b * a.o_bs + h_off;
  const int T_len = a.T_len;
  const float sl2 = a.scale * kLog2e;
  const int n_tiles = (T_len + kRows - 1) / kRows;
  const auto load_kv = [&](int st, int j) {
    Tl::load(sK + st * Tl::kElems, kb, j * kRows, T_len, a.ts, tid);
    Tl::load(sV + st * Tl::kElems, vb, j * kRows, T_len, a.ts, tid);
  };

  Tl::load(sQ, qb, m0, T_len, a.ts, tid);
  Tl::load(sG, gb, m0, T_len, a.o_ts, tid);
  load_kv(0, 0);
  cp_async_commit();

  {  // D = rowsum(dO * O) of the block's rows while the copies fly: two threads a row
    const int r = tid >> 1, half = tid & 1;
    const int row = m0 + r;
    float d = 0.f;
    if (row < T_len) {
      const T* go = gb + (int64_t)row * a.o_ts + half * (D / 2);
      const T* oo = ob + (int64_t)row * a.o_ts + half * (D / 2);
#pragma unroll 8
      for (int e = 0; e < D / 2; ++e) d = fmaf(to_f32(go[e]), to_f32(oo[e]), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) sD[r] = d;
  }
  cp_async_wait<0>();
  __syncthreads();
  OwnRows<T, D> qf, gf;   // this warp's 16 rows of Q and dO
  qf.load(sQ, warp * 16, lane);
  gf.load(sG, warp * 16, lane);
  float lse2[2], Dr[2];   // rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = m0 + rl < T_len ? a.lse[bh * T_len + m0 + rl] * kLog2e : 0.f;
    Dr[r] = sD[rl];
  }
  __syncthreads();   // held Q and dO are read out before tile 1 is copied over them

  float dq[NB][4];
  float pdp[2] = {0.f, 0.f};   // this thread's share of rowsum(p * dp), rows g, g + 8
  zero(dq);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = ring_next<kSt>(j, n_tiles, load_kv);
    __syncthreads();
    const T* tK = sK + st * Tl::kElems;
    const T* tV = sV + st * Tl::kElems;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    Tl::mma_abt(s, qf, tK, lane);    // S = Q K^T
    Tl::mma_abt(dp, gf, tV, lane);   // dP = dO V^T
    const int n0 = j * kRows;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = n0 + acc_col(lane, nb, e) < T_len
                            ? exp2f(fmaf(s[nb][e], sl2, -lse2[r])) : 0.f;
        pdp[r] = fmaf(p, dp[nb][e], pdp[r]);
        s[nb][e] = p * (dp[nb][e] - Dr[r]);   // ds
      }
    Tl::mma_pb(dq, s, tK, lane, c0);   // dQ += dS K
    __syncthreads();  // this stage is read out before the next copy into it
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.bs + h_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + (lane >> 2) + 8 * r;
    float d = pdp[r];   // the four lanes of a row
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (row < T_len) {   // a block pair's S and dP, and so d, are the same bits
      if ((lane & 3) == 0 && c0 == 0) a.delta[bh * T_len + row] = d;
      T* out = dqb + (int64_t)row * a.ts + c0 + (lane & 3) * 2;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        Tl::store2(out + nb * 8, dq[nb][2 * r] * a.scale, dq[nb][2 * r + 1] * a.scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(const BwdArgs a) {
  using Tl = Tile<T, D>;
  constexpr int kSt = kStages<T, D>, kSplit = kColSplit<D>, NB = D / 8 / kSplit;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);                          // [kSt][tile]
  T* sG = sQ + kSt * Tl::kElems;                               // [kSt][tile]: dO
  // K and V: the rings' second stages when held, else tiles of their own
  T* sK = kHeldRows<D> ? sQ + Tl::kElems : sG + kSt * Tl::kElems;
  T* sV = kHeldRows<D> ? sG + Tl::kElems : sK + Tl::kElems;
  float* sL = reinterpret_cast<float*>(sQ + kBwdTiles<T, D> * Tl::kElems);   // [2][64]: lse
  float* sDq = sL + 2 * kRows;                                 // [2][64]: D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = (blockIdx.x / kSplit) * kRows;
  const int c0 = (blockIdx.x % kSplit) * (D / kSplit);   // this block's dK, dV columns
  const int64_t h_off = (int64_t)blockIdx.y * D;
  const int64_t b = blockIdx.z;
  const int64_t bh = b * gridDim.y + blockIdx.y;
  const T* qb = static_cast<const T*>(a.q) + b * a.bs + h_off;
  const T* kb = static_cast<const T*>(a.k) + b * a.bs + h_off;
  const T* vb = static_cast<const T*>(a.v) + b * a.bs + h_off;
  const T* gb = static_cast<const T*>(a.dout) + b * a.o_bs + h_off;
  const int T_len = a.T_len;
  const float sl2 = a.scale * kLog2e;
  const int n_tiles = (T_len + kRows - 1) / kRows;

  // query tile j: Q and dO rows, and the tile's lse and D (one thread each)
  const auto load_queries = [&](int st, int j) {
    const int i0 = j * kRows;
    Tl::load(sQ + st * Tl::kElems, qb, i0, T_len, a.ts, tid);
    Tl::load(sG + st * Tl::kElems, gb, i0, T_len, a.o_ts, tid);
    const int c = tid & (kRows - 1), i = i0 + c;
    const float* src = tid < kRows ? a.lse : a.delta;
    float* dst = (tid < kRows ? sL : sDq) + st * kRows + c;
    cp_async4(smem_u32(dst), src + bh * T_len + (i < T_len ? i : 0), i < T_len);
  };

  Tl::load(sK, kb, k0, T_len, a.ts, tid);
  Tl::load(sV, vb, k0, T_len, a.ts, tid);
  load_queries(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  OwnRows<T, D> kf, vf;   // this warp's 16 keys of K and V
  kf.load(sK, warp * 16, lane);
  vf.load(sV, warp * 16, lane);
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + warp * 16 + (lane >> 2) + 8 * r < T_len;
  __syncthreads();   // held K and V are read out before tile 1 is copied over them

  float dk[NB][4], dv[NB][4];
  zero(dk);
  zero(dv);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = ring_next<kSt>(j, n_tiles, load_queries);
    __syncthreads();
    const T* tQ = sQ + st * Tl::kElems;
    const T* tG = sG + st * Tl::kElems;
    const float* L = sL + st * kRows;
    const float* Dq = sDq + st * kRows;
    const int i0 = j * kRows;

    float s[8][4];   // S^T, then P^T: 16 keys x 64 queries
    zero(s);
    Tl::template mma_abt<true>(s, kf, tQ, lane);   // the dQ launch's S, transposed
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = acc_col(lane, nb, e);
        s[nb][e] = key_ok[e >> 1] && i0 + c < T_len
                       ? exp2f(fmaf(s[nb][e], sl2, -(L[c] * kLog2e))) : 0.f;
      }
    Tl::mma_pb(dv, s, tG, lane, c0);   // dV += P^T dO
    float dp[8][4];  // dP^T, then dS^T
    zero(dp);
    Tl::template mma_abt<true>(dp, vf, tG, lane);   // dP^T = V dO^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nb][e] = s[nb][e] * (dp[nb][e] - Dq[acc_col(lane, nb, e)]);
    Tl::mma_pb(dk, dp, tQ, lane, c0);  // dK += dS^T Q
    __syncthreads();  // this stage is read out before the next copy into it
  }

  const int64_t out0 = b * a.bs + h_off + c0;
  T* dkb = static_cast<T*>(a.dk) + out0;
  T* dvb = static_cast<T*>(a.dv) + out0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const int64_t off = (int64_t)(k0 + warp * 16 + (lane >> 2) + 8 * r) * a.ts + (lane & 3) * 2;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      Tl::store2(dkb + off + nb * 8, dk[nb][2 * r] * a.scale, dk[nb][2 * r + 1] * a.scale);
      Tl::store2(dvb + off + nb * 8, dv[nb][2 * r], dv[nb][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch

// Dynamic shared memory of each kernel, in bytes: the forward's tiles (Q
// and the K and V rings), the backward's (kBwdTiles) and its row values.
template <typename T, int D>
constexpr int kFwdSmem = (1 + 2 * kStages<T, D>) * kTileBytes<T, D>;
template <typename T, int D>
constexpr int kDqSmem = kBwdTiles<T, D> * kTileBytes<T, D> + kRows * 4;
template <typename T, int D>
constexpr int kDkvSmem = kBwdTiles<T, D> * kTileBytes<T, D> + 4 * kRows * 4;
template <typename T, int D>
constexpr bool kFits =
    kFwdSmem<T, D> <= kSmemLimit && kDqSmem<T, D> <= kSmemLimit && kDkvSmem<T, D> <= kSmemLimit;
static_assert(kFits<float, 128> && kFits<float, 192> && kFits<bf16, 192>,
              "every instantiation must fit one block's shared memory");

bool bad_shape(int B, int H, int T_len, int D) {
  return (D != 64 && D != 96 && D != 128 && D != 192) || B <= 0 || H <= 0 || T_len <= 0 ||
         B > 65535 || H > 65535;
}

// 16-byte copies: every pointer 16-byte aligned, every stride a multiple of
// 16 bytes.
template <typename T>
bool misaligned(std::initializer_list<const void*> ptrs,
                std::initializer_list<int64_t> strides) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return true;
  for (int64_t s : strides)
    if (s * (int64_t)sizeof(T) % 16 != 0) return true;
  return false;
}

constexpr int kMaxDevices = 64;

// The kernels take more than 48 KB of dynamic shared memory (fp32 at every
// D, bf16 above D = 64): every kernel opts in once per device, element type
// and head dim.
template <typename T, int D>
cudaError_t set_attributes() {
  static bool set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[dev]) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(attention_fwd_kernel<T, D>, attr, kFwdSmem<T, D>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, D>, attr, kDqSmem<T, D>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T, D>, attr, kDkvSmem<T, D>);
  if (err != cudaSuccess) return err;
  set[dev] = true;
  return cudaSuccess;
}

struct FwdArgs {
  const void* q; const void* k; const void* v; void* o; float* lse;
  int B, H, T_len;
  int64_t q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts;
  float scale;
};

template <typename T, int D>
int launch_fwd_d(const FwdArgs& f, cudaStream_t stream) {
  cudaError_t err = set_attributes<T, D>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f.T_len + kRows - 1) / kRows, f.H, f.B);
  attention_fwd_kernel<T, D><<<grid, kThreads, kFwdSmem<T, D>, stream>>>(
      static_cast<const T*>(f.q), static_cast<const T*>(f.k), static_cast<const T*>(f.v),
      static_cast<T*>(f.o), f.lse, f.T_len, f.q_bs, f.q_ts, f.kv_bs, f.kv_ts, f.o_bs, f.o_ts,
      f.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int T_len, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts,
               int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  if (bad_shape(B, H, T_len, D) ||
      misaligned<T>({q, k, v, o}, {q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts}))
    return (int)cudaErrorInvalidValue;
  const FwdArgs f{q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_fwd_d<T, 64>(f, s);
    case 96: return launch_fwd_d<T, 96>(f, s);
    case 128: return launch_fwd_d<T, 128>(f, s);
    default: return launch_fwd_d<T, 192>(f, s);
  }
}

template <typename T, int D>
int launch_bwd_d(const BwdArgs& a, int B, int H, cudaStream_t stream) {
  cudaError_t err = set_attributes<T, D>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T_len + kRows - 1) / kRows * kColSplit<D>, H, B);
  attention_bwd_dq_kernel<T, D><<<grid, kThreads, kDqSmem<T, D>, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<T, D><<<grid, kThreads, kDkvSmem<T, D>, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int H,
               int T_len, int D, int64_t bs, int64_t ts, int64_t o_bs, int64_t o_ts,
               float scale, void* stream) {
  if (bad_shape(B, H, T_len, D) || lse == nullptr || delta == nullptr ||
      misaligned<T>({q, k, v, o, dout, dq, dk, dv}, {bs, ts, o_bs, o_ts}))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, lse, dq, dk, dv, delta, T_len, bs, ts, o_bs, o_ts, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_bwd_d<T, 64>(a, B, H, s);
    case 96: return launch_bwd_d<T, 96>(a, B, H, s);
    case 128: return launch_bwd_d<T, 128>(a, B, H, s);
    default: return launch_bwd_d<T, 192>(a, B, H, s);
  }
}

}  // namespace

extern "C" {

int attention_fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int H, int T, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs,
                      int64_t kv_ts, int64_t o_bs, int64_t o_ts, float scale,
                      void* stream) {
  return launch_fwd<float>(q, k, v, o, lse, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
                           scale, stream);
}

int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int T, int D, int64_t q_bs, int64_t q_ts,
                       int64_t kv_bs, int64_t kv_ts, int64_t o_bs, int64_t o_ts,
                       float scale, void* stream) {
  return launch_fwd<bf16>(q, k, v, o, lse, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
                          scale, stream);
}

int attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq, void* dk, void* dv,
                      float* delta, int B, int H, int T, int D, int64_t bs, int64_t ts,
                      int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  return launch_bwd<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, T, D, bs, ts,
                           o_bs, o_ts, scale, stream);
}

int attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* delta, int B, int H, int T, int D, int64_t bs, int64_t ts,
                       int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  return launch_bwd<bf16>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, T, D, bs, ts,
                          o_bs, o_ts, scale, stream);
}

const char* mcvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
