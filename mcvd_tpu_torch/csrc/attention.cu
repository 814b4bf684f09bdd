// Softmax attention on mma.sync (sm_90a): the route of attention_fwd and
// attention_bwd that ops/attention.py's `attention_route` gives head dim 24,
// the 3D family's one-head attention (over its 7 or 2 frames, and its 4-px
// and 16-px space: 16 and 256 tokens). Head dims 64-192, the main path,
// take the wgmma kernels of attention_wgmma.cuh. Both routes compute the
// same function with the same rounding points. The kernels are templates
// over the element type and the head dim D, instantiated at D = 24 alone;
// the C entry points refuse any other.
//
// Replaces mcvd_tpu/ops/lab/attention.py: fused_attention (_kernel) and
// fused_attention_packed (_packed_kernel), and their custom VJPs _fa_bwd and
// _packed_bwd (:78, :187), on this route's shapes. A block owns 64 rows
// (queries, or keys in the dK/dV launch) of one (batch, head) and walks the
// other side in tiles of 64, so no (T, T) block exists and T has no limit.
//
// What bounds them: at this route's shapes, not the tensor cores. A
// sequence of 7 or 2 tokens fills 7 or 2 of a block's 64 rows (89-97% of
// each block idles), and D = 24 is padded to 32 columns; the work is
// B*H*W sequences of a few hundred FLOPs each, so launch and per-block
// costs rule (PERF.md). The design keeps each block small and cheap: four
// warps own 16 rows each on mma.sync with fp32 accumulators, the walked
// tiles come through a 2-stage ring of cp.async 16-byte copies (the next
// tile's copy overlaps this tile's math), and an accumulator (scores, p or
// ds) is reused from registers as the A operand of the next product, so no
// block of p or ds passes through shared memory. Packing several short
// sequences into one block is later work.
//
// D = 24: a row is padded to 32 columns in shared memory, the pad written
// as zeros by the copy (cp.async with no source bytes) and never loaded
// from device memory: in AttnBlock's packed (B, T, 3C) qkv, column 24 of
// q's row is k's first column. Every product runs at depth 32 (bf16
// m16n8k16 takes depth in steps of 16): the pad's zeros add exact zeros to
// S = Q K^T and dP = dO V^T, and the outputs' pad columns are zeros that
// are not stored. The forward holds its Q fragments in registers; the
// backward's own rows (Q and dO, or K and V) keep tiles of their own and
// each product reads its A fragments from them as it goes.
//
// The grid's batch axis (gridDim.z) stops at 65,535, and the time
// attention's batch is B*H*W (256,000 at fast_fid's batch of 1000): a call
// with more launches once for each run of up to 65,535 (launch_fwd_d,
// launch_bwd_d), on pointers moved to the run.
//
// Two element types, one body each (the tile traits below):
//
// bf16 on mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Tiles are [64][32]
// bf16 with each row padded to 5 16-byte chunks: an odd count, so
// ldmatrix's eight row reads of one chunk hit eight distinct bank groups.
// A tile whose rows are a product's n side is read
// with ldmatrix, one whose rows are the k side with ldmatrix.trans. An
// accumulator is rounded to bf16 as the A operand of the next product.
//
// fp32 as 3xTF32 on mma.sync.m16n8k8 (tf32 in, fp32 accumulate): each
// operand x is split as hi = cvt.rna.tf32(x), lo = tf32(x - hi), and a
// product accumulates lo*hi + hi*lo, then hi*hi; lo*lo is dropped. That
// keeps ~21-22 bits of each product against fp32's 24 (fp32-class, not
// TF32). Tiles are [64][D+4] fp32 (rows padded by 4 words: a fragment read
// of a warp hits 32 distinct banks) read by 32-bit loads. The accumulator
// of m16n8k8 holds columns 2t and 2t+1 where the A operand wants t and t+4,
// so a product whose A is an accumulator takes its k order permuted:
// position t of an 8-wide k slice is element 2t and position t+4 is 2t+1,
// in A and in B alike, and the accumulator is A with no shuffle. Held
// fragments are kept as fp32 and split once per tile; a staged tile's
// element is split where a fragment read takes it.
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
//   mma_pb(c, p, tile, lane)  c += P tile[:, :8 NB]: P (16 x
//       64) in accumulator layout, its 64 columns the tile's rows (the k
//       side), c NB blocks of 8 output columns;
//   store2(ptr, a, b)          two adjacent outputs.
template <typename T, int D> struct Tile;

// bf16: m16n8k16; A holds rows g, g+8, columns 2t, 2t+1 (+8); B holds
// k = 2t, 2t+1 (+8), column g.
template <int D> struct Tile<bf16, D> {
  static_assert(D % 32 == 0 && D % 64 != 0, "head dim: an odd multiple of 32");
  // rows of D/8 16-byte chunks padded by one: an odd count spreads eight
  // rows' reads of one chunk over the eight bank groups
  static constexpr int kPitch = D + 8;
  static constexpr int kElems = kRows * kPitch;
  static constexpr int kK = D / 16;      // k slices of a row

  static __device__ __forceinline__ int at(int row, int col) { return row * kPitch + col; }
  // DR <= D: the row's real columns; the chunks past them are zero-filled
  template <int DR = D>
  static __device__ __forceinline__ void load(bf16* dst, const bf16* src, int row0, int T_len,
                                              int64_t ts, int tid) {
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kChunks, ch = idx % kChunks;
      const bool valid = row0 + row < T_len && ch < DR / 8;
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
                                                const bf16* t, int lane) {
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
                                      dp * 16 + (mi >> 1) * 8)),
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

  template <int DR = D>
  static __device__ __forceinline__ void load(float* dst, const float* src, int row0,
                                              int T_len, int64_t ts, int tid) {
    constexpr int kChunks = D / 4;
#pragma unroll
    for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kChunks, ch = idx % kChunks;
      const bool valid = row0 + row < T_len && ch < DR / 4;
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
                                                const float* t, int lane) {
    const float* r = t + 2 * (lane & 3) * kPitch + (lane >> 2);
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

template <typename T, int D> constexpr int kTileBytes = Tile<T, D>::kElems * (int)sizeof(T);
// The tiles' width for head dim D: D rounded up to a multiple of 32 (24 ->
// 32).
template <int D> constexpr int kPad = (D + 31) / 32 * 32;

// Brings tile j of a walk into its stage of the 2-stage ring and returns
// the stage; tile 0 was issued before the walk, and load(stage, tile)
// issues a tile's copies. Tile j + 1's copy is issued first, so it overlaps
// tile j's math.
template <class F>
__device__ __forceinline__ int ring_next(int j, int n_tiles, const F& load) {
  if (j + 1 < n_tiles) {
    load((j + 1) & 1, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  return j & 1;
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
  constexpr int DP = kPad<D>;   // the tiles' width
  using Tl = Tile<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);   // [tile]
  T* sK = sQ + Tl::kElems;              // [2][tile]
  T* sV = sK + 2 * Tl::kElems;          // [2][tile]

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
    Tl::template load<D>(sK + st * Tl::kElems, kb, j * kRows, T_len, kv_ts, tid);
    Tl::template load<D>(sV + st * Tl::kElems, vb, j * kRows, T_len, kv_ts, tid);
  };

  // Q has a tile of its own, so tile 1's copy starts before Q has landed
  Tl::template load<D>(sQ, qb, m0, T_len, q_ts, tid);
  load_kv(0, 0);
  cp_async_commit();

  typename Tl::Held qf;   // this warp's 16 query rows, read after tile 0 lands
  float acc[DP / 8][4];   // O: 16 rows x DP
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (scaled)
  float l_r[2] = {0.f, 0.f};              // this thread's share of the running sums
  zero(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = ring_next(j, n_tiles, load_kv);
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
      for (int nb = 0; nb < DP / 8; ++nb) {
        acc[nb][2 * r] *= alpha;
        acc[nb][2 * r + 1] *= alpha;
      }
    }

    Tl::mma_pb(acc, s, tV, lane);   // O += P V, P from the score registers
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
      for (int nb = 0; nb < D / 8; ++nb)   // the real columns; the pad's are zeros
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
//   attention_bwd_dq_kernel, query-major: a block owns 64 query rows, stages
//   their Q and dO, computes their D_i, and walks the keys in
//   tiles of 64: S = Q K^T and dP = dO V^T, then p and ds in fp32
//   registers, then dQ += dS K with dS as A. Three products a tile.
//   attention_bwd_dkv_kernel, key-major, after it: a block owns 64 keys,
//   stages their K and V, and walks the queries in tiles of 64
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
  constexpr int DP = kPad<D>;   // the tiles' width
  using Tl = Tile<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);   // [2][tile]
  T* sV = sK + 2 * Tl::kElems;          // [2][tile]
  T* sQ = sV + 2 * Tl::kElems;          // [tile]
  T* sG = sQ + Tl::kElems;              // [tile]: dO
  float* sD = reinterpret_cast<float*>(sG + Tl::kElems);   // [64]: row terms

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kRows;
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
    Tl::template load<D>(sK + st * Tl::kElems, kb, j * kRows, T_len, a.ts, tid);
    Tl::template load<D>(sV + st * Tl::kElems, vb, j * kRows, T_len, a.ts, tid);
  };

  Tl::template load<D>(sQ, qb, m0, T_len, a.ts, tid);
  Tl::template load<D>(sG, gb, m0, T_len, a.o_ts, tid);
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
  typename Tl::Staged qf, gf;  // this warp's 16 rows of Q and dO
  qf.load(sQ, warp * 16, lane);
  gf.load(sG, warp * 16, lane);
  float lse2[2], Dr[2];   // rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = m0 + rl < T_len ? a.lse[bh * T_len + m0 + rl] * kLog2e : 0.f;
    Dr[r] = sD[rl];
  }

  float dq[DP / 8][4];
  float pdp[2] = {0.f, 0.f};   // this thread's share of rowsum(p * dp), rows g, g + 8
  zero(dq);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = ring_next(j, n_tiles, load_kv);
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
    Tl::mma_pb(dq, s, tK, lane);   // dQ += dS K
    __syncthreads();  // this stage is read out before the next copy into it
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.bs + h_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + (lane >> 2) + 8 * r;
    float d = pdp[r];   // the four lanes of a row
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (row < T_len) {
      if ((lane & 3) == 0) a.delta[bh * T_len + row] = d;
      T* out = dqb + (int64_t)row * a.ts + (lane & 3) * 2;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)   // the real columns; the pad's are zeros
        Tl::store2(out + nb * 8, dq[nb][2 * r] * a.scale, dq[nb][2 * r + 1] * a.scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int DP = kPad<D>;   // the tiles' width
  using Tl = Tile<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);   // [2][tile]
  T* sG = sQ + 2 * Tl::kElems;          // [2][tile]: dO
  T* sK = sG + 2 * Tl::kElems;          // [tile]
  T* sV = sK + Tl::kElems;              // [tile]
  float* sL = reinterpret_cast<float*>(sV + Tl::kElems);   // [2][64]: lse
  float* sDq = sL + 2 * kRows;                             // [2][64]: D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kRows;
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
    Tl::template load<D>(sQ + st * Tl::kElems, qb, i0, T_len, a.ts, tid);
    Tl::template load<D>(sG + st * Tl::kElems, gb, i0, T_len, a.o_ts, tid);
    const int c = tid & (kRows - 1), i = i0 + c;
    const float* src = tid < kRows ? a.lse : a.delta;
    float* dst = (tid < kRows ? sL : sDq) + st * kRows + c;
    cp_async4(smem_u32(dst), src + bh * T_len + (i < T_len ? i : 0), i < T_len);
  };

  Tl::template load<D>(sK, kb, k0, T_len, a.ts, tid);
  Tl::template load<D>(sV, vb, k0, T_len, a.ts, tid);
  load_queries(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  typename Tl::Staged kf, vf;  // this warp's 16 keys of K and V
  kf.load(sK, warp * 16, lane);
  vf.load(sV, warp * 16, lane);
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + warp * 16 + (lane >> 2) + 8 * r < T_len;

  float dk[DP / 8][4], dv[DP / 8][4];
  zero(dk);
  zero(dv);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = ring_next(j, n_tiles, load_queries);
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
    Tl::mma_pb(dv, s, tG, lane);   // dV += P^T dO
    float dp[8][4];  // dP^T, then dS^T
    zero(dp);
    Tl::template mma_abt<true>(dp, vf, tG, lane);   // dP^T = V dO^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nb][e] = s[nb][e] * (dp[nb][e] - Dq[acc_col(lane, nb, e)]);
    Tl::mma_pb(dk, dp, tQ, lane);  // dK += dS^T Q
    __syncthreads();  // this stage is read out before the next copy into it
  }

  const int64_t out0 = b * a.bs + h_off;
  T* dkb = static_cast<T*>(a.dk) + out0;
  T* dvb = static_cast<T*>(a.dv) + out0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const int64_t off = (int64_t)(k0 + warp * 16 + (lane >> 2) + 8 * r) * a.ts + (lane & 3) * 2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {   // the real columns
      Tl::store2(dkb + off + nb * 8, dk[nb][2 * r] * a.scale, dk[nb][2 * r + 1] * a.scale);
      Tl::store2(dvb + off + nb * 8, dv[nb][2 * r], dv[nb][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch

// Dynamic shared memory of each kernel, in bytes: the forward's tiles (Q
// and the K and V rings), the backward's (the two rings and two tiles of its
// own rows) and its row values.
template <typename T, int D>
constexpr int kFwdSmem = 5 * kTileBytes<T, kPad<D>>;
template <typename T, int D>
constexpr int kDqSmem = 6 * kTileBytes<T, kPad<D>> + kRows * 4;
template <typename T, int D>
constexpr int kDkvSmem = 6 * kTileBytes<T, kPad<D>> + 4 * kRows * 4;

constexpr int kHeadDim = 24;   // the one instantiation

bool bad_shape(int B, int H, int T_len, int D) {
  return D != kHeadDim || B <= 0 || H <= 0 || T_len <= 0 || H > 65535;
}

constexpr int kMaxGridZ = 65535;   // the grid's batch axis; a larger B launches in runs

template <typename T>
const void* shift(const void* p, int64_t n) { return static_cast<const T*>(p) + n; }
template <typename T>
void* shift(void* p, int64_t n) { return static_cast<T*>(p) + n; }

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

// The fp32 backward takes more than 48 KB of dynamic shared memory: every
// kernel opts in once per device and element type.
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
  for (int b0 = 0; b0 < f.B; b0 += kMaxGridZ) {
    const int nb = f.B - b0 < kMaxGridZ ? f.B - b0 : kMaxGridZ;
    const dim3 grid((f.T_len + kRows - 1) / kRows, f.H, nb);
    attention_fwd_kernel<T, D><<<grid, kThreads, kFwdSmem<T, D>, stream>>>(
        static_cast<const T*>(f.q) + b0 * f.q_bs, static_cast<const T*>(f.k) + b0 * f.kv_bs,
        static_cast<const T*>(f.v) + b0 * f.kv_bs, static_cast<T*>(f.o) + b0 * f.o_bs,
        f.lse == nullptr ? nullptr : f.lse + (int64_t)b0 * f.H * f.T_len, f.T_len, f.q_bs,
        f.q_ts, f.kv_bs, f.kv_ts, f.o_bs, f.o_ts, f.scale * kLog2e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int T_len, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts,
               int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  if (bad_shape(B, H, T_len, D) ||
      misaligned<T>({q, k, v, o}, {q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts}))
    return (int)cudaErrorInvalidValue;
  const FwdArgs f{q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale};
  return launch_fwd_d<T, kHeadDim>(f, (cudaStream_t)stream);
}

template <typename T, int D>
int launch_bwd_d(const BwdArgs& a, int B, int H, cudaStream_t stream) {
  cudaError_t err = set_attributes<T, D>();
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const int nb = B - b0 < kMaxGridZ ? B - b0 : kMaxGridZ;
    const int64_t x0 = b0 * a.bs, o0 = b0 * a.o_bs, r0 = (int64_t)b0 * H * a.T_len;
    const BwdArgs c{shift<T>(a.q, x0), shift<T>(a.k, x0), shift<T>(a.v, x0),
                    shift<T>(a.o, o0), shift<T>(a.dout, o0), a.lse + r0, shift<T>(a.dq, x0),
                    shift<T>(a.dk, x0), shift<T>(a.dv, x0), a.delta + r0, a.T_len, a.bs,
                    a.ts, a.o_bs, a.o_ts, a.scale};
    const dim3 grid((a.T_len + kRows - 1) / kRows, H, nb);
    attention_bwd_dq_kernel<T, D><<<grid, kThreads, kDqSmem<T, D>, stream>>>(c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attention_bwd_dkv_kernel<T, D><<<grid, kThreads, kDkvSmem<T, D>, stream>>>(c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
  return launch_bwd_d<T, kHeadDim>(a, B, H, (cudaStream_t)stream);
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
