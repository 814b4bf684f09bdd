// Softmax attention for NVIDIA Hopper (sm_90a), head dim 64: the forward
// attention_fwd and its VJP attention_bwd (see "backward" below).
//
// Replaces mcvd_tpu/ops/lab/attention.py: fused_attention (_kernel) and
// fused_attention_packed (_packed_kernel). Those Pallas kernels hold the whole
// (T, T) score block of one (batch, head) in VMEM; here a block owns 64 query
// rows of one (batch, head) and walks the keys in tiles with an online
// softmax (running max and sum), so no (T, T) block exists anywhere and T has
// no limit. Two bodies share that plan:
//
// bf16, on the tensor cores (attention_fwd_tc_kernel), the FlashAttention-2
// form. What bounds it: at T = 1024, D = 64 a (batch, head) is 4*T*T*D =
// 268 MFLOP against ~0.5 MB of q, k, v and o, far above the card's
// bytes-per-FLOP line, so it is bound by the tensor cores' rate and, at
// D = 64, by the exponentials of the softmax beside them. Four warps own 16
// query rows each. Q is staged once in shared memory and held in registers
// as ldmatrix fragments; K/V tiles of 64 keys come through a 2-stage ring of
// cp.async 16-byte copies, so the next tile's copy overlaps this tile's
// math. Tiles are [64][64] bf16 with each row's eight 16-byte chunks
// permuted by chunk ^ (row % 8), so ldmatrix's eight row reads hit eight
// distinct bank groups. S = Q K^T and O += P V run on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the scores' accumulator
// fragments are rounded to bf16 and reused as the A operand of P V, V comes
// in by ldmatrix.trans. The online softmax stays in registers, with
// scale*log2(e) folded into exp2f. A ragged last key tile is zero-filled
// and masked to -inf; a ragged last query tile is zero-filled and not
// stored. wgmma with TMA-fed tiles is the route to the card's full rate and
// later work.
//
// fp32, on the CUDA cores (attention_fwd_kernel), the parity route: plain
// fp32 FMAs, keys in tiles of 32, Q in shared memory for the whole block,
// each K/V tile staged once (K transposed, rows padded against bank
// conflicts) and read as float4 by the four threads that share a query row.
//
// Numerics. fp32: inputs, scores, softmax and the PV product are fp32; the
// output is rounded once. bf16: products of bf16 are exact in fp32, so S is
// the fp32 score up to summation order; the unnormalised p = exp2(s - m) is
// rounded to bf16 before P V, as the Pallas kernel rounds p to v's dtype
// (there after normalising); l sums the unrounded p in fp32; O is fp32,
// divided by l once at the end and rounded once to bf16. Against a version
// that keeps p in fp32 this moves each output by at most
// 2^-8 * sum_j p_j |v_j| / l (2^-8: bf16's unit roundoff) before the last
// rounding.
//
// Layout: q, k, v are read at ptr + b*bs + t*ts + h*D + d, o written at
// o + b*o_bs + t*o_ts + h*D + d. The packed (B, T, 3C) qkv of AttnBlock is
// q = qkv, k = qkv + C, v = qkv + 2C with ts = 3C; the (BH, T, D) layout is
// H = 1, ts = D. The bf16 route reads 16-byte chunks: pointers 16-byte
// aligned and strides multiples of 8 elements (the wrapper checks).
//
// With a non-null lse pointer the forward also writes each row's logsumexp
// (B, H, T) in fp32, natural log of the scaled scores, for attention_bwd
// (below), whose two launches recompute p from it.
//
// C interface (ctypes): each entry returns cudaGetLastError() after the
// launch; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBM = 64;       // query rows per block
constexpr int kBN = 32;       // keys per tile (fp32 route)
constexpr int kThreads = 256; // fp32 route: thread t: query row t/4, quarter t%4
constexpr int kTcBN = 64;     // keys per tile (bf16 route)
constexpr int kTcThreads = 128;  // bf16 route: 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The fp32 route's body is written for an element type T; it is
// instantiated for float only (bf16 takes the tensor-core kernel below).
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int T_len, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts,
                     int64_t o_bs, int64_t o_ts, float scale) {
  __shared__ __align__(16) float sQ[kBM][kD + 1];    // +1: rows in distinct banks
  __shared__ __align__(16) float sKt[kD][kBN + 4];   // K^T; +4 keeps float4 alignment
  __shared__ __align__(16) float sV[kBN][kD + 4];
  __shared__ __align__(16) float sP[kBM][kBN + 1];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int64_t h_off = (int64_t)blockIdx.y * kD;
  const int64_t b = blockIdx.z;
  const T* qb = q + b * q_bs + h_off;
  const T* kb = k + b * kv_bs + h_off;
  const T* vb = v + b * kv_bs + h_off;
  T* ob = o + b * o_bs + h_off;

  for (int idx = tid; idx < kBM * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    const int row = m0 + r;
    sQ[r][d] = row < T_len ? to_f32(qb[row * q_ts + d]) : 0.f;
  }

  const int r = tid >> 2;   // query row within the block
  const int qd = tid & 3;   // which quarter of the row this thread owns
  float m_i = -INFINITY;    // running max of this row's scores
  float l_i = 0.f;          // running sum of exp(score - m_i)
  float acc[16];            // output dims qd*16 .. qd*16+15
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;

  for (int n0 = 0; n0 < T_len; n0 += kBN) {
    __syncthreads();  // the previous tile's sKt/sV/sP reads are done
    for (int idx = tid; idx < kBN * kD; idx += kThreads) {
      const int c = idx / kD, d = idx % kD;
      const int key = n0 + c;
      float kv = 0.f, vv = 0.f;
      if (key < T_len) {
        kv = to_f32(kb[key * kv_ts + d]);
        vv = to_f32(vb[key * kv_ts + d]);
      }
      sKt[d][c] = kv;
      sV[c][d] = vv;
    }
    __syncthreads();

    // scores of keys n0 + qd*8 .. +7 for query row r
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) {
      const float qv = sQ[r][d];
      const float4 k0 = *reinterpret_cast<const float4*>(&sKt[d][qd * 8]);
      const float4 k1 = *reinterpret_cast<const float4*>(&sKt[d][qd * 8 + 4]);
      s[0] = fmaf(qv, k0.x, s[0]); s[1] = fmaf(qv, k0.y, s[1]);
      s[2] = fmaf(qv, k0.z, s[2]); s[3] = fmaf(qv, k0.w, s[3]);
      s[4] = fmaf(qv, k1.x, s[4]); s[5] = fmaf(qv, k1.y, s[5]);
      s[6] = fmaf(qv, k1.z, s[6]); s[7] = fmaf(qv, k1.w, s[7]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = (n0 + qd * 8 + j < T_len) ? s[j] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    // the four lanes of a row are adjacent in one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);  // finite: key n0 is always valid
    const float alpha = expf(m_i - m_new); // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = expf(s[j] - m_new);
      sP[r][qd * 8 + j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] *= alpha;
    __syncwarp();  // the row's p values, written by its four lanes, are visible

#pragma unroll 8
    for (int c = 0; c < kBN; ++c) {
      const float p = sP[r][c];
      const float4* vr = reinterpret_cast<const float4*>(&sV[c][qd * 16]);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float4 vv = vr[f];
        acc[4 * f + 0] = fmaf(p, vv.x, acc[4 * f + 0]);
        acc[4 * f + 1] = fmaf(p, vv.y, acc[4 * f + 1]);
        acc[4 * f + 2] = fmaf(p, vv.z, acc[4 * f + 2]);
        acc[4 * f + 3] = fmaf(p, vv.w, acc[4 * f + 3]);
      }
    }
  }

  const int row = m0 + r;
  if (row < T_len) {
    const float inv = 1.f / l_i;
    T* orow = ob + row * o_ts + qd * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) orow[e] = from_f32<T>(acc[e] * inv);
    if (lse != nullptr && qd == 0)
      lse[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * T_len + row] = m_i + logf(l_i);
  }
}

// ------------------------------------------------- bf16 on the tensor cores

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a [rows][64] bf16 tile whose 16-byte
// chunks are permuted within each row by chunk ^ (row % 8).
__device__ __forceinline__ int swz(int row, int col) {
  return row * kD + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// 16 bytes global -> shared; valid == false fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// rows [row0, row0 + 64) of a (token, 64) slice into a swizzled tile; 128
// threads, four 16-byte chunks each; rows >= T_len are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int T_len,
                                          int64_t ts, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * kTcThreads;
    const int row = idx >> 3, ch = idx & 7;
    const bool valid = row0 + row < T_len;
    const bf16* g = src + (valid ? (int64_t)(row0 + row) * ts + ch * 8 : 0);
    cp_async16(smem_u32(dst + swz(row, ch * 8)), g, valid);
  }
}

// Fragment layout of m16n8k16 (lane = 4*g + t): A holds rows g and g+8,
// columns 2t, 2t+1 (+8); B holds k = 2t, 2t+1 (+8), column g; the fp32
// accumulator holds rows g (c0, c1) and g+8 (c2, c3), columns 2t, 2t+1.
__global__ void __launch_bounds__(kTcThreads)
attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int T_len, int64_t q_bs, int64_t q_ts,
                        int64_t kv_bs, int64_t kv_ts, int64_t o_bs, int64_t o_ts,
                        float scale_log2) {
  __shared__ __align__(128) bf16 sQ[kBM * kD];
  __shared__ __align__(128) bf16 sK[2][kTcBN * kD];
  __shared__ __align__(128) bf16 sV[2][kTcBN * kD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBM;
  const int64_t h_off = (int64_t)blockIdx.y * kD;
  const int64_t b = blockIdx.z;
  const bf16* qb = q + b * q_bs + h_off;
  const bf16* kb = k + b * kv_bs + h_off;
  const bf16* vb = v + b * kv_bs + h_off;
  bf16* ob = o + b * o_bs + h_off;
  const int n_tiles = (T_len + kTcBN - 1) / kTcBN;

  load_tile(sQ, qb, m0, T_len, q_ts, tid);
  load_tile(sK[0], kb, 0, T_len, kv_ts, tid);
  load_tile(sV[0], vb, 0, T_len, kv_ts, tid);
  cp_async_commit();

  uint32_t qf[4][4];     // Q fragments: this warp's 16 rows, d in four slices of 16
  float acc[8][4];       // O: 16 rows x 64 d, as eight n8 blocks
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (scaled)
  float l_r[2] = {0.f, 0.f};              // this thread's share of the running sums
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      load_tile(sK[st ^ 1], kb, (j + 1) * kTcBN, T_len, kv_ts, tid);
      load_tile(sV[st ^ 1], vb, (j + 1) * kTcBN, T_len, kv_ts, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int row = warp * 16 + (lane & 15), col = kk * 16 + (lane >> 4) * 8;
        ldsm_x4(smem_u32(sQ + swz(row, col)), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
      }
    }
    const bf16* tK = sK[st];
    const bf16* tV = sV[st];

    // S = Q K^T: 16 rows x 64 keys, eight n8 blocks of keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int mi = lane >> 3;
        const int key = np * 16 + (lane & 7) + (mi >> 1) * 8;
        const int d = kk * 16 + (mi & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(tK + swz(key, d)), b0, b1, b2, b3);
        mma_bf16(s[2 * np], qf[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // online softmax over this tile, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const int n0 = j * kTcBN;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + nb * 8 + (lane & 3) * 2 + (e & 1);
        s[nb][e] = key < T_len ? s[nb][e] * scale_log2 : -INFINITY;
      }
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
      for (int nb = 0; nb < 8; ++nb) {
        acc[nb][2 * r] *= alpha;
        acc[nb][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P from the score fragments, 16 keys per k-slice
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        const int mi = lane >> 3;
        const int key = kk * 16 + (lane & 7) + (mi & 1) * 8;
        const int d = dp * 16 + (mi >> 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(tV + swz(key, d)), b0, b1, b2, b3);
        mma_bf16(acc[2 * dp], pa, b0, b1);
        mma_bf16(acc[2 * dp + 1], pa, b2, b3);
      }
    }
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
      bf16* orow = ob + (int64_t)row * o_ts + (lane & 3) * 2;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        *reinterpret_cast<uint32_t*>(orow + nb * 8) =
            pack_bf16(acc[nb][2 * r] * inv, acc[nb][2 * r + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)   // natural log: (m + log2 l) * ln 2
        lse[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * T_len + row] =
            (m_r[r] + log2f(l)) * kLn2;
    }
  }
}

// ----------------------------------------------------------------- backward
//
// attention_bwd: the VJP of the JAX package's _fa_bwd / _packed_bwd
// (mcvd_tpu/ops/lab/attention.py:78, :187; einsums there, no Pallas body),
// in the FlashAttention-2 form. The forward saved each row's logsumexp
// (lse, natural log of the scaled scores), so p = exp(s*scale - lse) is
// recomputed tile by tile and neither P, dP nor dS reaches device memory:
//   D_i = rowsum(dO_i * O_i)   (= rowsum(dp * p), the VJP's row term);
//   ds = p * (dp - D), dp = dO V^T;
//   dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO.
// Two launches, no atomics, so the result is deterministic:
//   attention_bwd_dq_kernel, query-major: a block owns 64 query rows of one
//   (batch, head), computes and stores their D, and walks the keys in tiles
//   of 32 accumulating dQ;
//   attention_bwd_dkv_kernel, key-major, after it: a block owns 64 keys and
//   walks the queries in tiles of 32 accumulating dK and dV.
// Both run on the CUDA cores in fp32 for fp32 and bf16 inputs (bf16 read and
// widened, the gradients rounded once), the forward fp32 route's thread
// layout: thread t owns row t/4 of the block and a quarter t%4 of the 64
// dims; a tile's scores are 8 per thread, made from row-major and
// transposed copies of the tiles in shared memory (rows padded against bank
// conflicts).
//
// What bounds it on this card: operations. S and dP are computed in both
// kernels, so it does 7 products of 2*T*T*64 FLOPs per (batch, head) where
// 5 would do, on the CUDA cores at fp32's 67 TFLOP/s; at small T the bytes
// of q, k, v, o, dO and d(qkv). The tensor-core form (mma.sync, as the bf16
// forward) is later work (ROADMAP).

constexpr int kBwdRows = 64;   // rows (queries or keys) a block owns
constexpr int kBwdTile = 32;   // keys (dq kernel) or queries (dkv kernel) per tile
constexpr int kBwdThreads = 256;
constexpr int kPadT = kBwdTile + 4;   // transposed tile row: float4-aligned
constexpr int kPadD = kD + 4;         // row-major tile row: float4-aligned
constexpr int kPadR = kD + 1;         // a block's own rows: bank-distinct

template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Shared memory of the two kernels, in floats.
constexpr int kDqSmem = 2 * kBwdRows * kPadR + 2 * kD * kPadT + kBwdTile * kPadD +
                        kBwdRows * (kBwdTile + 1);
constexpr int kDkvSmem = 2 * kBwdRows * kPadR + 2 * kD * kPadT + 2 * kBwdTile * kPadD +
                         2 * kBwdRows * (kBwdTile + 1) + 2 * kBwdTile;

// rows [row0, row0 + n) of a (token, 64) slice into fp32 shared memory,
// row-major with row pitch `pitch` and/or transposed ([d][row], pitch
// kPadT); rows >= T_len are zero.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t ts, int row0, int n,
                                      int T_len, float* rowmajor, int pitch, float* trans,
                                      int tid) {
  for (int idx = tid; idx < n * kD; idx += kBwdThreads) {
    const int r = idx / kD, d = idx % kD;
    const int row = row0 + r;
    const float v = row < T_len ? to_f32(src[(int64_t)row * ts + d]) : 0.f;
    if (rowmajor) rowmajor[r * pitch + d] = v;
    if (trans) trans[d * kPadT + r] = v;
  }
}

// acc[j] += sum_d a[d] * bt[d][j0 + j] for j < 8: a row of 64 against eight
// columns of a transposed tile.
__device__ __forceinline__ void dot8(const float* a, const float* bt, int j0, float (&acc)[8]) {
#pragma unroll 16
  for (int d = 0; d < kD; ++d) {
    const float av = a[d];
    const float4 b0 = *reinterpret_cast<const float4*>(bt + d * kPadT + j0);
    const float4 b1 = *reinterpret_cast<const float4*>(bt + d * kPadT + j0 + 4);
    acc[0] = fmaf(av, b0.x, acc[0]); acc[1] = fmaf(av, b0.y, acc[1]);
    acc[2] = fmaf(av, b0.z, acc[2]); acc[3] = fmaf(av, b0.w, acc[3]);
    acc[4] = fmaf(av, b1.x, acc[4]); acc[5] = fmaf(av, b1.y, acc[5]);
    acc[6] = fmaf(av, b1.z, acc[6]); acc[7] = fmaf(av, b1.w, acc[7]);
  }
}

// acc[e] += sum_c w[c] * m[c][d0 + e] for e < 16, c < kBwdTile.
__device__ __forceinline__ void axpy16(const float* w, const float* m, int d0, float (&acc)[16]) {
#pragma unroll 8
  for (int c = 0; c < kBwdTile; ++c) {
    const float wc = w[c];
    const float4* mr = reinterpret_cast<const float4*>(m + c * kPadD + d0);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float4 mv = mr[f];
      acc[4 * f + 0] = fmaf(wc, mv.x, acc[4 * f + 0]);
      acc[4 * f + 1] = fmaf(wc, mv.y, acc[4 * f + 1]);
      acc[4 * f + 2] = fmaf(wc, mv.z, acc[4 * f + 2]);
      acc[4 * f + 3] = fmaf(wc, mv.w, acc[4 * f + 3]);
    }
  }
}

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;
  void* dq; void* dk; void* dv;
  float* delta;            // (B, H, T) row sums D
  int T_len;
  int64_t bs, ts;          // q, k, v and dq, dk, dv: batch and token strides
  int64_t o_bs, o_ts;      // o and dO
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) attention_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;                          // [64][kPadR]
  float* sdO = sQ + kBwdRows * kPadR;      // [64][kPadR]
  float* sKt = sdO + kBwdRows * kPadR;     // [64 d][kPadT]
  float* sVt = sKt + kD * kPadT;           // [64 d][kPadT]
  float* sK = sVt + kD * kPadT;            // [32][kPadD]
  float* sS = sK + kBwdTile * kPadD;       // [64][33]: ds of the tile

  const int tid = threadIdx.x, r = tid >> 2, qd = tid & 3;
  const int m0 = blockIdx.x * kBwdRows;
  const int64_t h_off = (int64_t)blockIdx.y * kD;
  const int64_t b = blockIdx.z;
  const int64_t bh = b * gridDim.y + blockIdx.y;
  const T* qb = static_cast<const T*>(a.q) + b * a.bs + h_off;
  const T* kb = static_cast<const T*>(a.k) + b * a.bs + h_off;
  const T* vb = static_cast<const T*>(a.v) + b * a.bs + h_off;
  const T* ob = static_cast<const T*>(a.o) + b * a.o_bs + h_off;
  const T* gb = static_cast<const T*>(a.dout) + b * a.o_bs + h_off;
  const int T_len = a.T_len;
  const float sl2 = a.scale * kLog2e;

  stage(qb, a.ts, m0, kBwdRows, T_len, sQ, kPadR, static_cast<float*>(nullptr), tid);
  stage(gb, a.o_ts, m0, kBwdRows, T_len, sdO, kPadR, static_cast<float*>(nullptr), tid);
  __syncthreads();

  // D of this row: the four lanes of the row split its 64 dims
  const int row = m0 + r;
  const bool row_ok = row < T_len;
  float D = 0.f;
  if (row_ok) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      D = fmaf(sdO[r * kPadR + qd * 16 + e], to_f32(ob[(int64_t)row * a.o_ts + qd * 16 + e]), D);
  }
  D += __shfl_xor_sync(0xffffffffu, D, 1);
  D += __shfl_xor_sync(0xffffffffu, D, 2);
  if (row_ok && qd == 0) a.delta[bh * T_len + row] = D;
  const float lse2 = row_ok ? a.lse[bh * T_len + row] * kLog2e : 0.f;

  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  for (int n0 = 0; n0 < T_len; n0 += kBwdTile) {
    __syncthreads();   // the previous tile's reads are done
    stage(kb, a.ts, n0, kBwdTile, T_len, sK, kPadD, sKt, tid);
    stage(vb, a.ts, n0, kBwdTile, T_len, static_cast<float*>(nullptr), 0, sVt, tid);
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = dp[j] = 0.f;
    dot8(sQ + r * kPadR, sKt, qd * 8, s);
    dot8(sdO + r * kPadR, sVt, qd * 8, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = row_ok && n0 + qd * 8 + j < T_len;
      const float p = ok ? exp2f(s[j] * sl2 - lse2) : 0.f;
      sS[r * (kBwdTile + 1) + qd * 8 + j] = p * (dp[j] - D);
    }
    __syncwarp();   // the row's ds, written by its four lanes, are visible
    axpy16(sS + r * (kBwdTile + 1), sK, qd * 16, acc);
  }
  if (row_ok) {
    T* out = static_cast<T*>(a.dq) + b * a.bs + h_off + (int64_t)row * a.ts + qd * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = from_f32<T>(acc[e] * a.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) attention_bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* sK = sm;                          // [64 keys][kPadR]
  float* sV = sK + kBwdRows * kPadR;       // [64 keys][kPadR]
  float* sQt = sV + kBwdRows * kPadR;      // [64 d][kPadT]
  float* sdOt = sQt + kD * kPadT;          // [64 d][kPadT]
  float* sQ = sdOt + kD * kPadT;           // [32][kPadD]
  float* sdO = sQ + kBwdTile * kPadD;      // [32][kPadD]
  float* sP = sdO + kBwdTile * kPadD;      // [64 keys][33]: p of the tile
  float* sS = sP + kBwdRows * (kBwdTile + 1);   // [64 keys][33]: ds
  float* sL = sS + kBwdRows * (kBwdTile + 1);   // [32]: lse * log2(e)
  float* sD = sL + kBwdTile;                    // [32]: D

  const int tid = threadIdx.x, c = tid >> 2, qd = tid & 3;
  const int k0 = blockIdx.x * kBwdRows;
  const int64_t h_off = (int64_t)blockIdx.y * kD;
  const int64_t b = blockIdx.z;
  const int64_t bh = b * gridDim.y + blockIdx.y;
  const T* qb = static_cast<const T*>(a.q) + b * a.bs + h_off;
  const T* kb = static_cast<const T*>(a.k) + b * a.bs + h_off;
  const T* vb = static_cast<const T*>(a.v) + b * a.bs + h_off;
  const T* gb = static_cast<const T*>(a.dout) + b * a.o_bs + h_off;
  const int T_len = a.T_len;
  const float sl2 = a.scale * kLog2e;

  stage(kb, a.ts, k0, kBwdRows, T_len, sK, kPadR, static_cast<float*>(nullptr), tid);
  stage(vb, a.ts, k0, kBwdRows, T_len, sV, kPadR, static_cast<float*>(nullptr), tid);
  const int key = k0 + c;
  const bool key_ok = key < T_len;

  float dk[16], dv[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) dk[e] = dv[e] = 0.f;
  for (int i0 = 0; i0 < T_len; i0 += kBwdTile) {
    __syncthreads();   // the previous tile's reads are done
    stage(qb, a.ts, i0, kBwdTile, T_len, sQ, kPadD, sQt, tid);
    stage(gb, a.o_ts, i0, kBwdTile, T_len, sdO, kPadD, sdOt, tid);
    if (tid < kBwdTile) {
      const int i = i0 + tid;
      sL[tid] = i < T_len ? a.lse[bh * T_len + i] * kLog2e : 0.f;
      sD[tid] = i < T_len ? a.delta[bh * T_len + i] : 0.f;
    }
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = dp[j] = 0.f;
    dot8(sK + c * kPadR, sQt, qd * 8, s);     // s[j] = k_c . q_i
    dot8(sV + c * kPadR, sdOt, qd * 8, dp);   // dp[j] = v_c . dO_i
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ii = qd * 8 + j;
      const bool ok = key_ok && i0 + ii < T_len;
      const float p = ok ? exp2f(s[j] * sl2 - sL[ii]) : 0.f;
      sP[c * (kBwdTile + 1) + ii] = p;
      sS[c * (kBwdTile + 1) + ii] = p * (dp[j] - sD[ii]);
    }
    __syncwarp();   // the key's p and ds, written by its four lanes, are visible
    axpy16(sP + c * (kBwdTile + 1), sdO, qd * 16, dv);
    axpy16(sS + c * (kBwdTile + 1), sQ, qd * 16, dk);
  }
  if (key_ok) {
    const int64_t off = b * a.bs + h_off + (int64_t)key * a.ts + qd * 16;
    T* ok_ = static_cast<T*>(a.dk) + off;
    T* ov = static_cast<T*>(a.dv) + off;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      ok_[e] = from_f32<T>(dk[e] * a.scale);
      ov[e] = from_f32<T>(dv[e]);
    }
  }
}

bool bad_shape(int B, int H, int T_len, int D) {
  return D != kD || B <= 0 || H <= 0 || T_len <= 0 || B > 65535 || H > 65535;
}

int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int T_len, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs,
               int64_t kv_ts, int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  if (bad_shape(B, H, T_len, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T_len + kBM - 1) / kBM, H, B);
  attention_fwd_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, T_len, q_bs, q_ts, kv_bs,
      kv_ts, o_bs, o_ts, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int H, int T_len, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs,
                int64_t kv_ts, int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 == 0;
  if (bad_shape(B, H, T_len, D) || !aligned ||
      (q_bs | q_ts | kv_bs | kv_ts | o_bs | o_ts) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T_len + kBM - 1) / kBM, H, B);
  attention_fwd_tc_kernel<<<grid, kTcThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

constexpr int kMaxDevices = 64;

// Both backward kernels opt in to more than 48 KB of dynamic shared memory:
// once per device and element type.
template <typename T>
cudaError_t bwd_attributes() {
  static bool set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem * 4);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem * 4);
  if (err != cudaSuccess) return err;
  set[dev] = true;
  return cudaSuccess;
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int H,
               int T_len, int D, int64_t bs, int64_t ts, int64_t o_bs, int64_t o_ts,
               float scale, void* stream) {
  if (bad_shape(B, H, T_len, D) || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = bwd_attributes<T>();
  if (err != cudaSuccess) return (int)err;
  const BwdArgs a{q, k, v, o, dout, lse, dq, dk, dv, delta, T_len, bs, ts, o_bs, o_ts, scale};
  const dim3 grid((T_len + kBwdRows - 1) / kBwdRows, H, B);
  attention_bwd_dq_kernel<T><<<grid, kBwdThreads, kDqSmem * 4, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<T><<<grid, kBwdThreads, kDkvSmem * 4, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int attention_fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int H, int T, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs,
                      int64_t kv_ts, int64_t o_bs, int64_t o_ts, float scale,
                      void* stream) {
  return launch_f32(q, k, v, o, lse, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
                    scale, stream);
}

int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int T, int D, int64_t q_bs, int64_t q_ts,
                       int64_t kv_bs, int64_t kv_ts, int64_t o_bs, int64_t o_ts,
                       float scale, void* stream) {
  return launch_bf16(q, k, v, o, lse, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
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
