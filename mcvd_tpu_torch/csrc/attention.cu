// Softmax attention forward for NVIDIA Hopper (sm_90a), head dim 64.
//
// Replaces mcvd_tpu/ops/lab/attention.py: fused_attention (_kernel) and
// fused_attention_packed (_packed_kernel). Those Pallas kernels hold the whole
// (T, T) score block of one (batch, head) in VMEM; here a block owns 64 query
// rows of one (batch, head) and walks the keys in tiles of 32 with an online
// softmax (running max and sum), so no (T, T) block exists anywhere and T has
// no limit.
//
// What bounds it on this card: at T = 1024, D = 64 a (batch, head) is
// 4*T*T*D = 268 MFLOP against ~0.8 MB of q, k, v and o, far above the
// bytes-per-FLOP line, so it is bound by arithmetic. This first version does
// the arithmetic as plain fp32 FMAs on CUDA cores (no tensor cores): Q sits
// in shared memory for the whole block, each K/V tile is staged once in
// shared memory (K transposed, rows padded against bank conflicts) and read
// as float4 by the four threads that share a query row. mma.sync or wgmma
// with TMA-fed tiles is later work.
//
// Numerics: inputs (fp32 or bf16) are widened to fp32 on load; scores,
// softmax and the PV product are fp32 (p is kept in fp32, where the Pallas
// kernel casts it to v's dtype); the output is rounded once to the input
// dtype.
//
// Layout: q, k, v are read at ptr + b*bs + t*ts + h*D + d, o written at
// o + b*o_bs + t*o_ts + h*D + d. The packed (B, T, 3C) qkv of AttnBlock is
// q = qkv, k = qkv + C, v = qkv + 2C with ts = 3C; the (BH, T, D) layout is
// H = 1, ts = D.
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
constexpr int kBN = 32;       // keys per tile
constexpr int kThreads = 256; // thread t: query row t/4, quarter t%4

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int T_len,
                     int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts,
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
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int T_len, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs,
           int64_t kv_ts, int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || T_len <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T_len + kBM - 1) / kBM, H, B);
  attention_fwd_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int attention_fwd_f32(const void* q, const void* k, const void* v, void* o, int B,
                      int H, int T, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs,
                      int64_t kv_ts, int64_t o_bs, int64_t o_ts, float scale,
                      void* stream) {
  return launch<float>(q, k, v, o, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
                       scale, stream);
}

int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int B,
                       int H, int T, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs,
                       int64_t kv_ts, int64_t o_bs, int64_t o_ts, float scale,
                       void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts, o_bs,
                               o_ts, scale, stream);
}

const char* mcvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
