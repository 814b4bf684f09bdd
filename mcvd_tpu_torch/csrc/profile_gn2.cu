// The GroupNorm microbenchmark's two kernels for NVIDIA Hopper (sm_90a):
// gn_copy, a bandwidth probe, and gn_variant, a one-launch GroupNorm.
//
// Replace tools/profile_gn2.py: make_copy.fn (Pallas body copy_kernel) and
// gn_variant (its inner kernel). Both are bound by bytes: well under one
// FLOP per byte moved.
//
// gn_copy: y = bf16(float(x) * 1.0000001f) over a flat bf16 buffer, in a
// grid-stride loop of 16-byte loads and stores (8 values a thread a step).
// The product rounds back to x itself, as the JAX bf16 product does; the
// multiply only keeps the pass from being a memcpy. Its time at 2 x 8.4 MB
// moved is the card's measured copy ceiling at the microbenchmark's shape.
//
// gn_variant: one launch computes the group statistics, the combine (mean,
// rstd, gamma/beta, 1+scale/shift) and normalize+SiLU, with nothing on the
// host in between. The Pallas kernel holds one example in VMEM. Here one
// block owns one example (hsplit = 1) or one H-tile of it (hsplit > 1), a
// contiguous run of rows*CN values of the channels_last memory:
//   pass 1  reads the run once with 16-byte loads; thread t always sees the
//           same VEC channels (blockDim is a multiple of CN/VEC), so it sums
//           x and x^2 for them in registers (fp32); the per-thread sums go
//           to shared memory and reduce, in a fixed order, to channels and
//           then to groups (group = channel / (CN/G)): deterministic, no
//           atomics;
//   combine mean = s1/n, var = s2/n - mean^2, rstd = rsqrt(var + eps) per
//           group, in shared memory;
//   pass 2  reads the run again and stores
//           silu(((x - mean)*rstd*gamma + beta)*(1 + scale) + shift)
//           in x's dtype, in the JAX kernel's order of operations.
// A (64, 64, 64) bf16 example is 512 KB, past the 227 KB of shared memory a
// block can hold, so pass 2 reads it from L2 (16 examples, 8 MB, fit in the
// 50 MB L2), not from on-chip memory as the TPU kernel does. With one block
// per example only B blocks run: 16 of the 132 SMs at B = 16, hsplit = 1.
// A thread-block cluster per example, reducing over distributed shared
// memory, is the Hopper form of "the example on chip" and later work.
//
// hsplit > 1 reproduces the JAX variant's tile-local statistics (each H-tile
// normalised by its own mean and variance, n = n_per_group / hsplit): not
// GroupNorm, for timing only. stats_bf16 reproduces what the JAX program
// computes for `xf = x.astype(bf16)`, `jnp.sum(xf * xf)`: x rounded to bf16,
// squares and sums in fp32 (XLA keeps the bf16 product in fp32, as its
// excess-precision rule allows), each channel's sums rounded to bf16.
//
// C interface (ctypes): each entry returns cudaGetLastError() after the
// launch; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 1024;
constexpr int kThreadBudget = 512;   // threads a block, rounded down to CN/VEC
constexpr int kUnroll = 4;           // 16-byte loads in flight a thread

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
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------- gn_copy

constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kCopyThreads)
gn_copy_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
               int64_t n) {
  const int64_t n_vec = n / 8;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (int64_t i = i0; i < n_vec; i += stride) {
    uint4 raw = xv[i];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * 1.0000001f);
    yv[i] = raw;
  }
  for (int64_t i = n_vec * 8 + i0; i < n; i += stride)  // the ragged tail
    y[i] = __float2bfloat16(__bfloat162float(x[i]) * 1.0000001f);
}

// ------------------------------------------------------------- gn_variant

template <typename T>
__global__ void __launch_bounds__(kThreadBudget)
gn_variant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ y, int hsplit,
                  int rows, int CN, int G, float n_per_group, float eps,
                  int stats_bf16) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int nthreads = blockDim.x;
  float* part = smem;                        // [2][nthreads][VEC]
  float* chan = part + 2 * nthreads * VEC;   // [2][CN]
  float* grp = chan + 2 * CN;                // [2][G]: mean, rstd

  const int tid = threadIdx.x;
  const int nv = CN / VEC;         // 16-byte vectors a row
  const int oct = tid % nv;        // this thread's VEC channels: oct*VEC ..
  const int r0 = tid / nv;
  const int rstep = nthreads / nv;
  const int b = blockIdx.y;
  const int64_t base = ((int64_t)b * hsplit + blockIdx.x) * rows * CN + oct * VEC;
  const T* xb = x + base;
  T* yb = y + base;

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  for (int r = r0; r < rows; r += kUnroll * rstep) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * rstep;
      raw[u] = rr < rows ? *reinterpret_cast<const uint4*>(xb + (int64_t)rr * CN)
                         : make_uint4(0, 0, 0, 0);   // zeros add nothing
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = stats_bf16 ? round_bf16(to_f32(e[i])) : to_f32(e[i]);
        s1[i] += v;
        s2[i] += v * v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    part[tid * VEC + i] = s1[i];
    part[(nthreads + tid) * VEC + i] = s2[i];
  }
  __syncthreads();
  for (int c = tid; c < CN; c += nthreads) {
    const int o = c / VEC, i = c % VEC;
    float a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < rstep; ++j) {
      const int t = j * nv + o;
      a1 += part[t * VEC + i];
      a2 += part[(nthreads + t) * VEC + i];
    }
    if (stats_bf16) {
      a1 = round_bf16(a1);
      a2 = round_bf16(a2);
    }
    chan[c] = a1;
    chan[CN + c] = a2;
  }
  __syncthreads();
  const int cpg = CN / G;
  for (int g = tid; g < G; g += nthreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      a1 += chan[c];
      a2 += chan[CN + c];
    }
    const float mean = a1 / n_per_group;
    const float var = a2 / n_per_group - mean * mean;
    grp[g] = mean;
    grp[G + g] = rsqrtf(var + eps);
  }
  __syncthreads();

  float mu[VEC], rs[VEC], ga[VEC], be[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = oct * VEC + i;
    const int g = c / cpg;
    mu[i] = grp[g];
    rs[i] = grp[G + g];
    ga[i] = gamma[c];
    be[i] = beta[c];
    sc[i] = 1.f + scale[(int64_t)b * CN + c];
    sh[i] = shift[(int64_t)b * CN + c];
  }
  for (int r = r0; r < rows; r += kUnroll * rstep) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * rstep;
      if (rr < rows) raw[u] = *reinterpret_cast<const uint4*>(xb + (int64_t)rr * CN);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * rstep;
      if (rr >= rows) continue;
      T* e = reinterpret_cast<T*>(&raw[u]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float v = (to_f32(e[i]) - mu[i]) * rs[i];
        v = v * ga[i] + be[i];
        v = v * sc[i] + sh[i];
        v = v / (1.f + expf(-v));   // SiLU
        e[i] = from_f32<T>(v);
      }
      *reinterpret_cast<uint4*>(yb + (int64_t)rr * CN) = raw[u];
    }
  }
}

template <typename T>
int launch_variant(const void* x, const void* gamma, const void* beta, const void* scale,
                   const void* shift, void* y, int B, int hsplit, int rows, int CN, int G,
                   float n_per_group, float eps, int stats_bf16, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (B <= 0 || B > 65535 || hsplit <= 0 || hsplit > 65535 || rows <= 0 || G <= 0 ||
      CN <= 0 || CN > kMaxChannels || CN % VEC || CN % G)
    return (int)cudaErrorInvalidValue;
  const int nv = CN / VEC;
  const int threads = nv * (kThreadBudget / nv);   // a multiple of nv
  const size_t smem = (2 * (size_t)threads * VEC + 2 * CN + 2 * G) * sizeof(float);
  const dim3 grid(hsplit, B);
  gn_variant_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(y), hsplit, rows, CN, G,
      n_per_group, eps, stats_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gn_copy_bf16(const void* x, void* y, int64_t n, int n_blocks, void* stream) {
  if (n <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  gn_copy_kernel<<<n_blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n);
  return (int)cudaGetLastError();
}

int gn_variant_f32(const void* x, const void* gamma, const void* beta, const void* scale,
                   const void* shift, void* y, int B, int hsplit, int rows, int CN, int G,
                   float n_per_group, float eps, int stats_bf16, void* stream) {
  return launch_variant<float>(x, gamma, beta, scale, shift, y, B, hsplit, rows, CN, G,
                               n_per_group, eps, stats_bf16, stream);
}

int gn_variant_bf16(const void* x, const void* gamma, const void* beta, const void* scale,
                    const void* shift, void* y, int B, int hsplit, int rows, int CN, int G,
                    float n_per_group, float eps, int stats_bf16, void* stream) {
  return launch_variant<__nv_bfloat16>(x, gamma, beta, scale, shift, y, B, hsplit, rows,
                                       CN, G, n_per_group, eps, stats_bf16, stream);
}

}  // extern "C"
