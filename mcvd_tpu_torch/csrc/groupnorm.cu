// GroupNorm(+affine)(+AdaGN)(+SiLU) in one launch for NVIDIA Hopper (sm_90a):
// gn_fused, and its VJP gn_fused_bwd (see "backward" below).
//
// Replaces mcvd_tpu/ops/lab/groupnorm.py: fused_group_norm's single pass
// (_kernel) and _fused_group_norm_tiled's two passes (_stats_kernel,
// _norm_kernel). The Pallas kernel holds one example in VMEM; one example of
// the main path is up to 1.5 MB in bf16, past the 227 KB of shared memory of
// one block, so here a thread-block cluster of up to 8 blocks (the portable
// size) shares an example.
//
// Input x is (B, C*N, H, W) stored channels_last, that is (B, S = H*W, C*N)
// in memory. Grid (cluster, B): block `rank` of example b's cluster owns the
// contiguous run of rows [rank*rows, min(S, (rank+1)*rows)), each row C*N
// channels. Thread t always sees the same VEC = 16/sizeof(T) channels
// (blockDim is a multiple of C*N/VEC), so it sums x and x^2 for them in fp32
// registers; those sums reduce through shared memory in a fixed order to
// channels, then to this block's per-group partials, which it publishes in
// its shared memory. After a cluster barrier every block reads all peers'
// partials over distributed shared memory in rank order: no atomics, so the
// statistics are deterministic and the same in every block. Statistics are
// E[x^2] - mean^2 in fp32, as in the Pallas _kernel. Each thread folds mean,
// rstd, gamma/beta (gamma[c / N]) and 1+scale/shift into y = A*x + B for its
// channels, applies SiLU if asked, and stores in x's dtype with 16-byte
// stores.
//
// What bounds it on this card: bytes, well under one FLOP per byte. The
// block streams its rows twice from global memory with 16-byte loads,
// kUnroll in flight a thread: the statistics pass, then the apply pass,
// which finds the rows in the 50 MB L2 that the block has just filled. So
// one kernel stands for both Pallas paths, the single pass (x held in VMEM)
// and the tiled two passes. Holding the rows in shared memory instead (bulk
// copies, x read once) was measured slower at every main-path shape: a block
// of up to 215 KB lets one block use an SM, and the L2 already serves the
// second read (PERF.md). One launch per call and, at B = 16, 128 blocks,
// where one block per example left 116 of the 132 SMs idle.
// __launch_bounds__(512, 2) caps registers at 64 so that two blocks fit an
// SM, which keeps enough loads in flight.
//
// The forward also writes the (B, 2, G) mean and rstd when given a pointer
// for them, for gn_fused_bwd (below), the backward on the same plan.
//
// C interface (ctypes): gn_fused and gn_fused_bwd return cudaGetLastError()
// (or the launch's own error) and never synchronise or allocate;
// gn_fused_max_active_clusters reports how many clusters of a plan the card
// can hold at once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;          // 16-byte loads in flight a thread
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may opt in to

struct GnArgs {
  const void* x;
  void* y;
  const void* gamma;   // (C,) or null
  const void* beta;
  const void* scale;   // (B, C*N) rows ss_stride apart, or null
  const void* shift;
  float* stats;        // (B, 2, G) mean, rstd for the backward, or null
  int64_t ss_stride;
  int S, CN, G, N, rows;
  float eps, n_per_group;
  int act, gb_bf16, ss_bf16;
};

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
__device__ __forceinline__ float load_param(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared memory, in bytes:
// [red: threads*VEC][chan: 2*CN][gpart: 2*G][gstat: 2*G] (f32).
// The wrapper's plan() computes the same sum.
inline int64_t smem_layout(int threads, int vec, int CN, int G) {
  return 4 * ((int64_t)threads * vec + 2 * CN + 4 * G);
}

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw, float (&s1)[16 / sizeof(T)],
                                           float (&s2)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) {
    const float v = to_f32(e[i]);
    s1[i] += v;
    s2[i] += v * v;
  }
}

template <typename T>
__device__ __forceinline__ uint4 apply(uint4 raw, const float (&A)[16 / sizeof(T)],
                                       const float (&Bc)[16 / sizeof(T)], int act) {
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) {
    float v = fmaf(to_f32(e[i]), A[i], Bc[i]);
    if (act) v = v / (1.f + expf(-v));  // SiLU
    e[i] = from_f32<T>(v);
  }
  return raw;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2) gn_fused_kernel(const GnArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CN = a.CN, G = a.G;
  const int nv = CN / VEC;         // 16-byte vectors a row
  const int oct = tid % nv;        // this thread's channels: oct*VEC ..
  const int r0 = tid / nv;
  const int rstep = nthreads / nv;
  const int row_lo = rank * a.rows;
  const int nrows = max(0, min(a.S, row_lo + a.rows) - row_lo);
  const int64_t base = ((int64_t)b * a.S + row_lo) * CN;
  const T* xb = static_cast<const T*>(a.x) + base;
  T* yb = static_cast<T*>(a.y) + base;

  float* red = reinterpret_cast<float*>(smem);
  float* chan = red + nthreads * VEC;   // [2][CN]: sums of x, x^2 per channel
  float* gpart = chan + 2 * CN;         // [2][G]: this block's group sums
  float* gstat = gpart + 2 * G;         // [2][G]: mean, rstd

  // pass 1: per-thread sums of x and x^2 over its rows, for its VEC channels
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  for (int rr = r0; rr < nrows; rr += kUnroll * rstep) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rr + u * rstep;
      raw[u] = r < nrows ? *reinterpret_cast<const uint4*>(xb + (int64_t)r * CN + oct * VEC)
                         : make_uint4(0, 0, 0, 0);   // zeros add nothing
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate<T>(raw[u], s1, s2);
  }

  // per channel, then per group of this block, in a fixed order
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[tid * VEC + i] = pass ? s2[i] : s1[i];
    __syncthreads();
    for (int c = tid; c < CN; c += nthreads) {
      const int o = c / VEC, i = c % VEC;
      float acc = 0.f;
      for (int j = 0; j < rstep; ++j) acc += red[(j * nv + o) * VEC + i];
      chan[pass * CN + c] = acc;
    }
    __syncthreads();
  }
  const int cpg = CN / G;
  for (int g = tid; g < G; g += nthreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      a1 += chan[c];
      a2 += chan[CN + c];
    }
    gpart[g] = a1;
    gpart[G + g] = a2;
  }

  // the cluster's statistics: every block sums all partials in rank order
  cluster_arrive();
  cluster_wait();
  for (int g = tid; g < G; g += nthreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < n_ranks; ++r) {
      const float* peer = cluster.map_shared_rank(gpart, r);
      t1 += peer[g];
      t2 += peer[G + g];
    }
    const float mean = t1 / a.n_per_group;
    const float var = t2 / a.n_per_group - mean * mean;
    gstat[g] = mean;
    gstat[G + g] = rsqrtf(var + a.eps);
    if (a.stats != nullptr && rank == 0) {
      a.stats[(int64_t)b * 2 * G + g] = mean;
      a.stats[(int64_t)b * 2 * G + G + g] = gstat[G + g];
    }
  }
  cluster_arrive();   // this block is done reading its peers' partials
  __syncthreads();

  // y = A*x + B for this thread's channels: normalise, gamma/beta, AdaGN
  float A[VEC], Bc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = oct * VEC + i;
    const int g = c / cpg;
    const float mean = gstat[g], rstd = gstat[G + g];
    float ai = rstd, bi = -mean * rstd;
    if (a.gamma) {
      const float ga = load_param(a.gamma, c / a.N, a.gb_bf16);
      ai = ai * ga;
      bi = bi * ga + load_param(a.beta, c / a.N, a.gb_bf16);
    }
    if (a.scale) {
      const int64_t k = (int64_t)b * a.ss_stride + c;
      const float e = 1.f + load_param(a.scale, k, a.ss_bf16);
      ai = ai * e;
      bi = bi * e + load_param(a.shift, k, a.ss_bf16);
    }
    A[i] = ai;
    Bc[i] = bi;
  }

  // pass 2: read again (from L2), apply and store
  for (int rr = r0; rr < nrows; rr += kUnroll * rstep) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rr + u * rstep;
      if (r < nrows) raw[u] = *reinterpret_cast<const uint4*>(xb + (int64_t)r * CN + oct * VEC);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rr + u * rstep;
      if (r < nrows)
        *reinterpret_cast<uint4*>(yb + (int64_t)r * CN + oct * VEC) =
            apply<T>(raw[u], A, Bc, a.act);
    }
  }
  cluster_wait();   // no block leaves while a peer may still read its partials
}

// ------------------------------------------------------------ backward
//
// gn_fused_bwd: the VJP of y = act(A*x + Bc), the closed form of the JAX
// package's custom VJP _fgn_bwd (mcvd_tpu/ops/lab/groupnorm.py:160), which
// XLA compiles from jnp there (it has no Pallas body). Per (b, channel),
// with xh = (x - mean)*rstd from the forward's saved statistics, dz = dy *
// silu'(u) (dy without the activation) and a = gamma*(1 + scale):
//   S1 = sum_hw dz, S2 = sum_hw dz*xh;
//   d_shift = S1, d_scale = gamma*S2 + beta*S1;
//   per example, (1 + scale)*S2 and (1 + scale)*S1, summed over b and the
//   frames_last copies n by a second small launch into dgamma, dbeta;
//   per group, m1 = sum a*S1 / n, m2 = sum a*S2 / n;
//   dx = rstd*(a*dz - m1 - xh*m2).
// That is the forward's structure, a per-channel reduction over H*W that
// crosses blocks and then a streaming pass, so it runs on the forward's plan:
// the cluster of example b splits its rows; each block sums dz and dz*xh for
// its rows per channel, in a fixed order; after a cluster barrier every
// block adds all peers' per-channel sums over distributed shared memory in
// rank order (no atomics: deterministic, the same in every block); block 0
// writes the per-example parameter sums; then every block re-reads its x
// and dy (from L2) and writes dx.
//
// What bounds it on this card: bytes, reading x and dy twice (the second
// time mostly from L2) and writing dx, a few FLOPs per byte.
// __launch_bounds__(512, 1): the per-channel coefficients of a thread's
// VEC channels (mean, rstd, A, Bc and, in the second pass, a, m1, m2) take
// registers that the forward's 64-register cap would spill; kBwdUnroll = 2
// keeps two 16-byte loads of x and two of dy in flight a thread.

constexpr int kBwdUnroll = 2;

struct GnBwdArgs {
  const void* x;
  const void* dy;
  void* dx;
  const float* stats;  // (B, 2, G) mean, rstd from the forward
  const void* gamma;   // (C,) or null
  const void* beta;
  const void* scale;   // (B, C*N) rows ss_stride apart, or null
  const void* shift;
  int64_t ss_stride;
  int S, CN, G, N, rows;
  float n_per_group;
  int act, gb_bf16, ss_bf16;
  float* d_ss;   // (B, 2*CN): d_scale | d_shift
  float* part;   // (B, 2*CN): (1+scale)*S2 | (1+scale)*S1, summed into dgamma | dbeta
};

// Shared memory, in bytes:
// [red: threads*VEC][chan: 2*CN][tot: 2*CN][gm: 2*G] (f32).
inline int64_t bwd_smem_layout(int threads, int vec, int CN, int G) {
  return 4 * ((int64_t)threads * vec + 4 * CN + 2 * G);
}

// dz of one element: dy, times silu'(u) at u = A*x + Bc with the activation
__device__ __forceinline__ float grad_pre_act(float xv, float gv, float A, float Bc, int act) {
  if (!act) return gv;
  const float u = fmaf(xv, A, Bc);
  const float sig = 1.f / (1.f + expf(-u));
  return gv * (sig + u * sig * (1.f - sig));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) gn_fused_bwd_kernel(const GnBwdArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CN = a.CN, G = a.G;
  const int cpg = CN / G;
  const int nv = CN / VEC;
  const int oct = tid % nv;
  const int r0 = tid / nv;
  const int rstep = nthreads / nv;
  const int row_lo = rank * a.rows;
  const int nrows = max(0, min(a.S, row_lo + a.rows) - row_lo);
  const int64_t base = ((int64_t)b * a.S + row_lo) * CN;
  const T* xb = static_cast<const T*>(a.x) + base;
  const T* gb = static_cast<const T*>(a.dy) + base;
  T* dxb = static_cast<T*>(a.dx) + base;

  float* red = reinterpret_cast<float*>(smem);
  float* chan = red + nthreads * VEC;   // [2][CN]: this block's S1, S2 per channel
  float* tot = chan + 2 * CN;           // [2][CN]: the example's S1, S2
  float* gm = tot + 2 * CN;             // [2][G]: m1, m2

  // this thread's channels: statistics and the forward's fold A*x + Bc
  float mean[VEC], rstd[VEC], A[VEC], Bc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = oct * VEC + i;
    const int g = c / cpg;
    mean[i] = a.stats[(int64_t)b * 2 * G + g];
    rstd[i] = a.stats[(int64_t)b * 2 * G + G + g];
    float ai = rstd[i], bi = -mean[i] * rstd[i];
    if (a.gamma) {
      const float ga = load_param(a.gamma, c / a.N, a.gb_bf16);
      ai = ai * ga;
      bi = bi * ga + load_param(a.beta, c / a.N, a.gb_bf16);
    }
    if (a.scale) {
      const int64_t k = (int64_t)b * a.ss_stride + c;
      const float e = 1.f + load_param(a.scale, k, a.ss_bf16);
      ai = ai * e;
      bi = bi * e + load_param(a.shift, k, a.ss_bf16);
    }
    A[i] = ai;
    Bc[i] = bi;
  }

  // pass 1: per-thread sums of dz and dz*xh over its rows
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  for (int rr = r0; rr < nrows; rr += kBwdUnroll * rstep) {
    uint4 rx[kBwdUnroll], rg[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int r = rr + u * rstep;
      const int64_t off = (int64_t)r * CN + oct * VEC;
      rx[u] = r < nrows ? *reinterpret_cast<const uint4*>(xb + off) : make_uint4(0, 0, 0, 0);
      rg[u] = r < nrows ? *reinterpret_cast<const uint4*>(gb + off) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const T* ex = reinterpret_cast<const T*>(&rx[u]);
      const T* eg = reinterpret_cast<const T*>(&rg[u]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {   // dy = 0 on padding rows: adds nothing
        const float xv = to_f32(ex[i]);
        const float dz = grad_pre_act(xv, to_f32(eg[i]), A[i], Bc[i], a.act);
        s1[i] += dz;
        s2[i] += dz * ((xv - mean[i]) * rstd[i]);
      }
    }
  }

  // per channel of this block, in a fixed order, published for the peers
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[tid * VEC + i] = pass ? s2[i] : s1[i];
    __syncthreads();
    for (int c = tid; c < CN; c += nthreads) {
      const int o = c / VEC, i = c % VEC;
      float acc = 0.f;
      for (int j = 0; j < rstep; ++j) acc += red[(j * nv + o) * VEC + i];
      chan[pass * CN + c] = acc;
    }
    __syncthreads();
  }

  // the example's sums: every block adds all peers' in rank order
  cluster_arrive();
  cluster_wait();
  for (int c = tid; c < 2 * CN; c += nthreads) {
    float t = 0.f;
    for (int r = 0; r < n_ranks; ++r) t += cluster.map_shared_rank(chan, r)[c];
    tot[c] = t;
  }
  cluster_arrive();   // this block is done reading its peers' sums
  __syncthreads();

  // per group m1, m2 over a = gamma*(1 + scale); block 0 writes the
  // example's parameter sums
  for (int g = tid; g < G; g += nthreads) {
    float m1 = 0.f, m2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      float ac = a.gamma ? load_param(a.gamma, c / a.N, a.gb_bf16) : 1.f;
      if (a.scale) ac *= 1.f + load_param(a.scale, (int64_t)b * a.ss_stride + c, a.ss_bf16);
      m1 += ac * tot[c];
      m2 += ac * tot[CN + c];
    }
    gm[g] = m1 / a.n_per_group;
    gm[G + g] = m2 / a.n_per_group;
  }
  if (rank == 0) {
    for (int c = tid; c < CN; c += nthreads) {
      const float S1 = tot[c], S2 = tot[CN + c];
      const float e = a.scale ? 1.f + load_param(a.scale, (int64_t)b * a.ss_stride + c,
                                                 a.ss_bf16) : 1.f;
      if (a.scale) {
        const float ga = a.gamma ? load_param(a.gamma, c / a.N, a.gb_bf16) : 1.f;
        const float be = a.gamma ? load_param(a.beta, c / a.N, a.gb_bf16) : 0.f;
        a.d_ss[(int64_t)b * 2 * CN + c] = ga * S2 + be * S1;
        a.d_ss[(int64_t)b * 2 * CN + CN + c] = S1;
      }
      if (a.gamma) {
        a.part[(int64_t)b * 2 * CN + c] = e * S2;
        a.part[(int64_t)b * 2 * CN + CN + c] = e * S1;
      }
    }
  }
  __syncthreads();

  // pass 2: dx = rstd*(a*dz - m1 - xh*m2), re-reading x and dy (from L2)
  float ac[VEC], m1[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = oct * VEC + i;
    const int g = c / cpg;
    ac[i] = a.gamma ? load_param(a.gamma, c / a.N, a.gb_bf16) : 1.f;
    if (a.scale) ac[i] *= 1.f + load_param(a.scale, (int64_t)b * a.ss_stride + c, a.ss_bf16);
    m1[i] = gm[g];
    m2[i] = gm[G + g];
  }
  for (int rr = r0; rr < nrows; rr += kBwdUnroll * rstep) {
    uint4 rx[kBwdUnroll], rg[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int r = rr + u * rstep;
      const int64_t off = (int64_t)r * CN + oct * VEC;
      if (r < nrows) {
        rx[u] = *reinterpret_cast<const uint4*>(xb + off);
        rg[u] = *reinterpret_cast<const uint4*>(gb + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int r = rr + u * rstep;
      if (r >= nrows) continue;
      const T* ex = reinterpret_cast<const T*>(&rx[u]);
      const T* eg = reinterpret_cast<const T*>(&rg[u]);
      uint4 out;
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xv = to_f32(ex[i]);
        const float dz = grad_pre_act(xv, to_f32(eg[i]), A[i], Bc[i], a.act);
        const float xh = (xv - mean[i]) * rstd[i];
        eo[i] = from_f32<T>(rstd[i] * (ac[i] * dz - m1[i] - xh * m2[i]));
      }
      *reinterpret_cast<uint4*>(dxb + (int64_t)r * CN + oct * VEC) = out;
    }
  }
  cluster_wait();   // no block leaves while a peer may still read its sums
}

// dgamma[c] = sum_b sum_n part[b, c*N + n], dbeta likewise, in a fixed order.
__global__ void gn_bwd_params_kernel(const float* __restrict__ part, float* __restrict__ dgb,
                                     int B, int CN, int C, int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float dg = 0.f, db = 0.f;
  for (int b = 0; b < B; ++b)
    for (int n = 0; n < N; ++n) {
      dg += part[(int64_t)b * 2 * CN + c * N + n];
      db += part[(int64_t)b * 2 * CN + CN + c * N + n];
    }
  dgb[c] = dg;
  dgb[C + c] = db;
}

constexpr int kMaxDevices = 64;

// The opt-in to kSmemLimit bytes of dynamic shared memory holds per device
// and per kernel: set once for each (device, dtype, direction) this process
// launches on.
template <typename T, bool kBwd>
cudaError_t config(int B, int cluster, int threads, int smem, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  static bool attrs_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attrs_set[dev]) {
    err = kBwd ? cudaFuncSetAttribute(gn_fused_bwd_kernel<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit)
               : cudaFuncSetAttribute(gn_fused_kernel<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    attrs_set[dev] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, B);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch(const GnArgs& a, int B, int cluster, int threads, int smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config<T, false>(B, cluster, threads, smem, (cudaStream_t)stream, &cfg,
                                     &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, gn_fused_kernel<T>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const GnBwdArgs& a, int B, int cluster, int threads, int smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config<T, true>(B, cluster, threads, smem, (cudaStream_t)stream, &cfg,
                                    &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, gn_fused_bwd_kernel<T>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int max_clusters(int B, int cluster, int threads, int smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config<T, false>(B, cluster, threads, smem, 0, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, gn_fused_kernel<T>, &cfg);
}

// The plan's checks, against the kernel's own layout (`want_smem` is the
// direction's shared-memory layout).
bool bad_plan(int bf16, int B, int S, int CN, int G, int N, int rows, int cluster,
              int threads, int smem, bool bwd) {
  const int vec = bf16 ? 8 : 4;
  if (B <= 0 || B > 65535 || S <= 0 || CN <= 0 || G <= 0 || N <= 0 || rows <= 0 ||
      cluster < 1 || cluster > kMaxCluster || CN % vec || CN % G || CN % N)
    return true;
  const int nv = CN / vec;
  if (threads <= 0 || threads > kMaxThreads || threads % nv) return true;
  if ((int64_t)rows * cluster < S || (int64_t)rows * (cluster - 1) >= S) return true;
  const int64_t want = bwd ? bwd_smem_layout(threads, vec, CN, G)
                           : smem_layout(threads, vec, CN, G);
  return smem != want || smem > kSmemLimit;
}

}  // namespace

extern "C" {

int gn_fused(const void* x, void* y, const void* gamma, const void* beta, const void* scale,
             const void* shift, float* stats, int64_t ss_stride, int gb_bf16, int ss_bf16,
             int bf16, int B, int S, int CN, int G, int N, int rows, int cluster, int threads,
             int smem, float eps, float n_per_group, int act, void* stream) {
  if (bad_plan(bf16, B, S, CN, G, N, rows, cluster, threads, smem, false) ||
      (uintptr_t)x % 16 || (uintptr_t)y % 16 || (gamma == nullptr) != (beta == nullptr) ||
      (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const GnArgs a{x, y, gamma, beta, scale, shift, stats, ss_stride, S, CN, G, N, rows,
                 eps, n_per_group, act, gb_bf16, ss_bf16};
  return bf16 ? launch<__nv_bfloat16>(a, B, cluster, threads, smem, stream)
              : launch<float>(a, B, cluster, threads, smem, stream);
}

// ws: fp32 workspace of 4*B*CN + 2*C floats: [d_scale | d_shift] (B, 2CN),
// the per-example parameter sums (B, 2CN), then [dgamma | dbeta] (2C).
// Launches the cluster kernel, then (with gamma) the parameter reduction.
int gn_fused_bwd(const void* x, const void* dy, void* dx, const float* stats,
                 const void* gamma, const void* beta, const void* scale, const void* shift,
                 int64_t ss_stride, int gb_bf16, int ss_bf16, int bf16, int B, int S, int CN,
                 int G, int N, int rows, int cluster, int threads, int smem,
                 float n_per_group, int act, float* ws, int C, void* stream) {
  if (bad_plan(bf16, B, S, CN, G, N, rows, cluster, threads, smem, true) ||
      (uintptr_t)x % 16 || (uintptr_t)dy % 16 || (uintptr_t)dx % 16 || stats == nullptr ||
      ws == nullptr || C * N != CN || (gamma == nullptr) != (beta == nullptr) ||
      (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  float* d_ss = ws;
  float* part = ws + (int64_t)2 * B * CN;
  const GnBwdArgs a{x, dy, dx, stats, gamma, beta, scale, shift, ss_stride, S, CN, G, N,
                    rows, n_per_group, act, gb_bf16, ss_bf16, d_ss, part};
  int err = bf16 ? launch_bwd<__nv_bfloat16>(a, B, cluster, threads, smem, stream)
                 : launch_bwd<float>(a, B, cluster, threads, smem, stream);
  if (err != 0 || gamma == nullptr) return err;
  gn_bwd_params_kernel<<<(C + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, ws + (int64_t)4 * B * CN, B, CN, C, N);
  return (int)cudaGetLastError();
}

int gn_fused_max_active_clusters(int bf16, int B, int S, int CN, int G, int N, int rows,
                                 int cluster, int threads, int smem, int* out) {
  if (bad_plan(bf16, B, S, CN, G, N, rows, cluster, threads, smem, false))
    return (int)cudaErrorInvalidValue;
  return bf16 ? max_clusters<__nv_bfloat16>(B, cluster, threads, smem, out)
              : max_clusters<float>(B, cluster, threads, smem, out);
}

}  // extern "C"
