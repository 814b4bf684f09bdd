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
// channels. Thread t always sees the same VEC = VB/sizeof(T) channels, one
// vector of VB bytes: 16, or 8 for bf16 rows whose channels are a multiple
// of 4 but not of 8 (84 = 12 x 7 in the 3D family), at half the bytes a
// load (blockDim is a multiple of C*N/VEC), so it sums x and x^2 for them in fp32
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
// The grid's example axis stops at 65,535 (the 3D family's time attention
// normalises B*256 token sequences, 256,000 at fast_fid's batch of 1000): a
// call with more examples launches once for each run of up to 65,535, on
// pointers moved to the run (gn_fused, gn_fused_bwd below).
//
// The forward also writes the (B, 2, G) mean and rstd when given a pointer
// for them, for gn_fused_bwd (below), the backward, which runs on a plan of
// its own.
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

// A thread's vector of channels: 16 bytes (8 bf16 or 4 fp32 values), or
// 8 bytes (4 bf16) where bf16's channels are a multiple of 4 but not of 8
// (the 3D family's 84 folded channels); VB is its size in bytes.
template <int VB> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <int VB> using Vec = typename VecOf<VB>::type;

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

template <typename T, int VB>
__device__ __forceinline__ void accumulate(const Vec<VB>& raw, float (&s1)[VB / sizeof(T)],
                                           float (&s2)[VB / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(VB / sizeof(T)); ++i) {
    const float v = to_f32(e[i]);
    s1[i] += v;
    s2[i] += v * v;
  }
}

template <typename T, int VB>
__device__ __forceinline__ Vec<VB> apply(Vec<VB> raw, const float (&A)[VB / sizeof(T)],
                                       const float (&Bc)[VB / sizeof(T)], int act) {
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(VB / sizeof(T)); ++i) {
    float v = fmaf(to_f32(e[i]), A[i], Bc[i]);
    if (act) v = v / (1.f + expf(-v));  // SiLU
    e[i] = from_f32<T>(v);
  }
  return raw;
}

template <typename T, int VB>
__global__ void __launch_bounds__(kMaxThreads, 2) gn_fused_kernel(const GnArgs a) {
  constexpr int VEC = VB / sizeof(T);
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
    Vec<VB> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rr + u * rstep;
      raw[u] = r < nrows ? *reinterpret_cast<const Vec<VB>*>(xb + (int64_t)r * CN + oct * VEC)
                         : Vec<VB>{};   // zeros add nothing
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate<T, VB>(raw[u], s1, s2);
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
    Vec<VB> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rr + u * rstep;
      if (r < nrows) raw[u] = *reinterpret_cast<const Vec<VB>*>(xb + (int64_t)r * CN + oct * VEC);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rr + u * rstep;
      if (r < nrows)
        *reinterpret_cast<Vec<VB>*>(yb + (int64_t)r * CN + oct * VEC) =
            apply<T, VB>(raw[u], A, Bc, a.act);
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
//   dgamma, dbeta = (1 + scale)*S2, (1 + scale)*S1 summed over b and the
//   frames_last copies n (gn_bwd_params_kernel, a small second launch);
//   per group, m1 = sum a*S1 / n, m2 = sum a*S2 / n;
//   dx = rstd*(a*dz - m1 - xh*m2).
//
// What bounds it on this card: bytes, a few FLOPs per byte. The sums S1, S2
// cross the whole of an example before dx can be written, so x and dy are
// read twice: five tensor passes of traffic against the three of the bound
// (x and dy read once, dx written once).
//
// Two routes; ops/groupnorm.py's bwd_plan picks one from what the call is
// (measured on an H100, PERF.md):
//   split, for calls whose x and dy pass 1.25 MiB (24 MiB with gamma):
//   two launches over a grid of (chunk, example) blocks, about four blocks
//   of 240-256 threads an SM in all, so every SM keeps 16-byte loads of x
//   and dy in flight (one cluster per example gives one block an SM in
//   lock-step: pass 1, barrier, pass 2; and at the main path's largest
//   shape x and dy, 50 MB in bf16, no longer fit the L2 for the second
//   read). gn_bwd_sums_kernel writes each chunk's per-channel S1, S2 and
//   its share of each group's m1, m2 to an fp32 scratch; gn_bwd_apply_kernel
//   sums its example's group shares in chunk order (m1, m2) and the
//   per-channel partials of a share of the channels (parameter gradients),
//   then streams its rows again for dx. Its grid walks the chunks in the
//   opposite order to the first launch, so the rows read last, the
//   likeliest still in L2, are read first; it is a dependent launch
//   (programmatic stream serialization), so its blocks compute their
//   coefficients while the first launch drains. silu' takes the fast exp2
//   and reciprocal there (__expf, __fdividef, a few ulp), and dx folds its
//   per-channel coefficients into two FMAs.
//   cluster, for the rest (the calls up to 1.25 MiB, set by launch latency,
//   on the forward's clusters of 8, and the affine forms up to 24 MiB, whose
//   dgamma, dbeta take a third launch on the split route, on clusters of
//   4): one launch, a thread-block cluster per example; each block sums
//   its rows' S1, S2 per channel in a fixed order, every block adds all
//   peers' sums over distributed shared memory in rank order, rank 0
//   writes the example's parameter sums, and every block streams its rows
//   again (from L2) for dx. __launch_bounds__(512, 1): the per-channel
//   coefficients of a
//   thread's VEC channels (mean, rstd, A, Bc and, in the second pass, a, m1,
//   m2) take registers that the forward's 64-register cap would spill.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits.

constexpr int kBwdUnroll = 4;       // split route: rows of x and of dy in flight a thread
constexpr int kClusterUnroll = 2;   // cluster route

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
  float* part_c;   // split: (B, chunks, 2, CN), S1 | S2 of each chunk
  float* part_g;   // split: (B, chunks, 2, G), each chunk's share of m1 | m2
  float* d_ss;     // (B, 2*CN): d_scale | d_shift
  float* part;     // (B, 2*CN): (1+scale)*S2 | (1+scale)*S1, summed into dgamma | dbeta
};

// Shared memory, in bytes, of every backward kernel:
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

// The same with the fast exp2 and reciprocal (a few ulp), as
// sig*(1 + u*(1 - sig)): the split route's
__device__ __forceinline__ float grad_pre_act_fast(float xv, float gv, float A, float Bc,
                                                   int act) {
  if (!act) return gv;
  const float u = fmaf(xv, A, Bc);
  const float sig = __fdividef(1.f, 1.f + __expf(-u));
  return gv * sig * fmaf(u, 1.f - sig, 1.f);
}

// a = gamma*(1 + scale) of channel c of example b
__device__ __forceinline__ float grad_scale(const GnBwdArgs& a, int b, int c) {
  float ac = a.gamma ? load_param(a.gamma, c / a.N, a.gb_bf16) : 1.f;
  if (a.scale) ac *= 1.f + load_param(a.scale, (int64_t)b * a.ss_stride + c, a.ss_bf16);
  return ac;
}

// From the example's S1, S2 of channel c: d_scale, d_shift and the
// per-example parameter sums.
__device__ __forceinline__ void channel_grads(const GnBwdArgs& a, int b, int c, float S1,
                                              float S2) {
  const int CN = a.CN;
  if (a.scale) {
    const float ga = a.gamma ? load_param(a.gamma, c / a.N, a.gb_bf16) : 1.f;
    const float be = a.gamma ? load_param(a.beta, c / a.N, a.gb_bf16) : 0.f;
    a.d_ss[(int64_t)b * 2 * CN + c] = ga * S2 + be * S1;
    a.d_ss[(int64_t)b * 2 * CN + CN + c] = S1;
  }
  if (a.gamma) {
    const float e = a.scale ? 1.f + load_param(a.scale, (int64_t)b * a.ss_stride + c,
                                               a.ss_bf16) : 1.f;
    a.part[(int64_t)b * 2 * CN + c] = e * S2;
    a.part[(int64_t)b * 2 * CN + CN + c] = e * S1;
  }
}

// The split route: the rows a block owns (chunk `run` of example b), and
// this thread's channels' statistics and the forward's fold A*x + Bc.
template <typename T, int VB>
struct BwdRows {
  static constexpr int VEC = VB / sizeof(T);
  int oct, r0, rstep, nrows;
  int64_t base;
  float rstd[VEC], nmr[VEC], A[VEC], Bc[VEC];   // nmr = -mean*rstd

  __device__ __forceinline__ BwdRows(const GnBwdArgs& a, int run, int b) {
    const int nv = a.CN / VEC;
    oct = threadIdx.x % nv;
    r0 = threadIdx.x / nv;
    rstep = blockDim.x / nv;
    const int row_lo = run * a.rows;
    nrows = max(0, min(a.S, row_lo + a.rows) - row_lo);
    base = ((int64_t)b * a.S + row_lo) * a.CN + oct * VEC;
    const int cpg = a.CN / a.G;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = oct * VEC + i;
      const float mean = a.stats[(int64_t)b * 2 * a.G + c / cpg];
      rstd[i] = a.stats[(int64_t)b * 2 * a.G + a.G + c / cpg];
      nmr[i] = -mean * rstd[i];
      float ai = rstd[i], bi = nmr[i];
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
  }

  // this block's S1, S2 per channel into chan[2][CN], in a fixed order
  // (through red[threads*VEC]); chan may be shared or global memory
  __device__ __forceinline__ void sums(const GnBwdArgs& a, float* red, float* chan) const {
    const T* xb = static_cast<const T*>(a.x) + base;
    const T* gb = static_cast<const T*>(a.dy) + base;
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
    for (int rr = r0; rr < nrows; rr += kBwdUnroll * rstep) {
      Vec<VB> rx[kBwdUnroll], rg[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int r = rr + u * rstep;
        const int64_t off = (int64_t)r * a.CN;
        rx[u] = r < nrows ? *reinterpret_cast<const Vec<VB>*>(xb + off) : Vec<VB>{};
        rg[u] = r < nrows ? *reinterpret_cast<const Vec<VB>*>(gb + off) : Vec<VB>{};
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const T* ex = reinterpret_cast<const T*>(&rx[u]);
        const T* eg = reinterpret_cast<const T*>(&rg[u]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {   // dy = 0 on padding rows: adds nothing
          const float xv = to_f32(ex[i]);
          const float dz = grad_pre_act_fast(xv, to_f32(eg[i]), A[i], Bc[i], a.act);
          s1[i] += dz;
          s2[i] += dz * fmaf(xv, rstd[i], nmr[i]);
        }
      }
    }
    const int tid = threadIdx.x, nv = a.CN / VEC;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[tid * VEC + i] = pass ? s2[i] : s1[i];
      __syncthreads();
      for (int c = tid; c < a.CN; c += blockDim.x) {
        const int o = c / VEC, i = c % VEC;
        float acc = 0.f;
        for (int j = 0; j < rstep; ++j) acc += red[(j * nv + o) * VEC + i];
        chan[pass * a.CN + c] = acc;
      }
      __syncthreads();
    }
  }

  // dx = rstd*(a*dz - m1 - xh*m2) over this block's rows, reading x and dy
  // again; gm[2][G] holds the example's m1, m2
  __device__ __forceinline__ void dx(const GnBwdArgs& a, int b, const float* gm) const {
    const int cpg = a.CN / a.G;
    float k1[VEC], k2[VEC], k0[VEC];   // dx = k1*dz + k2*xh + k0
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = oct * VEC + i;
      k1[i] = rstd[i] * grad_scale(a, b, c);
      k0[i] = -rstd[i] * gm[c / cpg];
      k2[i] = -rstd[i] * gm[a.G + c / cpg];
    }
    const T* xb = static_cast<const T*>(a.x) + base;
    const T* gb = static_cast<const T*>(a.dy) + base;
    T* dxb = static_cast<T*>(a.dx) + base;
    for (int rr = r0; rr < nrows; rr += kBwdUnroll * rstep) {
      Vec<VB> rx[kBwdUnroll], rg[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int r = rr + u * rstep;
        if (r < nrows) {
          rx[u] = *reinterpret_cast<const Vec<VB>*>(xb + (int64_t)r * a.CN);
          rg[u] = *reinterpret_cast<const Vec<VB>*>(gb + (int64_t)r * a.CN);
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int r = rr + u * rstep;
        if (r >= nrows) continue;
        const T* ex = reinterpret_cast<const T*>(&rx[u]);
        const T* eg = reinterpret_cast<const T*>(&rg[u]);
        Vec<VB> out;
        T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xv = to_f32(ex[i]);
          const float dz = grad_pre_act_fast(xv, to_f32(eg[i]), A[i], Bc[i], a.act);
          eo[i] = from_f32<T>(fmaf(k1[i], dz, fmaf(k2[i], fmaf(xv, rstd[i], nmr[i]), k0[i])));
        }
        *reinterpret_cast<Vec<VB>*>(dxb + (int64_t)r * a.CN) = out;
      }
    }
  }
};

// m1, m2 of each group from per-channel sums tot[2][CN] (the example's, or
// a chunk's share of them)
__device__ __forceinline__ void group_means(const GnBwdArgs& a, int b, const float* tot,
                                            float* gm) {
  const int cpg = a.CN / a.G;
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    float m1 = 0.f, m2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      const float ac = grad_scale(a, b, c);
      m1 += ac * tot[c];
      m2 += ac * tot[a.CN + c];
    }
    gm[g] = m1 / a.n_per_group;
    gm[a.G + g] = m2 / a.n_per_group;
  }
}

// out[i] = sum over k < chunks of src[k*stride + i], i < n, in a fixed
// order and with every thread taking part: thread t sums the chunks k = s,
// s + S, ... of value i = t % n (s = t / n, S = blockDim/n slices), then one
// thread a value adds the S slice sums in order. scratch holds max(n,
// blockDim) floats of shared memory.
__device__ __forceinline__ void sum_chunks(const float* src, int64_t stride, int n, int chunks,
                                           float* scratch, float* out) {
  const int S = max(1, (int)blockDim.x / n);
  for (int t = threadIdx.x; t < n * S; t += blockDim.x) {
    const int i = t % n;
    float acc = 0.f;
    for (int k = t / n; k < chunks; k += S) acc += src[k * stride + i];
    scratch[t] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float acc = 0.f;
    for (int sl = 0; sl < S; ++sl) acc += scratch[sl * n + i];
    out[i] = acc;
  }
  __syncthreads();
}

// The cluster route: one launch, grid (cluster, B).
template <typename T, int VB>
__global__ void __launch_bounds__(kMaxThreads, 1) gn_bwd_cluster_kernel(const GnBwdArgs a) {
  constexpr int VEC = VB / sizeof(T);
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
  for (int rr = r0; rr < nrows; rr += kClusterUnroll * rstep) {
    Vec<VB> rx[kClusterUnroll], rg[kClusterUnroll];
#pragma unroll
    for (int u = 0; u < kClusterUnroll; ++u) {
      const int r = rr + u * rstep;
      const int64_t off = (int64_t)r * CN + oct * VEC;
      rx[u] = r < nrows ? *reinterpret_cast<const Vec<VB>*>(xb + off) : Vec<VB>{};
      rg[u] = r < nrows ? *reinterpret_cast<const Vec<VB>*>(gb + off) : Vec<VB>{};
    }
#pragma unroll
    for (int u = 0; u < kClusterUnroll; ++u) {
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
  for (int rr = r0; rr < nrows; rr += kClusterUnroll * rstep) {
    Vec<VB> rx[kClusterUnroll], rg[kClusterUnroll];
#pragma unroll
    for (int u = 0; u < kClusterUnroll; ++u) {
      const int r = rr + u * rstep;
      const int64_t off = (int64_t)r * CN + oct * VEC;
      if (r < nrows) {
        rx[u] = *reinterpret_cast<const Vec<VB>*>(xb + off);
        rg[u] = *reinterpret_cast<const Vec<VB>*>(gb + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kClusterUnroll; ++u) {
      const int r = rr + u * rstep;
      if (r >= nrows) continue;
      const T* ex = reinterpret_cast<const T*>(&rx[u]);
      const T* eg = reinterpret_cast<const T*>(&rg[u]);
      Vec<VB> out;
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xv = to_f32(ex[i]);
        const float dz = grad_pre_act(xv, to_f32(eg[i]), A[i], Bc[i], a.act);
        const float xh = (xv - mean[i]) * rstd[i];
        eo[i] = from_f32<T>(rstd[i] * (ac[i] * dz - m1[i] - xh * m2[i]));
      }
      *reinterpret_cast<Vec<VB>*>(dxb + (int64_t)r * CN + oct * VEC) = out;
    }
  }
  cluster_wait();   // no block leaves while a peer may still read its sums
}

// The split route's first launch, grid (chunks, B).
template <typename T, int VB>
__global__ void __launch_bounds__(kMaxThreads, 1) gn_bwd_sums_kernel(const GnBwdArgs a) {
  constexpr int VEC = VB / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, chunks = gridDim.x;
  const int CN = a.CN, G = a.G;
  float* red = reinterpret_cast<float*>(smem);
  float* chan = red + blockDim.x * VEC;   // [2][CN]: this chunk's S1, S2
  const BwdRows<T, VB> w(a, chunk, b);
  w.sums(a, red, chan);
  float* pc = a.part_c + ((int64_t)b * chunks + chunk) * 2 * CN;
  for (int c = threadIdx.x; c < 2 * CN; c += blockDim.x) pc[c] = chan[c];
  // this chunk's share of m1, m2
  group_means(a, b, chan, a.part_g + ((int64_t)b * chunks + chunk) * 2 * G);
  __syncthreads();
  // this block's writes are issued: the dependent launch may start
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The split route's second launch, grid (chunks, B), walked in reverse.
template <typename T, int VB>
__global__ void __launch_bounds__(kMaxThreads, 1) gn_bwd_apply_kernel(const GnBwdArgs a) {
  constexpr int VEC = VB / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunks = gridDim.x;
  const int chunk = chunks - 1 - blockIdx.x, b = gridDim.y - 1 - blockIdx.y;
  const int CN = a.CN, G = a.G;
  float* red = reinterpret_cast<float*>(smem);   // scratch of the sums over chunks
  float* tot = red + blockDim.x * VEC + 2 * CN;  // [2][CN]: S1, S2 of this block's channels
  float* gm = tot + 2 * CN;                      // [2][G]: m1, m2
  const BwdRows<T, VB> w(a, chunk, b);

  // the first launch's sums are complete and visible after this
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // m1, m2 of the example's groups: its chunks' shares, summed in order
  sum_chunks(a.part_g + (int64_t)b * chunks * 2 * G, 2 * G, 2 * G, chunks, red, gm);
  // this block's share of the channels: the example's S1, S2, and their
  // parameter gradients
  if (a.scale || a.gamma) {
    const int per = (CN + chunks - 1) / chunks, c0 = chunk * per;
    const int n = max(0, min(CN, c0 + per) - c0);
    if (n > 0) {
      const float* pc = a.part_c + (int64_t)b * chunks * 2 * CN + c0;
      sum_chunks(pc, 2 * CN, n, chunks, red, tot);
      sum_chunks(pc + CN, 2 * CN, n, chunks, red, tot + CN);
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        channel_grads(a, b, c0 + i, tot[i], tot[CN + i]);
    }
  }
  w.dx(a, b, gm);
}

// dgamma[c] = sum_b sum_n part[b, c*N + n], dbeta likewise, in a fixed
// order: block c, thread t sums the examples t, t + kParamThreads, ... (each
// example's N frames in order), then the threads' sums meet in a fixed tree.
// One thread a channel walking all B examples took ~1 ms at the 3D family's
// B*256 = 4,096 examples of its time attention (PERF.md).
constexpr int kParamThreads = 256;

__global__ void __launch_bounds__(kParamThreads)
gn_bwd_params_kernel(const float* __restrict__ part, float* __restrict__ dgb, int B, int CN,
                     int C, int N) {
  __shared__ float sg[kParamThreads], sb[kParamThreads];
  const int c = blockIdx.x, t = threadIdx.x;
  float dg = 0.f, db = 0.f;
  for (int b = t; b < B; b += kParamThreads)
    for (int n = 0; n < N; ++n) {
      dg += part[(int64_t)b * 2 * CN + c * N + n];
      db += part[(int64_t)b * 2 * CN + CN + c * N + n];
    }
  sg[t] = dg;
  sb[t] = db;
  __syncthreads();
  for (int h = kParamThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      sg[t] += sg[t + h];
      sb[t] += sb[t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    dgb[c] = sg[0];
    dgb[C + c] = sb[0];
  }
}

constexpr int kMaxDevices = 64;

// The opt-in to kSmemLimit bytes of dynamic shared memory holds per device
// and per kernel: set once for each device a kernel launches on.
template <class K>
cudaError_t opt_in(K kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <typename T, int VB>
cudaError_t config(int B, int cluster, int threads, int smem, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  static bool done[kMaxDevices] = {};
  cudaError_t err = opt_in(gn_fused_kernel<T, VB>, done);
  if (err != cudaSuccess) return err;
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

template <typename T, int VB>
int launch(const GnArgs& a, int B, int cluster, int threads, int smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config<T, VB>(B, cluster, threads, smem, (cudaStream_t)stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, gn_fused_kernel<T, VB>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward: the cluster route's one launch, or the split route's sums
// and then the dependent apply.
template <typename T, int VB>
int launch_bwd(const GnBwdArgs& a, int B, int blocks, int threads, int smem, bool split,
               void* stream) {
  static bool done[3][kMaxDevices] = {};
  cudaError_t err;
  if (!split) {
    err = opt_in(gn_bwd_cluster_kernel<T, VB>, done[0]);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = config<T, VB>(B, blocks, threads, smem, (cudaStream_t)stream, &cfg, &attr);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, gn_bwd_cluster_kernel<T, VB>, a);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  err = opt_in(gn_bwd_sums_kernel<T, VB>, done[1]);
  if (err == cudaSuccess) err = opt_in(gn_bwd_apply_kernel<T, VB>, done[2]);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, gn_bwd_sums_kernel<T, VB>, a);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_bwd_apply_kernel<T, VB>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T, int VB>
int max_clusters(int B, int cluster, int threads, int smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config<T, VB>(B, cluster, threads, smem, 0, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, gn_fused_kernel<T, VB>, &cfg);
}

// The plans' checks, against the kernels' own layouts: `blocks` row runs of
// `rows` rows cover S with none empty (a cluster of at most 8, or any
// number of chunks in the backward's split route); `vec` channels a vector
// (8 bf16 or 4 fp32 in 16 bytes, or 4 bf16 in 8).
bool bad_plan(int bf16, int vec, int B, int S, int CN, int G, int N, int rows, int blocks,
              int threads, int smem, bool bwd, bool split) {
  if (vec != (bf16 ? 8 : 4) && !(bf16 && vec == 4)) return true;
  if (B <= 0 || S <= 0 || CN <= 0 || G <= 0 || N <= 0 || rows <= 0 ||
      blocks < 1 || (!split && blocks > kMaxCluster) || CN % vec || CN % G || CN % N)
    return true;
  const int nv = CN / vec;
  if (threads <= 0 || threads > kMaxThreads || threads % nv) return true;
  if ((int64_t)rows * blocks < S || (int64_t)rows * (blocks - 1) >= S) return true;
  const int64_t want = bwd ? bwd_smem_layout(threads, vec, CN, G)
                           : smem_layout(threads, vec, CN, G);
  return smem != want || smem > kSmemLimit;
}

// The grid's example axis (gridDim.y) stops at 65,535: a call with more
// examples launches once for each run of up to that many, on pointers
// moved to the run's first example.
constexpr int kMaxGridY = 65535;

const void* at(const void* p, int64_t bytes) {
  return p == nullptr ? nullptr : static_cast<const char*>(p) + bytes;
}
void* at(void* p, int64_t bytes) {
  return p == nullptr ? nullptr : static_cast<char*>(p) + bytes;
}

}  // namespace

extern "C" {

int gn_fused(const void* x, void* y, const void* gamma, const void* beta, const void* scale,
             const void* shift, float* stats, int64_t ss_stride, int gb_bf16, int ss_bf16,
             int bf16, int vec, int B, int S, int CN, int G, int N, int rows, int cluster,
             int threads, int smem, float eps, float n_per_group, int act, void* stream) {
  if (bad_plan(bf16, vec, B, S, CN, G, N, rows, cluster, threads, smem, false, false) ||
      (uintptr_t)x % 16 || (uintptr_t)y % 16 || (gamma == nullptr) != (beta == nullptr) ||
      (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t esz = bf16 ? 2 : 4, psz = ss_bf16 ? 2 : 4;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const int64_t xo = (int64_t)b0 * S * CN * esz, so = (int64_t)b0 * ss_stride * psz;
    const GnArgs a{at(x, xo), at(y, xo), gamma, beta, at(scale, so), at(shift, so),
                   stats == nullptr ? nullptr : stats + (int64_t)b0 * 2 * G, ss_stride, S,
                   CN, G, N, rows, eps, n_per_group, act, gb_bf16, ss_bf16};
    const int err = !bf16 ? launch<float, 16>(a, nb, cluster, threads, smem, stream)
                    : vec == 8 ? launch<__nv_bfloat16, 16>(a, nb, cluster, threads, smem, stream)
                               : launch<__nv_bfloat16, 8>(a, nb, cluster, threads, smem, stream);
    if (err != 0) return err;
  }
  return 0;
}

// ws: fp32 workspace of B*P*2*(CN + G) + 4*B*CN + 2*C floats, P = blocks on
// the split route and 0 on the cluster route: the per-chunk channel sums
// (B, P, 2, CN) and group sums (B, P, 2, G), [d_scale | d_shift] (B, 2CN),
// the per-example parameter sums (B, 2CN), then [dgamma | dbeta] (2C).
// `blocks` runs of `rows` rows per example: a cluster of at most 8, or the
// split route's chunks. With gamma, a last small launch sums dgamma, dbeta
// over all B examples.
int gn_fused_bwd(const void* x, const void* dy, void* dx, const float* stats,
                 const void* gamma, const void* beta, const void* scale, const void* shift,
                 int64_t ss_stride, int gb_bf16, int ss_bf16, int bf16, int vec, int B, int S,
                 int CN, int G, int N, int rows, int blocks, int threads, int smem, int split,
                 float n_per_group, int act, float* ws, int C, void* stream) {
  if (bad_plan(bf16, vec, B, S, CN, G, N, rows, blocks, threads, smem, true, split) ||
      (uintptr_t)x % 16 || (uintptr_t)dy % 16 || (uintptr_t)dx % 16 || stats == nullptr ||
      ws == nullptr || C * N != CN || (gamma == nullptr) != (beta == nullptr) ||
      (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t P = split ? blocks : 0;
  float* part_c = ws;
  float* part_g = part_c + (int64_t)B * P * 2 * CN;
  float* d_ss = part_g + (int64_t)B * P * 2 * G;
  float* part = d_ss + (int64_t)2 * B * CN;
  float* dgb = part + (int64_t)2 * B * CN;
  const int64_t esz = bf16 ? 2 : 4, psz = ss_bf16 ? 2 : 4;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const int64_t xo = (int64_t)b0 * S * CN * esz, so = (int64_t)b0 * ss_stride * psz;
    const GnBwdArgs a{at(x, xo), at(dy, xo), at(dx, xo), stats + (int64_t)b0 * 2 * G, gamma,
                      beta, at(scale, so), at(shift, so), ss_stride, S, CN, G, N, rows,
                      n_per_group, act, gb_bf16, ss_bf16, part_c + b0 * P * 2 * CN,
                      part_g + b0 * P * 2 * G, d_ss + (int64_t)b0 * 2 * CN,
                      part + (int64_t)b0 * 2 * CN};
    const int err =
        !bf16 ? launch_bwd<float, 16>(a, nb, blocks, threads, smem, split, stream)
        : vec == 8 ? launch_bwd<__nv_bfloat16, 16>(a, nb, blocks, threads, smem, split, stream)
                   : launch_bwd<__nv_bfloat16, 8>(a, nb, blocks, threads, smem, split, stream);
    if (err != 0) return err;
  }
  if (gamma == nullptr) return 0;
  gn_bwd_params_kernel<<<C, kParamThreads, 0, (cudaStream_t)stream>>>(part, dgb, B, CN, C, N);
  return (int)cudaGetLastError();
}

int gn_fused_max_active_clusters(int bf16, int vec, int B, int S, int CN, int G, int N,
                                 int rows, int cluster, int threads, int smem, int* out) {
  if (bad_plan(bf16, vec, B, S, CN, G, N, rows, cluster, threads, smem, false, false))
    return (int)cudaErrorInvalidValue;
  const int nb = B < kMaxGridY ? B : kMaxGridY;
  return !bf16 ? max_clusters<float, 16>(nb, cluster, threads, smem, out)
         : vec == 8 ? max_clusters<__nv_bfloat16, 16>(nb, cluster, threads, smem, out)
                    : max_clusters<__nv_bfloat16, 8>(nb, cluster, threads, smem, out);
}

}  // extern "C"
