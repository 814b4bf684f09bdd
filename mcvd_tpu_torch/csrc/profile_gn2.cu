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
// host in between. The Pallas kernel holds one example in VMEM; here a
// thread-block cluster holds it in the shared memory of its blocks. A
// statistics domain is one example (hsplit = 1) or one H-tile of it
// (hsplit > 1): a contiguous run of rows*CN values of the channels_last
// memory. The grid is (cluster*hsplit, B), one cluster a domain: up to 8
// blocks (the portable size), or up to 16 where the card's occupancy query
// (below) holds them; block `rank` owns the rows [rank*rpb, min(rows,
// (rank+1)*rpb)). tools/profile_gn2.py's variant_plan picks the route, the
// cluster (the largest that keeps B*hsplit*cluster blocks within the 132
// SMs and every cluster on the card at once), the rows a block and the
// chunks; this file checks the plan.
//   load    one thread issues 1-D TMA bulk copies (cp.async.bulk, global to
//           shared), each completing on its own mbarrier. Resident route
//           (the domain fits its cluster): the block's rows in one copy,
//           held; several smaller copies, so that the sums start as the
//           first lands, finished later on the H100. Streamed route: chunks
//           of chunk_rows rows through a ring of `stages` slots, every
//           chunk twice;
//   pass 1  thread t sums x and x^2 (fp32) for its same VEC channels
//           (blockDim is a multiple of CN/VEC) from shared memory; the
//           per-thread sums go to shared memory as rows, and thread ch adds
//           column ch over the rows in order;
//   combine each block pushes its channel sums into every peer's shared
//           memory (remote stores over distributed shared memory, no round
//           trip), then one cluster barrier, after which every block adds
//           them in rank order from its own shared memory (with stats_bf16
//           it rounds each channel's complete sums to bf16 here) and sums
//           channels into groups: mean = s1/n, var = s2/n - mean^2, rstd =
//           rsqrt(var + eps). No atomics: the statistics are deterministic
//           and the same in every block, and no block reads a peer's memory
//           after the barrier, so none waits for its peers to leave;
//   pass 2  reads the rows again from shared memory (resident) or through
//           the ring, from L2 (streamed), and stores
//           silu(((x - mean)*rstd*gamma + beta)*(1 + scale) + shift)
//           in x's dtype with 16-byte stores, in the JAX kernel's order of
//           operations; SiLU takes the fast exp2 and reciprocal (__expf,
//           __fdividef: a few ulp).
// y leaves by 16-byte stores from registers, not by bulk stores from shared
// memory: a store does not hold its thread until memory answers, so the
// threads keep the write stream full, and a bulk store would need a proxy
// fence and a block barrier for the same bytes. The launch is a dependent
// one (programmatic stream serialization): the grid may start while the
// previous kernel on the stream finishes, and griddepcontrol.wait holds
// every access to memory until it has.
//
// What bounds it: bytes, and the phases in series. On the resident route x
// is read from HBM once and y written once, the bound's traffic; the load,
// the statistics (block sums, the cluster barrier, the groups) and pass 2
// follow one another in every block, and pass 2 is held by SiLU's two MUFU
// operations an element as much as by the stores. At the microbenchmark's
// (16, 64, 64, 64) the H100 80GB HBM3 holds 15 clusters of 8 (or 7) blocks
// of 512 threads at once, so the plan takes clusters of 6: 96 blocks of
// 87 KB in bf16, one wave (PERF.md). Past what a cluster holds (~1.6 MB a
// domain at 8 blocks, ~3.2 MB at 16) the streamed route reads x twice, the
// second time from the 50 MB L2; with few domains it runs on few SMs (32 at
// two examples, in clusters of 16), where SiLU's MUFU operations bound
// pass 2.
//
// hsplit > 1 reproduces the JAX variant's tile-local statistics (each H-tile
// normalised by its own mean and variance, n = n_per_group / hsplit): not
// GroupNorm, for timing only. stats_bf16 reproduces what the JAX program
// computes for `xf = x.astype(bf16)`, `jnp.sum(xf * xf)`: x rounded to bf16,
// squares and sums in fp32 (XLA keeps the bf16 product in fp32, as its
// excess-precision rule allows), each channel's sums rounded to bf16.
//
// C interface (ctypes): each entry returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a plan it cannot run); it never
// synchronises and allocates nothing. gn_variant_max_active_clusters
// reports how many clusters of a plan the card holds at once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxChannels = 1024;
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;          // 8 portable, 16 with the non-portable opt-in
constexpr int kSmemLimit = 232448;       // 227 KB, the most a block may opt in to
constexpr int kMaxTx = (1 << 20) - 1;    // an mbarrier phase's transaction bytes
constexpr int kMaxGridY = 65535;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of this parity; traps
// after ~20 s so that a wait that never completes fails the launch.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    else if (now - t0 > 40000000000LL) __trap();
  }
}
// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the TMA; completion counted on the barrier in bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct VariantArgs {
  const void* x;
  const float* gamma;   // (CN,)
  const float* beta;
  const float* scale;   // (B, CN)
  const float* shift;
  void* y;
  int hsplit, rows, CN, G;   // rows: of a domain (an example or an H-tile)
  int rows_per_block, chunk_rows, stages, resident, stats_bf16;
  float n_per_group, eps;
};

// Shared memory, in bytes: [slots: stages*chunk_rows*CN values of x]
// [red: rstep*2*CN = 2*VEC*threads][chan: 2*CN][gath: cluster*2*CN][cstat: 2*CN]
// [prm: 4*CN] (f32) [stages mbarriers]. gath holds every block's channel
// sums, pushed by each block; prm the example's gamma, beta, 1 + scale and
// shift. The plan (tools/profile_gn2.py: variant_smem) computes the same
// sum.
inline int64_t variant_smem(int threads, int esz, int CN, int chunk_rows, int stages,
                            int cluster) {
  return (int64_t)stages * chunk_rows * CN * esz +
         4 * (2 * (int64_t)threads * (16 / esz) + (8 + 2 * (int64_t)cluster) * CN) +
         8 * (int64_t)stages;
}

// The values of one 16-byte vector, taken from its words in registers (the
// vector is one 16-byte load, not one load a value).
template <typename T> __device__ __forceinline__ void unpack(const uint4& raw, float* v);
template <> __device__ __forceinline__ void unpack<float>(const uint4& raw, float* v) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw, float* v) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Values into one 16-byte vector of T, rounded to nearest even.
template <typename T> __device__ __forceinline__ uint4 pack(const float* v);
template <> __device__ __forceinline__ uint4 pack<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x and x^2 of one 16-byte vector into the thread's sums. stats_bf16 rounds
// x to bf16 first, which changes only fp32 input.
template <typename T>
__device__ __forceinline__ void accumulate(uint4 raw, float (&s1)[16 / sizeof(T)],
                                           float (&s2)[16 / sizeof(T)], int stats_bf16) {
  float v[16 / sizeof(T)];
  unpack<T>(raw, v);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) {
    if constexpr (sizeof(T) == 4) v[i] = stats_bf16 ? round_bf16(v[i]) : v[i];
    s1[i] += v[i];
    s2[i] += v[i] * v[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) gn_variant_kernel(const VariantArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int tile = blockIdx.x / n_ranks;   // the H-tile (0 when hsplit = 1)
  const int b = blockIdx.y;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CN = a.CN, G = a.G;
  const int nv = CN / VEC;          // 16-byte vectors a row
  const int oct = tid % nv;         // this thread's channels: oct*VEC ..
  const int r0 = tid / nv;
  const int rstep = nthreads / nv;
  const int row_lo = rank * a.rows_per_block;
  const int nrows = min(a.rows, row_lo + a.rows_per_block) - row_lo;   // > 0 by the plan
  const int64_t base = (((int64_t)b * a.hsplit + tile) * a.rows + row_lo) * CN;
  const T* xb = static_cast<const T*>(a.x) + base;
  T* yb = static_cast<T*>(a.y) + base;
  const int stages = a.stages, chunk_rows = a.chunk_rows;
  const int nchunks = (nrows + chunk_rows - 1) / chunk_rows;
  const int nloads = a.resident ? nchunks : 2 * nchunks;   // streamed: every chunk twice
  const int chunk_elems = chunk_rows * CN;

  T* slots = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(slots + (int64_t)stages * chunk_elems);   // [rstep][2][CN]
  float* chan = red + 2 * VEC * nthreads;   // [2][CN]: this block's channel sums
  float* gath = chan + 2 * CN;              // [rank][2][CN]: every block's, pushed
  float* cstat = gath + 2 * CN * n_ranks;   // [2][CN]: each channel's mean, rstd
  float* prm = cstat + 2 * CN;              // [4][CN]: gamma, beta, 1 + scale, shift
  const uint32_t bars = smem_u32(prm + 4 * CN);

  // load j of the block's walk: chunk j % nchunks into slot j % stages
  auto issue = [&](int j) {
    const int c = j % nchunks, s = j % stages;
    const uint32_t bytes = (uint32_t)(min(chunk_rows, nrows - c * chunk_rows) * CN * sizeof(T));
    mbar_expect_tx(bars + 8 * s, bytes);
    bulk_load(smem_u32(slots + (int64_t)s * chunk_elems), xb + (int64_t)c * chunk_elems, bytes,
              bars + 8 * s);
  };
  // the previous kernel on the stream (this one's dependent launch) has
  // completed and its writes are visible: x, the parameters, y
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < min(stages, nloads); ++j) issue(j);
  }
  cluster_arrive_relaxed();   // this block runs: peers may write to its shared memory
  // the example's parameters, into shared memory while x lands
  for (int ch = tid; ch < CN; ch += nthreads) {
    prm[ch] = a.gamma[ch];
    prm[CN + ch] = a.beta[ch];
    prm[2 * CN + ch] = 1.f + a.scale[(int64_t)b * CN + ch];
    prm[3 * CN + ch] = a.shift[(int64_t)b * CN + ch];
  }
  __syncthreads();

  // pass 1: as each chunk lands, sums of x and x^2 for this thread's channels
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  for (int j = 0; j < nchunks; ++j) {
    const int s = j % stages;
    mbar_wait(bars + 8 * s, (j / stages) & 1);
    const T* src = slots + (int64_t)s * chunk_elems + oct * VEC;
    const int cr = min(chunk_rows, nrows - j * chunk_rows);
#pragma unroll 4
    for (int r = r0; r < cr; r += rstep)
      accumulate<T>(*reinterpret_cast<const uint4*>(src + r * CN), s1, s2, a.stats_bf16);
    if (!a.resident) {
      __syncthreads();   // every thread is done with slot s
      if (tid == 0 && j + stages < nloads) issue(j + stages);
    }
  }

  // the next kernel on the stream may start launching: its blocks wait in
  // griddepcontrol.wait until this grid completes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // this block's per-channel sums, in a fixed order: every thread stores
  // its sums as row r0 of red ([rstep][2*CN], 16-byte stores), then thread
  // ch of 2*CN adds column ch over the rows in order (consecutive threads,
  // consecutive banks)
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    float* row = red + r0 * 2 * CN + oct * VEC + i;
    *reinterpret_cast<float4*>(row) = make_float4(s1[i], s1[i + 1], s1[i + 2], s1[i + 3]);
    *reinterpret_cast<float4*>(row + CN) = make_float4(s2[i], s2[i + 1], s2[i + 2], s2[i + 3]);
  }
  __syncthreads();
  for (int ch = tid; ch < 2 * CN; ch += nthreads) {
    float t = 0.f;
#pragma unroll 8
    for (int r = 0; r < rstep; ++r) t += red[r * 2 * CN + ch];
    chan[ch] = t;
  }

  // the cluster's: each block pushes its channel sums into every peer's
  // gath[rank] (remote stores, no round trip), then one cluster barrier,
  // after which every block adds gath in rank order from its own shared
  // memory and no block touches a peer's. stats_bf16 rounds a channel's
  // complete sums, so channels cross, not groups.
  cluster_wait();     // every peer runs (the arrival at the start)
  __syncthreads();    // chan is written
  for (int k = tid; k < n_ranks * (CN / 2); k += nthreads) {   // float4s: 2*CN/4 a peer
    const int peer = k / (CN / 2), e = k % (CN / 2);
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(gath, peer) + rank * 2 * CN);
    dst[e] = reinterpret_cast<const float4*>(chan)[e];
  }
  cluster_arrive();
  cluster_wait();
  for (int ch = tid; ch < 2 * CN; ch += nthreads) {   // the cluster's, into red
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_ranks) t += gath[r * 2 * CN + ch];
    red[ch] = a.stats_bf16 ? round_bf16(t) : t;
  }
  __syncthreads();
  // the group statistics, one thread a group, channels in order; each
  // channel's mean and rstd into cstat
  const int cpg = CN / G;
  for (int g = tid; g < G; g += nthreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int ch = g * cpg; ch < (g + 1) * cpg; ++ch) {
      a1 += red[ch];
      a2 += red[CN + ch];
    }
    const float mean = a1 / a.n_per_group;
    const float var = a2 / a.n_per_group - mean * mean;
    const float rstd = rsqrtf(var + a.eps);
    for (int ch = g * cpg; ch < (g + 1) * cpg; ++ch) {
      cstat[ch] = mean;
      cstat[CN + ch] = rstd;
    }
  }
  __syncthreads();

  // pass 2: y = silu(((x - mean)*rstd*gamma + beta)*(1 + scale) + shift), in
  // this order, over the held rows (resident: the slots are the block's rows
  // in order) or over the chunks again through the ring (streamed)
  float mu[VEC], rs[VEC], ga[VEC], be[VEC], sc[VEC], sh[VEC];
  auto load4 = [&](float (&dst)[VEC], const float* src) {   // 16-byte loads
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(src + oct * VEC + i);
      dst[i] = f.x;
      dst[i + 1] = f.y;
      dst[i + 2] = f.z;
      dst[i + 3] = f.w;
    }
  };
  load4(mu, cstat);
  load4(rs, cstat + CN);
  load4(ga, prm);
  load4(be, prm + CN);
  load4(sc, prm + 2 * CN);
  load4(sh, prm + 3 * CN);
  auto apply = [&](const T* src, T* dst, int rows) {
#pragma unroll 2
    for (int r = r0; r < rows; r += rstep) {
      float v[VEC];
      unpack<T>(*reinterpret_cast<const uint4*>(src + r * CN), v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[i] = (v[i] - mu[i]) * rs[i];
        v[i] = v[i] * ga[i] + be[i];
        v[i] = v[i] * sc[i] + sh[i];
        v[i] = __fdividef(v[i], 1.f + __expf(-v[i]));   // SiLU, fast exp2 and reciprocal
      }
      *reinterpret_cast<uint4*>(dst + (int64_t)r * CN) = pack<T>(v);
    }
  };
  if (a.resident) {
    apply(slots + oct * VEC, yb + oct * VEC, nrows);
    return;
  }
  for (int c = 0; c < nchunks; ++c) {
    const int j = nchunks + c, s = j % stages;
    mbar_wait(bars + 8 * s, (j / stages) & 1);
    apply(slots + (int64_t)s * chunk_elems + oct * VEC, yb + (int64_t)c * chunk_elems + oct * VEC,
          min(chunk_rows, nrows - c * chunk_rows));
    __syncthreads();   // every thread is done with slot s
    if (tid == 0 && j + stages < nloads) issue(j + stages);
  }
}

// The plan's checks, against the kernel's layout: B and hsplit within the
// grid, clusters of at most 16 blocks with none empty, whole 16-byte
// vectors a row, a multiple of CN/VEC threads, chunks within one mbarrier
// phase, a resident plan holding every chunk, the shared memory it needs.
bool bad_plan(int esz, int B, int hsplit, int rows, int CN, int G, int cluster,
              int rows_per_block, int threads, int chunk_rows, int stages, int resident,
              int smem) {
  const int vec = 16 / esz;
  if (B <= 0 || B > kMaxGridY || hsplit <= 0 || hsplit > 65535 || rows <= 0 || G <= 0 ||
      CN <= 0 || CN > kMaxChannels || CN % vec || CN % G)
    return true;
  if (cluster < 1 || cluster > kMaxCluster || rows_per_block < 1 ||
      (int64_t)rows_per_block * cluster < rows || (int64_t)rows_per_block * (cluster - 1) >= rows)
    return true;
  const int nv = CN / vec;
  if (threads <= 0 || threads > kMaxThreads || threads % nv) return true;
  if (chunk_rows < 1 || stages < 1 || (int64_t)chunk_rows * CN * esz > kMaxTx ||
      (resident != 0 && resident != 1))
    return true;
  if (resident && (int64_t)stages * chunk_rows < rows_per_block) return true;
  return smem != variant_smem(threads, esz, CN, chunk_rows, stages, cluster) || smem > kSmemLimit;
}

// The opt-ins to kSmemLimit bytes of dynamic shared memory and to clusters
// past the portable 8 hold per device and per kernel: set once for each
// device the kernel launches on. attr
// holds two attributes: the cluster and the dependent launch.
template <typename T>
cudaError_t config(int B, int hsplit, int cluster, int threads, int smem, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(gn_variant_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err == cudaSuccess)   // clusters past 8 blocks, where the plan takes them
      err = cudaFuncSetAttribute(gn_variant_kernel<T>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * hsplit, B);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a dependent launch: the grid may start while the previous kernel on the
  // stream finishes; griddepcontrol.wait in the kernel holds every access
  // to memory until that kernel has completed
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 2;
  return cudaSuccess;
}

template <typename T>
int launch_variant(const VariantArgs& a, int B, int cluster, int threads, int smem,
                   void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = config<T>(B, a.hsplit, cluster, threads, smem, (cudaStream_t)stream, &cfg,
                              attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, gn_variant_kernel<T>, a);
  if (err != cudaSuccess) return (int)err;
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

// x (B, hsplit*rows, CN) channels_last, y the same; gamma, beta (CN,), scale,
// shift (B, CN), all fp32; the plan: cluster, rows_per_block, threads,
// chunk_rows, stages, resident, smem (tools/profile_gn2.py: variant_plan).
int gn_variant(int bf16, const void* x, const void* gamma, const void* beta, const void* scale,
               const void* shift, void* y, int B, int hsplit, int rows, int CN, int G,
               float n_per_group, float eps, int stats_bf16, int cluster, int rows_per_block,
               int threads, int chunk_rows, int stages, int resident, int smem, void* stream) {
  if (bad_plan(bf16 ? 2 : 4, B, hsplit, rows, CN, G, cluster, rows_per_block, threads,
               chunk_rows, stages, resident, smem) ||
      (uintptr_t)x % 16 || (uintptr_t)y % 16 || !gamma || !beta || !scale || !shift)
    return (int)cudaErrorInvalidValue;
  const VariantArgs a{x,    static_cast<const float*>(gamma), static_cast<const float*>(beta),
                      static_cast<const float*>(scale), static_cast<const float*>(shift),
                      y,    hsplit, rows, CN, G, rows_per_block, chunk_rows, stages, resident,
                      stats_bf16 ? 1 : 0, n_per_group, eps};
  return bf16 ? launch_variant<__nv_bfloat16>(a, B, cluster, threads, smem, stream)
              : launch_variant<float>(a, B, cluster, threads, smem, stream);
}

int gn_variant_max_active_clusters(int bf16, int B, int hsplit, int rows, int CN, int G,
                                   int cluster, int rows_per_block, int threads, int chunk_rows,
                                   int stages, int resident, int smem, int* out) {
  if (bad_plan(bf16 ? 2 : 4, B, hsplit, rows, CN, G, cluster, rows_per_block, threads,
               chunk_rows, stages, resident, smem))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = bf16 ? config<__nv_bfloat16>(B, hsplit, cluster, threads, smem, 0, &cfg, attr)
                         : config<float>(B, hsplit, cluster, threads, smem, 0, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  return (int)(bf16 ? cudaOccupancyMaxActiveClusters(out, gn_variant_kernel<__nv_bfloat16>, &cfg)
                    : cudaOccupancyMaxActiveClusters(out, gn_variant_kernel<float>, &cfg));
}

}  // extern "C"
