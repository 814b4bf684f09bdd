// Softmax attention on Hopper's warpgroup MMA (sm_90a): attention_fwd and
// its VJP attention_bwd at head dims 24, 64, 96, 128 and 192, any T, in
// bf16 and fp32 (3xTF32). One family in two forms, picked by plan_of
// (ops/attention.py's `attention_plan` mirrors it):
//   - tiled (fwd_kernel, dq_kernel, dkv_kernel): a block owns 64 or 128
//     query rows of one sequence (KT keys in the dK/dV launch) and walks
//     the other side in tiles; head dims 64-192 at any T, and 24 at T > 64;
//   - packed (fwd_packed_kernel, bwd_packed_kernel, "packed form" below):
//     head dim 24 at T <= 64, G = 64 / T whole sequences in a 64-row tile,
//     on a persistent grid, the backward in one launch.
// attention_wgmma_bf16.cu and attention_wgmma_f32.cu instantiate this
// header at 64-192, attention_wgmma_d24.cu at 24, one nvcc process each.
//
// Replaces mcvd_tpu/ops/lab/attention.py: fused_attention (_kernel, :26) and
// fused_attention_packed (_packed_kernel, :113) and their custom VJPs
// _fa_bwd and _packed_bwd (:78, :187); both forms compute the same function
// with the same rounding points (below).
//
// What bounds them: operations (4*T*T*D FLOPs a (batch, head) forward, 5
// such products backward, against ~0.5 MB of q, k, v and o at T = 1024, far
// above the card's bytes-per-FLOP line). wgmma is the only way to the
// tensor cores' full rate (989 TFLOP/s bf16; 495 tf32, 165 as 3xTF32), so
// every product here runs on it, with its accumulator in registers. The
// shape of each kernel (fwd_kernel, dq_kernel, dkv_kernel):
//   - a block is one or two consumer warpgroups, each owning 64 rows
//     (queries; KT keys in the dK/dV launch) and running every product of
//     them, and a producer warpgroup whose one thread issues TMA loads: the
//     block's own rows once, then the walked tiles into a 2-stage ring in
//     shared memory, each stage guarded by a full and an empty mbarrier
//     (the consumers release a stage when their products have read it, so
//     tile j + 1 lands while tile j is computed). Two consumer warpgroups
//     share each walked tile and overlap each other's softmax with their
//     products; one block an SM. setmaxnreg moves the producer's
//     registers to the consumers (see kProducerRegs);
//   - TMA reads one 4D tensor map per operand over (D, H, T, B) with the
//     (batch, token) strides of the caller's layout, so the packed (B, T, 3C)
//     qkv of AttnBlock is read in place (q, k and v are three maps with
//     bases qkv, qkv + C, qkv + 2C) and a ragged last tile (rows past T) or
//     the columns past D of a bf16 96-wide head (two 64-column boxes) or of
//     a 24-wide one (one box: bf16 S and dP take depth 32 and P V and dS K
//     N = 64, fp32 depth and N 24) are zero-filled by the hardware, never
//     read from the next example or head. A box is 128 bytes wide (64 bf16
//     or 32 fp32) with the 128-byte swizzle that wgmma's descriptors read
//     (D = 24 in bf16 fills 48 of its bytes: its tiles take 2.7x the
//     shared memory of the data, 8 KB for 64 rows); a tile is D / box boxes. The
//     maps are encoded on the host (cuTensorMapEncodeTiled, reached with
//     dlopen of libcuda.so.1) and kept in a cache keyed by pointer, shape
//     and strides that holds every map of a training step (get_map), so a
//     call on tensors seen before encodes nothing; a sequence shorter than
//     a tile is one ragged tile, zero-filled the same way;
//   - a wait on an mbarrier that never completes traps after ~20 s (a
//     failed launch, not a hung card).
//
// The forward (fwd_kernel), FlashAttention-2 form: S = Q
// K^T over a walked tile of KT keys (one or two warpgroups a block, by
// fwd_warpgroups), online softmax in fp32 registers with
// scale*log2(e) folded into exp2f (running max m and sum l), O += P V with P
// taken from the score registers as the A operand, O / l rounded once. bf16
// rounds the unnormalised p to bf16 before P V (l sums the unrounded p) and
// walks tiles of 64 keys: `attention_tc_emulation` and `bf16_tolerances`
// (ops/attention.py) model exactly that and hold here unchanged.
//
// The backward: two launches on one stream, no atomics, so two calls give
// the same bits. dq_kernel owns 64 queries a warpgroup and walks KT keys: S = Q K^T,
// dP = dO V^T, p = exp2(s*scale*log2(e) - lse*log2(e)), ds = p (dp - D)
// with D = rowsum(dO * O) from the forward's output, dQ += dS K; it stores
// D' = rowsum(p * dp) for the second launch. dkv_kernel owns KT keys a
// warpgroup and walks tiles of 64 queries. It computes S and dP in the dQ launch's
// orientation (queries as M, keys as N: the same instruction on the same
// operands at the same positions, Q's tile row i % 64 and K's row j % KT),
// so its S and dP are the dQ launch's bit for bit; each row of the ds it
// uses (with D') then sums to zero to fp32 rounding, as in the plain VJP,
// and an exactly-zero gradient such as the key bias's stays at fp32 noise.
// It writes P and dS (rounded to bf16, or split) to shared memory and
// accumulates the transposed gradients dV^T += dO^T P and dK^T += Q^T dS
// (M = the head dim, in 64-row slices; A = dO or Q read transposed), which
// keeps its accumulators at D x KT.
//
// Element types:
//   bf16: wgmma m64nNk16, fp32 accumulate. Tiles are used as TMA lands
//   them: K-major operands (rows x D) directly, V and K as the B of P V and
//   dS K, and dO and Q as the A of the dK/dV products, with the
//   descriptor's transpose bit (MN-major).
//   fp32: 3xTF32 on wgmma m64nNk8: every operand x is split as hi =
//   cvt.rna.tf32(x), lo = tf32(x - hi) (ops.attention.tf32_split), and a
//   product accumulates lo*hi + hi*lo, then hi*hi, per step of 8 (lo*lo is
//   dropped): ~21-22 bits of each product, fp32-class, never plain TF32.
//   tf32 wgmma takes B only K-major and A from registers or K-major shared
//   memory, so A operands are read into registers from the raw tiles and
//   split there, and the consumer converts each B tile once in shared
//   memory: hi in place, lo beside it, and transposed copies (hi and lo)
//   where a product needs the tile the other way round (V for P V, K for
//   dS K). An A operand taken from an accumulator (P, dS) holds columns 2t
//   and 2t + 1 where tf32's A fragment wants t and t + 4, so the transposed
//   copies store their k order permuted (position t of a step of 8 is
//   element 2t, t + 4 is 2t + 1) and the accumulator is the A operand as
//   it stands. The hi and lo tiles are why fp32 takes narrower key tiles at
//   the wide heads: KT = 32 for the forward above D = 96, 32 (D = 96, 128)
//   and 16 (D = 192) backward, and one stage of the ring where two do not
//   fit the 227 KB a block may have (kFwdStages, kDqStages, kDkvStages).
//
// C interface (ctypes), in the .cu files: each entry returns
// cudaGetLastError() after its launches (or the error that refused it); it
// never synchronises and allocates nothing.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>
#include <type_traits>

#include "wgmma_ops.cuh"

namespace attn_wg {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kRows = 64;           // a consumer warpgroup's rows; a walked query tile
constexpr int kMaxGridZ = 65535;    // the grid's batch axis; a larger B launches in runs
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may opt in to
// A block: NWG consumer warpgroups (warpgroups 0..NWG-1), then the
// producer warpgroup; one block an SM (launch bounds: min blocks 1). ptxas
// (CUDA 12.8) compiles every region of a kernel within the one register
// count it enters with: 168 a thread at 384 threads (two consumer
// warpgroups), and at 256 threads the consumer's setmaxnreg count. At 384
// threads setmaxnreg.dec 24 / .inc 240 then moves the producer's registers
// to the consumers (24 * 128 + 240 * 256 = 168 * 384), which the compiled
// consumer code leaves unused: its ceiling is the entry count.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
template <int NWG> constexpr int kThreadsOf = 128 * (NWG + 1);
template <int NWG> constexpr int kEntryRegs = NWG == 1 ? kConsumerRegs : NWG == 2 ? 168 : 128;
// The consumers' count after setmaxnreg: 240, or 160 with three consumer
// warpgroups (512 threads enter with 128).
template <int NWG> constexpr int kConsumerRegsOf = NWG == 3 ? 160 : kConsumerRegs;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 == kEntryRegs<2> * kThreadsOf<2>,
              "setmaxnreg moves registers, it does not add them");
static_assert(kProducerRegs * 128 + kConsumerRegsOf<3> * 384 <= kEntryRegs<3> * kThreadsOf<3>,
              "setmaxnreg moves registers, it does not add them");

// ------------------------------------------------------------ PTX helpers

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
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
// One box of a 4D tensor map (column c0 of head c1, row c2, batch c3) into
// shared memory; completion is counted on the barrier in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// A box from shared memory to a 4D tensor map's (c0, c1, c2, c3); coordinates
// past the map's edges are not written. Committed as one bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// The thread's bulk stores have read their shared memory (kRead) or are done.
template <bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of the warpgroup are pending.
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers that an asynchronous wgmma reads or writes stay where they are
// until after wg_wait(): the compiler may neither move their uses across
// nor reuse them for other values.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void keep(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(r[i]);
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void keep(uint32_t (&r)[N][M][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(r[i]);
}
// Named barriers: id 1 over every consumer thread, id 2 + w over consumer
// warpgroup w alone.
template <int NWG>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NWG) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}
// Shared-memory writes by threads, made visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Four 8 x 8 bf16 matrices (one register a thread each, the mma fragment
// layout: row lane / 4, columns 2 (lane % 4) + 0, 1) stored transposed: row
// i of matrix m goes to the 16 bytes at the address lane 8 m + i gives.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// x = hi + lo: hi = x rounded to tf32 (ties away), lo = the rest rounded.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16(a); }

// ------------------------------------------------------------ tile geometry
//
// A tile of R rows is stored as boxes of 128-byte rows (kBoxCols elements),
// box after box, each R x 128 bytes, with the 128-byte swizzle of TMA and
// wgmma: 16-byte chunk c of row r sits at chunk c ^ (r % 8). Tiles start on
// 1024-byte boundaries, where the swizzle's pattern starts.

template <typename T> constexpr int kBoxCols = 128 / (int)sizeof(T);
template <typename T>
__host__ __device__ constexpr int boxes(int cols) {
  return (cols + kBoxCols<T> - 1) / kBoxCols<T>;
}
template <typename T>
__host__ __device__ constexpr int tile_bytes(int rows, int cols) {
  return boxes<T>(cols) * rows * 128;
}

// Byte offset of element (r, c) in a tile of R rows.
template <typename T, int R>
__device__ __forceinline__ uint32_t toff(int r, int c) {
  constexpr int kE = (int)sizeof(T);
  const int b = c / kBoxCols<T>, cb = (c % kBoxCols<T>) * kE;
  return b * (R * 128) + r * 128 + ((((cb >> 4) ^ (r & 7))) << 4) + (cb & 15);
}

// wgmma descriptor of a 128-byte-swizzled operand: start address, leading
// and stride byte offsets.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand (rows x K) in a tile of R rows, k step kk of 32 bytes (16
// bf16 or 8 tf32): rows are the M or N side, eight-row groups 1024 bytes
// apart.
template <int R>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
  return sdesc(tile + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}
// MN-major bf16 operand (rows are K, columns the M or N side) in a tile of R
// rows, k step kk of 16 rows; 64-column boxes are R * 128 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t mdesc(uint32_t tile, int kk) {
  return sdesc(tile + kk * 2048, R * 128, 1024);
}

// Rows [row0, row0 + R) of head h, batch b into a tile: one TMA load a box.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int h, int row0, int b) {
#pragma unroll
  for (int x = 0; x < boxes<T>(D); ++x)
    tma_load(dst + x * (R * 128), map, bar, x * kBoxCols<T>, h, row0, b);
}

// Position of element e (0..7) of a k step of 8 in a tf32 B tile whose A is
// an accumulator: 2t -> t, 2t + 1 -> t + 4.
__device__ __forceinline__ int kperm(int e) { return (e & 1) * 4 + (e >> 1); }

// fp32: a raw tile's K-major B operand converted in place to hi, lo beside
// it (same layout); rows x D, by NT threads.
template <int R, int D, int NT>
__device__ __forceinline__ void split_tile(unsigned char* sm, uint32_t raw, uint32_t lo,
                                           int tid) {
#pragma unroll 4
  for (int i = tid; i < R * D / 4; i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const uint32_t off = toff<float, R>(r, c);
    float4 x = *reinterpret_cast<float4*>(sm + raw + off);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(sm + raw + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(sm + lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// fp32: a raw tile (R rows x D) transposed into hi and lo tiles of D rows x
// R columns, the k order of each step of 8 permuted (kperm), for products
// whose A is an accumulator and whose K side is the raw tile's rows.
template <int R, int D, int NT>
__device__ __forceinline__ void transpose_split(unsigned char* sm, uint32_t raw, uint32_t hi,
                                                uint32_t lo, int tid) {
#pragma unroll 4
  for (int i = tid; i < R * D / 4; i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(sm + raw + toff<float, R>(r, c));
    const int kc = (r & ~7) | kperm(r & 7);
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      split_tf32(v[e], h, l);
      const uint32_t off = toff<float, D>(c + e, kc);
      *reinterpret_cast<uint32_t*>(sm + hi + off) = h;
      *reinterpret_cast<uint32_t*>(sm + lo + off) = l;
    }
  }
}

// fp32 A fragment of k step kk from a raw tile of R rows, split: rows r0 =
// row0 + g and r0 + 8, columns 8kk + t and + 4 (the tf32 A layout).
template <int R>
__device__ __forceinline__ void load_a_tf32(const unsigned char* sm, uint32_t tile, int row0,
                                            int g, int t, int kk, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  const int r0 = row0 + g, c0 = 8 * kk + t;
  const float x[4] = {*reinterpret_cast<const float*>(sm + tile + toff<float, R>(r0, c0)),
                      *reinterpret_cast<const float*>(sm + tile + toff<float, R>(r0 + 8, c0)),
                      *reinterpret_cast<const float*>(sm + tile + toff<float, R>(r0, c0 + 4)),
                      *reinterpret_cast<const float*>(sm + tile + toff<float, R>(r0 + 8, c0 + 4))};
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
}

// The same, transposed: A's rows are the tile's columns (d = col0 + g, + 8;
// zero past D) and A's k side its rows (8kk + t, + 4).
template <int R, int D>
__device__ __forceinline__ void load_at_tf32(const unsigned char* sm, uint32_t tile, int col0,
                                             int g, int t, int kk, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int d0 = col0 + g, k0 = 8 * kk + t;
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = d0 + (e & 1) * 8, k = k0 + (e >> 1) * 4;
    x[e] = d < D ? *reinterpret_cast<const float*>(sm + tile + toff<float, R>(k, d)) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
}

// 3xTF32 step: c += a b, a split in registers, b's hi and lo descriptors.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N / 2], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                     int acc) {
  wgmma::rs_tf32<N>(c, al, bh, acc);
  wgmma::rs_tf32<N>(c, ah, bl, 1);
  wgmma::rs_tf32<N>(c, ah, bh, 1);
}

// S = A B^T over K = D for 64 rows of A (from row a0 of a tile of RA rows)
// and N rows of B (from row b0 of a tile of RB rows); tiles as byte offsets
// from the aligned base. bf16: both from shared memory, issued and left in
// flight (the caller commits and waits, so that two products share a
// wait); fp32: A split in registers two k steps at a time into two buffers,
// the next chunk's loads and splits overlapping this chunk's products
// (wgmma may not read registers that change under it: a buffer is reused
// only after the chunk that read it completed), B's hi (the tile, converted
// in place) and lo; returns with the products done.
template <typename T, int D, int N, int RA, int RB>
__device__ __forceinline__ void scores(float (&s)[N / 2], const unsigned char* sm,
                                       uint32_t base, uint32_t a, int a0, uint32_t bh,
                                       uint32_t bl, int b0, int g, int t, int warp) {
  if constexpr (std::is_same_v<T, bf16>) {
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)   // D = 24: columns 24-31 are the map's zeros
      wgmma::ss_bf16<N, 0, 0>(s, kdesc<RA>(base + a + a0 * 128, kk),
                              kdesc<RB>(base + bh + b0 * 128, kk), kk > 0);
  } else {
    constexpr int NK = D / 8, kChunk = 2, NC = (NK + kChunk - 1) / kChunk;
    uint32_t ah[2][kChunk][4], al[2][kChunk][4];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < NK) load_a_tf32<RA>(sm, a, a0 + 16 * warp, g, t, i, ah[0][i], al[0][i]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int x = c & 1;
      wg_fence();
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int kk = c * kChunk + i;
        if (kk < NK)   // D = 24: three steps, the last chunk one
          mma3<N>(s, ah[x][i], al[x][i], kdesc<RB>(base + bh + b0 * 128, kk),
                  kdesc<RB>(base + bl + b0 * 128, kk), kk > 0);
      }
      wg_commit();
      if (c > 0) {   // chunk c - 1 is done: its buffer takes chunk c + 1
        wg_wait<1>();
        keep(ah[x ^ 1]);
        keep(al[x ^ 1]);
      }
      if (c + 1 < NC) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if ((c + 1) * kChunk + i < NK)
            load_a_tf32<RA>(sm, a, a0 + 16 * warp, g, t, (c + 1) * kChunk + i, ah[x ^ 1][i],
                            al[x ^ 1][i]);
      }
    }
    wg_wait();
    keep(s);
    keep(ah);
    keep(al);
  }
}

// bf16: S and dP of the backward (or one product), issued together and
// waited for once; fp32: one after the other.
template <typename T, int D, int N, int RA, int RB>
__device__ __forceinline__ void scores2(float (&s)[N / 2], float (&dp)[N / 2],
                                        const unsigned char* sm, uint32_t base, uint32_t aq,
                                        uint32_t ag, int a0, uint32_t bk, uint32_t bkl,
                                        uint32_t bv, uint32_t bvl, int b0, int g, int t,
                                        int warp) {
  if constexpr (std::is_same_v<T, bf16>) {
    wg_fence();
    scores<T, D, N, RA, RB>(s, sm, base, aq, a0, bk, 0, b0, g, t, warp);
    scores<T, D, N, RA, RB>(dp, sm, base, ag, a0, bv, 0, b0, g, t, warp);
    wg_commit();
    wg_wait();
    keep(s);
    keep(dp);
  } else {
    scores<T, D, N, RA, RB>(s, sm, base, aq, a0, bk, bkl, b0, g, t, warp);
    scores<T, D, N, RA, RB>(dp, sm, base, ag, a0, bv, bvl, b0, g, t, warp);
  }
}

// fp32, dK/dV launch: c (64 rows of d from col0, KT keys) += A^T B over the
// 64 queries of a walked tile, A = the raw tile (queries x d) read
// transposed and split, B = P or dS (hi and lo tiles, keys x queries).
template <int D, int KT>
__device__ __forceinline__ void out_product_f32(float (&c)[KT / 2], const unsigned char* sm,
                                                uint32_t base, uint32_t a, uint32_t bh,
                                                uint32_t bl, int col0, int g, int t) {
  constexpr int kChunk = 2, NC = kRows / 8 / kChunk;   // double-buffered as in scores
  uint32_t ah[2][kChunk][4], al[2][kChunk][4];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) load_at_tf32<kRows, D>(sm, a, col0, g, t, i, ah[0][i], al[0][i]);
  keep(c);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int x = k & 1;
    wg_fence();
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int kk = k * kChunk + i;
      mma3<KT>(c, ah[x][i], al[x][i], kdesc<KT>(base + bh, kk), kdesc<KT>(base + bl, kk), 1);
    }
    wg_commit();
    if (k > 0) {
      wg_wait<1>();
      keep(ah[x ^ 1]);
      keep(al[x ^ 1]);
    }
    if (k + 1 < NC) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        load_at_tf32<kRows, D>(sm, a, col0, g, t, (k + 1) * kChunk + i, ah[x ^ 1][i],
                               al[x ^ 1][i]);
    }
  }
  wg_wait();
  keep(c);
  keep(ah);
  keep(al);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = 0.f;
}

// The configuration of each (element type, head dim): walked key tiles (KT)
// of the forward (bf16: 64 keys, the tile ops.attention's emulation takes;
// 128 at D = 64 measured no faster, PERF.md) and of the backward (the
// backward's KT is also the keys a dK/dV warpgroup owns; D = 24 takes
// D = 64's), and the consumer warpgroups of the two backward
// kernels (the forward's are picked a call: `fwd_warpgroups`). Two where
// their tiles fit, else one: fp32 dQ at D = 192 (two 128-row own tiles
// alone are 192 KB), fp32 dK/dV at D = 24, 64 and 128 (each warpgroup's P and
// dS tiles in hi and lo beside the own K and V). Two measured faster where
// both fit (fp32 dK/dV at D = 96: 1.03 against 1.20 ms a backward, at 192:
// 3.48 against 4.00; T = 1024, h = 2, B = 16 on an H100, PERF.md).
template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kFwdKT = !kF32 || D <= 96 ? 64 : 32;
  static constexpr int kBwdKT = D <= 64 ? 64 : (!kF32 || D <= 128 ? 32 : 16);
  static constexpr int kDqWG = !kF32 || D <= 128 ? 2 : 1;
  static constexpr int kDkvWG = kF32 && D != 96 && D != 192 ? 1 : 2;
  static constexpr int kDP = boxes<T>(D) * kBoxCols<T>;   // padded width (bf16 24 -> 64, 96 -> 128)
};

// Shared memory of each kernel: byte offsets from a 1024-aligned base; the
// mbarriers last. Two stages where they fit, else one (three or four
// measured no faster on an H100, PERF.md).
template <typename T, int D, int S, int NWG>
struct FwdSmem {
  static constexpr int KT = Cfg<T, D>::kFwdKT;
  static constexpr bool kF32 = Cfg<T, D>::kF32;
  static constexpr int kQ = 0;
  static constexpr int kTile = tile_bytes<T>(KT, D);
  static constexpr int kK = kQ + tile_bytes<T>(kRows * NWG, D);
  static constexpr int kV = kK + S * kTile;
  static constexpr int kKl = kV + S * kTile;                             // fp32: K lo
  static constexpr int kVth = kKl + (kF32 ? kTile : 0);                  // fp32: V^T hi, lo
  static constexpr int kVtl = kVth + (kF32 ? tile_bytes<T>(D, KT) : 0);
  static constexpr int kBar = kVtl + (kF32 ? tile_bytes<T>(D, KT) : 0);
  static constexpr int kBytes = kBar + 8 * (2 * S + 1) + 1024;
};
template <typename T, int D, int NWG>
constexpr int kFwdStages = FwdSmem<T, D, 2, NWG>::kBytes <= kSmemLimit ? 2 : 1;

template <typename T, int D, int S>
struct DqSmem {
  static constexpr int KT = Cfg<T, D>::kBwdKT, NWG = Cfg<T, D>::kDqWG;
  static constexpr bool kF32 = Cfg<T, D>::kF32;
  static constexpr int kTile = tile_bytes<T>(KT, D);
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + tile_bytes<T>(kRows * NWG, D);
  static constexpr int kK = kG + tile_bytes<T>(kRows * NWG, D);
  static constexpr int kV = kK + S * kTile;
  static constexpr int kKl = kV + S * kTile;                             // fp32: K lo, V lo
  static constexpr int kVl = kKl + (kF32 ? kTile : 0);
  static constexpr int kKth = kVl + (kF32 ? kTile : 0);                  // fp32: K^T hi, lo
  static constexpr int kKtl = kKth + (kF32 ? tile_bytes<T>(D, KT) : 0);
  static constexpr int kRowD = kKtl + (kF32 ? tile_bytes<T>(D, KT) : 0);  // the rows' D
  static constexpr int kBar = kRowD + kRows * NWG * 4;
  static constexpr int kBytes = kBar + 8 * (2 * S + 1) + 1024;
};
template <typename T, int D>
constexpr int kDqStages = DqSmem<T, D, 2>::kBytes <= kSmemLimit ? 2 : 1;

template <typename T, int D, int S>
struct DkvSmem {
  static constexpr int KT = Cfg<T, D>::kBwdKT, NWG = Cfg<T, D>::kDkvWG;
  static constexpr bool kF32 = Cfg<T, D>::kF32;
  static constexpr int kTile = tile_bytes<T>(kRows, D);                 // a walked tile
  static constexpr int kOwn = tile_bytes<T>(KT * NWG, D);               // the block's keys
  static constexpr int kPS = tile_bytes<T>(KT, kRows);                  // P or dS of a warpgroup
  static constexpr int kK = 0;
  static constexpr int kV = kK + kOwn;
  static constexpr int kKl = kV + kOwn;                                 // fp32: own K lo, V lo
  static constexpr int kVl = kKl + (kF32 ? kOwn : 0);
  static constexpr int kQ = kVl + (kF32 ? kOwn : 0);
  static constexpr int kG = kQ + S * kTile;
  // each warpgroup's P and dS tiles (fp32: hi and lo): kP + w * kPS, ...
  static constexpr int kP = kG + S * kTile;
  static constexpr int kPl = kP + NWG * kPS;
  static constexpr int kS = kPl + (kF32 ? NWG * kPS : 0);
  static constexpr int kSl = kS + NWG * kPS;
  static constexpr int kBar = kSl + (kF32 ? NWG * kPS : 0);
  static constexpr int kBytes = kBar + 8 * (2 * S + 1) + 1024;
};
template <typename T, int D>
constexpr int kDkvStages = DkvSmem<T, D, 2>::kBytes <= kSmemLimit ? 2 : 1;

// The block's aligned shared-memory base: (shared address, generic pointer).
__device__ __forceinline__ uint32_t smem_base(unsigned char* raw, unsigned char*& sm) {
  const uint32_t a = smem_u32(raw);
  const uint32_t base = (a + 1023) & ~1023u;
  sm = raw + (base - a);
  return base;
}

// Barriers: full[s] (the producer's expect_tx), empty[s] (every consumer
// warp) and own (the block's own rows, once).
__device__ __forceinline__ void init_barriers(uint32_t bars, int S, int consumer_warps) {
  for (int s = 0; s < S; ++s) {
    mbar_init(bars + 8 * s, 1);
    mbar_init(bars + 8 * (S + s), consumer_warps);
  }
  mbar_init(bars + 16 * S, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's walk: own rows (a callable issuing them on the own
// barrier, own_bytes in all), then n_tiles walked tiles into the ring.
template <int S, class Own, class Walked>
__device__ __forceinline__ void produce(uint32_t bars, uint32_t own_bytes, const Own& own,
                                        int n_tiles, uint32_t tile_bytes_all,
                                        const Walked& walked) {
  const uint32_t own_bar = bars + 16 * S;
  mbar_expect_tx(own_bar, own_bytes);
  own(own_bar);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S;
    mbar_wait(bars + 8 * (S + st), ((j / S) & 1) ^ 1);
    mbar_expect_tx(bars + 8 * st, tile_bytes_all);
    walked(st, j, bars + 8 * st);
  }
}

// The consumer's release of a stage: one arrival a warp, once its reads are
// done.
__device__ __forceinline__ void release(uint32_t bars, int S, int st, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bars + 8 * (S + st));
}

// ------------------------------------------------------------------ forward

template <typename T, int D, int NWG>
__global__ void __launch_bounds__(kThreadsOf<NWG>, 1)
fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, T* __restrict__ o, float* __restrict__ lse,
           int T_len, int b0, int64_t o_bs, int64_t o_ts, float scale_log2) {
  constexpr int S = kFwdStages<T, D, NWG>, KT = Cfg<T, D>::kFwdKT, QR = kRows * NWG;
  constexpr bool kF32 = Cfg<T, D>::kF32;
  constexpr int NO = kF32 ? D : Cfg<T, D>::kDP;   // P V's N: the output's columns
  using L = FwdSmem<T, D, S, NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = smem_base(smem_raw, sm);
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = b0 + blockIdx.z, m0 = blockIdx.x * QR;
  const int n_tiles = (T_len + KT - 1) / KT;
  if (tid == 0) init_barriers(bars, S, 4 * NWG);
  __syncthreads();

  if (tid >= 128 * NWG) {   // producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * NWG)
      produce<S>(
          bars, tile_bytes<T>(QR, D),
          [&](uint32_t bar) { load_tile<T, D, QR>(base + L::kQ, &mq, bar, h, m0, b); },
          n_tiles, 2 * L::kTile, [&](int st, int j, uint32_t bar) {
            load_tile<T, D, KT>(base + L::kK + st * L::kTile, &mk, bar, h, j * KT, b);
            load_tile<T, D, KT>(base + L::kV + st * L::kTile, &mv, bar, h, j * KT, b);
          });
  } else {   // consumer warpgroup wg: query rows 64 wg .. 64 wg + 63 of the block
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    float acc[NO / 2];   // O: rows 16 warp + g (+ 8), NO columns
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
    zero(acc);
    mbar_wait(bars + 16 * S, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S;
      mbar_wait(bars + 8 * st, (j / S) & 1);
      const uint32_t oK = L::kK + st * L::kTile, oV = L::kV + st * L::kTile;
      float s[KT / 2];   // S = Q K^T: 64 rows x KT keys
      if constexpr (kF32) {
        consumer_sync<NWG>();   // every warpgroup's previous P V has read V^T
        split_tile<KT, D, 128 * NWG>(sm, oK, L::kKl, tid);
        transpose_split<KT, D, 128 * NWG>(sm, oV, L::kVth, L::kVtl, tid);
        fence_async_smem();
        consumer_sync<NWG>();
        scores<T, D, KT, QR, KT>(s, sm, base, L::kQ, 64 * wg, oK, L::kKl, 0, g, t, warp);
        release(bars, S, st, lane);   // K and V are converted; S has read K
      } else {
        wg_fence();
        scores<T, D, KT, QR, KT>(s, sm, base, L::kQ, 64 * wg, oK, 0, 0, g, t, warp);
        wg_commit();
        wg_wait();
        keep(s);
      }
      // online softmax over this tile, rows g (e = 0, 1) and g + 8 (e = 2, 3)
      const int n0 = j * KT;
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * nb + e] = n0 + 8 * nb + 2 * t + (e & 1) < T_len ? s[4 * nb + e] * scale_log2
                                                               : -INFINITY;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[r];
#pragma unroll
        for (int nb = 0; nb < KT / 8; ++nb)
          mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * r], s[4 * nb + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));   // the four lanes of a row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f(m_r[r] - mx);   // finite mx: key n0 is valid; 0 at first
        m_r[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < KT / 8; ++nb) {
          s[4 * nb + 2 * r] = exp2f(s[4 * nb + 2 * r] - mx);
          s[4 * nb + 2 * r + 1] = exp2f(s[4 * nb + 2 * r + 1] - mx);
          sum += s[4 * nb + 2 * r] + s[4 * nb + 2 * r + 1];
        }
        l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
        for (int nb = 0; nb < NO / 8; ++nb) {
          acc[4 * nb + 2 * r] *= alpha;
          acc[4 * nb + 2 * r + 1] *= alpha;
        }
      }

      // O += P V, P from the score registers
      if constexpr (kF32) {
        uint32_t ph[KT / 8][4], pl[KT / 8][4];
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk) {
          split_tf32(s[4 * kk + 0], ph[kk][0], pl[kk][0]);
          split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
          split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
          split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
        }
        keep(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk)
          mma3<NO>(acc, ph[kk], pl[kk], kdesc<D>(base + L::kVth, kk),
                   kdesc<D>(base + L::kVtl, kk), 1);
        wg_commit();
        wg_wait();
        keep(acc);
        keep(ph);
        keep(pl);
      } else {
        uint32_t pa[KT / 16][4];   // p rounded to bf16 (l summed the unrounded p)
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        keep(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          wgmma::rs_bf16<NO, 1>(acc, pa[kk], mdesc<KT>(base + oV, kk), 1);
        wg_commit();
        wg_wait();
        keep(acc);
        keep(pa);
        release(bars, S, st, lane);
      }
    }

    T* ob = o + (int64_t)b * o_bs + (int64_t)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = m0 + 64 * wg + 16 * warp + g + 8 * r;
      if (row < T_len) {
        T* orow = ob + (int64_t)row * o_ts + 2 * t;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb)   // the real columns
          store2(orow + 8 * nb, acc[4 * nb + 2 * r] * inv, acc[4 * nb + 2 * r + 1] * inv);
        if (lse != nullptr && t == 0)   // natural log: (m + log2 l) * ln 2
          lse[((int64_t)b * gridDim.y + h) * T_len + row] = (m_r[r] + log2f(l)) * kLn2;
      }
    }
  }
}

// ----------------------------------------------------------------- backward

struct BwdArgs {
  const void* o;           // the forward's output, for D = rowsum(dO * O)
  const void* dout;
  const float* lse;        // (B, H, T), natural log of the scaled scores
  float* delta;            // (B, H, T): D' = rowsum(p * dp), from the dQ launch
  void* dq; void* dk; void* dv;
  int64_t bs, ts;          // q, k, v and dq, dk, dv: batch and token strides
  int64_t o_bs, o_ts;      // o and dO
  int T_len, b0;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsOf<Cfg<T, D>::kDqWG>, 1)
dq_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mg,
          const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
          const BwdArgs a) {
  constexpr int S = kDqStages<T, D>, KT = Cfg<T, D>::kBwdKT, NWG = Cfg<T, D>::kDqWG;
  constexpr int QR = kRows * NWG;
  constexpr bool kF32 = Cfg<T, D>::kF32;
  constexpr int NO = kF32 ? D : Cfg<T, D>::kDP;   // dS K's N
  using L = DqSmem<T, D, S>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = smem_base(smem_raw, sm);
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = a.b0 + blockIdx.z, m0 = blockIdx.x * QR;
  const int T_len = a.T_len;
  const int n_tiles = (T_len + KT - 1) / KT;
  if (tid == 0) init_barriers(bars, S, 4 * NWG);
  __syncthreads();

  if (tid >= 128 * NWG) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * NWG)
      produce<S>(
          bars, 2 * tile_bytes<T>(QR, D),
          [&](uint32_t bar) {
            load_tile<T, D, QR>(base + L::kQ, &mq, bar, h, m0, b);
            load_tile<T, D, QR>(base + L::kG, &mg, bar, h, m0, b);
          },
          n_tiles, 2 * L::kTile, [&](int st, int j, uint32_t bar) {
            load_tile<T, D, KT>(base + L::kK + st * L::kTile, &mk, bar, h, j * KT, b);
            load_tile<T, D, KT>(base + L::kV + st * L::kTile, &mv, bar, h, j * KT, b);
          });
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int64_t bh = (int64_t)b * gridDim.y + h;
    const float sl2 = a.scale * kLog2e;
    float* sD = reinterpret_cast<float*>(sm + L::kRowD);
    {  // D = rowsum(dO * O) of the block's rows while the loads fly: two threads a row
      const int r = tid >> 1, half = tid & 1, row = m0 + r;
      float d = 0.f;
      if (row < T_len) {
        const int64_t off = (int64_t)b * a.o_bs + (int64_t)row * a.o_ts + (int64_t)h * D +
                            half * (D / 2);
        const T* go = static_cast<const T*>(a.dout) + off;
        const T* oo = static_cast<const T*>(a.o) + off;
#pragma unroll 8
        for (int e = 0; e < D / 2; ++e) d = fmaf(to_f32(go[e]), to_f32(oo[e]), d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (half == 0) sD[r] = d;
    }
    consumer_sync<NWG>();
    float lse2[2], drow[2];   // rows g and g + 8 of this warp's 16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 64 * wg + 16 * warp + g + 8 * r;
      lse2[r] = m0 + rl < T_len ? a.lse[bh * T_len + m0 + rl] * kLog2e : 0.f;
      drow[r] = sD[rl];
    }
    float dq[NO / 2];
    float pdp[2] = {0.f, 0.f};   // this thread's share of rowsum(p * dp)
    zero(dq);
    mbar_wait(bars + 16 * S, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S;
      mbar_wait(bars + 8 * st, (j / S) & 1);
      const uint32_t oK = L::kK + st * L::kTile, oV = L::kV + st * L::kTile;
      float s[KT / 2], dp[KT / 2];
      if constexpr (kF32) {
        consumer_sync<NWG>();   // every warpgroup's previous dS K has read K^T
        transpose_split<KT, D, 128 * NWG>(sm, oK, L::kKth, L::kKtl, tid);
        consumer_sync<NWG>();   // K^T has read the raw K before it is split in place
        split_tile<KT, D, 128 * NWG>(sm, oK, L::kKl, tid);
        split_tile<KT, D, 128 * NWG>(sm, oV, L::kVl, tid);
        fence_async_smem();
        consumer_sync<NWG>();
      }
      // S = Q K^T, dP = dO V^T
      scores2<T, D, KT, QR, KT>(s, dp, sm, base, L::kQ, L::kG, 64 * wg, oK, L::kKl, oV, L::kVl,
                                0, g, t, warp);
      if constexpr (kF32) release(bars, S, st, lane);   // K^T is a copy; K and V are read
      const int n0 = j * KT;
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = 4 * nb + e;
          const float p = n0 + 8 * nb + 2 * t + (e & 1) < T_len
                              ? exp2f(fmaf(s[i], sl2, -lse2[r])) : 0.f;
          pdp[r] = fmaf(p, dp[i], pdp[r]);
          s[i] = p * (dp[i] - drow[r]);   // ds
        }
      // dQ += dS K, dS from the registers
      if constexpr (kF32) {
        uint32_t dh[KT / 8][4], dl[KT / 8][4];
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk) {
          split_tf32(s[4 * kk + 0], dh[kk][0], dl[kk][0]);
          split_tf32(s[4 * kk + 2], dh[kk][1], dl[kk][1]);
          split_tf32(s[4 * kk + 1], dh[kk][2], dl[kk][2]);
          split_tf32(s[4 * kk + 3], dh[kk][3], dl[kk][3]);
        }
        keep(dq);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk)
          mma3<NO>(dq, dh[kk], dl[kk], kdesc<D>(base + L::kKth, kk),
                   kdesc<D>(base + L::kKtl, kk), 1);
        wg_commit();
        wg_wait();
        keep(dq);
        keep(dh);
        keep(dl);
      } else {
        uint32_t da[KT / 16][4];
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          da[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          da[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          da[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          da[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        keep(dq);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          wgmma::rs_bf16<NO, 1>(dq, da[kk], mdesc<KT>(base + oK, kk), 1);
        wg_commit();
        wg_wait();
        keep(dq);
        keep(da);
        release(bars, S, st, lane);
      }
    }

    T* dqb = static_cast<T*>(a.dq) + (int64_t)b * a.bs + (int64_t)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wg + 16 * warp + g + 8 * r;
      float d = pdp[r];   // the four lanes of a row
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (row < T_len) {
        if (t == 0) a.delta[bh * T_len + row] = d;
        T* out = dqb + (int64_t)row * a.ts + 2 * t;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb)
          store2(out + 8 * nb, dq[4 * nb + 2 * r] * a.scale, dq[4 * nb + 2 * r + 1] * a.scale);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsOf<Cfg<T, D>::kDkvWG>, 1)
dkv_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mg,
           const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
           const BwdArgs a) {
  constexpr int S = kDkvStages<T, D>, KT = Cfg<T, D>::kBwdKT, NWG = Cfg<T, D>::kDkvWG;
  constexpr int KR = KT * NWG;        // the block's keys
  constexpr bool kF32 = Cfg<T, D>::kF32;
  constexpr int NM = (D + 63) / 64;   // 64-row slices of the head dim (dK^T, dV^T)
  using L = DkvSmem<T, D, S>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = smem_base(smem_raw, sm);
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = a.b0 + blockIdx.z;
  const int T_len = a.T_len;
  const int n_tiles = (T_len + kRows - 1) / kRows;
  if (tid == 0) init_barriers(bars, S, 4 * NWG);
  __syncthreads();

  if (tid >= 128 * NWG) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * NWG)
      produce<S>(
          bars, 2 * L::kOwn,
          [&](uint32_t bar) {
            load_tile<T, D, KR>(base + L::kK, &mk, bar, h, blockIdx.x * KR, b);
            load_tile<T, D, KR>(base + L::kV, &mv, bar, h, blockIdx.x * KR, b);
          },
          n_tiles, 2 * L::kTile, [&](int st, int j, uint32_t bar) {
            load_tile<T, D, kRows>(base + L::kQ + st * L::kTile, &mq, bar, h, j * kRows, b);
            load_tile<T, D, kRows>(base + L::kG + st * L::kTile, &mg, bar, h, j * kRows, b);
          });
  } else {   // consumer warpgroup wg: keys KT wg .. KT wg + KT - 1 of the block
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int k0 = blockIdx.x * KR + KT * wg;
    const int64_t bh = (int64_t)b * gridDim.y + h;
    const float sl2 = a.scale * kLog2e;
    const uint32_t oP = L::kP + wg * L::kPS, oPl = L::kPl + wg * L::kPS;
    const uint32_t oS = L::kS + wg * L::kPS, oSl = L::kSl + wg * L::kPS;
    float dkt[NM][KT / 2], dvt[NM][KT / 2];   // dK^T, dV^T: rows d, KT keys
#pragma unroll
    for (int mi = 0; mi < NM; ++mi) {
      zero(dkt[mi]);
      zero(dvt[mi]);
    }
    mbar_wait(bars + 16 * S, 0);
    if constexpr (kF32) {   // the own K and V: hi in place, lo beside
      split_tile<KR, D, 128 * NWG>(sm, L::kK, L::kKl, tid);
      split_tile<KR, D, 128 * NWG>(sm, L::kV, L::kVl, tid);
      fence_async_smem();
      consumer_sync<NWG>();
    }

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S, i0 = j * kRows;
      mbar_wait(bars + 8 * st, (j / S) & 1);
      const uint32_t oQ = L::kQ + st * L::kTile, oG = L::kG + st * L::kTile;
      float s[KT / 2], dp[KT / 2];   // the dQ launch's S and dP: 64 queries x KT keys
      scores2<T, D, KT, kRows, KR>(s, dp, sm, base, oQ, oG, 0, L::kK, L::kKl, L::kV, L::kVl,
                                   KT * wg, g, t, warp);
      float L2[2], Dq[2];
      bool q_ok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 16 * warp + g + 8 * r;
        q_ok[r] = i < T_len;
        L2[r] = q_ok[r] ? a.lse[bh * T_len + i] * kLog2e : 0.f;
        Dq[r] = q_ok[r] ? a.delta[bh * T_len + i] : 0.f;
      }
      // p and ds (in place of s and dp), then to shared memory as B tiles
      // (keys x queries, K-major)
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = 4 * nb + e;
          const int kc = 8 * nb + 2 * t + (e & 1);
          s[i] = q_ok[r] && k0 + kc < T_len ? exp2f(fmaf(s[i], sl2, -L2[r])) : 0.f;
          dp[i] = s[i] * (dp[i] - Dq[r]);
        }
      if constexpr (kF32) {
#pragma unroll
        for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * nb + e;
            const uint32_t off = toff<T, KT>(8 * nb + 2 * t + (e & 1), 16 * warp + g + 8 * (e >> 1));
            uint32_t hi, lo;
            split_tf32(s[i], hi, lo);
            *reinterpret_cast<uint32_t*>(sm + oP + off) = hi;
            *reinterpret_cast<uint32_t*>(sm + oPl + off) = lo;
            split_tf32(dp[i], hi, lo);
            *reinterpret_cast<uint32_t*>(sm + oS + off) = hi;
            *reinterpret_cast<uint32_t*>(sm + oSl + off) = lo;
          }
      } else {
        // bf16: 8 x 8 blocks (8 queries of a warp's 16, 8 keys) stored
        // transposed, four a stmatrix: lane 8 m + i addresses key row i of
        // block m = (key block nb0 + m / 2, query half m % 2), whose 16
        // bytes are query chunk 2 warp + m % 2 of the row (swizzled)
        const int m = lane >> 3, i = lane & 7;
#pragma unroll
        for (int nb0 = 0; nb0 < KT / 8; nb0 += 2) {
          const int kc = 8 * (nb0 + (m >> 1)) + i;
          const uint32_t off = kc * 128 + ((((2 * warp + (m & 1)) ^ (kc & 7))) << 4);
          stmatrix_x4_trans(base + oP + off, pack_bf16(s[4 * nb0], s[4 * nb0 + 1]),
                            pack_bf16(s[4 * nb0 + 2], s[4 * nb0 + 3]),
                            pack_bf16(s[4 * nb0 + 4], s[4 * nb0 + 5]),
                            pack_bf16(s[4 * nb0 + 6], s[4 * nb0 + 7]));
          stmatrix_x4_trans(base + oS + off, pack_bf16(dp[4 * nb0], dp[4 * nb0 + 1]),
                            pack_bf16(dp[4 * nb0 + 2], dp[4 * nb0 + 3]),
                            pack_bf16(dp[4 * nb0 + 4], dp[4 * nb0 + 5]),
                            pack_bf16(dp[4 * nb0 + 6], dp[4 * nb0 + 7]));
        }
      }
      fence_async_smem();
      warpgroup_sync(wg);
      // dV^T += dO^T P and dK^T += Q^T dS, a 64-row slice of d at a time
#pragma unroll
      for (int mi = 0; mi < NM; ++mi) {
        if constexpr (kF32) {
          out_product_f32<D, KT>(dvt[mi], sm, base, oG, oP, oPl, 64 * mi + 16 * warp, g, t);
          out_product_f32<D, KT>(dkt[mi], sm, base, oQ, oS, oSl, 64 * mi + 16 * warp, g, t);
        } else {
          keep(dvt[mi]);
          keep(dkt[mi]);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kRows / 16; ++kk) {
            wgmma::ss_bf16<KT, 1, 0>(dvt[mi], mdesc<kRows>(base + oG + mi * kRows * 128, kk),
                                     kdesc<KT>(base + oP, kk), 1);
            wgmma::ss_bf16<KT, 1, 0>(dkt[mi], mdesc<kRows>(base + oQ + mi * kRows * 128, kk),
                                     kdesc<KT>(base + oS, kk), 1);
          }
          wg_commit();
          wg_wait();
          keep(dvt[mi]);
          keep(dkt[mi]);
        }
      }
      release(bars, S, st, lane);
    }

    const int64_t out0 = (int64_t)b * a.bs + (int64_t)h * D;
    T* dkb = static_cast<T*>(a.dk) + out0;
    T* dvb = static_cast<T*>(a.dv) + out0;
#pragma unroll
    for (int mi = 0; mi < NM; ++mi)
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 64 * mi + 16 * warp + g + 8 * (e >> 1);
          const int key = k0 + 8 * nb + 2 * t + (e & 1);
          if (d < D && key < T_len) {
            const int64_t off = (int64_t)key * a.ts + d;
            store1(dkb + off, dkt[mi][4 * nb + e] * a.scale);
            store1(dvb + off, dvt[mi][4 * nb + e]);
          }
        }
  }
}

// ------------------------------------------------------------ packed form
//
// Sequences of T <= 64 tokens (head dim 24: the 3D family's time attention
// over 7 or 2 frames and its 4-px space attention over 16 tokens): a 64-row
// tile holds G = 64 / T whole sequences of one head, rows g T + t, loaded by
// one TMA box of (columns, 1, T, G) per operand; sequences past B are the
// map's zero fill, and rows past G T (never loaded) are zeroed once when the
// block starts. Every key outside a query's own sequence is masked, so a
// tile computes each of its sequences as the tiled kernels would compute it
// alone: the masked p are exact zeros, and the row max, bf16's rounding of
// p and the logsumexp are those of the sequence (ops.attention's
// emulations, run one sequence at a time, give the same bits on the packed
// tile). What bounds it: bytes (a tile's 64 x 64 x 32 products are ~0.5
// MFLOP against ~9 KB of q, k and v), and at a few microseconds of work a
// tile, the cost of a block: so the grid is persistent, one block an SM
// walking tiles blockIdx.x, + gridDim.x, ...; the producer's ring loads
// the next tiles while the consumer warpgroups (each taking every NWG-th
// tile of the block, each stage always the same warpgroup's) compute
// theirs, and a tile's stores overlap the next loads (the backward's
// gradients leave through shared memory by TMA stores; the forward's
// straight from the registers, which measured faster). A batch of any
// size is one launch.

struct PackArgs {
  int T_len, B, H, G, n_tiles;
  int magic;            // row / T = (row * magic) >> 16 for row < 64
  int64_t o_bs, o_ts;   // the forward's output
  float scale_log2;
};

// Consumer warpgroups and ring stages: the forward three warpgroups on a
// 6-stage ring (three measured faster than two, and a deeper ring no
// faster: PERF.md); the bf16 backward two on 4 stages; the fp32 backward
// one on 2 (its P and dS in hi and lo, its split K and V and its dQ tile
// take 100 KB beside the 40 KB stages).
template <typename T>
struct PackCfg {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kFwdWG = 3, kFwdStages = 6;
  static constexpr int kBwdWG = kF32 ? 1 : 2, kBwdStages = kF32 ? 2 : 4;
};

// Stages first (NOPS 64-row operand tiles each), then each warpgroup's
// scratch (kScratch bytes), then the barriers: full[S], empty[S].
template <typename T, int D, int NOPS, int S, int NWG, int kScratch>
struct PackSmem {
  static constexpr int kTile = tile_bytes<T>(kRows, D);
  static constexpr int kStage = NOPS * kTile;
  static constexpr int kWork = S * kStage;
  static constexpr int kBar = kWork + NWG * kScratch;
  static constexpr int kBytes = kBar + 16 * S + 1024;
  __host__ __device__ static constexpr uint32_t op(int st, int i) {
    return st * kStage + i * kTile;
  }
  __host__ __device__ static constexpr uint32_t scratch(int wg) { return kWork + wg * kScratch; }
};
// fp32 forward scratch: K lo, V^T hi and lo
template <typename T, int D>
constexpr int kPackFwdScratch =
    PackCfg<T>::kF32 ? tile_bytes<T>(kRows, D) + 2 * tile_bytes<T>(D, kRows) : 0;
// backward scratch: P and dS' (fp32: hi and lo; then the dK and dV tiles),
// fp32 K lo, V lo, K^T hi and lo, the dQ tile (the gradients leave by TMA
// stores of the tile's G sequences)
template <typename T, int D>
constexpr int kPackBwdScratch =
    (PackCfg<T>::kF32 ? 4 * tile_bytes<T>(kRows, kRows) + 2 * tile_bytes<T>(kRows, D) +
                            2 * tile_bytes<T>(D, kRows)
                      : 2 * tile_bytes<T>(kRows, kRows)) +
    tile_bytes<T>(kRows, D);
template <typename T, int D>
using PackFwdSmem = PackSmem<T, D, 3, PackCfg<T>::kFwdStages, PackCfg<T>::kFwdWG,
                             kPackFwdScratch<T, D>>;
template <typename T, int D>
using PackBwdSmem = PackSmem<T, D, 5, PackCfg<T>::kBwdStages, PackCfg<T>::kBwdWG,
                             kPackBwdScratch<T, D>>;

// The block's start: zero the rows past G T of every box of the stages
// (never loaded, they must read as finite zeros), init the barriers, fence
// both for the async proxy.
__device__ __forceinline__ void pack_start(unsigned char* sm, int work_bytes, int rows_loaded,
                                           uint32_t bars, int S, int tid) {
  constexpr int kBox = kRows * 128;
  const int tail = kBox - rows_loaded * 128;
  for (int i = tid * 16; i < work_bytes / kBox * tail; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(sm + (i / tail) * kBox + (kBox - tail) + i % tail) =
        make_uint4(0, 0, 0, 0);
  fence_async_smem();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), 4);   // the four warps of the stage's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer: the block's tiles in order, tile i into stage i % S, each
// operand one box of G sequences per 128-byte column box.
template <typename T, int D, int S, int NOPS>
__device__ __forceinline__ void pack_produce(uint32_t base, uint32_t bars, int stage_bytes,
                                             int tile_bytes_, const CUtensorMap* const* maps,
                                             const PackArgs& p) {
  const uint32_t box_bytes = boxes<T>(D) * 128u * p.T_len * p.G;
#pragma unroll
  for (int op = 0; op < NOPS; ++op)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[op]))
                 : "memory");
  int i = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++i) {
    const int st = i % S;
    const uint32_t full = bars + 8 * st;
    mbar_wait(bars + 8 * (S + st), ((i / S) & 1) ^ 1);
    mbar_expect_tx(full, NOPS * box_bytes);
    const int h = tile % p.H, b0 = (tile / p.H) * p.G;
#pragma unroll
    for (int op = 0; op < NOPS; ++op)
#pragma unroll
      for (int x = 0; x < boxes<T>(D); ++x)
        tma_load(base + st * stage_bytes + op * tile_bytes_ + x * (kRows * 128), maps[op], full,
                 x * kBoxCols<T>, h, 0, b0);
  }
}

// A consumer thread's two rows (16 warp + g, + 8) of a packed tile: the
// sequence slot, its first row, and whether it is a sequence of the batch.
struct PackRows {
  int seq[2], lo[2];
  bool ok[2];
};
__device__ __forceinline__ PackRows pack_rows(const PackArgs& p, int b0, int warp, int g) {
  PackRows r;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = 16 * warp + g + 8 * e;
    r.seq[e] = (row * p.magic) >> 16;
    r.lo[e] = r.seq[e] * p.T_len;
    r.ok[e] = r.seq[e] < p.G && b0 + r.seq[e] < p.B;
  }
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsOf<PackCfg<T>::kFwdWG>, 1)
fwd_packed_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, T* __restrict__ o,
                  float* __restrict__ lse, const PackArgs p) {
  constexpr int NWG = PackCfg<T>::kFwdWG, S = PackCfg<T>::kFwdStages;
  constexpr bool kF32 = PackCfg<T>::kF32;
  constexpr int NO = kF32 ? D : Cfg<T, D>::kDP;   // P V's N
  using L = PackFwdSmem<T, D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = smem_base(smem_raw, sm);
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  pack_start(sm, L::kWork, p.G * p.T_len, bars, S, tid);

  if (tid >= 128 * NWG) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * NWG) {
      const CUtensorMap* maps[3] = {&mq, &mk, &mv};
      pack_produce<T, D, S, 3>(base, bars, L::kStage, L::kTile, maps, p);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegsOf<NWG>>();
  const int wg = tid >> 7, twg = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31,
            g = lane >> 2, t = lane & 3;
  const uint32_t oKl = L::scratch(wg), oVth = oKl + tile_bytes<T>(kRows, D),
                 oVtl = oVth + tile_bytes<T>(D, kRows);
  int i = wg;
  for (int tile = blockIdx.x + wg * gridDim.x; tile < p.n_tiles;
       tile += NWG * gridDim.x, i += NWG) {
    const int st = i % S, h = tile % p.H, b0 = (tile / p.H) * p.G;
    const PackRows rows = pack_rows(p, b0, warp, g);
    const uint32_t oQ = L::op(st, 0), oK = L::op(st, 1), oV = L::op(st, 2);
    mbar_wait(bars + 8 * st, (i / S) & 1);
    float s[kRows / 2];   // S = Q K^T: 64 rows x 64 keys
    if constexpr (kF32) {
      warpgroup_sync(wg);   // the previous tile's P V has read V^T
      split_tile<kRows, D, 128>(sm, oK, oKl, twg);
      transpose_split<kRows, D, 128>(sm, oV, oVth, oVtl, twg);
      fence_async_smem();
      warpgroup_sync(wg);
      scores<T, D, kRows, kRows, kRows>(s, sm, base, oQ, 0, oK, oKl, 0, g, t, warp);
      release(bars, S, st, lane);   // K and V are converted; S has read K
    } else {
      wg_fence();
      scores<T, D, kRows, kRows, kRows>(s, sm, base, oQ, 0, oK, 0, 0, g, t, warp);
      wg_commit();
      wg_wait();
      keep(s);
    }
    // softmax over the row's own sequence: keys [lo, lo + T) (row r itself
    // is one, so the max is finite)
    float mx[2], l[2];
#pragma unroll
    for (int nb = 0; nb < kRows / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nb + 2 * t + (e & 1), lo = rows.lo[e >> 1];
        s[4 * nb + e] = c >= lo && c < lo + p.T_len ? s[4 * nb + e] * p.scale_log2 : -INFINITY;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < kRows / 8; ++nb)
        m = fmaxf(m, fmaxf(s[4 * nb + 2 * r], s[4 * nb + 2 * r + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kRows / 8; ++nb) {
        s[4 * nb + 2 * r] = exp2f(s[4 * nb + 2 * r] - m);
        s[4 * nb + 2 * r + 1] = exp2f(s[4 * nb + 2 * r + 1] - m);
        sum += s[4 * nb + 2 * r] + s[4 * nb + 2 * r + 1];
      }
      mx[r] = m;
      l[r] = sum;
    }
    float acc[NO / 2];   // O = P V
    zero(acc);
    if constexpr (kF32) {
      uint32_t ph[kRows / 8][4], pl[kRows / 8][4];
#pragma unroll
      for (int kk = 0; kk < kRows / 8; ++kk) {
        split_tf32(s[4 * kk + 0], ph[kk][0], pl[kk][0]);
        split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
        split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
        split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      keep(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 8; ++kk)
        mma3<NO>(acc, ph[kk], pl[kk], kdesc<D>(base + oVth, kk), kdesc<D>(base + oVtl, kk), 1);
      wg_commit();
      wg_wait();
      keep(acc);
      keep(ph);
      keep(pl);
    } else {
      uint32_t pa[kRows / 16][4];   // p rounded to bf16 (l summed the unrounded p)
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      keep(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma::rs_bf16<NO, 1>(acc, pa[kk], mdesc<kRows>(base + oV, kk), 1);
      wg_commit();
      wg_wait();
      keep(acc);
      keep(pa);
      release(bars, S, st, lane);
    }
    // O / l of the rows of the batch's sequences, straight from the
    // registers (a TMA store of the tile through shared memory measured
    // slower here: PERF.md)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (!rows.ok[r]) continue;
      const int b = b0 + rows.seq[r], tt = 16 * warp + g + 8 * r - rows.lo[r];
      const float inv = 1.f / sum;
      T* orow = o + (int64_t)b * p.o_bs + (int64_t)tt * p.o_ts + (int64_t)h * D + 2 * t;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        store2(orow + 8 * nb, acc[4 * nb + 2 * r] * inv, acc[4 * nb + 2 * r + 1] * inv);
      if (lse != nullptr && t == 0)
        lse[((int64_t)b * p.H + h) * p.T_len + tt] = (mx[r] + log2f(sum)) * kLn2;
    }
  }
}

// The backward of a packed tile in one launch: every sequence lies whole in
// its tile, so the block holds Q, K, V, dO and O of its G sequences and
// runs the five products S = Q K^T, dP = dO V^T, dQ = dS K, dV^T = dO^T P and
// dK^T = Q^T dS' with no atomics and no scratch in device memory. As the
// tiled pair: dS = P (dP - D) with D = rowsum(dO * O), and dK's
// dS' = P (dP - D') with D' = rowsum(P * dP) summed here over the row's
// keys (the dQ launch's D'); P and dS' pass through this warpgroup's shared
// memory as the B tiles of the dK/dV products (keys x queries).
template <typename T, int D>
__global__ void __launch_bounds__(kThreadsOf<PackCfg<T>::kBwdWG>, 1)
bwd_packed_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                  const __grid_constant__ CUtensorMap mo, const __grid_constant__ CUtensorMap mdq,
                  const __grid_constant__ CUtensorMap mdk, const __grid_constant__ CUtensorMap mdv,
                  const BwdArgs a, const PackArgs p) {
  constexpr int NWG = PackCfg<T>::kBwdWG, S = PackCfg<T>::kBwdStages;
  constexpr bool kF32 = PackCfg<T>::kF32;
  constexpr int NO = kF32 ? D : Cfg<T, D>::kDP;   // dS K's N
  using L = PackBwdSmem<T, D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = smem_base(smem_raw, sm);
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  pack_start(sm, L::kWork, p.G * p.T_len, bars, S, tid);

  if (tid >= 128 * NWG) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * NWG) {
      const CUtensorMap* maps[5] = {&mq, &mk, &mv, &mg, &mo};
      pack_produce<T, D, S, 5>(base, bars, L::kStage, L::kTile, maps, p);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegsOf<NWG>>();
  const int wg = tid >> 7, twg = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31,
            g = lane >> 2, t = lane & 3;
  const float sl2 = a.scale * kLog2e;
  constexpr int kPS = tile_bytes<T>(kRows, kRows);   // P or dS': keys x queries
  const uint32_t oP = L::scratch(wg), oS = oP + kPS;
  const uint32_t oPl = oS + kPS, oSl = oPl + kPS;                         // fp32
  const uint32_t oKl = oSl + kPS, oVl = oKl + tile_bytes<T>(kRows, D);    // fp32
  const uint32_t oKth = oVl + tile_bytes<T>(kRows, D), oKtl = oKth + tile_bytes<T>(D, kRows);
  const uint32_t oDq = L::scratch(wg) + kPackBwdScratch<T, D> - tile_bytes<T>(kRows, D);
  int i = wg;
  for (int tile = blockIdx.x + wg * gridDim.x; tile < p.n_tiles;
       tile += NWG * gridDim.x, i += NWG) {
    const int st = i % S, h = tile % p.H, b0 = (tile / p.H) * p.G;
    const PackRows rows = pack_rows(p, b0, warp, g);
    const uint32_t oQ = L::op(st, 0), oK = L::op(st, 1), oV = L::op(st, 2), oG = L::op(st, 3),
                   oO = L::op(st, 4);
    float L2[2];   // the rows' logsumexp, loaded while the tile lands
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tt = 16 * warp + g + 8 * r - rows.lo[r];
      L2[r] = rows.ok[r]
                  ? a.lse[((int64_t)(b0 + rows.seq[r]) * p.H + h) * p.T_len + tt] * kLog2e
                  : 0.f;
    }
    mbar_wait(bars + 8 * st, (i / S) & 1);
    if (twg == 0) tma_store_wait<true>();   // the previous tile's gradients have left
    warpgroup_sync(wg);   // and its products have read the scratch
    if constexpr (kF32) {
      transpose_split<kRows, D, 128>(sm, oK, oKth, oKtl, twg);
      warpgroup_sync(wg);   // K^T has read the raw K before it is split in place
      split_tile<kRows, D, 128>(sm, oK, oKl, twg);
      split_tile<kRows, D, 128>(sm, oV, oVl, twg);
      fence_async_smem();
      warpgroup_sync(wg);
    }
    // D = rowsum(dO * O) of the thread's rows: the four lanes of a row, D / 4
    // columns each
    float drow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < D / 4; ++e) {
        const uint32_t off = toff<T, kRows>(row, t * (D / 4) + e);
        d = fmaf(to_f32(*reinterpret_cast<const T*>(sm + oG + off)),
                 to_f32(*reinterpret_cast<const T*>(sm + oO + off)), d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      drow[r] = d;
    }
    float s[kRows / 2], dp[kRows / 2];   // S and dP: 64 queries x 64 keys
    scores2<T, D, kRows, kRows, kRows>(s, dp, sm, base, oQ, oG, 0, oK, oKl, oV, oVl, 0, g, t,
                                       warp);
    // p (in place of s), D' of the row, dS for dQ, dS' (in place of dp)
    float pdp[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kRows / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, idx = 4 * nb + e, c = 8 * nb + 2 * t + (e & 1);
        const bool in = rows.ok[r] && c >= rows.lo[r] && c < rows.lo[r] + p.T_len;
        s[idx] = in ? exp2f(fmaf(s[idx], sl2, -L2[r])) : 0.f;
        pdp[r] = fmaf(s[idx], dp[idx], pdp[r]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pdp[r] += __shfl_xor_sync(0xffffffffu, pdp[r], 1);
      pdp[r] += __shfl_xor_sync(0xffffffffu, pdp[r], 2);
    }
    float dq[NO / 2], dkt[kRows / 2], dvt[kRows / 2];   // dK^T, dV^T: rows d, 64 keys
    if constexpr (kF32) {
      uint32_t dh[kRows / 8][4], dl[kRows / 8][4];   // dS as dQ's A (accumulator order)
#pragma unroll
      for (int kk = 0; kk < kRows / 8; ++kk) {
        const int e0 = 4 * kk;
        split_tf32(s[e0 + 0] * (dp[e0 + 0] - drow[0]), dh[kk][0], dl[kk][0]);
        split_tf32(s[e0 + 2] * (dp[e0 + 2] - drow[1]), dh[kk][1], dl[kk][1]);
        split_tf32(s[e0 + 1] * (dp[e0 + 1] - drow[0]), dh[kk][2], dl[kk][2]);
        split_tf32(s[e0 + 3] * (dp[e0 + 3] - drow[1]), dh[kk][3], dl[kk][3]);
      }
#pragma unroll
      for (int nb = 0; nb < kRows / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * nb + e;
          const float ds1 = s[idx] * (dp[idx] - pdp[e >> 1]);
          const uint32_t off =
              toff<T, kRows>(8 * nb + 2 * t + (e & 1), 16 * warp + g + 8 * (e >> 1));
          uint32_t hi, lo;
          split_tf32(s[idx], hi, lo);
          *reinterpret_cast<uint32_t*>(sm + oP + off) = hi;
          *reinterpret_cast<uint32_t*>(sm + oPl + off) = lo;
          split_tf32(ds1, hi, lo);
          *reinterpret_cast<uint32_t*>(sm + oS + off) = hi;
          *reinterpret_cast<uint32_t*>(sm + oSl + off) = lo;
        }
      fence_async_smem();
      warpgroup_sync(wg);
      zero(dq);
      keep(dq);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 8; ++kk)
        mma3<NO>(dq, dh[kk], dl[kk], kdesc<D>(base + oKth, kk), kdesc<D>(base + oKtl, kk), 1);
      wg_commit();
      wg_wait();
      keep(dq);
      keep(dh);
      keep(dl);
      zero(dvt);
      zero(dkt);
      out_product_f32<D, kRows>(dvt, sm, base, oG, oP, oPl, 16 * warp, g, t);
      out_product_f32<D, kRows>(dkt, sm, base, oQ, oS, oSl, 16 * warp, g, t);
    } else {
      uint32_t da[kRows / 16][4];   // dS rounded to bf16, dQ's A
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i0 = 8 * kk + 2 * e, r = e & 1;
          da[kk][e] = pack_bf16(s[i0] * (dp[i0] - drow[r]), s[i0 + 1] * (dp[i0 + 1] - drow[r]));
        }
#pragma unroll
      for (int idx = 0; idx < kRows / 2; ++idx) dp[idx] = s[idx] * (dp[idx] - pdp[(idx >> 1) & 1]);
      // P and dS' as 8 x 8 blocks stored transposed (the tiled dK/dV launch's stmatrix)
      const int m = lane >> 3, ii = lane & 7;
#pragma unroll
      for (int nb0 = 0; nb0 < kRows / 8; nb0 += 2) {
        const int kc = 8 * (nb0 + (m >> 1)) + ii;
        const uint32_t off = kc * 128 + ((((2 * warp + (m & 1)) ^ (kc & 7))) << 4);
        stmatrix_x4_trans(base + oP + off, pack_bf16(s[4 * nb0], s[4 * nb0 + 1]),
                          pack_bf16(s[4 * nb0 + 2], s[4 * nb0 + 3]),
                          pack_bf16(s[4 * nb0 + 4], s[4 * nb0 + 5]),
                          pack_bf16(s[4 * nb0 + 6], s[4 * nb0 + 7]));
        stmatrix_x4_trans(base + oS + off, pack_bf16(dp[4 * nb0], dp[4 * nb0 + 1]),
                          pack_bf16(dp[4 * nb0 + 2], dp[4 * nb0 + 3]),
                          pack_bf16(dp[4 * nb0 + 4], dp[4 * nb0 + 5]),
                          pack_bf16(dp[4 * nb0 + 6], dp[4 * nb0 + 7]));
      }
      fence_async_smem();
      warpgroup_sync(wg);
      zero(dq);
      zero(dvt);
      zero(dkt);
      keep(dq);
      keep(dvt);
      keep(dkt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wgmma::rs_bf16<NO, 1>(dq, da[kk], mdesc<kRows>(base + oK, kk), 1);
        wgmma::ss_bf16<kRows, 1, 0>(dvt, mdesc<kRows>(base + oG, kk), kdesc<kRows>(base + oP, kk),
                                    1);
        wgmma::ss_bf16<kRows, 1, 0>(dkt, mdesc<kRows>(base + oQ, kk), kdesc<kRows>(base + oS, kk),
                                    1);
      }
      wg_commit();
      wg_wait();
      keep(dq);
      keep(dvt);
      keep(dkt);
      keep(da);
    }
    release(bars, S, st, lane);
    // dQ (rows queries), dK and dV (rows keys, from the transposed
    // accumulators' rows d) into staging tiles, dK and dV over P and dS'
    // (read), then a TMA store each: rows past the batch or past G T are
    // clipped by the maps' edges
    warpgroup_sync(wg);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        store2(reinterpret_cast<T*>(sm + oDq +
                                    toff<T, kRows>(16 * warp + g + 8 * r, 8 * nb + 2 * t)),
               dq[4 * nb + 2 * r] * a.scale, dq[4 * nb + 2 * r + 1] * a.scale);
    if (16 * warp < D) {
#pragma unroll
      for (int nb = 0; nb < kRows / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 16 * warp + g + 8 * (e >> 1), key = 8 * nb + 2 * t + (e & 1);
          if (d < D) {
            const uint32_t off = toff<T, kRows>(key, d);
            store1(reinterpret_cast<T*>(sm + oP + off), dkt[4 * nb + e] * a.scale);
            store1(reinterpret_cast<T*>(sm + oS + off), dvt[4 * nb + e]);
          }
        }
    }
    fence_async_smem();
    warpgroup_sync(wg);
    if (twg == 0)
#pragma unroll
      for (int x = 0; x < boxes<T>(D); ++x) {
        const uint32_t bx = x * (kRows * 128);
        tma_store(&mdq, base + oDq + bx, x * kBoxCols<T>, h, 0, b0);
        tma_store(&mdk, base + oP + bx, x * kBoxCols<T>, h, 0, b0);
        tma_store(&mdv, base + oS + bx, x * kBoxCols<T>, h, 0, b0);
      }
  }
  if (twg == 0) tma_store_wait<false>();
}

// ------------------------------------------------------------------ launch

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which every machine with a card
// has (nothing links against it).
inline EncodeFn encode_fn() {
  static const EncodeFn fn = []() -> EncodeFn {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor map of (D, H, T, B) with the caller's strides, boxes of
// (kBoxCols, 1, rows, seqs), 128-byte swizzle, zero fill past the edges
// (columns past D, rows past T, sequences past B).
struct MapKey {
  const void* ptr;
  int64_t ts, bs;
  int D, H, T, B, rows, seqs;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && ts == o.ts && bs == o.bs && D == o.D && H == o.H && T == o.T &&
           B == o.B && rows == o.rows && seqs == o.seqs;
  }
};

template <typename T>
bool encode_map(CUtensorMap* m, const MapKey& k) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  constexpr int kE = (int)sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)k.D, (cuuint64_t)k.H, (cuuint64_t)k.T,
                              (cuuint64_t)k.B};
  const cuuint64_t strides[3] = {(cuuint64_t)k.D * kE, (cuuint64_t)k.ts * kE,
                                 (cuuint64_t)k.bs * kE};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols<T>, 1, (cuuint32_t)k.rows,
                              (cuuint32_t)k.seqs};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt =
      std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(m, dt, 4, const_cast<void*>(k.ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The maps of recent calls, so that a call on tensors seen before (the
// sampler's and the step's, whose buffers the caching allocator hands out
// again) encodes nothing. 1,024 maps of each element type in 128 sets of 8,
// a set picked by a hash of the key, the least recently used map of a full
// set encoded over: a flagship training step takes 110 (10 attention calls
// of 3 forward and 8 backward maps), a sampler's evaluation 30.
template <typename T>
bool get_map(CUtensorMap* out, const MapKey& k) {
  constexpr int kSets = 128, kWays = 8;
  struct Entry {
    MapKey key;
    CUtensorMap map;
    uint64_t last_use;   // 0: empty
  };
  static Entry table[kSets][kWays];
  static uint64_t uses = 0;
  static std::mutex mu;
  uint64_t hsh = (uint64_t)(uintptr_t)k.ptr * 0x9E3779B97F4A7C15ull;
  for (int64_t v : {k.ts, k.bs, (int64_t)k.D, (int64_t)k.H, (int64_t)k.T, (int64_t)k.B,
                    (int64_t)k.rows, (int64_t)k.seqs})
    hsh = (hsh ^ (uint64_t)v) * 0x100000001B3ull;
  Entry* set = table[(hsh >> 32) % kSets];
  std::lock_guard<std::mutex> lock(mu);
  Entry* e = set;   // the key's entry, else the least recently used
  for (int w = 0; w < kWays; ++w) {
    if (set[w].last_use != 0 && set[w].key == k) {
      e = set + w;
      break;
    }
    if (set[w].last_use < e->last_use) e = set + w;
  }
  if (!(e->last_use != 0 && e->key == k)) {
    e->last_use = 0;
    if (!encode_map<T>(&e->map, k)) return false;
    e->key = k;
  }
  e->last_use = ++uses;
  *out = e->map;
  return true;
}

constexpr int kMaxDevices = 64;

// Once per device and kernel (the kernel's element type, head dim, kind and
// warpgroups key the static): opt in to its shared memory, and check that
// it enters with the registers setmaxnreg's budget assumes.
template <typename T, int D, int kKind, int NWG>
cudaError_t prepare(const void* kernel, int smem) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return err;
  if (at.numRegs != kEntryRegs<NWG>) return cudaErrorInvalidConfiguration;
  done[dev] = true;
  return cudaSuccess;
}

inline bool bad_args(int B, int H, int T_len, int D, std::initializer_list<const void*> ptrs,
                     std::initializer_list<int64_t> strides, int es) {
  if ((D != 24 && D != 64 && D != 96 && D != 128 && D != 192) || B <= 0 || H <= 0 || H > 65535 ||
      T_len <= 0)
    return true;
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return true;
  for (int64_t s : strides)
    if (s * es % 16 != 0) return true;
  return false;
}

// The plan of a call (ops.attention.attention_plan mirrors it): "packed"
// for head dim 24 at T <= 64, G = 64 / T sequences a tile and H ceil(B / G)
// tiles; else "tiled", a 64-query tile of one sequence, H B ceil(T / 64)
// tiles (the kernels above; a block takes one or two of them).
struct Plan {
  bool packed;
  int seqs;
  int64_t tiles;
};
inline Plan plan_of(int D, int T_len, int B, int H) {
  if (D == 24 && T_len <= kRows) {
    const int G = kRows / T_len;
    return {true, G, (int64_t)H * ((B + G - 1) / G)};
  }
  return {false, 1, (int64_t)H * B * ((T_len + kRows - 1) / kRows)};
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  return sms;
}

inline PackArgs pack_args(const Plan& pl, int B, int H, int T_len, int64_t o_bs, int64_t o_ts,
                          float scale) {
  return PackArgs{T_len, B, H, pl.seqs, (int)pl.tiles, (65536 + T_len - 1) / T_len, o_bs, o_ts,
                  scale * kLog2e};
}

template <typename T, int D>
int fwd_packed(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int T_len, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts,
               int64_t o_bs, int64_t o_ts, float scale, cudaStream_t stream) {
  constexpr int NWG = PackCfg<T>::kFwdWG, smem = PackFwdSmem<T, D>::kBytes;
  static_assert(smem <= kSmemLimit, "the packed forward's ring fits one block");
  const auto kern = fwd_packed_kernel<T, D>;
  cudaError_t err = prepare<T, D, 3, NWG>((const void*)kern, smem);
  if (err != cudaSuccess) return (int)err;
  const Plan pl = plan_of(D, T_len, B, H);
  if (pl.tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!get_map<T>(&mq, {q, q_ts, q_bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mk, {k, kv_ts, kv_bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mv, {v, kv_ts, kv_bs, D, H, T_len, B, T_len, pl.seqs}))
    return (int)cudaErrorNotSupported;
  const int grid = (int)(pl.tiles < sm_count() ? pl.tiles : sm_count());
  kern<<<grid, kThreadsOf<NWG>, smem, stream>>>(mq, mk, mv, static_cast<T*>(o), lse,
                                                pack_args(pl, B, H, T_len, o_bs, o_ts, scale));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_packed(const void* q, const void* k, const void* v, const BwdArgs& a, int B, int H,
               cudaStream_t stream) {
  constexpr int NWG = PackCfg<T>::kBwdWG, smem = PackBwdSmem<T, D>::kBytes;
  static_assert(smem <= kSmemLimit, "the packed backward's ring fits one block");
  const auto kern = bwd_packed_kernel<T, D>;
  cudaError_t err = prepare<T, D, 4, NWG>((const void*)kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int T_len = a.T_len;
  const Plan pl = plan_of(D, T_len, B, H);
  if (pl.tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mg, mo, mdq, mdk, mdv;
  if (!get_map<T>(&mq, {q, a.ts, a.bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mk, {k, a.ts, a.bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mv, {v, a.ts, a.bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mg, {a.dout, a.o_ts, a.o_bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mo, {a.o, a.o_ts, a.o_bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mdq, {a.dq, a.ts, a.bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mdk, {a.dk, a.ts, a.bs, D, H, T_len, B, T_len, pl.seqs}) ||
      !get_map<T>(&mdv, {a.dv, a.ts, a.bs, D, H, T_len, B, T_len, pl.seqs}))
    return (int)cudaErrorNotSupported;
  const int grid = (int)(pl.tiles < sm_count() ? pl.tiles : sm_count());
  kern<<<grid, kThreadsOf<NWG>, smem, stream>>>(
      mq, mk, mv, mg, mo, mdq, mdk, mdv, a, pack_args(pl, B, H, T_len, a.o_bs, a.o_ts, a.scale));
  return (int)cudaGetLastError();
}

// Head dim 24, instantiated in attention_wgmma_d24.cu (a translation unit
// of its own, compiled beside the other two): the packed form where
// plan_of says so, else the tiled kernels at D = 24.
template <typename T>
int fwd_d24(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
            int T_len, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts, int64_t o_bs,
            int64_t o_ts, float scale, cudaStream_t stream);
template <typename T>
int bwd_d24(const void* q, const void* k, const void* v, BwdArgs a, int B, int H,
            cudaStream_t stream);

// The forward's consumer warpgroups a block: one (64 query rows) while
// blocks of 64 rows do not outnumber the SMs, so that each takes an SM of
// its own; else two (128 rows, sharing each walked tile; an SM holds one
// block either way).
inline int fwd_warpgroups(int B, int H, int T_len) {
  return (int64_t)((T_len + kRows - 1) / kRows) * H * B > sm_count() ? 2 : 1;
}

template <typename T, int D, int NWG>
int fwd_run(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
            int T_len, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts, int64_t o_bs,
            int64_t o_ts, float scale, cudaStream_t stream) {
  const auto kern = fwd_kernel<T, D, NWG>;
  constexpr int smem = FwdSmem<T, D, kFwdStages<T, D, NWG>, NWG>::kBytes;
  static_assert(smem <= kSmemLimit, "the forward's tiles fit one block");
  cudaError_t err = prepare<T, D, 0, NWG>((const void*)kern, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int KT = Cfg<T, D>::kFwdKT, QR = kRows * NWG;
  CUtensorMap mq, mk, mv;
  if (!get_map<T>(&mq, {q, q_ts, q_bs, D, H, T_len, B, QR, 1}) ||
      !get_map<T>(&mk, {k, kv_ts, kv_bs, D, H, T_len, B, KT, 1}) ||
      !get_map<T>(&mv, {v, kv_ts, kv_bs, D, H, T_len, B, KT, 1}))
    return (int)cudaErrorNotSupported;
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const dim3 grid((T_len + QR - 1) / QR, H, B - b0 < kMaxGridZ ? B - b0 : kMaxGridZ);
    kern<<<grid, kThreadsOf<NWG>, smem, stream>>>(mq, mk, mv, static_cast<T*>(o), lse, T_len,
                                                   b0, o_bs, o_ts, scale * kLog2e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, int D>
int fwd_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
          int T_len, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts, int64_t o_bs,
          int64_t o_ts, float scale, cudaStream_t stream) {
  if (fwd_warpgroups(B, H, T_len) == 2)
    return fwd_run<T, D, 2>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
                            scale, stream);
  return fwd_run<T, D, 1>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
                          scale, stream);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int T_len, int D, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts,
               int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  if (bad_args(B, H, T_len, D, {q, k, v, o}, {q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts},
               (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 24: return fwd_d24<T>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale, s);
    case 64: return fwd_d<T, 64>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale, s);
    case 96: return fwd_d<T, 96>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale, s);
    case 128: return fwd_d<T, 128>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale, s);
    default: return fwd_d<T, 192>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale, s);
  }
}

template <typename T, int D>
int bwd_d(const void* q, const void* k, const void* v, BwdArgs a, int B, int H,
          cudaStream_t stream) {
  using C = Cfg<T, D>;
  const auto kdq = dq_kernel<T, D>;
  const auto kdkv = dkv_kernel<T, D>;
  constexpr int smem_dq = DqSmem<T, D, kDqStages<T, D>>::kBytes;
  constexpr int smem_dkv = DkvSmem<T, D, kDkvStages<T, D>>::kBytes;
  static_assert(smem_dq <= kSmemLimit && smem_dkv <= kSmemLimit,
                "the backward's tiles fit one block");
  cudaError_t err = prepare<T, D, 1, C::kDqWG>((const void*)kdq, smem_dq);
  if (err == cudaSuccess) err = prepare<T, D, 2, C::kDkvWG>((const void*)kdkv, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  constexpr int KT = C::kBwdKT, QR = kRows * C::kDqWG, KR = KT * C::kDkvWG;
  const int T_len = a.T_len;
  // dQ: own Q and dO (QR rows), walked K and V (KT); dK/dV: own K and V
  // (KR rows), walked Q and dO (64)
  CUtensorMap q1, g1, k1, v1, q2, g2, k2, v2;
  if (!get_map<T>(&q1, {q, a.ts, a.bs, D, H, T_len, B, QR, 1}) ||
      !get_map<T>(&g1, {a.dout, a.o_ts, a.o_bs, D, H, T_len, B, QR, 1}) ||
      !get_map<T>(&k1, {k, a.ts, a.bs, D, H, T_len, B, KT, 1}) ||
      !get_map<T>(&v1, {v, a.ts, a.bs, D, H, T_len, B, KT, 1}) ||
      !get_map<T>(&q2, {q, a.ts, a.bs, D, H, T_len, B, kRows, 1}) ||
      !get_map<T>(&g2, {a.dout, a.o_ts, a.o_bs, D, H, T_len, B, kRows, 1}) ||
      !get_map<T>(&k2, {k, a.ts, a.bs, D, H, T_len, B, KR, 1}) ||
      !get_map<T>(&v2, {v, a.ts, a.bs, D, H, T_len, B, KR, 1}))
    return (int)cudaErrorNotSupported;
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const int nb = B - b0 < kMaxGridZ ? B - b0 : kMaxGridZ;
    a.b0 = b0;
    kdq<<<dim3((T_len + QR - 1) / QR, H, nb), kThreadsOf<C::kDqWG>, smem_dq, stream>>>(
        q1, g1, k1, v1, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kdkv<<<dim3((T_len + KR - 1) / KR, H, nb), kThreadsOf<C::kDkvWG>, smem_dkv, stream>>>(
        q2, g2, k2, v2, a);
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
  if (lse == nullptr || delta == nullptr ||
      bad_args(B, H, T_len, D, {q, k, v, o, dout, dq, dk, dv}, {bs, ts, o_bs, o_ts},
               (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{o, dout, lse, delta, dq, dk, dv, bs, ts, o_bs, o_ts, T_len, 0, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 24: return bwd_d24<T>(q, k, v, a, B, H, s);
    case 64: return bwd_d<T, 64>(q, k, v, a, B, H, s);
    case 96: return bwd_d<T, 96>(q, k, v, a, B, H, s);
    case 128: return bwd_d<T, 128>(q, k, v, a, B, H, s);
    default: return bwd_d<T, 192>(q, k, v, a, B, H, s);
  }
}

}  // namespace attn_wg
