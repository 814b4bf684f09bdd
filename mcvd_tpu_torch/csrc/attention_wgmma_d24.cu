// attention_fwd and attention_bwd at head dim 24 (the 3D family's one-head
// attention): the instantiations of attention_wgmma.cuh at D = 24, in a
// translation unit of their own so that nvcc compiles them beside the bf16
// and fp32 files. The packed form takes T <= 64 (the time attention over 7
// or 2 frames, the 4-px space attention's 16 tokens), the tiled kernels the
// longer sequences (the 16-px space attention's 256); `plan_of` picks, and
// the C entry attention_plan_wgmma reports its choice to
// ops.attention.attention_plan's checks. The bf16 and fp32 entry points
// (attention_wgmma_bf16.cu, attention_wgmma_f32.cu) reach these through
// fwd_d24 and bwd_d24.

#include "attention_wgmma.cuh"

namespace attn_wg {

template <typename T>
int fwd_d24(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
            int T_len, int64_t q_bs, int64_t q_ts, int64_t kv_bs, int64_t kv_ts, int64_t o_bs,
            int64_t o_ts, float scale, cudaStream_t stream) {
  if (plan_of(24, T_len, B, H).packed)
    return fwd_packed<T, 24>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts,
                             scale, stream);
  return fwd_d<T, 24>(q, k, v, o, lse, B, H, T_len, q_bs, q_ts, kv_bs, kv_ts, o_bs, o_ts, scale,
                      stream);
}

template <typename T>
int bwd_d24(const void* q, const void* k, const void* v, BwdArgs a, int B, int H,
            cudaStream_t stream) {
  if (plan_of(24, a.T_len, B, H).packed) return bwd_packed<T, 24>(q, k, v, a, B, H, stream);
  return bwd_d<T, 24>(q, k, v, a, B, H, stream);
}

template int fwd_d24<float>(const void*, const void*, const void*, void*, float*, int, int, int,
                            int64_t, int64_t, int64_t, int64_t, int64_t, int64_t, float,
                            cudaStream_t);
template int fwd_d24<bf16>(const void*, const void*, const void*, void*, float*, int, int, int,
                           int64_t, int64_t, int64_t, int64_t, int64_t, int64_t, float,
                           cudaStream_t);
template int bwd_d24<float>(const void*, const void*, const void*, BwdArgs, int, int,
                            cudaStream_t);
template int bwd_d24<bf16>(const void*, const void*, const void*, BwdArgs, int, int,
                           cudaStream_t);

}  // namespace attn_wg

extern "C" {

// The plan of a call of head dim D over B sequences of T tokens and H
// heads: 1 packed, 0 tiled; the sequences a tile and the tiles.
int attention_plan_wgmma(int D, int T, int B, int H, int* seqs_per_tile, int64_t* tiles) {
  const attn_wg::Plan p = attn_wg::plan_of(D, T, B, H);
  *seqs_per_tile = p.seqs;
  *tiles = p.tiles;
  return p.packed ? 1 : 0;
}

// The message of a CUDA error code, for every wrapper of the library.
const char* mcvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
