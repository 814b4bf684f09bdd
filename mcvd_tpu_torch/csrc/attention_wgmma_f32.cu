// attention_fwd and attention_bwd on wgmma, fp32: the C entry points of the
// kernels in attention_wgmma.cuh (head dims 64, 96, 128, 192 here; 24
// through attention_wgmma_d24.cu), one nvcc process of their own.

#include "attention_wgmma.cuh"

extern "C" {

int attention_fwd_wgmma_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int H, int T, int D, int64_t q_bs, int64_t q_ts,
                            int64_t kv_bs, int64_t kv_ts, int64_t o_bs, int64_t o_ts,
                            float scale, void* stream) {
  return attn_wg::launch_fwd<float>(q, k, v, o, lse, B, H, T, D, q_bs, q_ts, kv_bs, kv_ts,
                                    o_bs, o_ts, scale, stream);
}

int attention_bwd_wgmma_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, void* dq, void* dk, void* dv,
                            float* delta, int B, int H, int T, int D, int64_t bs, int64_t ts,
                            int64_t o_bs, int64_t o_ts, float scale, void* stream) {
  return attn_wg::launch_bwd<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, T, D,
                                    bs, ts, o_bs, o_ts, scale, stream);
}

}  // extern "C"
