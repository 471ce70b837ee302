// K2 (flash-attention dq backward) in bf16 on the route
// "wgmma_tma_ws_padded": every D % 8 == 0 up to 256 but 64 and 128, the
// kernel of flash_attn_bwd_dq_ws.cuh with its boxes filled by TMA (the
// ones under 64 in one 64-column box that TMA fills with zeros past D).
// Replaces ray_tpu/ops/attention.py::_bwd_dq_kernel for those inputs.
// Instantiated here at DP = D rounded up to 32 (32 ... 256; DP 64 serves
// D 40..56, DP 128 D 104..120, D 64 and 128 themselves taking
// flash_attn_bwd.cu's instantiation) in a translation unit of its own, so
// that nvcc builds it beside flash_attn_bwd.cu. flash_attn_bwd.cu's header
// gives the design and its ptxas numbers.

#include "flash_attn_bwd_dq_ws.cuh"
#include "flash_attn_routes.cuh"

namespace rtt {

cudaError_t bwd_dq_padded(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int H, int Sq,
                          int Sk, int D, int causal, float scale,
                          cudaStream_t stream) {
  if (!wgmma_padded_head_dim(D)) return cudaErrorInvalidValue;
  return bwd_dq_padded_feed<FEED_TMA>(q, k, v, dout, lse, delta, dq, B, H,
                                      Sq, Sk, D, causal, scale, stream);
}

}  // namespace rtt
