// K3 (flash-attention dk/dv backward) in bf16 on the route
// "wgmma_tma_ws_padded": every D % 8 == 0 up to 256 but 64 and 128, the
// kernel of flash_attn_bwd_dkdv_padded.cuh with its boxes filled by TMA
// (the ones under 64 in one 64-column box that TMA fills with zeros past
// D). Replaces ray_tpu/ops/attention.py::_bwd_dkdv_kernel for those
// inputs.

#include "flash_attn_bwd_dkdv_padded.cuh"

namespace rtt {

cudaError_t bwd_dkdv_padded(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B,
                            int H, int Sq, int Sk, int D, int causal,
                            float scale, cudaStream_t stream) {
  if (!wgmma_padded_head_dim(D)) return cudaErrorInvalidValue;
  return bwd_dkdv_padded_feed<FEED_TMA>(q, k, v, dout, lse, delta, dk, dv, B,
                                        H, Sq, Sk, D, causal, scale, stream);
}

}  // namespace rtt
