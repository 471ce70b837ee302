// K1 in bf16 on the route "wgmma_tma_ws_padded": every D % 8 == 0 up to
// 256 but 64 and 128, the padded kernel (flash_attn_fwd_padded.cuh) with
// its boxes filled by TMA. Replaces ray_tpu/ops/attention.py::
// _flash_kernel (launched by _pallas_fwd) for those inputs.

#include "flash_attn_fwd_padded.cuh"

namespace rtt {

cudaError_t fwd_padded(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int Sq, int Sk,
                       int D, int causal, float scale, cudaStream_t stream) {
  if (!wgmma_padded_head_dim(D)) return cudaErrorInvalidValue;
  return fwd_padded_feed<FEED_TMA>(q, k, v, out, lse, B, H, Sq, Sk, D,
                                   causal, scale, stream);
}

}  // namespace rtt
