// K2 (flash-attention dq backward) in bf16 on the route
// "wgmma_cp_async_ws_padded": every D % 8 != 0 up to 256 (a row stride
// TMA cannot take), the kernel of flash_attn_bwd_dq_ws.cuh with its boxes
// filled by the producer warpgroups: cp.async at even D, loads through
// registers at odd D. Replaces ray_tpu/ops/attention.py::_bwd_dq_kernel
// for those inputs, and the mma.sync kernel that served them until it
// (64-row blocks of four 16-row warps, at about 1 % of the bound).

#include "flash_attn_bwd_dq_ws.cuh"
#include "flash_attn_routes.cuh"

namespace rtt {

cudaError_t bwd_dq_padded_cp_async(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int H, int Sq, int Sk,
                                   int D, int causal, float scale,
                                   cudaStream_t stream) {
  if (!wgmma_padded_cp_async_head_dim(D)) return cudaErrorInvalidValue;
  return bwd_dq_padded_feed<FEED_CP_ASYNC>(q, k, v, dout, lse, delta, dq, B,
                                           H, Sq, Sk, D, causal, scale,
                                           stream);
}

}  // namespace rtt
