// K1 in bf16 past head dim 256 on the route "dchunk_wgmma_cp_async_ws":
// every D % 8 != 0 past 256 (a row stride TMA cannot take), the kernel of
// flash_attn_dchunk_fwd_wgmma.cuh with its boxes filled by the producer
// warpgroup: cp.async at even D, loads through registers at odd D.
// Replaces ray_tpu/ops/attention.py::_flash_kernel (launched by
// _pallas_fwd) for those inputs.

#include "flash_attn_dchunk_fwd_wgmma.cuh"

namespace rtt {

cudaError_t fwd_dchunk_wgmma_cp_async(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int H, int Sq, int Sk, int D,
                                      int causal, float scale,
                                      cudaStream_t stream) {
  if (!dchunk_unaligned_head_dim(D)) return cudaErrorInvalidValue;
  return fwd_dchunk_feed<FEED_CP_ASYNC>(q, k, v, out, lse, B, H, Sq, Sk, D,
                                        causal, scale, stream);
}

}  // namespace rtt
