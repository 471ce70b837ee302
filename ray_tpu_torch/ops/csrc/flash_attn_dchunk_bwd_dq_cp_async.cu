// K2 (flash-attention dq backward) in bf16 past head dim 256 on the route
// "dchunk_wgmma_cp_async_ws": every D % 8 != 0 past 256 (a row stride TMA
// cannot take), the kernel of flash_attn_dchunk_bwd_wgmma.cuh at slices of
// dq up to 256 columns, its boxes filled by the producer warpgroups:
// cp.async at even D, loads through registers at odd D. Replaces
// ray_tpu/ops/attention.py::_bwd_dq_kernel (launched by _pallas_bwd) for
// those inputs.

#include "flash_attn_dchunk_bwd_wgmma.cuh"

namespace rtt {

cudaError_t bwd_dq_dchunk_wgmma_cp_async(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, int causal, float scale, cudaStream_t stream) {
  return bwd_dchunk_feed<false, FEED_CP_ASYNC>(
      q, k, v, dout, lse, delta, dq, nullptr, B, H, Sq, Sk, D, causal, scale,
      stream);
}

}  // namespace rtt

// The layout K2 launches past 256 at a shape on this route, launching
// nothing (bwd_dchunk_feed's ``layout``: seven ints);
// tools/check_head_dims.py reads it. Returns a cudaError_t (0 on success).
extern "C" int rtt_flash_attn_bwd_dq_dchunk_cp_async_layout(
    int B, int H, int Sq, int Sk, int D, int* layout) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || !layout)
    return cudaErrorInvalidValue;
  return bwd_dchunk_feed<false, FEED_CP_ASYNC>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      B, H, Sq, Sk, D, 1, 1.0f, nullptr, layout);
}
