// K1 in bf16 on the route "wgmma_cp_async_ws_padded": every D % 8 != 0 up
// to 256 (a row stride TMA cannot take), the padded kernel
// (flash_attn_fwd_padded.cuh) with its boxes filled by the producer
// warpgroup: cp.async at even D, loads through registers at odd D.
// Replaces ray_tpu/ops/attention.py::_flash_kernel (launched by
// _pallas_fwd) for those inputs, and the mma.sync kernel that served them
// until it (its 16-row warps ran the key tiles one after another at the
// short rows where no wgmma kernel reached).

#include "flash_attn_fwd_padded.cuh"

namespace rtt {

cudaError_t fwd_padded_cp_async(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int H, int Sq,
                                int Sk, int D, int causal, float scale,
                                cudaStream_t stream) {
  if (!wgmma_padded_cp_async_head_dim(D)) return cudaErrorInvalidValue;
  return fwd_padded_feed<FEED_CP_ASYNC>(q, k, v, out, lse, B, H, Sq, Sk, D,
                                        causal, scale, stream);
}

}  // namespace rtt
