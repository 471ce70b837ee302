// K2 (flash-attention dq backward) in fp32 past head dim 256 on the route
// "dchunk_fma_f32_ring": every D, the register-blocked kernel of
// flash_attn_ring_f32.cuh fed by its cp.async ring. Replaces
// ray_tpu/ops/attention.py::_bwd_dq_kernel (launched by _pallas_bwd) for
// those inputs.

#include "flash_attn_ring_f32.cuh"

namespace rtt {

cudaError_t bwd_dq_dchunk_fma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int H,
                              int Sq, int Sk, int D, int causal, float scale,
                              cudaStream_t stream) {
  if (!dchunk_head_dim(D)) return cudaErrorInvalidValue;
  return dchunk_shape(D, [&](auto shape) {
    return bwd_ring_at<decltype(shape), false>(q, k, v, dout, lse, delta, dq,
                                               nullptr, B, H, Sq, Sk, D,
                                               causal, scale, stream);
  });
}

}  // namespace rtt
