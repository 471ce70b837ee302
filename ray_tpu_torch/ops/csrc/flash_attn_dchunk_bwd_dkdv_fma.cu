// K3 (flash-attention dk/dv backward) in fp32 past head dim 256 on the
// route "dchunk_fma_f32_ring": every D, the register-blocked kernel of
// flash_attn_dchunk_ring_f32.cuh fed by its cp.async ring. Replaces
// ray_tpu/ops/attention.py::_bwd_dkdv_kernel (launched by _pallas_bwd) for
// those inputs.

#include "flash_attn_dchunk_ring_f32.cuh"

namespace rtt {

cudaError_t bwd_dkdv_dchunk_fma(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Sk, int D, int causal,
                                float scale, cudaStream_t stream) {
  return bwd_dchunk_ring<true>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                               Sk, D, causal, scale, stream);
}

}  // namespace rtt
