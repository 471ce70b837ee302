// K2 (flash-attention dq backward) in bf16 on wgmma at the padded head
// dims: D % 8 == 0, 64 < D <= 256, D != 128. Replaces
// ray_tpu/ops/attention.py::_bwd_dq_kernel for those inputs. The kernel is
// bwd_dq_ws_kernel (flash_attn_bwd_dq_ws.cuh), instantiated here at DP = D
// rounded up to 32 (96, 128, 160, 192, 224, 256) in a translation unit of
// its own, so that nvcc builds it beside flash_attn_bwd.cu; DP 128 serves
// D 104..120 (D 128 itself takes flash_attn_bwd.cu's instantiation).
// flash_attn_bwd.cu's header gives the design and its ptxas numbers.

#include "flash_attn_bwd_dq_ws.cuh"
#include "flash_attn_routes.cuh"

namespace rtt {

cudaError_t bwd_dq_padded(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int H, int Sq,
                          int Sk, int D, int causal, float scale,
                          cudaStream_t stream) {
  if (!wgmma_padded_head_dim(D)) return cudaErrorInvalidValue;
  const auto launch = [&](auto launcher) {
    return launcher(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v),
                    static_cast<const bf16*>(dout), lse, delta,
                    static_cast<bf16*>(dq), B, H, Sq, Sk, D, causal, scale,
                    stream);
  };
  switch ((D + 31) / 32 * 32) {
    case 96: return launch(&launch_dq_ws<96, false>);
    case 128: return launch(&launch_dq_ws<128, false>);
    case 160: return launch(&launch_dq_ws<160, false>);
    case 192: return launch(&launch_dq_ws<192, false>);
    case 224: return launch(&launch_dq_ws<224, false>);
    default: return launch(&launch_dq_ws<256, false>);
  }
}

}  // namespace rtt
