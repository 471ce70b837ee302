// K1 (flash-attention forward) in fp32 at head dims 1..256 on the route
// "fma_f32_ring": the register-blocked kernel of flash_attn_ring_f32.cuh
// fed by its cp.async ring, one slice (all of D) a block, Q resident in
// shared memory, K and V streamed. Replaces
// ray_tpu/ops/attention.py::_flash_kernel (launched by _pallas_fwd) for
// those inputs. Shapes (one_slice_shape<128>): 64 q rows a block (S
// blocked 8 x 4 a thread: 10.7 FMAs a 16-byte load) up to 128 columns,
// 32 past; the head-dim step and column group D rounded up to 16, 32 or
// 64 under 64. At B2 S2048 H16 D128 causal the work is 34.4 GFLOP,
// 0.513 ms at 67 TFLOP/s; at ModelConfig.debug's B2 S128 H4 D16 the
// launch sets the time.

#include "flash_attn_ring_f32.cuh"

cudaError_t rtt::fwd_fma_ring(const void* q, const void* k, const void* v,
                              void* out, float* lse, int B, int H, int Sq,
                              int Sk, int D, int causal, float scale,
                              cudaStream_t stream) {
  if (!fma_ring_head_dim(D)) return cudaErrorInvalidValue;
  return one_slice_shape<128>(D, [&](auto shape) {
    return fwd_ring_at<decltype(shape)>(q, k, v, out, lse, B, H, Sq, Sk, D,
                                        causal, scale, stream);
  });
}
