// K3 (flash-attention dk/dv backward) in fp32 at head dims 1..256 on the
// route "fma_f32_ring": the register-blocked kernel of
// flash_attn_ring_f32.cuh fed by its cp.async ring, one slice (all of D)
// a block, the block's keys of K and V resident in shared memory, Q and
// dO streamed, S^T and dP^T computed once a tile pair. Replaces
// ray_tpu/ops/attention.py::_bwd_dkdv_kernel (launched by _pallas_bwd) for
// those inputs. Shapes (one_slice_shape<64>): 64 keys a block (8 a
// thread: S^T and dP^T 10.7 FMAs a 16-byte load, dK and dV 16 at 64
// columns) up to 64 columns, where dK's and dV's registers (2 x 8 x 4
// NCG) leave room, 32 past; the head-dim step and column group D rounded
// up to 16, 32 or 64 under 64. At B2 S2048 H16 D128 causal the work is
// 68.7 GFLOP, 1.026 ms at 67 TFLOP/s.

#include "flash_attn_ring_f32.cuh"

namespace rtt {

cudaError_t bwd_dkdv_fma_ring(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int causal,
                              float scale, cudaStream_t stream) {
  if (!fma_ring_head_dim(D)) return cudaErrorInvalidValue;
  return one_slice_shape<64>(D, [&](auto shape) {
    return bwd_ring_at<decltype(shape), true>(q, k, v, dout, lse, delta, dk,
                                              dv, B, H, Sq, Sk, D, causal,
                                              scale, stream);
  });
}

}  // namespace rtt
