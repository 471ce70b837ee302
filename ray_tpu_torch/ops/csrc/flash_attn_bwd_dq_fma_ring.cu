// K2 (flash-attention dq backward) in fp32 at head dims 1..256 on the
// route "fma_f32_ring": the register-blocked kernel of
// flash_attn_ring_f32.cuh fed by its cp.async ring, one slice (all of D)
// a block, the block's query rows of Q and dO resident in shared memory,
// K and V streamed, S and dP computed once a tile pair, dq += ds K over
// the tile's keys (at D <= 64 from the S step's K chunk). Replaces
// ray_tpu/ops/attention.py::_bwd_dq_kernel (launched by _pallas_bwd) for
// those inputs. Shapes (one_slice_shape<128>, as K1's): 64 q rows a
// block (8 a thread: S and dP 10.7 FMAs a 16-byte load) up to 128
// columns, where dq's 8 x 4 NCG registers beside S's and dP's 2 x 8 x 4
// and 16 lse/delta values still fit without a spill, 32 past; the
// head-dim step and column group D rounded up to 16, 32 or 64 under 64.
// At B2 S2048 H16 D128 causal the work is 51.6 GFLOP, 0.770 ms at 67
// TFLOP/s.

#include "flash_attn_ring_f32.cuh"

namespace rtt {

cudaError_t bwd_dq_fma_ring(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int H,
                            int Sq, int Sk, int D, int causal, float scale,
                            cudaStream_t stream) {
  if (!fma_ring_head_dim(D)) return cudaErrorInvalidValue;
  return one_slice_shape<128>(D, [&](auto shape) {
    return bwd_ring_at<decltype(shape), false>(q, k, v, dout, lse, delta, dq,
                                               nullptr, B, H, Sq, Sk, D,
                                               causal, scale, stream);
  });
}

}  // namespace rtt
