// K1 (flash-attention forward) in fp32 past head dim 256 on the route
// "dchunk_fma_f32_ring": every D, with no upper bound, the
// register-blocked kernel of flash_attn_ring_f32.cuh fed by its cp.async
// ring, a block per 32 q rows and output slice of up to 320 columns, the
// q rows streamed beside each S step. Replaces
// ray_tpu/ops/attention.py::_flash_kernel (launched by _pallas_fwd) for
// those inputs. At the kernel phase's B1 S1000 H4 D320 row the work is
// 2.6 GFLOP, 0.038 ms at 67 TFLOP/s. What holds it back (PERF.md):
// shared memory. S's 4 x 4 blocking gives 8 FMAs a 16-byte load (at most
// half the FMA rate), P V's 13.3 at 5 column groups; a larger S block
// needs more keys a tile or more rows a thread, and O's registers (16 NCG:
// 80 at 320 columns) leave no room for either.
// ptxas (sm_90a, on the H100 host; tools/check_head_dims.py): 196-236
// registers (one block of 256 threads an SM), no spills.

#include "flash_attn_ring_f32.cuh"

cudaError_t rtt::fwd_dchunk_fma(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int H, int Sq,
                                int Sk, int D, int causal, float scale,
                                cudaStream_t stream) {
  if (!dchunk_head_dim(D)) return cudaErrorInvalidValue;
  return dchunk_shape(D, [&](auto shape) {
    return fwd_ring_at<decltype(shape)>(q, k, v, out, lse, B, H, Sq, Sk, D,
                                        causal, scale, stream);
  });
}
