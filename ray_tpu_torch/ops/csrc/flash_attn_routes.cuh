// The routes of K1, K2 and K3 past the wgmma kernels at head_dim 64 and
// 128, each in its own translation unit so that nvcc compiles them side by
// side: in bf16 all three on wgmma at every other head dim (their boxes
// filled by TMA where the row stride is a multiple of 16 bytes, by
// cp.async or through registers where not; up to 256 and past it), so a
// head dim takes the same route for all three; in fp32 all three on the
// register-blocked ring kernels (flash_attn_ring_f32.cuh) at every head
// dim. The C entry points in flash_attn_fwd.cu and flash_attn_bwd.cu
// dispatch to them. Each route takes the D its constexpr below admits
// and returns a cudaError_t (cudaErrorInvalidValue for a D outside its
// set). attention.py::kernel_route is the same table in Python.
//
// Layouts as the C entry points': q/dout/out/dq [B,Sq,H,D], k/v/dk/dv
// [B,Sk,H,D], contiguous with a 16-byte aligned base; lse and delta
// [B,H,Sq] float32.

#pragma once

#include <cuda_runtime.h>

namespace rtt {

// The fp32 head dims K1, K2 and K3 take on their ring kernels in one
// slice (route "fma_f32_ring"): every D up to 256
constexpr bool fma_ring_head_dim(int D) { return D >= 1 && D <= 256; }
// K1, K2 and K3 in fp32 at those head dims: register-blocked FMAs fed by
// a cp.async ring, the block's own rows resident
// (flash_attn_fwd_fma_ring.cu, flash_attn_bwd_dq_fma_ring.cu and
// flash_attn_bwd_dkdv_fma_ring.cu; K1's kernel and K2's and K3's in
// flash_attn_ring_f32.cuh)
cudaError_t fwd_fma_ring(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int H, int Sq, int Sk,
                         int D, int causal, float scale, cudaStream_t stream);
cudaError_t bwd_dq_fma_ring(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int H,
                            int Sq, int Sk, int D, int causal, float scale,
                            cudaStream_t stream);
cudaError_t bwd_dkdv_fma_ring(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int causal,
                              float scale, cudaStream_t stream);
// The bf16 head dims K1, K2 and K3 take on their padded wgmma kernels
// fed by TMA: D % 8 == 0 (TMA's 16-byte row stride) up to 256 but 64 and
// 128 (their own instantiations in flash_attn_fwd.cu and
// flash_attn_bwd.cu), the ones under 64 in a 64-column box that TMA fills
// with zeros past D
constexpr bool wgmma_padded_head_dim(int D) {
  return D % 8 == 0 && D >= 1 && D <= 256 && D != 64 && D != 128;
}
// ... and fed by cp.async (or through registers at odd D): D % 8 != 0 up
// to 256, a row stride TMA cannot take
constexpr bool wgmma_padded_cp_async_head_dim(int D) {
  return D % 8 != 0 && D >= 1 && D <= 256;
}
// K1, bf16 on wgmma at those head dims (flash_attn_fwd_padded.cu and
// flash_attn_fwd_padded_cp_async.cu, one kernel in
// flash_attn_fwd_padded.cuh)
cudaError_t fwd_padded(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int Sq, int Sk,
                       int D, int causal, float scale, cudaStream_t stream);
cudaError_t fwd_padded_cp_async(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int H, int Sq,
                                int Sk, int D, int causal, float scale,
                                cudaStream_t stream);
// K2, bf16 on wgmma at those head dims (flash_attn_bwd_dq_padded.cu and
// flash_attn_bwd_dq_padded_cp_async.cu, one kernel in
// flash_attn_bwd_dq_ws.cuh)
cudaError_t bwd_dq_padded(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int H, int Sq,
                          int Sk, int D, int causal, float scale,
                          cudaStream_t stream);
cudaError_t bwd_dq_padded_cp_async(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int H, int Sq, int Sk,
                                   int D, int causal, float scale,
                                   cudaStream_t stream);
// K3, bf16 on wgmma at those head dims (flash_attn_bwd_dkdv_padded.cu and
// flash_attn_bwd_dkdv_padded_cp_async.cu, one kernel in
// flash_attn_bwd_dkdv_padded.cuh)
cudaError_t bwd_dkdv_padded(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B,
                            int H, int Sq, int Sk, int D, int causal,
                            float scale, cudaStream_t stream);
cudaError_t bwd_dkdv_padded_cp_async(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int B, int H,
                                     int Sq, int Sk, int D, int causal,
                                     float scale, cudaStream_t stream);
// The head dims past 256 (the per-head-dim routes' widest), in bf16 and
// in fp32, with no upper bound
constexpr bool dchunk_head_dim(int D) { return D > 256; }
// The bf16 head dims K1, K2 and K3 take on wgmma past 256 fed by TMA: D %
// 8 == 0 (TMA's 16-byte row stride) ...
constexpr bool dchunk_wgmma_head_dim(int D) { return D > 256 && D % 8 == 0; }
// ... and the rest, whose rows TMA cannot stride: all three on wgmma fed
// by cp.async (or through registers at odd D)
constexpr bool dchunk_unaligned_head_dim(int D) {
  return D > 256 && D % 8 != 0;
}
// K1 in bf16 on wgmma at those head dims, a block per output slice of up
// to 256 columns (flash_attn_dchunk_fwd_wgmma.cu and
// flash_attn_dchunk_fwd_cp_async.cu, one kernel in
// flash_attn_dchunk_fwd_wgmma.cuh)
cudaError_t fwd_dchunk_wgmma(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int H, int Sq,
                             int Sk, int D, int causal, float scale,
                             cudaStream_t stream);
cudaError_t fwd_dchunk_wgmma_cp_async(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int H, int Sq, int Sk, int D,
                                      int causal, float scale,
                                      cudaStream_t stream);
// K2 and K3 in bf16 on wgmma at those head dims, a block per slice of up
// to 256 columns of dq, 128 of dk and dv, fed by TMA at the first set
// (flash_attn_dchunk_bwd_dq_wgmma.cu, flash_attn_dchunk_bwd_dkdv_wgmma.cu)
// and by cp.async at the second (flash_attn_dchunk_bwd_dq_cp_async.cu,
// flash_attn_dchunk_bwd_dkdv_cp_async.cu), one kernel in
// flash_attn_dchunk_bwd_wgmma.cuh
cudaError_t bwd_dq_dchunk_wgmma(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int B, int H,
                                int Sq, int Sk, int D, int causal,
                                float scale, cudaStream_t stream);
cudaError_t bwd_dkdv_dchunk_wgmma(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Sk, int D, int causal, float scale,
                                  cudaStream_t stream);
cudaError_t bwd_dq_dchunk_wgmma_cp_async(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, int causal, float scale, cudaStream_t stream);
cudaError_t bwd_dkdv_dchunk_wgmma_cp_async(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, int causal, float scale, cudaStream_t stream);
// K1, K2 and K3 in fp32 on the CUDA cores at every head dim past 256,
// register-blocked FMAs fed by cp.async rings, a block per output slice
// of up to 320 columns (K1 flash_attn_dchunk_fma.cu; K2 and K3
// flash_attn_dchunk_bwd_dq_fma.cu and flash_attn_dchunk_bwd_dkdv_fma.cu;
// the kernels in flash_attn_ring_f32.cuh)
cudaError_t fwd_dchunk_fma(const void* q, const void* k, const void* v,
                           void* out, float* lse, int B, int H, int Sq,
                           int Sk, int D, int causal, float scale,
                           cudaStream_t stream);
cudaError_t bwd_dq_dchunk_fma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int H,
                              int Sq, int Sk, int D, int causal, float scale,
                              cudaStream_t stream);
cudaError_t bwd_dkdv_dchunk_fma(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Sk, int D, int causal,
                                float scale, cudaStream_t stream);

}  // namespace rtt
