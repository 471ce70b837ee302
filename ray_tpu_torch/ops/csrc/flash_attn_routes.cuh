// The routes of K1, K2 and K3 past the wgmma kernels at head_dim 64 and
// 128, each in its own translation unit so that nvcc compiles them side by
// side: all three on wgmma at the padded head dims, the mma.sync (bf16)
// and FMA (fp32) kernels, and past 256 the head-dim-chunked kernels of
// both dtypes. The C entry points in flash_attn_fwd.cu and
// flash_attn_bwd.cu dispatch to them. The mma.sync and FMA routes take
// any head dim D in [1, MAX_HEAD_DIM] (flash_attn_common.cuh), the padded
// wgmma route the D that wgmma_padded_head_dim admits, the chunked routes
// every D past 256 (K1 in bf16 on wgmma at the D dchunk_wgmma_head_dim
// admits); each returns a cudaError_t (cudaErrorInvalidValue for
// a D outside its set).
//
// Layouts as the C entry points': q/dout/out/dq [B,Sq,H,D], k/v/dk/dv
// [B,Sk,H,D], contiguous with a 16-byte aligned base; lse and delta
// [B,H,Sq] float32.

#pragma once

#include <cuda_runtime.h>

namespace rtt {

// K1, bf16 on mma.sync (flash_attn_fwd_mma.cu)
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int H, int Sq, int Sk, int D,
                    int causal, float scale, cudaStream_t stream);
// K1, fp32 on the CUDA cores (flash_attn_fwd_fma.cu)
cudaError_t fwd_fma(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int H, int Sq, int Sk, int D,
                    int causal, float scale, cudaStream_t stream);
// K2, bf16 on mma.sync (flash_attn_bwd_dq_mma.cu)
cudaError_t bwd_dq_mma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, int B, int H, int Sq,
                       int Sk, int D, int causal, float scale,
                       cudaStream_t stream);
// K3, bf16 on mma.sync (flash_attn_bwd_dkdv_mma.cu)
cudaError_t bwd_dkdv_mma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B,
                         int H, int Sq, int Sk, int D, int causal,
                         float scale, cudaStream_t stream);
// The head dims K1, K2 and K3 take on wgmma at a padded width in bf16:
// D % 8 == 0 (TMA's 16-byte row stride), 64 < D <= 256, D != 128 (64 and
// 128 have their own instantiations in flash_attn_fwd.cu and
// flash_attn_bwd.cu)
constexpr bool wgmma_padded_head_dim(int D) {
  return D % 8 == 0 && D > 64 && D <= 256 && D != 128;
}
// K1, bf16 on wgmma at those head dims (flash_attn_fwd_padded.cu)
cudaError_t fwd_padded(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int Sq, int Sk,
                       int D, int causal, float scale, cudaStream_t stream);
// K2, bf16 on wgmma at those head dims (flash_attn_bwd_dq_padded.cu)
cudaError_t bwd_dq_padded(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int H, int Sq,
                          int Sk, int D, int causal, float scale,
                          cudaStream_t stream);
// K3, bf16 on wgmma at those head dims (flash_attn_bwd_dkdv_padded.cu)
cudaError_t bwd_dkdv_padded(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B,
                            int H, int Sq, int Sk, int D, int causal,
                            float scale, cudaStream_t stream);
// K2 and K3, fp32 on the CUDA cores (flash_attn_bwd_fma.cu)
cudaError_t bwd_dq_fma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, int B, int H, int Sq,
                       int Sk, int D, int causal, float scale,
                       cudaStream_t stream);
cudaError_t bwd_dkdv_fma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B,
                         int H, int Sq, int Sk, int D, int causal,
                         float scale, cudaStream_t stream);

// The head dims K1, K2 and K3 take on the chunked routes: every D past
// 256 (the per-head-dim routes' widest), in bf16 and in fp32
constexpr bool dchunk_head_dim(int D) { return D > 256; }
// The bf16 head dims K1 takes on wgmma past 256: D % 8 == 0 (TMA's
// 16-byte row stride); the rest stay on fwd_dchunk_mma
constexpr bool dchunk_wgmma_head_dim(int D) { return D > 256 && D % 8 == 0; }
// K1 in bf16 on wgmma at those head dims, a block per output slice of up
// to 256 columns (flash_attn_dchunk_fwd_wgmma.cu)
cudaError_t fwd_dchunk_wgmma(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int H, int Sq,
                             int Sk, int D, int causal, float scale,
                             cudaStream_t stream);
// K1 in bf16 on mma.sync at the other head dims past 256, K2 and K3 in
// bf16 at every head dim past 256 (flash_attn_dchunk.cu)
cudaError_t fwd_dchunk_mma(const void* q, const void* k, const void* v,
                           void* out, float* lse, int B, int H, int Sq,
                           int Sk, int D, int causal, float scale,
                           cudaStream_t stream);
cudaError_t bwd_dq_dchunk_mma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int H,
                              int Sq, int Sk, int D, int causal, float scale,
                              cudaStream_t stream);
cudaError_t bwd_dkdv_dchunk_mma(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Sk, int D, int causal,
                                float scale, cudaStream_t stream);
// K1, K2 and K3 in fp32 on the CUDA cores at those head dims
// (flash_attn_dchunk_fma.cu; K1 a block per output slice of up to 256
// columns)
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
