// Helpers shared by the flash-attention kernels (flash_attn_*.cu): bf16
// packing, cp.async group commits and waits, the row loader and products
// of K2's FMA route, the bf16 row stores, and the dispatch of a head dim
// to its padded instantiation.
// Each .cu file includes this once; everything here is inline code in an
// anonymous namespace, so the translation units do not share symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr float NEG_INF = -1e30f;  // the JAX package's _NEG_INF
constexpr int PAD = 4;             // fp32 elements of row padding

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// two floats -> packed bf16x2, the first in the low half (lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Any head dim D in [1, MAX_HEAD_DIM] on K2's FMA route: its kernel is
// instantiated at a padded head dim DP (D rounded up to 32) and told the
// real D. Loads fill the columns past D with zeros in shared memory (they
// add nothing to q.k or p.v), stores drop them. A row whose byte width is
// a multiple of 16 (D % 4 == 0) starts on the 16-byte grid and is copied
// 16 bytes at a time; any other row element by element.
// ---------------------------------------------------------------------------

constexpr int MAX_HEAD_DIM = 256;

constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <int STEP, class F, int... I>
cudaError_t dispatch_padded(int dp, F& f, std::integer_sequence<int, I...>) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dp == STEP * (I + 1)
              ? (err = f(std::integral_constant<int, STEP * (I + 1)>{}), true)
              : false) ||
         ...);
  return err;
}

// f(std::integral_constant<int, DP>{}) with DP = D rounded up to STEP
template <int STEP, class F>
cudaError_t with_padded_dim(int D, F&& f) {
  if (D < 1 || D > MAX_HEAD_DIM) return cudaErrorInvalidValue;
  return dispatch_padded<STEP>(
      round_up(D, STEP), f,
      std::make_integer_sequence<int, MAX_HEAD_DIM / STEP>{});
}

// rows [r0, r0 + ROWS) x columns [0, DP) of one head of a [S, H, D] fp32
// tensor (``src`` at the head's first element, ``row_stride`` = H * D)
// into shared rows of DP + PAD floats; rows past S and columns past D are
// zeros
template <int ROWS, int DP, int NTHREADS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long row_stride, int r0, int S,
                                              int D, int tid) {
  constexpr int LD = DP + PAD;
  if ((D & 3) == 0) {
    constexpr int CH = DP / 4;
    for (int i = tid; i < ROWS * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      float4 x = {};
      if (r0 + r < S && c < D) x = ld4(src + (r0 + r) * row_stride + c);
      *reinterpret_cast<float4*>(dst + r * LD + c) = x;
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] =
          r0 + r < S && c < D ? src[(r0 + r) * row_stride + c] : 0.f;
    }
  }
}

// K2's FMA route's two products, for warps of FMA_ROWS rows over fp32 row
// tiles of DP + PAD floats in shared memory (flash_attn_bwd_fma.cu).
constexpr int FMA_ROWS = 8;

// rows x columns (lane + 32 j) dot products of two row sets sharing the
// head dim: out[r][j] += A[r0 + r] . B[lane + 32 j]
template <int DP, int NC>
__device__ __forceinline__ void row_dots(float (&out)[FMA_ROWS][NC],
                                         const float* A, int r0,
                                         const float* B, int lane) {
  constexpr int LD = DP + PAD;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 bv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) bv[j] = ld4(B + (lane + 32 * j) * LD + c);
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      const float4 x = ld4(A + (r0 + r) * LD + c);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        out[r][j] = fmaf(x.x, bv[j].x, out[r][j]);
        out[r][j] = fmaf(x.y, bv[j].y, out[r][j]);
        out[r][j] = fmaf(x.z, bv[j].z, out[r][j]);
        out[r][j] = fmaf(x.w, bv[j].w, out[r][j]);
      }
    }
  }
}

// acc[r][i] += sum_j W[r][j] * X[j][lane*DPL + i] over a TILE-wide slab W
// (this warp's rows) and a row set X
template <int DP, int TILE>
__device__ __forceinline__ void slab_product(
    float (&acc)[FMA_ROWS][DP / 32], const float* W, const float* X,
    int lane) {
  constexpr int LD = DP + PAD;
  constexpr int DPL = DP / 32;
#pragma unroll 2
  for (int j = 0; j < TILE; ++j) {
    const float* x = X + j * LD + lane * DPL;
    float xv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) xv[i] = x[i];
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      const float w = W[r * TILE + j];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(w, xv[i], acc[r][i]);
    }
  }
}

// columns c and c + 1 (c even) of a bf16 row, those under n: one 4-byte
// store when `pairs` (the row starts 4-byte aligned and n is even), else
// one element at a time
__device__ __forceinline__ void store_pair_bf16(__nv_bfloat16* row, int c,
                                                int n, bool pairs, float lo,
                                                float hi) {
  if (pairs) {
    if (c < n) *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(lo, hi);
  } else {
    if (c < n) row[c] = __float2bfloat16_rn(lo);
    if (c + 1 < n) row[c + 1] = __float2bfloat16_rn(hi);
  }
}

// the same over a whole row of D values: pairs when D is even (the row
// then starts 4-byte aligned); columns past D are dropped
__device__ __forceinline__ void store_pair_bf16(__nv_bfloat16* row, int c,
                                                int D, float lo, float hi) {
  store_pair_bf16(row, c, D, (D & 1) == 0, lo, hi);
}

}  // namespace
