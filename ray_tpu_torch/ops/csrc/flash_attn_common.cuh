// Helpers shared by the flash-attention kernels (flash_attn_*.cu): warp
// reductions, the mma.sync bf16 tile product, ldmatrix fragment loads,
// cp.async copies, the row loaders and stores of the mma.sync and FMA
// routes, and the dispatch of a head dim to its padded instantiation.
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
constexpr int MMA_PAD = 8;         // bf16 elements of row padding

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> packed bf16x2, the first in the low half (lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 bf16 matrices from shared memory; lane l names row l%8 of
// matrix l/8. Without .trans lane (g,t) receives row g, columns 2t..2t+1
// of each; with .trans, rows 2t..2t+1 of column g (a B operand read from
// a row-major [k][n] tile).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16-byte global -> shared copy that bypasses registers; ``valid`` false
// writes zeros (the ragged edge past the sequence end)
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two 8x8 bf16 matrices from shared memory; lanes 0-15 name the rows
// (lane l: row l%8 of matrix l/8), as ldmatrix_x4's first two matrices
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// A-operand fragment of rows [row0, row0+16) x cols [col0, col0+16) of a
// row-major bf16 tile in shared memory (matrices: rows lo/hi x cols lo/hi)
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int row0, int col0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// acc[n] += A[rows wr..wr+16) . B[rows c + n*8 .. +8)^T over head dim DP,
// both row-major bf16 tiles in shared memory with rows of DP + MMA_PAD
// (S = Q K^T, dP = dO V^T, and their transposes in K3): one ldmatrix x4
// of B gives the fragments of two 16-wide steps (kk, kk+1), matrices
// (kk lo, kk hi, kk+1 lo, kk+1 hi); an odd last step takes an x2
template <int DP, int NT>
__device__ __forceinline__ void row_products(float (&acc)[NT][4],
                                             const __nv_bfloat16* A,
                                             const __nv_bfloat16* B, int wr,
                                             int c, int lane) {
  constexpr int LD = DP + MMA_PAD;
  constexpr int KD = DP / 16;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 2) {
    uint32_t a0[4], a1[4];
    load_a(a0, A, LD, wr, kk * 16, lane);
    if (kk + 1 < KD) load_a(a1, A, LD, wr, kk * 16 + 16, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* bp = B + (c + n * 8 + lm_row) * LD + kk * 16;
      if (kk + 1 < KD) {
        uint32_t b[4];
        ldmatrix_x4(b, bp + lm_mat * 8);
        mma_bf16(acc[n], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
        mma_bf16(acc[n], a1[0], a1[1], a1[2], a1[3], b[2], b[3]);
      } else {
        uint32_t b[2];
        ldmatrix_x2(b, bp + (lm_mat & 1) * 8);
        mma_bf16(acc[n], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Any head dim D in [1, MAX_HEAD_DIM] on the mma.sync and FMA routes: each
// kernel is instantiated at a padded head dim DP (D rounded up to 16 for
// bf16, to 32 for fp32) and told the real D. Loads fill the columns past
// D with zeros in shared memory (they add nothing to q.k or p.v), stores
// drop them. A row whose byte width is a multiple of 16 (bf16 D % 8 == 0,
// fp32 D % 4 == 0) starts on the 16-byte grid and is copied 16 bytes at a
// time; any other row element by element.
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

// rows [r0, r0 + ROWS) x columns [0, DP) of one head of a [S, H, D] bf16
// tensor (``src`` at the head's first element, ``row_stride`` = H * D)
// into shared rows of DP + MMA_PAD elements; rows past S and columns past
// D are zeros. The 16-byte path issues cp.async copies: the caller
// commits and waits for them as for its own.
template <int ROWS, int DP, int NTHREADS>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long row_stride, int r0,
                                               int S, int D, int tid) {
  constexpr int LD = DP + MMA_PAD;
  if ((D & 7) == 0) {
    constexpr int CH = DP / 8;
    for (int i = tid; i < ROWS * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r0 + r < S && c < D;
      cp_async16(dst + r * LD + c, src + (ok ? (r0 + r) * row_stride + c : 0),
                 ok);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP;
      __nv_bfloat16 x = __ushort_as_bfloat16(0);
      if (r0 + r < S && c < D) x = src[(r0 + r) * row_stride + c];
      dst[r * LD + c] = x;
    }
  }
}

// the fp32 counterpart, into shared rows of DP + PAD floats
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

// The FMA routes' two products, for warps of FMA_ROWS rows over fp32 row
// tiles of DP + PAD floats in shared memory (flash_attn_bwd_fma.cu, and
// every kernel of flash_attn_dchunk_fma.cu at DP 64).
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
