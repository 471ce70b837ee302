// Helpers shared by the flash-attention kernels (flash_attn_*.cu): bf16
// packing, cp.async group commits and waits, and the bf16 row stores.
// Each .cu file includes this once; everything here is inline code in an
// anonymous namespace, so the translation units do not share symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
