// Hopper (sm_90a) building blocks shared by the warp-specialised
// flash-attention kernels: tensor maps for TMA (built on the host per
// call), mbarrier rings, TMA tile loads, wgmma shared-memory descriptors
// and the wgmma instructions themselves, and setmaxnreg.
//
// The CUDA API's cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda at
// link time. Everything is inline code in an anonymous namespace, as in
// flash_attn_common.cuh: each .cu file that includes it gets its own copy.
//
// Shared-memory layout of a TMA tile: a tensor map over a [B, S, H, D]
// bf16 tensor is 4-D, {D, H, S, B} innermost first, so a box that runs
// past S is zero-filled inside its own batch. A box is {64, 1, rows, 1}
// with 128-byte swizzle: `rows` rows of 64 head dims (128 bytes) each, in
// 8-row atoms of 1024 bytes. A head_dim-128 tile is two such boxes, one
// after the other. wgmma reads the boxes through descriptors:
//   K-major operand (head_dim contiguous: Q, K in Q.K^T): 8-row atoms
//     1024 bytes apart (SBO); a 16-wide k step inside a box moves the
//     start address by 32 bytes;
//   MN-major operand (the row axis is the product's k: V in P.V): 8-row
//     atoms along k 1024 bytes apart (SBO), 64-wide column atoms along n
//     one box apart (LBO); a 16-row k step moves the start by 2048 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SWIZZLE_ROW_BYTES = 128;  // one box row: 64 bf16
constexpr int BOX_COLS = 64;            // head dims per box
// returned by the launchers when a tensor map cannot be made: 1000 +
// cuTensorMapEncodeTiled's CUresult
constexpr int TENSOR_MAP_ERROR = 1000;

// ---------------------------------------------------------------------------
// Host: tensor maps.
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A [B, S, H, D] bf16 tensor as boxes of `rows` sequence positions x 64
// head dims of one (batch, head), 128-byte swizzled. 0 or an error code.
inline int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S,
                       int H, int D, int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {BOX_COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// A flat fp32 array of n values as boxes of `len` consecutive values
// (lse and delta rows); past n reads zeros. 0 or an error code.
inline int encode_rows(CUtensorMap* map, const void* ptr, long n, int len) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // unread at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)len};
  const cuuint32_t elem[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// the card's SM count (132 on an H100 SXM), read once
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
    return count;
  }();
  return n;
}

// ---------------------------------------------------------------------------
// Device: shared-memory addresses, mbarriers, TMA.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: parity 1 passes at once, parity 0 waits for the first
// completion). A wait that never ends (a miscounted ring) traps after
// 2^30 polls, seconds past any real wait, so the launch fails instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 30)) __trap();
  }
}

// mbar_wait without __trap(): a wait that never ends stores through a
// null pointer after 2^30 polls (the launch fails with "an illegal memory
// access was encountered") and returns, so it cannot hold the card either
// way. A trap in a kernel makes ptxas (CUDA 12.9) allocate the consumers'
// code within the registers the launch bounds give a thread (168 at 384
// threads), whatever setmaxnreg raises at run time; without one it
// allocates within setmaxnreg's count (240 for the consumers). The padded
// K2 and K3 kernels wait with this one (flash_attn_bwd.cu's header gives
// their ptxas numbers both ways).
__device__ __forceinline__ void mbar_wait_no_trap(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 30)) {
      *reinterpret_cast<volatile int*>(uintptr_t{0}) = 0;
      return;
    }
  }
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// one TMA box of a 4-D map into shared memory; completion counts on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0)
      : "memory");
}

// ---------------------------------------------------------------------------
// Device: register budgets, wgmma.
// ---------------------------------------------------------------------------

// the warpgroup of this thread, broadcast from lane 0 so that the compiler
// sees it uniform across the warp: ptxas applies setmaxnreg to a role's
// code only when the branch into that role is warp-uniform
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// `x`, opaque to the compiler: descriptors built from it inside a loop are
// built where they are used instead of hoisted out of the loop and held
// in registers for all of it (16 descriptors of a resident tile are 32
// registers a thread)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// descriptor of a 128-byte-swizzled operand tile at shared address `addr`
// (see the layout note at the top); byte offsets as the ISA counts them
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of a wgmma accumulator across
// the points where the asynchronous product owns it
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator of m64nNk16 (fp32): warp w of the warpgroup holds rows
// 16w..16w+15; lane (g = lane/4, t = lane%4) holds d[i] at row
// 16w + g + 8*((i>>1)&1), column 8*(i>>2) + 2t + (i&1). The register A
// fragment of a 16-wide k step kc is the same layout read as bf16 pairs:
// {d[8kc], d[8kc+1]}, {d[8kc+2], d[8kc+3]}, {d[8kc+4], d[8kc+5]},
// {d[8kc+6], d[8kc+7]}.

// D[64, 64] (+)= A[64, 16] * B[16, 64], A and B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// D[64, 128] (+)= A[64, 16] * B[16, 128], A and B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// D[64, 64] (+)= A[64, 16] * B[16, 64], A in registers (the
// accumulator-like fragment of a 16-wide k step), B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// D[64, 32] (+)= A[64, 16] * B[16, 32], A and B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// D[64, 32] (+)= A[64, 16] * B[16, 32], A in registers, B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// D[64, 128] (+)= A[64, 16] * B[16, 128], A in registers (the
// accumulator-like fragment of a 16-wide k step), B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// Products whose N is a head dim padded to a multiple of 32 (not 64): B
// is MN-major (the transpose bit), N columns of boxes of 64 columns
// `box` bytes apart, the first box at shared address `b`; accumulated
// into d[N / 2] as one m64nNk16 would lay it out. Run as m64n128,
// m64n64 and m64n32 pieces, each starting on a box edge: a 32-column
// piece is the first half of its box (its 128-byte rows hold 64 columns;
// the wgmma reads the first 64 bytes of each, swizzled as TMA wrote
// them). A comes from registers (rs) or from a shared-memory descriptor
// (ss). Accumulator piece c is d[c / 2 ...]: the layout of m64nNk16
// puts column 8j..8j+7 in d[4j..4j+3].
template <int N>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint32_t b, uint32_t box) {
  static_assert(N % 32 == 0 && N <= 256, "N: a multiple of 32 up to 256");
#pragma unroll
  for (int c = 0; c + 128 <= N; c += 128)
    wgmma_rs_n128<1>(*reinterpret_cast<float(*)[64]>(d + c / 2), a,
                     sw128_desc(b + (c / 64) * box, box, 1024), 1);
  constexpr int c64 = N / 128 * 128;
  if constexpr (N - c64 >= 64)
    wgmma_rs_n64<1>(*reinterpret_cast<float(*)[32]>(d + c64 / 2), a,
                    sw128_desc(b + (c64 / 64) * box, box, 1024), 1);
  constexpr int c32 = N / 64 * 64;
  if constexpr (N - c32 == 32)
    wgmma_rs_n32<1>(*reinterpret_cast<float(*)[16]>(d + c32 / 2), a,
                    sw128_desc(b + (c32 / 64) * box, box, 1024), 1);
}

template <int N>
__device__ __forceinline__ void wgmma_ss_cols(float (&d)[N / 2],
                                              uint64_t da, uint32_t b,
                                              uint32_t box) {
  static_assert(N % 32 == 0 && N <= 256, "N: a multiple of 32 up to 256");
#pragma unroll
  for (int c = 0; c + 128 <= N; c += 128)
    wgmma_ss_n128<1>(*reinterpret_cast<float(*)[64]>(d + c / 2), da,
                     sw128_desc(b + (c / 64) * box, box, 1024), 1);
  constexpr int c64 = N / 128 * 128;
  if constexpr (N - c64 >= 64)
    wgmma_ss_n64<1>(*reinterpret_cast<float(*)[32]>(d + c64 / 2), da,
                    sw128_desc(b + (c64 / 64) * box, box, 1024), 1);
  constexpr int c32 = N / 64 * 64;
  if constexpr (N - c32 == 32)
    wgmma_ss_n32<1>(*reinterpret_cast<float(*)[16]>(d + c32 / 2), da,
                    sw128_desc(b + (c32 / 64) * box, box, 1024), 1);
}

// bar.sync on named barrier `id` (1..15; __syncthreads takes 0) for
// `threads` threads, a multiple of 32
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// makes this thread's st.shared writes visible to the async proxy (the
// wgmmas that read them as operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Device: boxes filled without TMA. TMA needs a row stride that is a
// multiple of 16 bytes, and a bf16 row of D % 8 != 0 values is not one.
// The producer warpgroup's FEED_THREADS threads then fill the same
// boxes themselves: the 16-byte chunk ch of box row r goes to chunk
// ch ^ (r & 7) of that row, the offset inside the chunk kept, which is
// what TMA's 128-byte swizzle writes, so the sw128_desc descriptors read
// either fill unchanged. At even D a row starts 4-byte aligned (8-byte
// at D % 4 == 0): cp.async copies 4 or 8 bytes, in its zero-fill form
// (src-size 0) for rows past S and columns past D, and each thread's
// share of a stage completes on the stage's full barrier through
// cp.async.mbarrier.arrive.noinc (one arrival a thread, so the barrier
// counts FEED_THREADS). At odd D a row starts 2-byte aligned: each
// thread loads two bf16 values through registers, stores them as one
// word, fences its stores into the async proxy and arrives. wgmma reads
// shared memory through the async proxy and these fills write through
// the generic one, so a consumer fences again after each wait on a full
// barrier (feed_acquire).
// ---------------------------------------------------------------------------

constexpr int FEED_TMA = 0;       // one thread issues TMA boxes
constexpr int FEED_CP_ASYNC = 1;  // the producer warpgroup fills them
constexpr int FEED_THREADS = 128;
// Producer warpgroups of a block: one, but three beside one consumer
// warpgroup where the boxes are filled without TMA. Each takes every
// third fill of a stage: an odd-D fill waits for global memory once a
// batch of rows, so one warpgroup kept one fill in flight at a time.
__host__ __device__ constexpr int feed_producers(int feed, int ncw) {
  return feed != FEED_TMA && ncw == 1 ? 3 : 1;
}
// setmaxnreg counts of each producer and consumer warpgroup, where a
// block has more than two (the registers it starts with, dealt out
// again: 384 x 168, or 512 x 128). A TMA producer runs in 24; one that
// fills the boxes itself needs more (ptxas spilled 60-716 bytes in it at
// 24, 104-444 at 40), which leaves two consumers 224 each (their code
// takes 138-202 where no setmaxnreg bounds it)
__host__ __device__ constexpr int producer_regs(int feed, int ncw) {
  return feed == FEED_TMA ? 24 : ncw == 2 ? 56 : 88;
}
__host__ __device__ constexpr int consumer_regs(int feed, int ncw) {
  return feed == FEED_TMA ? 240 : ncw == 2 ? 224 : 240;
}

// BYTES (4 or 8) from global to shared memory; zeros when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued so far has
// landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of one head of a
// [S, H, D] bf16 tensor (`head` at the head's first element, rows
// `stride` elements apart) into the box at shared address `box` (1024
// aligned), by thread `pt` of FEED_THREADS; rows past S and columns past
// D are zeros. COLS: the box's 64 columns, or the first 32 where a
// product reads no more. c0 is a multiple of 8. BATCH: rows a thread
// loads through registers (odd D) before it stores them, as many as its
// registers allow: each batch waits once for global memory.
template <int ROWS, int COLS, int BATCH>
__device__ __forceinline__ void fill_box(uint32_t box,
                                         const __nv_bfloat16* head,
                                         long stride, int r0, int S, int c0,
                                         int D, int pt) {
  static_assert(COLS == 64 || COLS == 32, "COLS: 64 or 32");
  // recomputed at each call: values derived from pt, hoisted out of the
  // producer's loops for every box, spilled its few registers
  pt = static_cast<int>(opaque(static_cast<uint32_t>(pt)));
  if ((D & 3) == 0) {
    // 8-byte copies of 4 columns; a thread's rows are STEP apart, a
    // multiple of 8, so they share r & 7 and one swizzled offset
    constexpr int PER_ROW = COLS / 4, STEP = FEED_THREADS / PER_ROW;
    static_assert(ROWS % STEP == 0 && STEP % 8 == 0, "rows a thread");
    const int ch = pt % PER_ROW, r1 = pt / PER_ROW;
    const int c = c0 + 4 * ch;
    const uint32_t at = box + r1 * SWIZZLE_ROW_BYTES +
                        ((((ch >> 1) ^ (r1 & 7)) << 4) | ((ch & 1) << 3));
    const __nv_bfloat16* src = head + (long)(r0 + r1) * stride + c;
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) {
      const bool ok = c < D && r0 + r1 + i * STEP < S;
      cp_async_ca<8>(at + i * STEP * SWIZZLE_ROW_BYTES,
                     ok ? src + (long)i * STEP * stride : head, ok);
    }
    return;
  }
  // two columns a thread: one 4-byte copy at even D, two 2-byte loads
  // through registers at odd D
  constexpr int PER_ROW = COLS / 2, STEP = FEED_THREADS / PER_ROW;
  constexpr int N = ROWS / STEP;
  static_assert(ROWS % STEP == 0, "rows a thread");
  const int ch = pt % PER_ROW, r1 = pt / PER_ROW;
  const int c = c0 + 2 * ch;
  const __nv_bfloat16* src = head + (long)(r0 + r1) * stride + c;
  const auto at = [&](int i) {
    const int r = r1 + i * STEP;
    return box + r * SWIZZLE_ROW_BYTES +
           ((((ch >> 2) ^ (r & 7)) << 4) | ((ch & 3) << 2));
  };
  if ((D & 1) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool ok = c < D && r0 + r1 + i * STEP < S;
      cp_async_ca<4>(at(i), ok ? src + (long)i * STEP * stride : head, ok);
    }
    return;
  }
  // loads of a batch of rows in flight before their stores
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += BATCH) {
    uint32_t x[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      x[i] = 0;
      if (i0 + i >= N || r0 + r1 + (i0 + i) * STEP >= S) continue;
      const unsigned short* p = reinterpret_cast<const unsigned short*>(
          src + (long)(i0 + i) * STEP * stride);
      if (c < D) x[i] = p[0];
      if (c + 1 < D) x[i] |= (uint32_t)p[1] << 16;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i)
      if (i0 + i < N) st_shared_b32(at(i0 + i), x[i]);
  }
}

// this producer thread's share of a stage is issued: its arrival on the
// stage's full barrier (see above)
__device__ __forceinline__ void fill_done(uint32_t full, int D) {
  if (D & 1) {
    fence_proxy_async();
    mbar_arrive(full);
  } else {
    cp_async_arrive_noinc(full);
  }
}

// a consumer's wait on a full barrier, then (boxes filled without TMA)
// the proxy fence before wgmma reads them
template <int FEED>
__device__ __forceinline__ void feed_acquire(uint32_t full,
                                             uint32_t parity) {
  mbar_wait_no_trap(full, parity);
  if constexpr (FEED != FEED_TMA) fence_proxy_async();
}

}  // namespace
