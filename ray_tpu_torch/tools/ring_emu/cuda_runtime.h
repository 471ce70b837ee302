// The CUDA runtime as the fp32 ring kernels (ops/csrc/flash_attn_ring_f32.cuh)
// use it, emulated on the host so that their index arithmetic, masks,
// rings and hand-offs can be held against the plain versions on a
// machine without a card (tools/emulate_ring.py translates the sources:
// their asm and launches become the emu_* hooks below). A block's threads
// are OS threads run together, blocks one after another; __syncthreads,
// named barriers, __syncwarp and shuffles are std::barrier waits; a
// cp.async is a synchronous copy (its commit and wait no-ops), so a
// missing wait is not seen, a missing barrier or a wrong index is. Shared
// memory starts as NaN at every launch, so a read of what no thread wrote
// shows.
#pragma once
#include <math.h>
#include <string.h>

#include <algorithm>
#include <barrier>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
using std::max;
using std::min;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef struct CUstream_st* cudaStream_t;

constexpr int EMU_SMEM_BYTES = 232448;  // a block's shared memory on sm_90
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 gridDim;
alignas(16) inline unsigned char emu_smem[EMU_SMEM_BYTES];
inline int emu_smem_set = 0;  // the launch's cudaFuncSetAttribute bytes

template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int bytes) {
  if (bytes > EMU_SMEM_BYTES) return cudaErrorInvalidValue;
  emu_smem_set = bytes;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

struct EmuWarp {
  float buf[32];
  std::barrier<> bar{32};
};
struct EmuBlock {
  explicit EmuBlock(int threads) : all(threads), warps(threads / 32) {
    for (auto& g : groups) g = std::make_unique<std::barrier<>>(128);
  }
  std::barrier<> all;
  std::unique_ptr<std::barrier<>> groups[16];  // named barriers of 128
  std::vector<EmuWarp> warps;
};
inline EmuBlock* emu_block;

inline void __syncthreads() { emu_block->all.arrive_and_wait(); }
inline void __syncwarp() {
  emu_block->warps[threadIdx.x / 32].bar.arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  EmuWarp& w = emu_block->warps[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  w.buf[lane] = v;
  w.bar.arrive_and_wait();
  const float r = w.buf[lane ^ off];
  w.bar.arrive_and_wait();
  return r;
}
// cp.async of n floats, zeros where not valid (src-size 0)
inline void emu_cp(float* dst, const float* src, int n, bool valid) {
  for (int i = 0; i < n; ++i) dst[i] = valid ? src[i] : 0.f;
}
// bar.sync id, 128
inline void emu_group_sync(int id) { emu_block->groups[id]->arrive_and_wait(); }

inline void emu_launch(dim3 grid, int threads,
                       const std::function<void()>& body) {
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        memset(emu_smem, 0xff, sizeof(emu_smem));
        EmuBlock block(threads);
        emu_block = &block;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=, &body] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {x, y, z};
            body();
          });
        for (auto& t : ts) t.join();
      }
}
