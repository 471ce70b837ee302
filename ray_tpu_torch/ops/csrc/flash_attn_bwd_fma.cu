// K2 (flash-attention dq backward) in fp32 on the CUDA cores, any head
// dim 1..256 (route "fma_f32"). Replaces
// ray_tpu/ops/attention.py::_bwd_dq_kernel for float32 inputs;
// flash_attn_bwd.cu describes the kernel family and its numerics. K3 in
// fp32 up to 256 is the ring kernel of flash_attn_ring_f32.cuh
// (flash_attn_bwd_dkdv_fma_ring.cu).
//
// Exact fp32 FMAs (the tensor cores would round to tf32) in warps of 8
// rows: a lane owns TILE/32 keys of a
// TILE-wide tile for the row products and DP/32 head dims for ds.K.
// Instantiated at DP = D rounded up to 32 and told the real D (columns
// past D load as zeros and are never stored). A block keeps four [TILE,
// DP] row tiles and one [TILE, TILE] slab in shared memory: at TILE 64
// that passes the 227 KB a block may have past DP 192, so there the tiles
// are 32 rows and the block 4 warps. What bounds it: fp32 at 67 TFLOP/s
// against 3.35 TB/s; at ModelConfig.debug's d 16 and S 128 bytes and the
// launch.

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

constexpr int ROWS_PER_WARP = FMA_ROWS;
constexpr size_t MAX_SMEM = 232448;  // bytes a block may have on sm_90

constexpr size_t smem_bytes(int DP, int TILE) {
  // four row tiles (Q, dO, K, V) + the ds slab
  return (size_t)4 * TILE * (DP + PAD) * sizeof(float) +
         (size_t)TILE * TILE * sizeof(float);
}

constexpr int tile_rows(int DP) {
  return smem_bytes(DP, 64) <= MAX_SMEM ? 64 : 32;
}

template <int DP, int TILE>
__global__ void __launch_bounds__(TILE * 4)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int H, int Sq, int Sk, int D, int causal, float scale) {
  constexpr int NTHREADS = TILE * 4;  // TILE / 8 warps of 8 rows
  constexpr int LD = DP + PAD;
  constexpr int DPL = DP / 32;
  constexpr int NC = TILE / 32;  // columns a lane owns

  // Q, dO, K tile, V tile, then the ds slab [TILE q rows][TILE keys]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + TILE * LD;
  float* Ks = dOs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* DSs = Vs + TILE * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;

  load_rows_f32<TILE, DP, NTHREADS>(Qs, q + q_off, row_stride, q0, Sq, D, tid);
  load_rows_f32<TILE, DP, NTHREADS>(dOs, dout + q_off, row_stride, q0, Sq, D,
                                    tid);

  const int r0 = warp * ROWS_PER_WARP;
  float* DSw = DSs + r0 * TILE;
  float lse_r[ROWS_PER_WARP], delta_r[ROWS_PER_WARP];
  float acc[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qp = q0 + r0 + r;
    lse_r[r] = qp < Sq ? lse[(long)bh * Sq + qp] : 0.f;
    delta_r[r] = qp < Sq ? delta[(long)bh * Sq + qp] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int q_last = min(q0 + TILE, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + TILE - 1) / TILE;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_rows_f32<TILE, DP, NTHREADS>(Ks, k + k_off, row_stride, k0, Sk, D,
                                      tid);
    load_rows_f32<TILE, DP, NTHREADS>(Vs, v + k_off, row_stride, k0, Sk, D,
                                      tid);
    __syncthreads();

    float s[ROWS_PER_WARP][NC] = {}, dp[ROWS_PER_WARP][NC] = {};
    row_dots<DP, NC>(s, Qs, r0, Ks, lane);
    row_dots<DP, NC>(dp, dOs, r0, Vs, lane);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kp = k0 + lane + 32 * j;
        const bool ok = kp < Sk && qp < Sq && (!causal || qp >= kp);
        const float p = ok ? expf(s[r][j] * scale - lse_r[r]) : 0.f;
        DSw[r * TILE + lane + 32 * j] = p * (dp[r][j] - delta_r[r]) * scale;
      }
    }
    __syncwarp();
    slab_product<DP, TILE>(acc, DSw, Ks, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Sq) continue;
    float* o = dq + q_off + (long)qp * row_stride;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane * DPL + i;
      if (c < D) o[c] = acc[r][i];
    }
  }
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int tile, int Sgrid, int BH,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sgrid + tile - 1) / tile, BH);
  kernel<<<grid, tile * 4, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

cudaError_t rtt::bwd_dq_fma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int H,
                            int Sq, int Sk, int D, int causal, float scale,
                            cudaStream_t stream) {
  return with_padded_dim<32>(D, [&](auto dim) -> cudaError_t {
    constexpr int DP = decltype(dim)::value;
    constexpr int TILE = tile_rows(DP);
    return launch(bwd_dq_f32_kernel<DP, TILE>, TILE, Sq, B * H,
                  smem_bytes(DP, TILE), stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(dout), lse, delta,
                  static_cast<float*>(dq), H, Sq, Sk, D, causal, scale);
  });
}
