// K2 and K3 (flash-attention backward) in fp32 on the CUDA cores, any
// head dim 1..256. Replace ray_tpu/ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkdv_kernel for float32 inputs; flash_attn_bwd.cu describes the
// kernel family and its numerics.
//
// Exact fp32 FMAs (the tensor cores would round to tf32), the forward's
// fp32 layout: warps of 8 rows; a lane owns TILE/32 columns of a
// TILE-wide tile for the row products and DP/32 head dims for the tile
// products. Instantiated at DP = D rounded up to 32 and told the real D
// (columns past D load as zeros and are never stored). A block keeps
// four [TILE, DP] row tiles and one or two [TILE, TILE] slabs in shared
// memory: at TILE 64 that passes the 227 KB a block may have past DP 160
// (K3 at DP 192 would need 233,984 bytes), so there the tiles are 32 rows
// and the block 4 warps. What bounds them: fp32 at 67 TFLOP/s against
// 3.35 TB/s; at ModelConfig.debug's d 16 and S 128 bytes and the launch.

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

constexpr int ROWS_PER_WARP = FMA_ROWS;
constexpr size_t MAX_SMEM = 232448;  // bytes a block may have on sm_90

constexpr size_t smem_bytes(int DP, int TILE, bool dkdv) {
  // four row tiles + one (dq: ds) or two (dk/dv: p, ds) slabs, and for
  // dk/dv the q tile's lse and delta
  return (size_t)4 * TILE * (DP + PAD) * sizeof(float) +
         (size_t)(dkdv ? 2 : 1) * TILE * TILE * sizeof(float) +
         (dkdv ? 2 * TILE * sizeof(float) : 0);
}

constexpr int tile_rows(int DP, bool dkdv) {
  return smem_bytes(DP, 64, dkdv) <= MAX_SMEM ? 64 : 32;
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

template <int DP, int TILE>
__global__ void __launch_bounds__(TILE * 4)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Sq, int Sk, int D,
                    int causal, float scale) {
  constexpr int NTHREADS = TILE * 4;
  constexpr int LD = DP + PAD;
  constexpr int DPL = DP / 32;
  constexpr int NC = TILE / 32;

  // K tile, V tile, Q tile, dO tile, the p and ds slabs [TILE keys][TILE
  // queries], then the q tile's lse and delta
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* dOs = Qs + TILE * LD;
  float* Ps = dOs + TILE * LD;
  float* DSs = Ps + TILE * TILE;
  float* lse_s = DSs + TILE * TILE;
  float* delta_s = lse_s + TILE;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * TILE;
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;

  load_rows_f32<TILE, DP, NTHREADS>(Ks, k + k_off, row_stride, k0, Sk, D, tid);
  load_rows_f32<TILE, DP, NTHREADS>(Vs, v + k_off, row_stride, k0, Sk, D, tid);

  const int r0 = warp * ROWS_PER_WARP;  // this warp's keys
  float* Pw = Ps + r0 * TILE;
  float* DSw = DSs + r0 * TILE;
  float dka[ROWS_PER_WARP][DPL], dva[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) dka[r][i] = dva[r][i] = 0.f;
  }

  const int qt_first = causal ? k0 / TILE : 0;
  const int n_qt = (Sq + TILE - 1) / TILE;

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_rows_f32<TILE, DP, NTHREADS>(Qs, q + q_off, row_stride, q0, Sq, D,
                                      tid);
    load_rows_f32<TILE, DP, NTHREADS>(dOs, dout + q_off, row_stride, q0, Sq,
                                      D, tid);
    if (tid < TILE) {
      const int qpos = q0 + tid;
      lse_s[tid] = qpos < Sq ? lse[(long)bh * Sq + qpos] : 0.f;
      delta_s[tid] = qpos < Sq ? delta[(long)bh * Sq + qpos] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for this warp's keys x queries (lane + 32 j)
    float sT[ROWS_PER_WARP][NC] = {}, dpT[ROWS_PER_WARP][NC] = {};
    row_dots<DP, NC>(sT, Ks, r0, Qs, lane);
    row_dots<DP, NC>(dpT, Vs, r0, dOs, lane);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int key = k0 + r0 + r;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int qi = lane + 32 * j;
        const int qpos = q0 + qi;
        const bool ok = qpos < Sq && key < Sk && (!causal || qpos >= key);
        const float p = ok ? expf(sT[r][j] * scale - lse_s[qi]) : 0.f;
        Pw[r * TILE + qi] = p;
        DSw[r * TILE + qi] = p * (dpT[r][j] - delta_s[qi]) * scale;
      }
    }
    __syncwarp();
    slab_product<DP, TILE>(dva, Pw, dOs, lane);
    slab_product<DP, TILE>(dka, DSw, Qs, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int key = k0 + r0 + r;
    if (key >= Sk) continue;
    const long o = k_off + (long)key * row_stride;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane * DPL + i;
      if (c < D) {
        dk[o + c] = dka[r][i];
        dv[o + c] = dva[r][i];
      }
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
    constexpr int TILE = tile_rows(DP, false);
    return launch(bwd_dq_f32_kernel<DP, TILE>, TILE, Sq, B * H,
                  smem_bytes(DP, TILE, false), stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(dout), lse, delta,
                  static_cast<float*>(dq), H, Sq, Sk, D, causal, scale);
  });
}

cudaError_t rtt::bwd_dkdv_fma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int causal,
                              float scale, cudaStream_t stream) {
  return with_padded_dim<32>(D, [&](auto dim) -> cudaError_t {
    constexpr int DP = decltype(dim)::value;
    constexpr int TILE = tile_rows(DP, true);
    return launch(bwd_dkdv_f32_kernel<DP, TILE>, TILE, Sk, B * H,
                  smem_bytes(DP, TILE, true), stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(dout), lse, delta,
                  static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
                  D, causal, scale);
  });
}
