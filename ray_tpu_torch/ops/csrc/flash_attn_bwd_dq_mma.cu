// K2 (flash-attention dq backward) in bf16 on mma.sync, for the head
// dims 1..256 that no wgmma kernel takes: every D under 64, and every D
// past 64 that is not a multiple of 8 (TMA's rows must be multiples of 16
// bytes; d 64 and 128 take flash_attn_bwd.cu's wgmma kernel, the other
// multiples of 8 up to 256 the padded wgmma kernels); past DP 64 its
// instantiations serve only those D. Replaces
// ray_tpu/ops/attention.py::_bwd_dq_kernel for those bf16 inputs;
// flash_attn_bwd.cu describes the kernel family and its numerics.
//
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators): one block per
// (batch*head, 64-row q tile), 4 warps of 16 q rows, each holding its
// fp32 dq rows in registers for the whole loop; Q and dO stay in shared
// memory, K/V tiles of 64 keys are double buffered. S = Q K^T and then
// dP = dO V^T (one after the other, so that only one of the two A operand
// sets is live beside dq: at DP 256 dq alone is 128 registers a thread);
// ds = p (dP - delta) scale leaves the accumulators already in the A
// layout of dq += ds K, whose B fragments come from the same K tile by
// transposing ldmatrix. Instantiated at DP = D rounded up to 16 and told
// the real D (flash_attn_common.cuh: with_padded_dim, load_rows_bf16).

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int TILE = 64;  // rows of every q and k tile

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int H, int Sq, int Sk, int D, int causal, float scale) {
  constexpr int LD = DP + MMA_PAD;
  constexpr int NT = TILE / 8;  // 8-key n-tiles of S
  constexpr int DT = DP / 8;    // 8-wide n-tiles of dq

  // Q tile, dO tile, then two stages of (K tile, V tile)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TILE * LD;
  bf16* KVs = dOs + TILE * LD;
  constexpr int STAGE = 2 * TILE * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // longest first
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;

  load_rows_bf16<TILE, DP, MMA_THREADS>(Qs, q + q_off, row_stride, q0, Sq, D,
                                        tid);
  load_rows_bf16<TILE, DP, MMA_THREADS>(dOs, dout + q_off, row_stride, q0, Sq,
                                        D, tid);
  cp_async_commit();

  const int wr = warp * 16;
  const int qp[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const long i = (long)bh * Sq + qp[row];
    lse_r[row] = qp[row] < Sq ? lse[i] : 0.f;
    delta_r[row] = qp[row] < Sq ? delta[i] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int q_last = min(q0 + TILE, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + TILE - 1) / TILE;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;

  auto load_tile = [&](int tile) {
    bf16* Kd = KVs + (tile & 1) * STAGE;
    load_rows_bf16<TILE, DP, MMA_THREADS>(Kd, k + k_off, row_stride,
                                          tile * TILE, Sk, D, tid);
    load_rows_bf16<TILE, DP, MMA_THREADS>(Kd + TILE * LD, v + k_off,
                                          row_stride, tile * TILE, Sk, D,
                                          tid);
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TILE;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = KVs + (tile & 1) * STAGE;
    const bf16* Vs = Ks + TILE * LD;

    // S = Q K^T and dP = dO V^T: s[n]/dp[n] hold rows (g, g+8) x keys
    // (n*8 + 2t, +1)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    row_products<DP, NT>(s, Qs, Ks, wr, 0, lane);
    row_products<DP, NT>(dp, dOs, Vs, wr, 0, lane);

    // p from lse, then ds (kept in s)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e >> 1;
        const bool ok = kp < Sk && qp[row] < Sq && (!causal || qp[row] >= kp);
        const float p = ok ? expf(s[n][e] * scale - lse_r[row]) : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[row]) * scale;
      }
    }

    // dq += ds K over 16-key steps; ds in bf16 as the A operand, K's B
    // fragments by transposing ldmatrix (as V in the forward's P.V)
#pragma unroll
    for (int kc = 0; kc < TILE / 16; ++kc) {
      const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const bf16* kp =
          Ks + (kc * 16 + (lm_mat & 1) * 8 + lm_row) * LD + (lm_mat >> 1) * 8;
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, kp + j * 8);
        mma_bf16(acc[j], a0, a1, a2, a3, bk[0], bk[1]);
        mma_bf16(acc[j + 1], a0, a1, a2, a3, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // no tile at all: the Q/dO group is still open

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qp[row] >= Sq) continue;
    bf16* out = dq + q_off + (long)qp[row] * row_stride;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store_pair_bf16(out, j * 8 + 2 * t, D, acc[j][2 * row],
                      acc[j][2 * row + 1]);
  }
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int Sq, int Sk, int D,
                      int causal, float scale, cudaStream_t stream) {
  // Q, dO and two stages of (K, V)
  const size_t smem = (size_t)6 * TILE * (DP + MMA_PAD) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, B * H);
  bwd_dq_mma_kernel<DP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), H, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t rtt::bwd_dq_mma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int H,
                            int Sq, int Sk, int D, int causal, float scale,
                            cudaStream_t stream) {
  return with_padded_dim<16>(D, [&](auto dim) -> cudaError_t {
    return launch_dq<decltype(dim)::value>(q, k, v, dout, lse, delta, dq, B,
                                           H, Sq, Sk, D, causal, scale,
                                           stream);
  });
}
