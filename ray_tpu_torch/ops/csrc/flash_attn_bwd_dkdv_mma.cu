// K3 (flash-attention dk/dv backward) in bf16 on mma.sync, for the head
// dims 1..256 that no wgmma kernel takes: every D under 64, and every D
// past 64 that is not a multiple of 8 (TMA's rows must be multiples of 16
// bytes; d 64 and 128 take flash_attn_bwd.cu's wgmma kernel, the other
// multiples of 8 up to 256 the padded wgmma kernels); past DP 64 its
// instantiations serve only those D. Replaces
// ray_tpu/ops/attention.py::_bwd_dkdv_kernel for those bf16 inputs;
// flash_attn_bwd.cu describes the kernel family and its numerics.
//
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators): one block per
// (batch*head, 64-key tile), 4 warps of 16 keys; K and V stay in shared
// memory, Q/dO tiles of 64 queries (with their lse and delta rows) are
// double buffered and consumed in 32-query register chunks. The
// transposed tiles S^T = K Q^T and dP^T = V dO^T are computed, so p^T
// and ds^T leave the accumulators in the A layout of dv += p^T dO and
// dk += ds^T Q. A warp holds its fp32 dk and dv rows in registers for the
// whole loop: 2 DP registers a thread, which past DP 128 leaves too few
// for the rest, so there the launcher runs the kernel twice, once for dv
// (S^T alone) and once for dk (S^T and dP^T), each holding one
// accumulator. Instantiated at DP = D rounded up to 16 and told the real
// D (flash_attn_common.cuh: with_padded_dim, load_rows_bf16).

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int TILE = 64;     // rows of every q and k tile
constexpr int Q_CHUNK = 32;  // queries per register chunk
// which accumulators one launch computes
constexpr int OUT_DV = 1;
constexpr int OUT_DK = 2;
constexpr int OUT_BOTH = OUT_DV | OUT_DK;
constexpr int MAX_BOTH_DP = 128;  // past this, one launch each

template <int DP, int OUT>
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int Sq, int Sk, int D,
                    int causal, float scale) {
  constexpr bool DO_DV = OUT & OUT_DV;
  constexpr bool DO_DK = OUT & OUT_DK;
  constexpr int LD = DP + MMA_PAD;
  constexpr int NT = Q_CHUNK / 8;  // 8-query n-tiles of a chunk
  constexpr int DT = DP / 8;
  // an accumulator the launch does not compute shrinks to one tile
  constexpr int DT_DK = DO_DK ? DT : 1;
  constexpr int DT_DV = DO_DV ? DT : 1;

  // K tile, V tile, then two stages of (Q tile, dO tile), then two
  // stages of (lse, delta) rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE * LD;
  bf16* QDs = Vs + TILE * LD;
  constexpr int STAGE = 2 * TILE * LD;
  float* rows_s = reinterpret_cast<float*>(QDs + 2 * STAGE);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * TILE;
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;

  load_rows_bf16<TILE, DP, MMA_THREADS>(Ks, k + k_off, row_stride, k0, Sk, D,
                                        tid);
  load_rows_bf16<TILE, DP, MMA_THREADS>(Vs, v + k_off, row_stride, k0, Sk, D,
                                        tid);
  cp_async_commit();

  const int wr = warp * 16;
  const int kp[2] = {k0 + wr + g, k0 + wr + g + 8};  // rows g, g+8
  float dka[DT_DK][4], dva[DT_DV][4];
#pragma unroll
  for (int j = 0; j < DT_DK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < DT_DV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[j][e] = 0.f;
  }

  // causal: queries before k0 never see this tile's keys
  const int qt_first = causal ? k0 / TILE : 0;
  const int n_qt = (Sq + TILE - 1) / TILE;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;

  auto load_qtile = [&](int qt) {
    const int st = (qt - qt_first) & 1;
    bf16* Qd = QDs + st * STAGE;
    load_rows_bf16<TILE, DP, MMA_THREADS>(Qd, q + q_off, row_stride,
                                          qt * TILE, Sq, D, tid);
    load_rows_bf16<TILE, DP, MMA_THREADS>(Qd + TILE * LD, dout + q_off,
                                          row_stride, qt * TILE, Sq, D, tid);
    cp_async_commit();
    // this stage's rows were last read before the previous trailing
    // barrier; the next leading barrier publishes them
    if (tid < TILE) {
      const int qpos = qt * TILE + tid;
      const long i = (long)bh * Sq + qpos;
      rows_s[st * 2 * TILE + tid] = qpos < Sq ? lse[i] : 0.f;
      rows_s[st * 2 * TILE + TILE + tid] = qpos < Sq ? delta[i] : 0.f;
    }
  };
  if (qt_first < n_qt) load_qtile(qt_first);

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * TILE;
    if (qt + 1 < n_qt) {
      load_qtile(qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = (qt - qt_first) & 1;
    const bf16* Qs = QDs + st * STAGE;
    const bf16* dOs = Qs + TILE * LD;
    const float* lse_s = rows_s + st * 2 * TILE;
    const float* delta_s = lse_s + TILE;

    for (int c = 0; c < TILE; c += Q_CHUNK) {
      // S^T = K Q^T and dP^T = V dO^T for queries [c, c + Q_CHUNK):
      // sT[n]/dpT[n] hold keys (g, g+8) x queries (c + n*8 + 2t, +1)
      float sT[NT][4], dpT[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
      }
      row_products<DP, NT>(sT, Ks, Qs, wr, c, lane);
      if constexpr (DO_DK) row_products<DP, NT>(dpT, Vs, dOs, wr, c, lane);

      // p^T (kept in sT) and ds^T (kept in dpT); lse/delta by column
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c + n * 8 + 2 * t + (e & 1);
          const int qpos = q0 + qi;
          const int key = kp[e >> 1];
          const bool ok = qpos < Sq && key < Sk && (!causal || qpos >= key);
          const float p = ok ? expf(sT[n][e] * scale - lse_s[qi]) : 0.f;
          sT[n][e] = p;
          dpT[n][e] = p * (dpT[n][e] - delta_s[qi]) * scale;
        }
      }

      // dv += p^T dO and dk += ds^T Q over 16-query steps; dO's and Q's
      // B fragments by transposing ldmatrix
#pragma unroll
      for (int kc = 0; kc < Q_CHUNK / 16; ++kc) {
        const int off = (c + kc * 16 + (lm_mat & 1) * 8 + lm_row) * LD +
                        (lm_mat >> 1) * 8;
        if constexpr (DO_DV) {
          const uint32_t p0 = pack_bf16(sT[2 * kc][0], sT[2 * kc][1]);
          const uint32_t p1 = pack_bf16(sT[2 * kc][2], sT[2 * kc][3]);
          const uint32_t p2 = pack_bf16(sT[2 * kc + 1][0], sT[2 * kc + 1][1]);
          const uint32_t p3 = pack_bf16(sT[2 * kc + 1][2], sT[2 * kc + 1][3]);
#pragma unroll
          for (int j = 0; j < DT; j += 2) {
            uint32_t bd[4];
            ldmatrix_x4_trans(bd, dOs + off + j * 8);
            mma_bf16(dva[j], p0, p1, p2, p3, bd[0], bd[1]);
            mma_bf16(dva[j + 1], p0, p1, p2, p3, bd[2], bd[3]);
          }
        }
        if constexpr (DO_DK) {
          const uint32_t d0 = pack_bf16(dpT[2 * kc][0], dpT[2 * kc][1]);
          const uint32_t d1 = pack_bf16(dpT[2 * kc][2], dpT[2 * kc][3]);
          const uint32_t d2 = pack_bf16(dpT[2 * kc + 1][0], dpT[2 * kc + 1][1]);
          const uint32_t d3 = pack_bf16(dpT[2 * kc + 1][2], dpT[2 * kc + 1][3]);
#pragma unroll
          for (int j = 0; j < DT; j += 2) {
            uint32_t bq[4];
            ldmatrix_x4_trans(bq, Qs + off + j * 8);
            mma_bf16(dka[j], d0, d1, d2, d3, bq[0], bq[1]);
            mma_bf16(dka[j + 1], d0, d1, d2, d3, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // no q tile at all: the K/V group is still open

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (kp[row] >= Sk) continue;
    const long o = k_off + (long)kp[row] * row_stride;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      if constexpr (DO_DK)
        store_pair_bf16(dk + o, j * 8 + 2 * t, D, dka[j][2 * row],
                        dka[j][2 * row + 1]);
      if constexpr (DO_DV)
        store_pair_bf16(dv + o, j * 8 + 2 * t, D, dva[j][2 * row],
                        dva[j][2 * row + 1]);
    }
  }
}

template <int DP, int OUT>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int B, int H,
                        int Sq, int Sk, int D, int causal, float scale,
                        cudaStream_t stream) {
  // K, V and two stages of (Q, dO), then two stages of (lse, delta)
  const size_t smem = (size_t)6 * TILE * (DP + MMA_PAD) * sizeof(bf16) +
                      4 * TILE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_mma_kernel<DP, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + TILE - 1) / TILE, B * H);
  bwd_dkdv_mma_kernel<DP, OUT><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, D, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t rtt::bwd_dkdv_mma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int causal,
                              float scale, cudaStream_t stream) {
  return with_padded_dim<16>(D, [&](auto dim) -> cudaError_t {
    constexpr int DP = decltype(dim)::value;
    if constexpr (DP <= MAX_BOTH_DP) {
      return launch_dkdv<DP, OUT_BOTH>(q, k, v, dout, lse, delta, dk, dv, B,
                                       H, Sq, Sk, D, causal, scale, stream);
    } else {
      cudaError_t err = launch_dkdv<DP, OUT_DV>(q, k, v, dout, lse, delta,
                                                dk, dv, B, H, Sq, Sk, D,
                                                causal, scale, stream);
      if (err != cudaSuccess) return err;
      return launch_dkdv<DP, OUT_DK>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                     Sq, Sk, D, causal, scale, stream);
    }
  });
}
