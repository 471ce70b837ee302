// K2 in bf16 on wgmma (sm_90a): bwd_dq_ws_kernel and its launcher, shared
// by the two translation units that instantiate it -- flash_attn_bwd.cu at
// head_dim 64 and 128, flash_attn_bwd_dq_padded.cu at the padded head dims
// (D % 8 == 0, 64 < D <= 256, D != 128). The design and its ptxas numbers
// are in flash_attn_bwd.cu's header.
//
// One block per (batch*head, 128-row q tile); warpgroups 0 and 1 each own
// 64 q rows and hold their dq accumulator [64, DP] in registers for the
// whole loop; warpgroup 2 is the producer. Q and dO are loaded once and
// stay; K and V tiles of 64 keys go round rings with their own full and
// empty barriers for K and for V: V is last read by dP, K by ds.K, so V's
// stage is released (and refilled) first.
//
// DP is the head dim the kernel computes, a multiple of 32: D itself at
// 64 and 128, else D rounded up to 32. The tensor maps' inner dimension is
// D, so TMA fills the columns D..DS of each row with zeros (DS: DP rounded
// up to a 64-column box): S and dP sum over DP/16 k steps (the padded
// ones add zeros), dq += ds.K runs at N = DP in box-aligned pieces, and
// only the D real columns of dq are written. At DS 256 two V stages do not
// fit beside resident Q/dO and two K stages (256 KB of the 227 KB a block
// may have): V gets one stage (224 KB).

#pragma once

#include "flash_attn_common.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WS_THREADS = 384;  // two consumer warpgroups + the producer
constexpr int WS_CONSUMERS = 256;
constexpr int DQ_BM = 128;  // q rows per block
constexpr int DQ_BN = 64;   // keys per K/V tile

template <int DP>
struct WsDqSmem {
  static_assert(DP % 32 == 0 && DP >= 64 && DP <= 256, "DP: 64..256 by 32");
  static constexpr int BOXES = (DP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int DS = BOXES * BOX_COLS;  // padded row, in columns
  static constexpr int K_STAGES = 2;
  static constexpr int V_STAGES = DS <= 192 ? 2 : 1;
  static constexpr int Q_BYTES = DQ_BM * DS * 2;   // Q or dO, resident
  static constexpr int KV_BYTES = DQ_BN * DS * 2;  // one K or one V tile
  static constexpr int Q_BOX = DQ_BM * SWIZZLE_ROW_BYTES;  // bytes a box
  static constexpr int KV_BOX = DQ_BN * SWIZZLE_ROW_BYTES;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + K_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + V_STAGES * KV_BYTES;
  // qdo_full, then k_full, v_full, k_empty, v_empty of each stage
  static constexpr int BYTES =
      BAR_OFF + (1 + 2 * K_STAGES + 2 * V_STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
  static_assert(ALLOC <= 232448, "over the 227 KB a block may have");
};

template <int DP, bool TRAP>
__global__ void __launch_bounds__(WS_THREADS, 1)
bwd_dq_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int H, int Sq, int Sk, int D, int causal, float scale) {
  using L = WsDqSmem<DP>;
  constexpr int KS = L::K_STAGES, VS = L::V_STAGES;
  const auto wait = [](uint32_t bar, uint32_t parity) {
    if constexpr (TRAP)
      mbar_wait(bar, parity);
    else
      mbar_wait_no_trap(bar, parity);
  };
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qdo_full = base + L::BAR_OFF;
  auto k_full = [&](int s) { return qdo_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return qdo_full + 8 * (1 + KS + s); };
  auto k_empty = [&](int s) { return qdo_full + 8 * (1 + KS + VS + s); };
  auto v_empty = [&](int s) {
    return qdo_full + 8 * (1 + 2 * KS + VS + s);
  };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BM;  // longest first
  // causal: keys past this tile's last row are never needed
  const int q_last = min(q0 + DQ_BM, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + DQ_BN - 1) / DQ_BN;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < KS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), WS_CONSUMERS);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), WS_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: every warp lowers its register limit, one thread
    // keeps the rings full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      mbar_expect_tx(qdo_full, 2 * L::Q_BYTES);
      for (int x = 0; x < L::BOXES; ++x) {
        tma_load_4d(base + x * L::Q_BOX, &tm_q, qdo_full, x * BOX_COLS, h,
                    q0, b);
        tma_load_4d(base + L::DO_OFF + x * L::Q_BOX, &tm_do, qdo_full,
                    x * BOX_COLS, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int sk = j % KS, sv = j % VS;
        wait(k_empty(sk), ((j / KS) & 1) ^ 1);
        mbar_expect_tx(k_full(sk), L::KV_BYTES);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_4d(base + L::K_OFF + sk * L::KV_BYTES + x * L::KV_BOX,
                      &tm_k, k_full(sk), x * BOX_COLS, h, j * DQ_BN, b);
        wait(v_empty(sv), ((j / VS) & 1) ^ 1);
        mbar_expect_tx(v_full(sv), L::KV_BYTES);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_4d(base + L::V_OFF + sv * L::KV_BYTES + x * L::KV_BOX,
                      &tm_v, v_full(sv), x * BOX_COLS, h, j * DQ_BN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [q0 + 64 wg, +64)
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wg_row = q0 + wg * 64;
    const int qp[2] = {wg_row + warp * 16 + g, wg_row + warp * 16 + g + 8};
    const float scale_log2 = scale * LOG2E;
    // this thread's two rows: lse in the log2 domain, delta; rows past Sq
    // take 0 and are never written
    float lse_l2[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long i = (long)bh * Sq + qp[r];
      lse_l2[r] = qp[r] < Sq ? lse[i] * LOG2E : 0.f;
      delta_r[r] = qp[r] < Sq ? delta[i] : 0.f;
    }
    // the tiles this warpgroup's rows reach: at the causal diagonal the
    // upper warpgroup (rows ending 64 before the lower one's) skips the
    // block's last tile, and a warpgroup wholly past Sq skips them all;
    // a skipped tile's stages are still released
    const int wg_kv = causal ? min(Sk, min(wg_row + 64, Sq)) : Sk;
    const int wg_tiles = wg_row < Sq ? (wg_kv + DQ_BN - 1) / DQ_BN : 0;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    const uint32_t q_rows = base + wg * 64 * SWIZZLE_ROW_BYTES;
    const uint32_t do_rows = q_rows + L::DO_OFF;
    wait(qdo_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int sk = j % KS, sv = j % VS;
      const uint32_t k_parity = (j / KS) & 1, v_parity = (j / VS) & 1;
      const uint32_t k_tile = base + L::K_OFF + sk * L::KV_BYTES;
      const uint32_t v_tile = base + L::V_OFF + sv * L::KV_BYTES;
      if (j >= wg_tiles) {
        // a full barrier's phase completes only after every consumer
        // released this stage's previous fill: arriving before it could
        // count toward that release
        wait(k_full(sk), k_parity);
        mbar_arrive(k_empty(sk));
        wait(v_full(sv), v_parity);
        mbar_arrive(v_empty(sv));
        continue;
      }
      const int k0 = j * DQ_BN;

      // S = Q K^T and dP = dO V^T: [64 rows, 64 keys], both operands
      // K-major; two groups, so p is computed while dP is in flight
      float sc[32], dp[32];
      const uint32_t q_at = opaque(q_rows), do_at = opaque(do_rows);
      wait(k_full(sk), k_parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t in_box = (kk & 3) * 32;
        wgmma_ss_n64<0>(
            sc, sw128_desc(q_at + (kk >> 2) * L::Q_BOX + in_box, 16, 1024),
            sw128_desc(k_tile + (kk >> 2) * L::KV_BOX + in_box, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wait(v_full(sv), v_parity);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t in_box = (kk & 3) * 32;
        wgmma_ss_n64<0>(
            dp, sw128_desc(do_at + (kk >> 2) * L::Q_BOX + in_box, 16, 1024),
            sw128_desc(v_tile + (kk >> 2) * L::KV_BOX + in_box, 16, 1024),
            kk > 0);
      }
      wgmma_commit();

      // p = exp(S scale - lse) as exp2 of one FMA, in place; the mask
      // only where the tile needs it: the causal diagonal, and keys past
      // Sk (TMA reads them as zeros: S = 0 there, p = exp(-lse) != 0)
      wgmma_wait<1>();
      fence_operand(sc);
      const bool edge =
          (causal && k0 + DQ_BN - 1 > wg_row) || k0 + DQ_BN > Sk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse_l2[r]));
        if (edge) {
          const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          p = (kp < Sk && (!causal || kp <= qp[r])) ? p : 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_operand(dp);
      mbar_arrive(v_empty(sv));  // V is done with

      // ds = p (dP - delta) scale in fp32, packed to bf16 as the register
      // A operand of dq += ds K: the accumulator pair {d[8kc + 2x],
      // d[8kc + 2x + 1]} is A register x of 16-key step kc (row g for
      // even x, g + 8 for odd)
      uint32_t da[DQ_BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < DQ_BN / 16; ++kc) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = 8 * kc + 2 * x;
          const float d = delta_r[x & 1];
          da[kc][x] = pack_bf16(sc[i] * (dp[i] - d) * scale,
                                sc[i + 1] * (dp[i + 1] - d) * scale);
        }
      }
      // dq += ds K over 16-key steps: K is MN-major here (head_dim
      // contiguous), so B is transposed; N = DP in box-aligned pieces
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DQ_BN / 16; ++kc)
        wgmma_rs_cols<DP>(acc, da[kc],
                          k_tile + kc * 16 * SWIZZLE_ROW_BYTES, L::KV_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      mbar_arrive(k_empty(sk));  // K is done with
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] >= Sq) continue;
      bf16* out = dq + (((long)b * Sq + qp[r]) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        if (8 * j < D)  // D % 8 == 0: a column block is all in or all out
          *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) =
              pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// D: the real head dim (D == DP at 64 and 128; D % 8 == 0 and D rounded up
// to 32 == DP elsewhere). TRAP: the waits trap past their bound
// (mbar_wait, the d 64/128 instantiations) or fault (mbar_wait_no_trap,
// the padded ones, whose consumers then get setmaxnreg's 240 registers)
template <int DP, bool TRAP>
cudaError_t launch_dq_ws(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* dout, const float* lse,
                         const float* delta, bf16* dq, int B, int H, int Sq,
                         int Sk, int D, int causal, float scale,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_bshd(&tq, q, B, Sq, H, D, DQ_BM);
  if (!err) err = encode_bshd(&tdo, dout, B, Sq, H, D, DQ_BM);
  if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, DQ_BN);
  if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, DQ_BN);
  if (err) return static_cast<cudaError_t>(err);
  constexpr int smem = WsDqSmem<DP>::ALLOC;
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dq_ws_kernel<DP, TRAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sq + DQ_BM - 1) / DQ_BM, B * H);
  bwd_dq_ws_kernel<DP, TRAP><<<grid, WS_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, dq, H, Sq, Sk, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace
