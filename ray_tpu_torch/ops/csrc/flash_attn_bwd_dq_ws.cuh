// K2 in bf16 on wgmma (sm_90a): bwd_dq_ws_kernel and its launchers,
// shared by the translation units that instantiate it -- flash_attn_bwd.cu
// at head_dim 64 and 128, flash_attn_bwd_dq_padded.cu at every other D %
// 8 == 0 up to 256 (boxes filled by TMA) and
// flash_attn_bwd_dq_padded_cp_async.cu at D % 8 != 0 up to 256 (boxes
// filled by the producer warpgroups' cp.async, or through registers at
// odd D: hopper_common.cuh's fill_box). The design and its ptxas numbers
// are in flash_attn_bwd.cu's header.
//
// One block per (batch*head, q tile of 64 NCW rows); each consumer
// warpgroup owns 64 q rows and holds its dq accumulator [64, DP] in
// registers for the whole loop; the producer warpgroups keep the rings
// full. Q and dO are loaded once and stay; K and V tiles of 64 keys go
// round rings with their own full and empty barriers for K and for V: V is
// last read by dP, K by ds.K, so V's stage is released (and refilled)
// first.
//
// DP is the head dim the kernel computes, a multiple of 32: D itself at
// 64 and 128, else D rounded up to 32 (32 ... 256). A row of the resident
// and streamed tiles is DS = DP rounded up to a 64-column box; the
// columns D..DS of each row are zeros (TMA fills past the tensor map's
// inner dimension D, fill_box past D): S and dP sum over DP/16 k steps
// (the padded ones add zeros), dq += ds.K runs at N = DP in box-aligned
// pieces (a 32-column piece reads the first half of its box: the whole of
// DP 32, which fill_box fills no further), and only the D real columns of
// dq are written. At DS 256 with two consumer warpgroups two V stages do
// not fit beside resident Q/dO and two K stages (256 KB of the 227 KB a
// block may have): V gets one stage (224 KB).

#pragma once

#include <type_traits>

#include "flash_attn_common.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WS_THREADS = 384;  // two consumer warpgroups + the producer
constexpr int WS_CONSUMERS = 256;
constexpr int DQ_BN = 64;  // keys per K/V tile

template <int DP, int NCW>
struct WsDqSmem {
  static_assert(DP % 32 == 0 && DP >= 32 && DP <= 256, "DP: 32..256 by 32");
  static_assert(NCW == 1 || NCW == 2, "one or two consumer warpgroups");
  static constexpr int BM = 64 * NCW;  // q rows a block
  static constexpr int BOXES = (DP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int DS = BOXES * BOX_COLS;  // padded row, in columns
  // the columns of a box a product reads (DP 32: 32)
  static constexpr int COLS = DP < BOX_COLS ? DP : BOX_COLS;
  static constexpr int K_STAGES = 2;
  static constexpr int V_STAGES = DS <= 192 || NCW == 1 ? 2 : 1;
  static constexpr int Q_BYTES = BM * DS * 2;      // Q or dO, resident
  static constexpr int KV_BYTES = DQ_BN * DS * 2;  // one K or one V tile
  static constexpr int Q_BOX = BM * SWIZZLE_ROW_BYTES;  // bytes a box
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

template <int DP, bool TRAP, int FEED, int NCW>
__global__ void __launch_bounds__(128 * (NCW + feed_producers(FEED, NCW)),
                                  1)
bwd_dq_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int H, int Sq, int Sk, int D, int causal, float scale) {
  using L = WsDqSmem<DP, NCW>;
  static_assert(!TRAP || (FEED == FEED_TMA && NCW == 2),
                "the trapping waits: d 64/128 fed by TMA");
  constexpr int KS = L::K_STAGES, VS = L::V_STAGES, BM = L::BM;
  constexpr int CONSUMERS = 128 * NCW;
  constexpr int NPROD = feed_producers(FEED, NCW);
  // rows of odd-D loads a producer thread keeps in flight (fill_box):
  // fewer in the 56 registers beside two consumer warpgroups
  constexpr int FILL_BATCH = NCW == 2 ? 8 : 16;
  const auto wait = [](uint32_t bar, uint32_t parity) {
    if constexpr (TRAP)
      mbar_wait(bar, parity);
    else
      mbar_wait_no_trap(bar, parity);
  };
  // a consumer's wait on a full barrier (then, boxes filled without TMA,
  // the proxy fence before wgmma reads them)
  const auto acquire = [&](uint32_t bar, uint32_t parity) {
    wait(bar, parity);
    if constexpr (FEED != FEED_TMA) fence_proxy_async();
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
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest first
  // causal: keys past this tile's last row are never needed
  const int q_last = min(q0 + BM, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + DQ_BN - 1) / DQ_BN;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    // a TMA fill arrives once (expect_tx); the other feed once a thread
    const int fills = FEED == FEED_TMA ? 1 : FEED_THREADS;
    mbar_init(qdo_full, fills);
    for (int s = 0; s < KS; ++s) {
      mbar_init(k_full(s), fills);
      mbar_init(k_empty(s), CONSUMERS);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(v_full(s), fills);
      mbar_init(v_empty(s), CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg >= NCW) {
    // ---- producers: every warp lowers its register limit; TMA: one
    // thread keeps the rings full; else every thread of NPROD warpgroups,
    // each taking every NPROD-th fill of the sequence Q+dO, K0, V0, K1, ...
    if constexpr (NCW + NPROD > 2)
      setmaxnreg_dec<producer_regs(FEED, NCW)>();
    if constexpr (FEED == FEED_TMA) {
      if (threadIdx.x == CONSUMERS) {
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
      const int p = wg - NCW;  // this producer warpgroup's fills: p mod NPROD
      const int pt = threadIdx.x % FEED_THREADS;
      const long stride = (long)H * D;  // elements between rows
      const bf16* qh = q + ((long)b * Sq * H + h) * D;
      const bf16* doh = dout + ((long)b * Sq * H + h) * D;
      const bf16* kh = k + ((long)b * Sk * H + h) * D;
      const bf16* vh = v + ((long)b * Sk * H + h) * D;
      if (p == 0) {
        for (int x = 0; x < L::BOXES; ++x) {
          fill_box<BM, L::COLS, FILL_BATCH>(base + x * L::Q_BOX, qh, stride,
                                            q0, Sq, x * BOX_COLS, D, pt);
          fill_box<BM, L::COLS, FILL_BATCH>(base + L::DO_OFF + x * L::Q_BOX,
                                            doh, stride, q0, Sq,
                                            x * BOX_COLS, D, pt);
        }
        fill_done(qdo_full, D);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int sk = j % KS, sv = j % VS;
        if ((1 + 2 * j) % NPROD == p) {
          wait(k_empty(sk), ((j / KS) & 1) ^ 1);
          for (int x = 0; x < L::BOXES; ++x)
            fill_box<DQ_BN, L::COLS, FILL_BATCH>(
                base + L::K_OFF + sk * L::KV_BYTES + x * L::KV_BOX, kh,
                stride, j * DQ_BN, Sk, x * BOX_COLS, D, pt);
          fill_done(k_full(sk), D);
        }
        if ((2 + 2 * j) % NPROD == p) {
          wait(v_empty(sv), ((j / VS) & 1) ^ 1);
          for (int x = 0; x < L::BOXES; ++x)
            fill_box<DQ_BN, L::COLS, FILL_BATCH>(
                base + L::V_OFF + sv * L::KV_BYTES + x * L::KV_BOX, vh,
                stride, j * DQ_BN, Sk, x * BOX_COLS, D, pt);
          fill_done(v_full(sv), D);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [q0 + 64 wg, +64)
    if constexpr (NCW + NPROD > 2)
      setmaxnreg_inc<consumer_regs(FEED, NCW)>();
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
    acquire(qdo_full, 0);

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
      acquire(k_full(sk), k_parity);
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
      acquire(v_full(sv), v_parity);
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
      // Sk (loaded as zeros: S = 0 there, p = exp(-lse) != 0)
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

    // the D real columns: fed by TMA, D % 8 == 0, so an 8-column block is
    // all in or all out (store_pair_bf16 there ran the whole kernel 5 %
    // slower at d 160); else 4-byte stores at even D (the row then starts
    // 4-byte aligned), one element at a time at odd D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] >= Sq) continue;
      bf16* out = dq + (((long)b * Sq + qp[r]) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if constexpr (FEED == FEED_TMA) {
          if (8 * j < D)
            *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) =
                pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        } else {
          store_pair_bf16(out, 8 * j + 2 * t, D, acc[4 * j + 2 * r],
                          acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// D: the real head dim (D == DP at 64 and 128; D rounded up to 32 == DP
// elsewhere). TRAP: the waits trap past their bound (mbar_wait, the d
// 64/128 instantiations) or fault (mbar_wait_no_trap, the padded ones,
// whose consumers then get setmaxnreg's count). FEED: TMA fills the boxes
// (tensor maps over q/k/v/dout), or the producer warpgroups do (no maps).
template <int DP, bool TRAP, int FEED, int NCW>
cudaError_t launch_dq_ws(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* dout, const float* lse,
                         const float* delta, bf16* dq, int B, int H, int Sq,
                         int Sk, int D, int causal, float scale,
                         cudaStream_t stream) {
  using L = WsDqSmem<DP, NCW>;
  CUtensorMap tq{}, tk{}, tv{}, tdo{};
  if constexpr (FEED == FEED_TMA) {
    int err = encode_bshd(&tq, q, B, Sq, H, D, L::BM);
    if (!err) err = encode_bshd(&tdo, dout, B, Sq, H, D, L::BM);
    if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, DQ_BN);
    if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, DQ_BN);
    if (err) return static_cast<cudaError_t>(err);
  }
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dq_ws_kernel<DP, TRAP, FEED, NCW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sq + L::BM - 1) / L::BM, B * H);
  bwd_dq_ws_kernel<DP, TRAP, FEED, NCW>
      <<<grid, 128 * (NCW + feed_producers(FEED, NCW)), L::ALLOC, stream>>>(
          tq, tk, tv, tdo, q, k, v, dout, lse, delta, dq, H, Sq, Sk, D,
          causal, scale);
  return cudaGetLastError();
}

// K2 at a padded head dim through the kernel fed by FEED: DP = D rounded
// up to 32; one consumer warpgroup where 128-row tiles would leave SMs
// idle and 64-row ones still fit one wave (as K1's padded kernel chooses)
template <int FEED>
cudaError_t bwd_dq_padded_feed(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int H,
                               int Sq, int Sk, int D, int causal,
                               float scale, cudaStream_t stream) {
  const long blocks128 = (long)((Sq + 127) / 128) * B * H;
  const auto pick = [&](auto width) -> cudaError_t {
    constexpr int DP = decltype(width)::value;
    const auto launch = [&](auto launcher) {
      return launcher(static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const bf16*>(dout), lse, delta,
                      static_cast<bf16*>(dq), B, H, Sq, Sk, D, causal, scale,
                      stream);
    };
    if (2 * blocks128 <= sm_count())
      return launch(&launch_dq_ws<DP, false, FEED, 1>);
    return launch(&launch_dq_ws<DP, false, FEED, 2>);
  };
  switch ((D + 31) / 32 * 32) {
    case 32: return pick(std::integral_constant<int, 32>{});
    case 64: return pick(std::integral_constant<int, 64>{});
    case 96: return pick(std::integral_constant<int, 96>{});
    case 128: return pick(std::integral_constant<int, 128>{});
    case 160: return pick(std::integral_constant<int, 160>{});
    case 192: return pick(std::integral_constant<int, 192>{});
    case 224: return pick(std::integral_constant<int, 224>{});
    default: return pick(std::integral_constant<int, 256>{});
  }
}

}  // namespace
