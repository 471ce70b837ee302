// K3 (flash-attention dk/dv backward) in bf16 on wgmma at every head dim
// up to 256 but 64 and 128 (flash_attn_bwd.cu's own kernel), on two routes
// by what fills the kernel's shared-memory boxes (the FEED parameter):
//   - "wgmma_tma_ws_padded" (flash_attn_bwd_dkdv_padded.cu, FEED_TMA): D %
//     8 == 0, the row stride TMA takes; 4-D tensor maps with the real D
//     inner fill the columns D..DS of each row with zeros, and the rows
//     past S too;
//   - "wgmma_cp_async_ws_padded" (flash_attn_bwd_dkdv_padded_cp_async.cu,
//     FEED_CP_ASYNC): D % 8 != 0. The producer warpgroup's 128 threads
//     fill the same swizzled boxes with cp.async (8 or 4 bytes by the
//     row's alignment) or, at odd D, through registers (hopper_common.cuh:
//     fill_box). A stage's lse and delta rows stay 1-D TMA copies (fp32
//     rows read from a 16-byte boundary), so its full barrier counts the
//     128 producer threads' arrivals and one more, the expect_tx arrival
//     of the thread that issues the two copies.
// Replaces ray_tpu/ops/attention.py::_bwd_dkdv_kernel for those inputs
// (and, on the second route and under 64, the mma.sync kernel that served
// them until it); flash_attn_bwd.cu's header describes the kernel family,
// its numerics and this kernel's ptxas numbers.
//
// At these widths the 64/128 kernel's shape does not fit: 128 resident
// keys and a two-stage Q/dO ring are 258 KB of shared memory at a padded
// row of 256 columns, and a warpgroup holding dK and dV for its 64 keys
// keeps 2 * 64 * D fp32 values over 128 threads, D registers a thread
// (256 at D 256) before S^T and dP^T. So one block per (batch*head,
// 64-key tile) keeps K and V resident, and its two consumer warpgroups
// split every 64-query tile between them twice over:
//   1. by queries: warpgroup w computes S^T = K Q^T and dP^T = V dO^T for
//      queries [32 w, 32 w + 32) of the tile (m64n32k16, both operands in
//      shared memory, K-major), and p^T = exp(S^T scale - lse) and ds^T =
//      p^T (dP^T - delta) scale from them in fp32;
//   2. it stores both, rounded to bf16 (where the 64/128 kernel rounds
//      them too), into the tile's shared 64 x 64 p^T and ds^T tiles,
//      128-byte swizzled as TMA lays out a tile, and a named barrier of
//      the 256 consumer threads waits for the other half;
//   3. by columns: warpgroup w accumulates dV += p^T dO and dK += ds^T Q
//      over all 64 queries for its own columns of the head dim, both
//      operands in shared memory (p^T, ds^T K-major; dO and Q MN-major).
// Nothing is computed twice and there is one launch. Each warpgroup holds
// NW columns of dK and dV: NW registers a thread (96 at D 160, 128 at
// D 256), beside 16 each for its halves of S^T and dP^T.
//
// The columns: a row of the resident and streamed tiles is DS = D rounded
// up to 64 columns, boxes of 64 (zeros past D); the products over D (S^T,
// dP^T) run DP/16 k steps (DP: D rounded up to 32), the products whose N
// is the head dim run in box-aligned m64n128, m64n64 and m64n32 pieces
// (wgmma_ss_cols). Every piece starts on a box edge, so each warpgroup's
// columns start on one: with an even number of boxes the warpgroups take
// half of them each; with three (DS 192) warpgroup 0 computes [0, DP - 64)
// and warpgroup 1 [64, DP), and warpgroup 0 writes only [0, 64); with one
// (D <= 64, DP 32 or 64) no column split starts on a box edge, so the two
// warpgroups split the products instead: warpgroup 0 accumulates dV and
// warpgroup 1 dK, each over all DP columns (ONE_BOX). The two warpgroups
// meet at a barrier every tile, so the tile takes as long as the wider
// half: D 160 is 96 + 96 columns computed, D 192 128 + 128.
//
// The loop is software-pipelined: step it starts tile it's S^T and dP^T,
// then tile it - 1's dV and dK, and computes tile it's p^T and ds^T while
// those products run, so the tensor cores are not idle through the
// elementwise work.
//
// The ring: Q and dO tiles of 64 queries with the tile's lse and delta
// rows (1-D TMA copies from the 16-byte boundary before the first row,
// read shifted), three stages at DS <= 192, two at DS 256. Shared memory
// at DS 192 / 256: K and V 48 / 64 KB, the ring 147 / 130 KB, p^T and
// ds^T 16 KB: 211 / 210 KB. One p^T/ds^T pair, so before it is
// overwritten a barrier waits until both warpgroups' products of the last
// tile have read it (two pairs would not fit at DS 256).
//
// Every wait is mbar_wait_no_trap: with mbar_wait's trap, ptxas kept the
// consumers within 168 registers and spilled at DS 192 and 256.

#pragma once

#include <type_traits>

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int PD_BK = 64;  // keys per block
constexpr int PD_BQ = 64;  // queries per streamed tile
constexpr int PD_THREADS = 384;  // two consumer warpgroups + the producer
constexpr int PD_CONSUMERS = 256;
constexpr int PD_BARRIER = 1;  // the consumers' named barrier
// lse/delta values a stage holds: the tile's 64 from the 16-byte boundary
// at or before its first row, 4 more; delta's at a 128-byte offset
constexpr int PD_ROWS = PD_BQ + 4;
constexpr int PD_DELTA_OFF = 512;
constexpr int PD_TILE = PD_BK * SWIZZLE_ROW_BYTES;  // 64 x 64 bf16: 8 KB

template <int DP>
struct PdSmem {
  static_assert(DP % 32 == 0 && DP >= 32 && DP <= 256, "DP: 32..256 by 32");
  static constexpr int BOXES = (DP + BOX_COLS - 1) / BOX_COLS;
  // the columns of a box a product reads (DP 32: 32)
  static constexpr int COLS = DP < BOX_COLS ? DP : BOX_COLS;
  // K or V (resident), or one Q or dO tile: 64 rows of BOXES boxes
  static constexpr int KV_BYTES = BOXES * PD_TILE;
  static constexpr int QT_BYTES = BOXES * PD_TILE;
  // one stage: Q, dO, then lse and delta in the last 1024 bytes
  static constexpr int STAGE = 2 * QT_BYTES + 1024;
  // three stages where they fit (DS <= 192), else two
  static constexpr int STAGES = BOXES <= 3 ? 3 : 2;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int RING_OFF = 2 * KV_BYTES;
  static constexpr int PT_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int DST_OFF = PT_OFF + PD_TILE;
  static constexpr int BAR_OFF = DST_OFF + PD_TILE;
  // kv_full, then per stage full, empty
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
  static_assert(ALLOC <= 232448, "over the 227 KB a block may have");
  static_assert(PD_DELTA_OFF >= PD_ROWS * 4 &&
                    PD_DELTA_OFF + PD_ROWS * 4 <= 1024,
                "lse and delta rows must fit the stage's last 1024 bytes");
  // one box: warpgroup 0 dV and warpgroup 1 dK, over all DP columns
  static constexpr bool ONE_BOX = BOXES == 1;
  // else each warpgroup's columns: from box FIRST * wg, NW of them
  static constexpr int FIRST = BOXES == 3 ? 1 : BOXES / 2;
  static constexpr int NW =
      ONE_BOX ? DP : BOXES == 3 ? DP - BOX_COLS : FIRST * BOX_COLS;
  static constexpr int SPLIT = FIRST * BOX_COLS;  // warpgroup 1 writes from
};

// byte offset of (row r, column c) in a 128-byte-swizzled 64 x 64 bf16
// tile: 16-byte chunk c / 8 of row r is stored at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return r * SWIZZLE_ROW_BYTES + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

template <int DP, int FEED>
__global__ void __launch_bounds__(PD_THREADS, 1)
bwd_dkdv_padded_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_lse,
                       const __grid_constant__ CUtensorMap tm_delta,
                       const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                       int Sq, int Sk, int D, int causal, float scale) {
  using L = PdSmem<DP>;
  static_assert(feed_producers(FEED, 2) == 1, "one producer warpgroup");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + L::BAR_OFF;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + L::STAGES + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * PD_BK;  // the first tiles have the most work
  // causal: queries before k0 never see this tile's keys
  const int qt_first = causal ? k0 / PD_BQ : 0;
  const int n_iter = max(0, (Sq + PD_BQ - 1) / PD_BQ - qt_first);
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    // TMA: one expect_tx arrival a fill; the other feed one a producer
    // thread, and a stage's one more for its lse/delta copies
    const int fills = FEED == FEED_TMA ? 1 : FEED_THREADS;
    mbar_init(kv_full, fills);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), FEED == FEED_TMA ? 1 : FEED_THREADS + 1);
      mbar_init(empty(s), PD_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer
    setmaxnreg_dec<producer_regs(FEED, 2)>();
    if constexpr (FEED == FEED_TMA) {
      if (threadIdx.x == 256 && n_iter > 0) {
        prefetch_tensor_map(&tm_q);
        prefetch_tensor_map(&tm_do);
        mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load_4d(base + x * PD_TILE, &tm_k, kv_full, x * BOX_COLS, h,
                      k0, b);
          tma_load_4d(base + L::V_OFF + x * PD_TILE, &tm_v, kv_full,
                      x * BOX_COLS, h, k0, b);
        }
        for (int it = 0; it < n_iter; ++it) {
          const int s = it % L::STAGES;
          const int q0 = (qt_first + it) * PD_BQ;
          const uint32_t st = base + L::RING_OFF + s * L::STAGE;
          mbar_wait_no_trap(empty(s), ((it / L::STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * L::QT_BYTES + 2 * PD_ROWS * 4);
          for (int x = 0; x < L::BOXES; ++x) {
            tma_load_4d(st + x * PD_TILE, &tm_q, full(s), x * BOX_COLS, h,
                        q0, b);
            tma_load_4d(st + L::QT_BYTES + x * PD_TILE, &tm_do, full(s),
                        x * BOX_COLS, h, q0, b);
          }
          // lse/delta as one flat array: a tile past Sq reads the next
          // head's rows (or zeros past the end), masked below
          const int row0 = (bh * Sq + q0) & ~3;
          tma_load_1d(st + 2 * L::QT_BYTES, &tm_lse, full(s), row0);
          tma_load_1d(st + 2 * L::QT_BYTES + PD_DELTA_OFF, &tm_delta,
                      full(s), row0);
        }
      }
    } else if (n_iter > 0) {
      // every producer thread fills its share of each box
      const int pt = threadIdx.x % FEED_THREADS;
      const long stride = (long)H * D;  // elements between rows
      const bf16* kh = k + ((long)b * Sk * H + h) * D;
      const bf16* vh = v + ((long)b * Sk * H + h) * D;
      const bf16* qh = q + ((long)b * Sq * H + h) * D;
      const bf16* doh = dout + ((long)b * Sq * H + h) * D;
      for (int x = 0; x < L::BOXES; ++x) {
        fill_box<PD_BK, L::COLS, 8>(base + x * PD_TILE, kh, stride, k0, Sk,
                                    x * BOX_COLS, D, pt);
        fill_box<PD_BK, L::COLS, 8>(base + L::V_OFF + x * PD_TILE, vh,
                                    stride, k0, Sk, x * BOX_COLS, D, pt);
      }
      fill_done(kv_full, D);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % L::STAGES;
        const int q0 = (qt_first + it) * PD_BQ;
        const uint32_t st = base + L::RING_OFF + s * L::STAGE;
        mbar_wait_no_trap(empty(s), ((it / L::STAGES) & 1) ^ 1);
        if (pt == 0) {
          // the rows as the TMA feed copies them (above)
          mbar_expect_tx(full(s), 2 * PD_ROWS * 4);
          const int row0 = (bh * Sq + q0) & ~3;
          tma_load_1d(st + 2 * L::QT_BYTES, &tm_lse, full(s), row0);
          tma_load_1d(st + 2 * L::QT_BYTES + PD_DELTA_OFF, &tm_delta,
                      full(s), row0);
        }
        for (int x = 0; x < L::BOXES; ++x) {
          fill_box<PD_BQ, L::COLS, 8>(st + x * PD_TILE, qh, stride, q0, Sq,
                                      x * BOX_COLS, D, pt);
          fill_box<PD_BQ, L::COLS, 8>(st + L::QT_BYTES + x * PD_TILE, doh,
                                      stride, q0, Sq, x * BOX_COLS, D, pt);
        }
        fill_done(full(s), D);
      }
    }
  } else {
    // ---- consumers: all 64 keys; queries [32 wg, +32) of each tile for
    // S^T and dP^T, columns [FIRST * 64 wg, +NW) for dK and dV (at one
    // box: dV on warpgroup 0, dK on 1). Step it starts tile it's S^T and
    // dP^T, then tile it - 1's dV and dK (its p^T and ds^T already in
    // shared memory): the products of it - 1 run while this warpgroup
    // turns tile it's S^T and dP^T into p^T and ds^T. The first and last
    // steps are peeled, so that every wgmma_wait counts a fixed number of
    // groups (ptxas serialises the wgmmas when it cannot tell which group
    // a wait retires)
    setmaxnreg_inc<consumer_regs(FEED, 2)>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kr[2] = {warp * 16 + g, warp * 16 + g + 8};  // tile rows
    const float scale_log2 = scale * LOG2E;
    const int col0 = wg * L::FIRST * BOX_COLS;
    const uint32_t col_off = wg * L::FIRST * PD_TILE;  // byte offset

    // {dV, dK} of this warpgroup's columns; at one box its one product
    float acc[L::ONE_BOX ? 1 : 2][L::NW / 2];
#pragma unroll
    for (int a = 0; a < (L::ONE_BOX ? 1 : 2); ++a)
#pragma unroll
      for (int i = 0; i < L::NW / 2; ++i) acc[a][i] = 0.f;
    float sT[16], dpT[16];
    auto stage_of = [&](int it) {
      return base + L::RING_OFF + (it % L::STAGES) * L::STAGE;
    };

    // S^T = K Q^T and dP^T = V dO^T of tile it: [64 keys, this
    // warpgroup's 32 queries], K-major; two groups, so p^T is computed
    // while dP^T is still in flight
    auto start_s_dp = [&](int it) {
      const uint32_t k_at = opaque(base), v_at = opaque(base + L::V_OFF);
      const uint32_t q_half = stage_of(it) + wg * 32 * SWIZZLE_ROW_BYTES;
      const uint32_t do_half = q_half + L::QT_BYTES;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t at = (kk >> 2) * PD_TILE + (kk & 3) * 32;
        wgmma_ss_n32<0>(sT, sw128_desc(k_at + at, 16, 1024),
                        sw128_desc(q_half + at, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t at = (kk >> 2) * PD_TILE + (kk & 3) * 32;
        wgmma_ss_n32<0>(dpT, sw128_desc(v_at + at, 16, 1024),
                        sw128_desc(do_half + at, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // dV += p^T dO and dK += ds^T Q over tile it's 64 queries in 16-query
    // k steps: A = p^T / ds^T in shared memory (K-major, the k step 32
    // bytes into each row), B = dO / Q rows (MN-major, the k step 16 rows
    // on), N = this warpgroup's NW columns. At one box warpgroup 0 runs
    // the first product and warpgroup 1 the second, over all DP columns
    auto start_dv_dk = [&](int it) {
      const uint32_t pt = opaque(base + L::PT_OFF);
      const uint32_t dst = opaque(base + L::DST_OFF);
      const uint32_t q_cols = stage_of(it) + col_off;
#pragma unroll
      for (int kc = 0; kc < PD_BQ / 16; ++kc) {
        const uint32_t step = kc * 16 * SWIZZLE_ROW_BYTES;
        if constexpr (L::ONE_BOX) {
          const uint32_t a = wg == 0 ? pt : dst;
          const uint32_t rows = wg == 0 ? q_cols + L::QT_BYTES : q_cols;
          wgmma_ss_cols<L::NW>(acc[0], sw128_desc(a + kc * 32, 16, 1024),
                               rows + step, PD_TILE);
        } else {
          wgmma_ss_cols<L::NW>(acc[0], sw128_desc(pt + kc * 32, 16, 1024),
                               q_cols + L::QT_BYTES + step, PD_TILE);
          wgmma_ss_cols<L::NW>(acc[1], sw128_desc(dst + kc * 32, 16, 1024),
                               q_cols + step, PD_TILE);
        }
      }
      wgmma_commit();
    };
    // p^T = exp(S^T scale - lse[col]) and ds^T = p^T (dP^T - delta[col])
    // scale in fp32, one 8-query column block j at a time, the mask only
    // where the tile needs it (the causal diagonal, the ragged ends); both
    // rounded to bf16 into the shared p^T and ds^T tiles once both
    // warpgroups' products of the last tile have read them. S_DONE and
    // DP_DONE: the wgmma groups still in flight once S^T, then dP^T, is
    // complete
    auto p_ds = [&](int it, auto s_done, auto dp_done) {
      const int q0 = (qt_first + it) * PD_BQ;
      const unsigned char* rows = base_ptr + (stage_of(it) - base) +
                                  2 * L::QT_BYTES;
      // the tile's first row in the copy
      const int shift = (bh * Sq + q0) & 3;
      const float* lse_s = reinterpret_cast<const float*>(rows) + shift;
      const float* delta_s =
          reinterpret_cast<const float*>(rows + PD_DELTA_OFF) + shift;
      const bool edge = (causal && q0 + 32 * wg < k0 + PD_BK - 1) ||
                        q0 + PD_BQ > Sq || k0 + PD_BK > Sk;
      wgmma_wait<decltype(s_done)::value>();
      fence_operand(sT);
      float p[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = 32 * wg + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          p[i] = ex2(fmaf(sT[i], scale_log2, -lse_s[qi + (e & 1)] * LOG2E));
          if (edge) {
            const int qpos = q0 + qi + (e & 1);
            const int key = k0 + kr[e >> 1];
            const bool ok =
                qpos < Sq && key < Sk && (!causal || qpos >= key);
            p[i] = ok ? p[i] : 0.f;
          }
        }
      }
      wgmma_wait<decltype(dp_done)::value>();
      fence_operand(dpT);
      uint32_t pp[8], dd[8];  // {d[4j], d[4j+1]} on kr[0], the rest kr[1]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = 32 * wg + 8 * j + 2 * t;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = p[4 * j + e] * (dpT[4 * j + e] - delta_s[qi + (e & 1)]) *
                  scale;
        pp[2 * j] = pack_bf16(p[4 * j], p[4 * j + 1]);
        pp[2 * j + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
        dd[2 * j] = pack_bf16(ds[0], ds[1]);
        dd[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      return [&, pp, dd]() {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t at =
                sw128_offset(kr[r], 32 * wg + 8 * j + 2 * t);
            *reinterpret_cast<uint32_t*>(base_ptr + L::PT_OFF + at) =
                pp[2 * j + r];
            *reinterpret_cast<uint32_t*>(base_ptr + L::DST_OFF + at) =
                dd[2 * j + r];
          }
        }
      };
    };
    // the other warpgroup is done reading the last tile's p^T and ds^T;
    // then this warpgroup's 32 query columns of both, and wait for the
    // other's
    auto store = [&](auto write) {
      named_barrier_sync(PD_BARRIER, PD_CONSUMERS);
      write();
      fence_proxy_async();
      named_barrier_sync(PD_BARRIER, PD_CONSUMERS);
    };
    auto release = [&](int it) {
#pragma unroll
      for (int a = 0; a < (L::ONE_BOX ? 1 : 2); ++a) fence_operand(acc[a]);
      mbar_arrive(empty(it % L::STAGES));  // tile it's stage is done with
    };
    using G0 = std::integral_constant<int, 0>;
    using G1 = std::integral_constant<int, 1>;
    using G2 = std::integral_constant<int, 2>;

    if (n_iter > 0) {
      feed_acquire<FEED>(kv_full, 0);
      feed_acquire<FEED>(full(0), 0);
      wgmma_fence();
      start_s_dp(0);
      store(p_ds(0, G1{}, G0{}));
      for (int it = 1; it < n_iter; ++it) {
        feed_acquire<FEED>(full(it % L::STAGES), (it / L::STAGES) & 1);
        wgmma_fence();
        start_s_dp(it);
        start_dv_dk(it - 1);
        auto write = p_ds(it, G2{}, G1{});
        wgmma_wait<0>();
        release(it - 1);
        store(write);
      }
      wgmma_fence();
      start_dv_dk(n_iter - 1);
      wgmma_wait<0>();
      release(n_iter - 1);
    }

    // rows past Sk are never written; a tile no query reaches writes
    // zeros. Warpgroup 0 writes [0, SPLIT), warpgroup 1 [SPLIT, D); at
    // one box warpgroup 0 writes dv and warpgroup 1 dk, all D columns.
    // 4-byte stores at even D (a row then starts 4-byte aligned), one
    // element at a time at odd D
    const int own_lo = !L::ONE_BOX && wg == 1 ? L::SPLIT : 0;
    const int own_hi = !L::ONE_BOX && wg == 0 ? L::SPLIT : D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + kr[r];
      if (key >= Sk) continue;
      const long o = (((long)b * Sk + key) * H + h) * D;
#pragma unroll
      for (int j = 0; j < L::NW / 8; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        if (c < own_lo) continue;
        if constexpr (L::ONE_BOX) {
          store_pair_bf16((wg == 0 ? dv : dk) + o, c, own_hi,
                          acc[0][4 * j + 2 * r], acc[0][4 * j + 2 * r + 1]);
        } else {
          store_pair_bf16(dv + o, c, own_hi, (D & 1) == 0,
                          acc[0][4 * j + 2 * r], acc[0][4 * j + 2 * r + 1]);
          store_pair_bf16(dk + o, c, own_hi, (D & 1) == 0,
                          acc[1][4 * j + 2 * r], acc[1][4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int DP, int FEED>
cudaError_t launch_dkdv_padded(const bf16* q, const bf16* k, const bf16* v,
                               const bf16* dout, const float* lse,
                               const float* delta, bf16* dk, bf16* dv, int B,
                               int H, int Sq, int Sk, int D, int causal,
                               float scale, cudaStream_t stream) {
  // the other feed reads q/k/v/dout through their pointers: no tile maps
  CUtensorMap tq{}, tk{}, tv{}, tdo{}, tl{}, td{};
  int err = 0;
  if constexpr (FEED == FEED_TMA) {
    err = encode_bshd(&tq, q, B, Sq, H, D, PD_BQ);
    if (!err) err = encode_bshd(&tdo, dout, B, Sq, H, D, PD_BQ);
    if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, PD_BK);
    if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, PD_BK);
  }
  if (!err) err = encode_rows(&tl, lse, (long)B * H * Sq, PD_ROWS);
  if (!err) err = encode_rows(&td, delta, (long)B * H * Sq, PD_ROWS);
  if (err) return static_cast<cudaError_t>(err);
  constexpr int smem = PdSmem<DP>::ALLOC;
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dkdv_padded_kernel<DP, FEED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sk + PD_BK - 1) / PD_BK, B * H);
  bwd_dkdv_padded_kernel<DP, FEED><<<grid, PD_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, tl, td, q, k, v, dout, dk, dv, H, Sq, Sk, D, causal,
      scale);
  return cudaGetLastError();
}

// K3 at a padded head dim through the kernel fed by FEED, instantiated at
// DP = D rounded up to 32
template <int FEED>
cudaError_t bwd_dkdv_padded_feed(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta,
                                 void* dk, void* dv, int B, int H, int Sq,
                                 int Sk, int D, int causal, float scale,
                                 cudaStream_t stream) {
  const auto launch = [&](auto launcher) {
    return launcher(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v),
                    static_cast<const bf16*>(dout), lse, delta,
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, Sq,
                    Sk, D, causal, scale, stream);
  };
  switch ((D + 31) / 32 * 32) {
    case 32: return launch(&launch_dkdv_padded<32, FEED>);
    case 64: return launch(&launch_dkdv_padded<64, FEED>);
    case 96: return launch(&launch_dkdv_padded<96, FEED>);
    case 128: return launch(&launch_dkdv_padded<128, FEED>);
    case 160: return launch(&launch_dkdv_padded<160, FEED>);
    case 192: return launch(&launch_dkdv_padded<192, FEED>);
    case 224: return launch(&launch_dkdv_padded<224, FEED>);
    default: return launch(&launch_dkdv_padded<256, FEED>);
  }
}

}  // namespace
