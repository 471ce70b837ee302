// Flash-attention backward for Hopper (sm_90a), plain CUDA C++: two
// kernels, the flash-attention-2 split of the JAX package's TPU kernels.
//
//   dq   (K2) replaces ray_tpu/ops/attention.py::_bwd_dq_kernel
//        one block per (batch*head, q tile: 128 rows on the wgmma routes,
//        64 where 128-row tiles would leave SMs idle); a loop over the
//        key tiles up to the causal diagonal accumulates dq = sum_k ds.K
//        in fp32 registers;
//   dkdv (K3) replaces ray_tpu/ops/attention.py::_bwd_dkdv_kernel
//        one block per (batch*head, key tile: 128 keys on the wgmma
//        route at d 64/128, 64 on the others); a loop over the q tiles
//        from the first one at or below the diagonal to the end
//        accumulates dv = sum_q p^T.dO and dk = sum_q ds^T.Q.
//
// Both launched by _pallas_bwd on the TPU. Each block owns its output
// tile, so there are no atomics and the result is deterministic. Both
// recompute p = exp(q.k * scale - lse) from the forward's saved lse
// (the [S, S] matrix never reaches device memory); delta = rowsum(O*dO)
// comes in precomputed, as on the TPU.
//
// Numerics as in the TPU kernels: p in fp32 from lse, dp = dO.V^T
// accumulated in fp32 from native-dtype operands, ds = p*(dp - delta)*
// scale in fp32; ds (and p, for dv) rounded to the input dtype before the
// product that consumes them; dq/dk/dv accumulated in fp32 and rounded
// once at the end.
//
// What bounds them on an H100: at the b1 train shape (B8 S2048 H16 D128,
// causal) K2 does ~206 GFLOP against ~338 MB, K3 ~275 GFLOP against
// ~405 MB: ~600-700 FLOP/byte, above the card's ~295 FLOP/byte ridge, so
// both are bound by operations and the bf16 path runs on the tensor
// cores. attention.py::kernel_route names the kernel each launch takes:
//   - K2, bf16, head_dim 64 and 128: bwd_dq_ws_kernel, wgmma on a
//     TMA-fed ring with warp specialisation. One block per (batch*head,
//     128-row q tile), longest causal tiles first; a producer warpgroup
//     (setmaxnreg.dec to 24, one thread issuing every TMA load) and two
//     consumer warpgroups (setmaxnreg.inc to 240), each owning 64 q rows
//     and holding its fp32 dq [64, D] in registers for the whole loop (64
//     registers a thread at D 128). Q and dO stay resident; K and V
//     tiles of 64 keys go round a two-stage ring with separate full and
//     empty barriers for K and for V, so V's stage is refilled as soon as
//     dP has been read while K's waits for ds.K; each K/V tile fetched
//     serves 128 q rows. S = Q K^T and dP = dO V^T are wgmma m64n64k16
//     with both operands in shared memory (K-major), issued as two
//     groups so that p = exp2(S scale log2e - lse log2e) is computed
//     while dP is in flight; ds = p (dP - delta) scale is computed in
//     fp32 one 8-key column block at a time and packed to bf16 as the
//     register A operand of dq += ds K, whose B is the same K tile read
//     MN-major (the transpose bit). At 64 keys a tile S and dP are 32
//     registers each, so S, dP, dq and the packed ds fit a consumer's
//     240 beside its addresses. The upper warpgroup's rows end 64 before
//     the lower one's: at the causal diagonal it skips the last tile's
//     products but still releases its stages. ptxas (sm_90a, on the H100
//     host): 168 registers at entry, setmaxnreg gives the consumers 240
//     at run time, but the trap in mbar_wait keeps ptxas allocating them
//     within 168 (see mbar_wait_no_trap); no spills and no serialised
//     wgmmas at D 64 or 128 all the same. Leaving ds.K in
//     flight across the next tile's S and dP made ptxas serialise the
//     wgmmas (0.76x); a third ring stage and one elementwise pass after
//     both products each changed the time by under 1 % (PERF.md).
//   - K3, bf16, head_dim 64 and 128: bwd_dkdv_ws_kernel, wgmma on a
//     TMA-fed ring with warp specialisation. One block per (batch*head,
//     128-key tile); a producer warpgroup (setmaxnreg.dec to 24, one
//     thread issuing every TMA load) and two consumer warpgroups
//     (setmaxnreg.inc to 240), each owning 64 keys and holding its fp32
//     dK and dV [64, D] in registers for the whole loop (128 registers a
//     thread at D 128), so no atomics and a deterministic result. K and V
//     stay resident; Q and dO tiles of 64 queries, with the tile's lse and
//     delta rows (1-D TMA copies), go round a two-stage ring, and each
//     Q/dO tile fetched serves 128 keys. S^T = K Q^T and dP^T = V dO^T
//     are wgmma m64n64k16 with both operands in shared memory
//     (K-major); p^T and ds^T are computed in fp32 one 8-query column
//     block at a time and packed to bf16 as the register A operands of
//     dV += p^T dO and dK += ds^T Q (dO and Q MN-major through the
//     transpose bit). ptxas (sm_90a, CUDA 12.9, on the H100 host): 168
//     registers at entry; as K2's, its consumers are allocated within
//     168 because mbar_wait traps; at D 64 no spills; at D 128 272 bytes
//     of spills and the note that the wgmmas are serialised for want of
//     registers: that is what holds it back (each wgmma waits for the
//     last, so the products of one warpgroup do not overlap its own
//     elementwise work).
//   - K2 and K3, bf16, every other head_dim up to 256 (the padded wgmma
//     routes): instantiated at DP = D rounded up to 32 (32 ... 256) over
//     rows of DS = D rounded up to 64 columns, boxes of 64 whose columns
//     past D are zeros. What fills the boxes is the FEED parameter: TMA
//     at D % 8 == 0 (route "wgmma_tma_ws_padded"; TMA needs rows of a
//     multiple of 16 bytes, and fills past D with zeros), else the
//     producer warpgroup's threads ("wgmma_cp_async_ws_padded": cp.async
//     of 8 or 4 bytes by the row's alignment, loads through registers at
//     odd D; hopper_common.cuh's fill_box), whose full barriers count one
//     arrival a producer thread. The products that sum over the head dim
//     run DP/16 k steps; those whose N is the head dim run in m64n128,
//     m64n64 and m64n32 pieces, each from a box edge (hopper_common.cuh's
//     wgmma_rs_cols / wgmma_ss_cols; a 32-column piece reads the first
//     half of its box's 128-byte rows, held against the plain version at
//     d 80 and 160). Every wait is mbar_wait_no_trap, so ptxas allocates
//     the consumers within setmaxnreg's count (240 fed by TMA; 224 beside
//     a producer warpgroup that fills the boxes itself, which takes 56).
//     K2 is bwd_dq_ws_kernel<DP, false, FEED, NCW>
//     (flash_attn_bwd_dq_ws.cuh, instantiated in
//     flash_attn_bwd_dq_padded.cu and flash_attn_bwd_dq_padded_cp_async.cu):
//     the d 64/128 design, its dq [64, DP] accumulator DP/2 registers a
//     thread (80 at D 160, 128 at 256) beside S and dP's 64; two K and two
//     V stages up to DS 192 (192 KB of shared memory there), one V stage
//     at DS 256 (224 KB); 64-row q tiles on one consumer warpgroup where
//     128-row ones would leave SMs idle (three producer warpgroups beside
//     it where they fill the boxes). K3 is bwd_dkdv_padded_kernel<DP,
//     FEED> (flash_attn_bwd_dkdv_padded.cuh, instantiated in
//     flash_attn_bwd_dkdv_padded.cu and
//     flash_attn_bwd_dkdv_padded_cp_async.cu): one block per
//     (batch*head, 64-key tile), K and V resident, Q/dO tiles of 64
//     queries on a three-stage ring (two at DS 256); the consumer
//     warpgroups split each tile's queries for S^T and dP^T (m64n32k16),
//     exchange p^T and ds^T through two 64 x 64 bf16 tiles in shared
//     memory and named barriers, and split the head dim's columns for
//     dV += p^T dO and dK += ds^T Q (both operands in shared memory): NW
//     columns each (96 at D 160, 128 at D 192..256), so dK and dV are NW
//     registers a thread; at D <= 64 (one box) they split the two
//     products instead (warpgroup 0 dV, warpgroup 1 dK, DP columns each);
//     the loop is software-pipelined (tile it - 1's products run while
//     tile it's p^T and ds^T are computed); 211 KB of shared memory at DS
//     192, 210 at DS 256. ptxas (sm_90a, CUDA 12.9, on the H100 host;
//     tools/check_head_dims.py): 168 registers at entry with two consumer
//     warpgroups (K2 fed by TMA with one: 106-218; beside three filling
//     producer warpgroups: 128), no spills and no serialised wgmmas at
//     any DP or feed for either kernel. With mbar_wait's trap K2 spilled
//     128 / 260 / 388 / 836 bytes at DP 160 / 192 / 224 / 256 with its
//     wgmmas serialised, and K3 spilled at DP 192..256. These routes
//     replaced mma.sync kernels (m16n8k16 tiles in 64-row blocks of four
//     warps), which served D under 64 and off the multiples of 8 at about
//     1 % of their bound.
//   - fp32, every head_dim 1..256: exact FMAs on the CUDA cores (the
//     tensor cores would round to tf32), register-blocked and fed by a
//     cp.async ring, one slice (all of D) a block (route "fma_f32_ring";
//     one kernel for both in flash_attn_ring_f32.cuh): K2 with its query
//     rows of Q and dO resident (flash_attn_bwd_dq_fma_ring.cu), K3 with
//     its keys of K and V (flash_attn_bwd_dkdv_fma_ring.cu).
//   - past 256 (the tile rings of a block no longer fit its 227 KB of
//     shared memory at full width): K2 and K3 in bf16 at D % 8 == 0 on
//     wgmma (route "dchunk_wgmma_tma_ws", flash_attn_dchunk_bwd_wgmma.cuh:
//     a block per tile and slice of its output's columns, up to 256 of dq
//     and 128 of dk/dv, S and dP over the whole head dim in TMA boxes);
//     in fp32 on register-blocked FMAs fed by a cp.async ring
//     ("dchunk_fma_f32_ring", flash_attn_ring_f32.cuh, slices of
//     up to 320 columns); in bf16 off the multiples of 8 (a row stride
//     TMA cannot take) the same wgmma kernel with its boxes filled by the
//     producer warpgroups ("dchunk_wgmma_cp_async_ws").
// Causal tiles are skipped by the loop bounds; ragged edges are masked
// in the kernels (rows past the sequence load as zeros and are never
// written), Sq != Sk takes top-left causal alignment as the forward does.
//
// Plain C interface, loaded with ctypes: the caller allocates the outputs,
// passes the current stream and raises on a non-zero return.

#include "flash_attn_bwd_dq_ws.cuh"
#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// K3, bf16, head_dim 64 and 128: wgmma on a TMA-fed ring, warp-specialised.
// One block per (batch*head, 128-key tile); warpgroups 0 and 1 each own 64
// keys and hold their dK and dV accumulators [64, D] in registers for the
// whole loop; warpgroup 2 is the producer. K and V are loaded once and
// stay; Q and dO tiles of 64 queries, with the tile's lse and delta rows,
// go round a two-stage ring (full: TMA bytes landed; empty: all 256
// consumer threads done reading). A tile's rows start at bh * Sq + q0,
// on a 16-byte boundary only when Sq % 4 == 0; a 1-D TMA copy that starts
// off it never completed its barrier on the H100 and the wait trapped
// (Sq 197, 198 and 199 did, 196 ran; ViT-B/16's S is 197).
// ROWS_ALIGNED = false copies from the boundary before the
// first row (4 values more) and reads the rows shifted, one float at a
// time; it costs registers, so Sq % 4 == 0 keeps the direct copy.
// ---------------------------------------------------------------------------

constexpr int WS_BK = 128;  // keys per block
constexpr int WS_BQ = 64;   // queries per streamed tile
constexpr int WS_STAGES = 2;

template <int D>
struct WsDkdvSmem {
  static constexpr int KV_BYTES = WS_BK * D * 2;  // K or V, resident
  static constexpr int QT_BYTES = WS_BQ * D * 2;  // one Q or dO tile
  static constexpr int KV_BOX = WS_BK * SWIZZLE_ROW_BYTES;  // bytes a box
  static constexpr int QT_BOX = WS_BQ * SWIZZLE_ROW_BYTES;
  // one stage: Q, dO, lse, delta; padded to the 1024-byte swizzle grid
  static constexpr int STAGE = 2 * QT_BYTES + 1024;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int RING_OFF = 2 * KV_BYTES;
  static constexpr int BAR_OFF = RING_OFF + WS_STAGES * STAGE;
  // kv_full, then per stage full, empty
  static constexpr int BYTES = BAR_OFF + (1 + 2 * WS_STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
};

// the lse or delta rows of a tile in its stage: the tile's own 64, or,
// copied from the 16-byte boundary before them, 4 more
template <bool ROWS_ALIGNED>
struct WsRows {
  static constexpr int LEN = ROWS_ALIGNED ? WS_BQ : WS_BQ + 4;
  static constexpr int BYTES = LEN * 4;
  static constexpr int DELTA_OFF = ROWS_ALIGNED ? BYTES : 512;  // 128-aligned
  static_assert(DELTA_OFF >= BYTES && DELTA_OFF + BYTES <= 1024,
                "lse and delta rows must fit the stage's last 1024 bytes");
};

template <int D, bool ROWS_ALIGNED>
__global__ void __launch_bounds__(WS_THREADS, 1)
bwd_dkdv_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_lse,
                   const __grid_constant__ CUtensorMap tm_delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                   int Sq, int Sk, int causal, float scale) {
  using L = WsDkdvSmem<D>;
  using R = WsRows<ROWS_ALIGNED>;
  constexpr int BOXES = D / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + L::BAR_OFF;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + WS_STAGES + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * WS_BK;  // the first tiles have the most work
  // causal: queries before k0 never see this tile's keys
  const int qt_first = causal ? k0 / WS_BQ : 0;
  const int n_iter = max(0, (Sq + WS_BQ - 1) / WS_BQ - qt_first);
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WS_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && n_iter > 0) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_do);
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(base + x * L::KV_BOX, &tm_k, kv_full, x * BOX_COLS, h,
                    k0, b);
        tma_load_4d(base + L::V_OFF + x * L::KV_BOX, &tm_v, kv_full,
                    x * BOX_COLS, h, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % WS_STAGES;
        const int q0 = (qt_first + it) * WS_BQ;
        const uint32_t st = base + L::RING_OFF + s * L::STAGE;
        mbar_wait(empty(s), ((it / WS_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::QT_BYTES + 2 * R::BYTES);
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * L::QT_BOX, &tm_q, full(s), x * BOX_COLS, h, q0,
                      b);
          tma_load_4d(st + L::QT_BYTES + x * L::QT_BOX, &tm_do, full(s),
                      x * BOX_COLS, h, q0, b);
        }
        // lse/delta as one flat array: a tile past Sq reads the next
        // head's rows (or zeros past the end), masked below
        const int row0 = ROWS_ALIGNED ? bh * Sq + q0 : (bh * Sq + q0) & ~3;
        tma_load_1d(st + 2 * L::QT_BYTES, &tm_lse, full(s), row0);
        tma_load_1d(st + 2 * L::QT_BYTES + R::DELTA_OFF, &tm_delta, full(s),
                    row0);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys [k0 + 64 wg, +64)
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wg_key = k0 + wg * 64;
    const int kp[2] = {wg_key + warp * 16 + g, wg_key + warp * 16 + g + 8};
    const float scale_log2 = scale * LOG2E;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    const uint32_t k_rows = base + wg * 64 * SWIZZLE_ROW_BYTES;
    const uint32_t v_rows = k_rows + L::V_OFF;
    if (n_iter > 0) mbar_wait(kv_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % WS_STAGES;
      const int q0 = (qt_first + it) * WS_BQ;
      const uint32_t q_tile = base + L::RING_OFF + s * L::STAGE;
      const uint32_t do_tile = q_tile + L::QT_BYTES;
      const unsigned char* rows =
          base_ptr + L::RING_OFF + s * L::STAGE + 2 * L::QT_BYTES;
      // the tile's first row in the copy
      const int shift = ROWS_ALIGNED ? 0 : (bh * Sq + q0) & 3;
      const float* lse_s = reinterpret_cast<const float*>(rows) + shift;
      const float* delta_s =
          reinterpret_cast<const float*>(rows + R::DELTA_OFF) + shift;
      mbar_wait(full(s), (it / WS_STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T: [64 keys, 64 queries], K-major;
      // two groups, so p^T is computed while dP^T is still in flight
      float sT[32], dpT[32];
      const uint32_t k_at = opaque(k_rows), v_at = opaque(v_rows);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk & 3) * 32;
        wgmma_ss_n64<0>(
            sT, sw128_desc(k_at + (kk >> 2) * L::KV_BOX + in_box, 16, 1024),
            sw128_desc(q_tile + (kk >> 2) * L::QT_BOX + in_box, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk & 3) * 32;
        wgmma_ss_n64<0>(
            dpT, sw128_desc(v_at + (kk >> 2) * L::KV_BOX + in_box, 16, 1024),
            sw128_desc(do_tile + (kk >> 2) * L::QT_BOX + in_box, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sT);
      fence_operand(dpT);

      // One 8-query column block j at a time: p^T = exp(S^T scale -
      // lse[col]) and ds^T = p^T (dP^T - delta[col]) scale in fp32, the
      // mask only where the tile needs it (the causal diagonal, the
      // ragged ends), both packed to bf16 as the register A operands of
      // dV += p^T dO and dK += ds^T Q. The empty asm keeps each block's
      // lse/delta loads at the block, so the accumulators of S^T and dP^T
      // die as the packed operands fill and nothing is held beside them.
      const bool edge = (causal && q0 < wg_key + 63) || q0 + WS_BQ > Sq ||
                        wg_key + 64 > Sk;
      uint32_t pa[WS_BQ / 16][4], da[WS_BQ / 16][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        asm volatile("" ::: "memory");
        const int qi = 8 * j + 2 * t;
        float2 lr, dr;
        if constexpr (ROWS_ALIGNED) {
          lr = *reinterpret_cast<const float2*>(lse_s + qi);
          dr = *reinterpret_cast<const float2*>(delta_s + qi);
        } else {  // shifted rows are only 4-byte aligned
          lr = make_float2(lse_s[qi], lse_s[qi + 1]);
          dr = make_float2(delta_s[qi], delta_s[qi + 1]);
        }
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float lse_c = (e & 1) ? lr.y : lr.x;
          p[e] = ex2(fmaf(sT[i], scale_log2, -lse_c * LOG2E));
          if (edge) {
            const int qpos = q0 + qi + (e & 1);
            const int key = kp[e >> 1];
            const bool ok =
                qpos < Sq && key < Sk && (!causal || qpos >= key);
            p[e] = ok ? p[e] : 0.f;
          }
          ds[e] = p[e] * (dpT[i] - ((e & 1) ? dr.y : dr.x)) * scale;
        }
        // column block j holds A-fragment pairs x = 2 (j & 1), +1 of
        // 16-query step j / 2
        pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
        da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
        da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < WS_BQ / 16; ++kc) {
        const uint32_t step = kc * 16 * SWIZZLE_ROW_BYTES;
        const uint64_t d_do = sw128_desc(do_tile + step, L::QT_BOX, 1024);
        const uint64_t d_q = sw128_desc(q_tile + step, L::QT_BOX, 1024);
        if constexpr (D == 128) {
          wgmma_rs_n128<1>(dva, pa[kc], d_do, 1);
          wgmma_rs_n128<1>(dka, da[kc], d_q, 1);
        } else {
          wgmma_rs_n64<1>(dva, pa[kc], d_do, 1);
          wgmma_rs_n64<1>(dka, da[kc], d_q, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dva);
      fence_operand(dka);
      mbar_arrive(empty(s));
    }

    // rows past Sk are never written; a tile no query reaches writes zeros
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kp[r] >= Sk) continue;
      const long o = (((long)b * Sk + kp[r]) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + o + j * 8 + 2 * t) =
            pack_bf16(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + j * 8 + 2 * t) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int D, bool ROWS_ALIGNED>
cudaError_t launch_dkdv_ws(const bf16* q, const bf16* k, const bf16* v,
                           const bf16* dout, const float* lse,
                           const float* delta, bf16* dk, bf16* dv, int B,
                           int H, int Sq, int Sk, int causal, float scale,
                           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tl, td;
  int err = encode_bshd(&tq, q, B, Sq, H, D, WS_BQ);
  if (!err) err = encode_bshd(&tdo, dout, B, Sq, H, D, WS_BQ);
  if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, WS_BK);
  if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, WS_BK);
  constexpr int row_len = WsRows<ROWS_ALIGNED>::LEN;
  if (!err) err = encode_rows(&tl, lse, (long)B * H * Sq, row_len);
  if (!err) err = encode_rows(&td, delta, (long)B * H * Sq, row_len);
  if (err) return static_cast<cudaError_t>(err);
  constexpr int smem = WsDkdvSmem<D>::ALLOC;
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dkdv_ws_kernel<D, ROWS_ALIGNED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sk + WS_BK - 1) / WS_BK, B * H);
  bwd_dkdv_ws_kernel<D, ROWS_ALIGNED><<<grid, WS_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, tl, td, dk, dv, H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim D in [1, 256]. q/dout/dq
// [B,Sq,H,D], k/v [B,Sk,H,D], all contiguous with 16-byte aligned bases
// and of one dtype; lse and delta [B,H,Sq] float32. Returns a cudaError_t
// (0 on success).
extern "C" int rtt_flash_attn_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int B, int H, int Sq, int Sk,
                                     int D, int causal, float scale,
                                     int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (rtt::dchunk_head_dim(D) && dtype == 0)
    return rtt::bwd_dq_dchunk_fma(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D,
                                  causal, scale, s);
  if (rtt::dchunk_wgmma_head_dim(D) && dtype == 1)
    return rtt::bwd_dq_dchunk_wgmma(q, k, v, dout, l, dl, dq, B, H, Sq, Sk,
                                    D, causal, scale, s);
  if (rtt::dchunk_unaligned_head_dim(D) && dtype == 1)
    return rtt::bwd_dq_dchunk_wgmma_cp_async(q, k, v, dout, l, dl, dq, B, H,
                                             Sq, Sk, D, causal, scale, s);
  if (rtt::fma_ring_head_dim(D) && dtype == 0)
    return rtt::bwd_dq_fma_ring(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D,
                                causal, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  const bf16 *bq = static_cast<const bf16*>(q),
             *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v),
             *bdo = static_cast<const bf16*>(dout);
  if (D == 64)
    return launch_dq_ws<64, true, FEED_TMA, 2>(bq, bk, bv, bdo, l, dl,
                                               static_cast<bf16*>(dq), B, H,
                                               Sq, Sk, 64, causal, scale, s);
  if (D == 128)
    return launch_dq_ws<128, true, FEED_TMA, 2>(bq, bk, bv, bdo, l, dl,
                                                static_cast<bf16*>(dq), B, H,
                                                Sq, Sk, 128, causal, scale,
                                                s);
  if (rtt::wgmma_padded_head_dim(D))
    return rtt::bwd_dq_padded(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D,
                              causal, scale, s);
  return rtt::bwd_dq_padded_cp_async(q, k, v, dout, l, dl, dq, B, H, Sq, Sk,
                                     D, causal, scale, s);
}

extern "C" int rtt_flash_attn_bwd_dkdv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D, int causal,
                                       float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (rtt::dchunk_head_dim(D) && dtype == 0)
    return rtt::bwd_dkdv_dchunk_fma(q, k, v, dout, l, dl, dk, dv, B, H, Sq,
                                    Sk, D, causal, scale, s);
  if (rtt::dchunk_wgmma_head_dim(D) && dtype == 1)
    return rtt::bwd_dkdv_dchunk_wgmma(q, k, v, dout, l, dl, dk, dv, B, H,
                                      Sq, Sk, D, causal, scale, s);
  if (rtt::dchunk_unaligned_head_dim(D) && dtype == 1)
    return rtt::bwd_dkdv_dchunk_wgmma_cp_async(q, k, v, dout, l, dl, dk, dv,
                                               B, H, Sq, Sk, D, causal, scale,
                                               s);
  if (rtt::fma_ring_head_dim(D) && dtype == 0)
    return rtt::bwd_dkdv_fma_ring(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk,
                                  D, causal, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (D == 64 || D == 128) {
    // K3's lse/delta rows are TMA-copied directly only when they start on
    // a 16-byte boundary (Sq % 4 == 0)
    const auto launch_ws =
        D == 64 ? (Sq % 4 == 0 ? &launch_dkdv_ws<64, true>
                               : &launch_dkdv_ws<64, false>)
                : (Sq % 4 == 0 ? &launch_dkdv_ws<128, true>
                               : &launch_dkdv_ws<128, false>);
    return launch_ws(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v),
                     static_cast<const bf16*>(dout), l, dl,
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, Sq,
                     Sk, causal, scale, s);
  }
  if (rtt::wgmma_padded_head_dim(D))
    return rtt::bwd_dkdv_padded(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk,
                                D, causal, scale, s);
  return rtt::bwd_dkdv_padded_cp_async(q, k, v, dout, l, dl, dk, dv, B, H,
                                       Sq, Sk, D, causal, scale, s);
}
