// K1 (flash-attention forward) in bf16 on wgmma at every head dim up to
// 256 that flash_attn_fwd.cu's d 64/128 kernel does not take. Replaces
// ray_tpu/ops/attention.py::_flash_kernel (launched by _pallas_fwd) for
// those inputs; flash_attn_fwd.cu's header describes the kernel family
// and its numerics. Two routes share the kernel, by what fills its
// shared-memory boxes (the FEED parameter):
//   - "wgmma_tma_ws_padded" (flash_attn_fwd_padded.cu, FEED_TMA): D % 8
//     == 0, the row stride TMA takes. 4-D tensor maps {D, H, S, B} with
//     the real D inner, 128-byte swizzle and boxes of 64 columns: TMA
//     fills the columns D..DS of each row with zeros, and the rows past S
//     of its batch too; a box of 64 columns over a D under 64 is the
//     same case;
//   - "wgmma_cp_async_ws_padded" (flash_attn_fwd_padded_cp_async.cu,
//     FEED_CP_ASYNC): D % 8 != 0. The producer warpgroup's 128 threads
//     fill the same swizzled boxes with cp.async (8 or 4 bytes by the
//     row's alignment) or, at odd D, through registers
//     (hopper_common.cuh: fill_box); each stage completes on its full
//     barrier, one arrival a producer thread. Beside one consumer
//     warpgroup there are three producer warpgroups, each filling every
//     third stage: at odd D a warpgroup waits for global memory once a
//     batch of rows, and one of them ran d 301 at half the speed.
// flash_fwd_padded_kernel<DP, NCW, FEED> is instantiated at DP = D
// rounded up to 32 (32, 64, ..., 256; DP 64 serves D 33..63, DP 128 D
// 97..127, D 64 and 128 themselves taking flash_attn_fwd.cu's kernel):
//   - one block per (batch*head, q tile of 64 NCW rows), longest causal
//     tiles first; producer warpgroups (above) and NCW consumer ones, each
//     owning 64 q rows and its O [64, DP] in fp32 registers (DP/2 a
//     thread: 80 at D 160, 128 at 256). NCW is 2 (128-row tiles: each K/V
//     tile fetched serves 128 rows; the producer lowers its registers to
//     24, 56 where it fills the boxes itself, by setmaxnreg.dec and the
//     consumers raise theirs to 240, 224 beside the latter) unless
//     128-row tiles would leave SMs idle and 64-row ones still fit one
//     wave, then 1 (64-row tiles, twice the blocks; fed by TMA, 256
//     threads may take 255 registers each without setmaxnreg; beside
//     three producer warpgroups the consumers raise theirs to 240 and the
//     producers lower theirs to 88): the d16_bf16 row (B2 S1000 H4) has
//     64 blocks of 128 rows for 132 SMs, 128 of 64. At d192 B2 S1000 H8
//     (128 blocks of 128 rows) 64-row tiles ran 0.80x;
//   - Q stays resident; K and V tiles of BN keys go round a two-stage
//     ring with a full and an empty barrier for K and for V in each
//     stage. BN is as wide as shared memory allows at the padded row DS
//     (DP rounded up to a 64-column box): 128 keys at DS 64 and 128, 96
//     at 192, 64 at 256, for 80 / 160 / 192 / 192 KB at two consumer
//     warpgroups;
//   - S = Q K^T is wgmma m64nBNk16 with both operands K-major in shared
//     memory over DP/16 k steps (the padded ones add zeros): BN/2
//     registers;
//   - the online softmax runs in the log2 domain with scale * log2 e
//     folded into the exponent's FMA; masks (the causal diagonal, keys
//     past Sk) only on the tiles that need them; the causal bound is the
//     loop bound, and a warpgroup skips the tiles past its own rows (the
//     upper one, whose rows end 64 before the lower one's, at the
//     diagonal; one wholly past Sq all of them), still releasing their
//     stages;
//   - P is the fp32 accumulator repacked to bf16 pairs in registers (the
//     register A operand; l sums the unrounded p), and O += P V runs at N
//     = DP in box-aligned m64n128 / m64n64 / m64n32 pieces with V MN-major
//     (wgmma_rs_cols); only the D real columns of out are written (4-byte
//     stores at even D, one element at a time at odd D), and lse =
//     m ln 2 + log(max(l, 1e-20));
//   - the loop is software-pipelined inside each warpgroup: tile j's S is
//     issued beside tile j - 1's P V, and tile j's softmax runs while that
//     P V is in flight (O is rescaled once it has landed); two warpgroups
//     overlap each other too;
//   - every wait is mbar_wait_no_trap: any __trap() in the kernel keeps
//     ptxas allocating the consumers within the launch bound's 168
//     registers, whatever setmaxnreg gives them (hopper_common.cuh).
// ptxas (sm_90a, on the H100 host; tools/check_head_dims.py): 168
// registers at entry with two consumer warpgroups, 138-202 with one fed
// by TMA, 128 at the other feed's 512 threads; no spills and no
// serialised wgmma at any width, layout or feed.
// What held the TMA route back at D % 8 == 0 past 64 is open (PERF.md):
// at bench.py's xl16 train shape, with its products taken out the loop
// ran no faster than the whole kernel, with its softmax taken out 13 %
// faster, and with each K/V tile loaded once for a cluster of two blocks
// (TMA multicast) 1.7x slower. Turns between the warpgroups over named
// barriers (FA3's ping-pong) and 112- and 80-key tiles each moved it by
// 2 % or less; 64-key tiles in three stages ran 6 % slower. Under 64 and
// at short rows (d 16, S 1000) the walk over key tiles, one after the
// other in each block, sets the time, not the products.

#pragma once

#include <type_traits>

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// D[64, 96] (+)= A[64, 16] * B[16, 96], A and B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, %51;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// S[64, BN] (+)= Q[64, 16] * K[BN, 16]^T, both K-major in shared memory
template <int BN>
__device__ __forceinline__ void wgmma_ss_keys(float (&d)[BN / 2],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
  if constexpr (BN == 64)
    wgmma_ss_n64<0>(d, da, db, scale_d);
  else if constexpr (BN == 96)
    wgmma_ss_n96<0>(d, da, db, scale_d);
  else
    wgmma_ss_n128<0>(d, da, db, scale_d);
}

template <int DP, int NCW>
struct FwdPaddedSmem {
  static_assert(DP % 32 == 0 && DP >= 32 && DP <= 256, "DP: 32..256 by 32");
  static_assert(NCW == 1 || NCW == 2, "one or two consumer warpgroups");
  static constexpr int BM = 64 * NCW;  // q rows a block
  static constexpr int BOXES = (DP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int DS = BOXES * BOX_COLS;  // padded row, in columns
  // the columns of a box a product reads (the last box of DP 32: 32)
  static constexpr int COLS = DP < BOX_COLS ? DP : BOX_COLS;
  // keys a K/V tile: as many as two stages beside Q leave room for
  static constexpr int BN = DS <= 128 ? 128 : DS <= 192 ? 96 : 64;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * DS * 2;   // resident
  static constexpr int KV_BYTES = BN * DS * 2;  // one K or one V tile
  static constexpr int Q_BOX = BM * SWIZZLE_ROW_BYTES;  // bytes a box
  static constexpr int KV_BOX = BN * SWIZZLE_ROW_BYTES;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int BYTES = BAR_OFF + (1 + 4 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
  static_assert(ALLOC <= 232448, "over the 227 KB a block may have");
};

template <int DP, int NCW, int FEED>
__global__ void __launch_bounds__(128 * (NCW + feed_producers(FEED, NCW)),
                                  1)
flash_fwd_padded_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ lse, int H, int Sq, int Sk,
                        int D, int causal, float scale_log2) {
  using L = FwdPaddedSmem<DP, NCW>;
  constexpr int ST = L::STAGES, BN = L::BN, BM = L::BM;
  constexpr int CONSUMERS = 128 * NCW;
  constexpr int NPROD = feed_producers(FEED, NCW);
  // rows of odd-D loads a producer thread keeps in flight (fill_box):
  // fewer in the 56 registers beside two consumer warpgroups
  constexpr int FILL_BATCH = NCW == 2 ? 8 : 16;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + ST + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * ST + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest first
  // causal: keys past this tile's last row are never needed
  const int q_last = min(q0 + BM, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + BN - 1) / BN;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    // a TMA fill arrives once (expect_tx); the other feed once a thread
    const int fills = FEED == FEED_TMA ? 1 : FEED_THREADS;
    mbar_init(q_full, fills);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), fills);
      mbar_init(v_full(s), fills);
      mbar_init(k_empty(s), CONSUMERS);
      mbar_init(v_empty(s), CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg >= NCW) {
    // ---- producers: keep the ring full (TMA: one thread; else every
    // thread of NPROD warpgroups, each taking every NPROD-th fill of the
    // sequence Q, K0, V0, K1, V1, ...)
    if constexpr (NCW + NPROD > 2)
      setmaxnreg_dec<producer_regs(FEED, NCW)>();
    if constexpr (FEED == FEED_TMA) {
      if (threadIdx.x == CONSUMERS) {
        prefetch_tensor_map(&tm_q);
        prefetch_tensor_map(&tm_k);
        prefetch_tensor_map(&tm_v);
        mbar_expect_tx(q_full, L::Q_BYTES);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_4d(base + x * L::Q_BOX, &tm_q, q_full, x * BOX_COLS, h,
                      q0, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % ST;
          const uint32_t free_parity = ((j / ST) & 1) ^ 1;
          mbar_wait_no_trap(k_empty(s), free_parity);
          mbar_expect_tx(k_full(s), L::KV_BYTES);
          for (int x = 0; x < L::BOXES; ++x)
            tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + x * L::KV_BOX,
                        &tm_k, k_full(s), x * BOX_COLS, h, j * BN, b);
          mbar_wait_no_trap(v_empty(s), free_parity);
          mbar_expect_tx(v_full(s), L::KV_BYTES);
          for (int x = 0; x < L::BOXES; ++x)
            tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + x * L::KV_BOX,
                        &tm_v, v_full(s), x * BOX_COLS, h, j * BN, b);
        }
      }
    } else {
      const int p = wg - NCW;  // this producer warpgroup's fills: p mod NPROD
      const int pt = threadIdx.x % FEED_THREADS;
      const long stride = (long)H * D;  // elements between rows
      const bf16* qh = q + ((long)b * Sq * H + h) * D;
      const bf16* kh = k + ((long)b * Sk * H + h) * D;
      const bf16* vh = v + ((long)b * Sk * H + h) * D;
      if (p == 0) {
        for (int x = 0; x < L::BOXES; ++x)
          fill_box<BM, L::COLS, FILL_BATCH>(base + x * L::Q_BOX, qh, stride,
                                            q0, Sq, x * BOX_COLS, D, pt);
        fill_done(q_full, D);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t free_parity = ((j / ST) & 1) ^ 1;
        if ((1 + 2 * j) % NPROD == p) {
          mbar_wait_no_trap(k_empty(s), free_parity);
          for (int x = 0; x < L::BOXES; ++x)
            fill_box<BN, L::COLS, FILL_BATCH>(
                base + L::K_OFF + s * L::KV_BYTES + x * L::KV_BOX, kh,
                stride, j * BN, Sk, x * BOX_COLS, D, pt);
          fill_done(k_full(s), D);
        }
        if ((2 + 2 * j) % NPROD == p) {
          mbar_wait_no_trap(v_empty(s), free_parity);
          for (int x = 0; x < L::BOXES; ++x)
            fill_box<BN, L::COLS, FILL_BATCH>(
                base + L::V_OFF + s * L::KV_BYTES + x * L::KV_BOX, vh,
                stride, j * BN, Sk, x * BOX_COLS, D, pt);
          fill_done(v_full(s), D);
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
    // the tiles this warpgroup's rows reach (see the header); a skipped
    // tile's stages are still released
    const int wg_kv = causal ? min(Sk, min(wg_row + 64, Sq)) : Sk;
    const int wg_tiles = wg_row < Sq ? (wg_kv + BN - 1) / BN : 0;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    // running max (log2 domain: scores times scale * log2 e) and sum
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float sc[BN / 2];        // S of one tile, then its p in fp32
    uint32_t pa[BN / 16][4];  // p in bf16: the A operand of P V
    const uint32_t q_rows = base + wg * 64 * SWIZZLE_ROW_BYTES;

    // S = Q K^T of tile j: [64 rows, BN keys], both operands K-major
    auto issue_s = [&](int j) {
      const int s = j % ST;
      const uint32_t k_tile = base + L::K_OFF + s * L::KV_BYTES;
      const uint32_t q_at = opaque(q_rows);
      feed_acquire<FEED>(k_full(s), (j / ST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t in_box = (kk & 3) * 32;
        wgmma_ss_keys<BN>(
            sc, sw128_desc(q_at + (kk >> 2) * L::Q_BOX + in_box, 16, 1024),
            sw128_desc(k_tile + (kk >> 2) * L::KV_BOX + in_box, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile j over 16-key steps: V is MN-major (head_dim
    // contiguous), so B is transposed; N = DP in box-aligned pieces
    auto issue_pv = [&](int j) {
      const int s = j % ST;
      const uint32_t v_tile = base + L::V_OFF + s * L::KV_BYTES;
      feed_acquire<FEED>(v_full(s), (j / ST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs_cols<DP>(o, pa[kc], v_tile + kc * 16 * SWIZZLE_ROW_BYTES,
                          L::KV_BOX);
      wgmma_commit();
    };
    // online softmax of tile j in sc (a row lives on the 4 lanes of a
    // quad): mask only the tiles that need it, update m and l, leave p in
    // sc and O's rescale factor in alpha
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = j * BN;
      if ((causal && k0 + BN - 1 > wg_row) || k0 + BN > Sk) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (kp >= Sk || (causal && kp > qp[(i >> 1) & 1])) sc[i] = NEG_INF;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = alpha[r] * l[r] + sum[r];  // l sums the unrounded p
      }
    };
    // p in bf16 as the register A operand of 16-key step kc: the
    // accumulator pair {sc[8kc + 2x], sc[8kc + 2x + 1]} is register x
    auto pack_p = [&] {
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kc][x] = pack_bf16(sc[8 * kc + 2 * x], sc[8 * kc + 2 * x + 1]);
      }
    };

    // Software-pipelined: tile j's S runs beside tile j - 1's P V, and
    // tile j's softmax while that P V is still in flight; O is rescaled
    // once P V has landed
    feed_acquire<FEED>(q_full, 0);
    float alpha[2];
    if (wg_tiles > 0) {
      issue_s(0);
      wgmma_wait<0>();
      fence_operand(sc);
      mbar_arrive(k_empty(0));
      softmax(0, alpha);  // O is still 0: no rescale
      pack_p();
    }
    for (int j = 1; j < wg_tiles; ++j) {
      issue_s(j);
      issue_pv(j - 1);
      wgmma_wait<1>();  // S of tile j
      fence_operand(sc);
      mbar_arrive(k_empty(j % ST));
      softmax(j, alpha);
      wgmma_wait<0>();  // P V of tile j - 1
      fence_operand(o);
      mbar_arrive(v_empty((j - 1) % ST));
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    if (wg_tiles > 0) {
      issue_pv(wg_tiles - 1);
      wgmma_wait<0>();
      fence_operand(o);
      mbar_arrive(v_empty((wg_tiles - 1) % ST));
    }
    // the tiles past this warpgroup's rows (see the header): released
    // unread. A full barrier's phase completes only after every consumer
    // released this stage's previous fill: arriving before it could count
    // toward that release
    for (int j = wg_tiles; j < n_tiles; ++j) {
      const int s = j % ST;
      mbar_wait_no_trap(k_full(s), (j / ST) & 1);
      mbar_arrive(k_empty(s));
      mbar_wait_no_trap(v_full(s), (j / ST) & 1);
      mbar_arrive(v_empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] >= Sq) continue;
      const float l_safe = fmaxf(l[r], 1e-20f);
      bf16* orow = out + (((long)b * Sq + qp[r]) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        store_pair_bf16(orow, 8 * j + 2 * t, D, o[4 * j + 2 * r] / l_safe,
                        o[4 * j + 2 * r + 1] / l_safe);
      if (t == 0)
        lse[((long)b * H + h) * Sq + qp[r]] = m[r] * LN2 + logf(l_safe);
    }
  }
}

template <int DP, int NCW, int FEED>
cudaError_t launch_fwd_padded(const bf16* q, const bf16* k, const bf16* v,
                              bf16* out, float* lse, int B, int H, int Sq,
                              int Sk, int D, int causal, float scale,
                              cudaStream_t stream) {
  using L = FwdPaddedSmem<DP, NCW>;
  // the other feed reads q/k/v through their pointers: no tensor maps
  CUtensorMap tq{}, tk{}, tv{};
  if constexpr (FEED == FEED_TMA) {
    int err = encode_bshd(&tq, q, B, Sq, H, D, L::BM);
    if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, L::BN);
    if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, L::BN);
    if (err) return static_cast<cudaError_t>(err);
  }
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_padded_kernel<DP, NCW, FEED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sq + L::BM - 1) / L::BM, B * H);
  flash_fwd_padded_kernel<DP, NCW, FEED>
      <<<grid, 128 * (NCW + feed_producers(FEED, NCW)), L::ALLOC, stream>>>(
          tq, tk, tv, q, k, v, out, lse, H, Sq, Sk, D, causal,
          scale * LOG2E);
  return cudaGetLastError();
}

// K1 at head dim D <= 256 through the padded kernel fed by FEED: DP = D
// rounded up to 32, one consumer warpgroup where 128-row tiles would
// leave SMs idle and 64-row ones still fit one wave (a block takes an SM:
// 138-202 registers a thread)
template <int FEED>
cudaError_t fwd_padded_feed(const void* q, const void* k, const void* v,
                            void* out, float* lse, int B, int H, int Sq,
                            int Sk, int D, int causal, float scale,
                            cudaStream_t stream) {
  const long blocks128 = (long)((Sq + 127) / 128) * B * H;
  const auto pick = [&](auto width) -> cudaError_t {
    constexpr int DP = decltype(width)::value;
    const auto launch = [&](auto launcher) {
      return launcher(static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(out),
                      lse, B, H, Sq, Sk, D, causal, scale, stream);
    };
    if (2 * blocks128 <= sm_count())
      return launch(&launch_fwd_padded<DP, 1, FEED>);
    return launch(&launch_fwd_padded<DP, 2, FEED>);
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
