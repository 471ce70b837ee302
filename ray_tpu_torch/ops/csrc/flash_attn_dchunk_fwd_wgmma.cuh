// K1 (flash-attention forward) in bf16 on wgmma past head dim 256, every
// D with no upper bound, on two routes by what fills the kernel's
// shared-memory boxes (the FEED parameter):
//   - "dchunk_wgmma_tma_ws" (flash_attn_dchunk_fwd_wgmma.cu, FEED_TMA):
//     D % 8 == 0, a row stride of a multiple of 16 bytes, which TMA needs;
//   - "dchunk_wgmma_cp_async_ws" (flash_attn_dchunk_fwd_cp_async.cu,
//     FEED_CP_ASYNC): D % 8 != 0. The producer warpgroup's 128 threads
//     fill the same 128-byte-swizzled boxes with cp.async (8 or 4 bytes
//     by the row's alignment) or, at odd D, through registers
//     (hopper_common.cuh: fill_box); each stage completes on its full
//     barrier, one arrival a producer thread; beside one consumer
//     warpgroup three producer warpgroups fill every third stage each (as
//     in flash_attn_fwd_padded.cuh). It replaced the chunked mma.sync
//     kernel, which gave each 64-column output chunk a block of its own
//     and so computed S D/64 times a tile pair (5x the products at D
//     300).
// Replaces ray_tpu/ops/attention.py::_flash_kernel (lines 202-259,
// launched by _pallas_fwd) for those inputs; flash_attn_fwd.cu's header
// describes the kernel family and its numerics, which this one keeps:
// bf16 operands, fp32 accumulators, the online softmax in the log2
// domain, P rounded to bf16 before P V with l summing the unrounded p,
// lse = m ln 2 + log(max(l, 1e-20)), the causal bound as the loop bound,
// keys past Sk and rows past Sq masked in the kernel.
//
// What bounds it on the H100: at D 512 a (query, key) pair costs 4D FLOPs
// against 2D bytes of K and V that 128 query rows share, so operations
// bound it (the kernel phase's B2 S2048 H8 D512 row: 68.7 GFLOP, 0.0695 ms
// at 989 TFLOP/s). The mma.sync kernel it replaces recomputed S over every
// 64-column chunk in each of a tile's D/64 blocks (4.5x the products at D
// 512, 3x at 320). Here a block owns a slice of O's columns, up to 256
// wide, so S is computed ceil(D / 256) times a tile pair (2 at D 264..512;
// 1.5x the ideal products at D 320 and 512):
//   - the head dim is cut into ns = ceil(D / 256) balanced slices whose
//     widths are multiples of 8 (D 264: 2 x 136), and the kernel is
//     instantiated at the slice width rounded up to 32, SWP in 160..256;
//     O [64, SWP] in fp32 is SWP/2 registers a consumer thread (128 at
//     256, as the padded kernel at DP 256);
//   - one block per (q tile, batch*head, slice), longest causal tiles
//     first; a producer warpgroup (one thread of which issues every TMA
//     load, or all of whose threads fill the boxes) and one or two
//     consumer warpgroups of 64 q rows each (NCW).
//     Two (128-row tiles, each K/V tile serving 128 rows) when that fills
//     the card; one (64-row tiles) when 128-row tiles would leave SMs
//     idle (the kernel phase's B1 S1000 H4 rows: 64 blocks of 128 rows,
//     128 of 64, for 132 SMs; faster there in a trial at D 512, and no
//     slower at the wide rows). With two, the producer lowers its registers
//     (setmaxnreg.dec to 24, 56 where it fills the boxes itself) and the
//     consumers raise theirs (inc to 240, 224 beside the latter);
//     with one, fed by TMA, 256 threads may take 255 registers each
//     without it (beside the other feed's three producer warpgroups the
//     consumers take 240, the producers 88);
//   - S = Q K^T runs over the whole head dim in 64-column boxes: Q stays
//     resident when its nb boxes fit beside the rings (D <= 512 at two
//     consumer warpgroups: 128 KB at 512), else each box of Q streams in
//     the K ring's stage beside its K box. K goes round a four-stage ring
//     of boxes of 64 keys x 64 columns (8 KB, full and empty barriers per
//     stage); each box's product is issued as four m64n64k16 wgmmas and
//     its stage released once it has landed, while the next box's product
//     runs. The slice of V a tile needs (64 keys x SWP columns from column
//     c0, boxes wholly past D not loaded) goes round a two-stage ring;
//   - P V is wgmma m64nSWPk16 in box-aligned pieces (wgmma_rs_cols) with P
//     from registers; only the slice's real columns are written (4-byte
//     stores at even D, one element at a time at odd D);
//   - every slice block of a tile computes S in the same order, so m, l
//     and p are bit-identical across slices; slice 0 writes lse;
//   - every wait is mbar_wait_no_trap (a __trap() would keep ptxas from
//     allocating the consumers within setmaxnreg's count).
// Shared memory at D 512, two consumer warpgroups: Q 128 KB, K ring 32 KB,
// V ring 64 KB (227 KB a block may have).
// ptxas (sm_90a, on the H100 host; tools/check_head_dims.py):
// 168 registers at entry with two consumer warpgroups (they run in up to
// 240, 224 fed by cp.async), 154-202 with one fed by TMA, 128 at the
// other feed's 512 threads; no spills and no serialised wgmma at any
// width, layout or feed.

#pragma once

#include <type_traits>

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DW_BN = 64;          // keys a K/V tile
constexpr int DW_KST = 4;          // stages of the K ring (a box each)
constexpr int DW_VST = 2;          // stages of the V ring (a slice tile each)
constexpr int DW_MAX_SLICE = 256;  // O columns a block owns at most
constexpr int DW_KBOX = DW_BN * SWIZZLE_ROW_BYTES;  // 64 keys x 64 columns
constexpr int DW_SMEM_MAX = 232448;                  // 227 KB

// A block's shared memory, in bytes from a 1024-aligned base (128-byte
// swizzle repeats every 1024 bytes): Q resident (nb boxes) when QRES, the
// K ring (a K box a stage, and its Q box when Q streams), the V ring, the
// barriers.
template <int SWP, int NCW, bool QRES>
struct DwLayout {
  static_assert(SWP % 32 == 0 && SWP > 128 && SWP <= DW_MAX_SLICE,
                "SWP: 160..256 by 32");
  static constexpr int BM = 64 * NCW;  // q rows a block
  static constexpr int QBOX = BM * SWIZZLE_ROW_BYTES;
  static constexpr int VBOXES = (SWP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int VTILE = VBOXES * DW_KBOX;
  static constexpr int STAGE = DW_KBOX + (QRES ? 0 : QBOX);
  // q_full, then k_full, k_empty per K stage, v_full, v_empty per V stage
  static constexpr int BARS = 8 * (1 + 2 * DW_KST + 2 * DW_VST);
  __host__ __device__ static int ring_off(int nb) {
    return QRES ? nb * QBOX : 0;
  }
  __host__ __device__ static int v_off(int nb) {
    return ring_off(nb) + DW_KST * STAGE;
  }
  __host__ __device__ static int bar_off(int nb) {
    return v_off(nb) + DW_VST * VTILE;
  }
  static int alloc(int nb) { return bar_off(nb) + BARS + 1024; }
};

template <int SWP, int NCW, bool QRES, int FEED>
__global__ void __launch_bounds__(128 * (NCW + feed_producers(FEED, NCW)),
                                  1)
fwd_dchunk_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ lse, int H, int Sq, int Sk,
                        int D, int sw, int causal, float scale_log2) {
  using L = DwLayout<SWP, NCW, QRES>;
  constexpr int BM = L::BM, BN = DW_BN, KST = DW_KST, VST = DW_VST;
  constexpr int CONSUMERS = 128 * NCW;
  constexpr int NPROD = feed_producers(FEED, NCW);
  // rows of odd-D loads a producer thread keeps in flight (fill_box):
  // fewer in the 56 registers beside two consumer warpgroups
  constexpr int FILL_BATCH = NCW == 2 ? 8 : 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int nb = (D + BOX_COLS - 1) / BOX_COLS;  // 64-column boxes a row
  const uint32_t ring = base + L::ring_off(nb);
  const uint32_t vring = base + L::v_off(nb);
  const uint32_t q_full = base + L::bar_off(nb);
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + KST + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * KST + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 2 * KST + VST + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest first
  const int c0 = blockIdx.z * sw;  // this block's O columns [c0, c0 + sw)
  // causal: keys past this tile's last row are never needed
  const int q_last = min(q0 + BM, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + BN - 1) / BN;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    // a TMA fill arrives once (expect_tx); the other feed once a thread
    const int fills = FEED == FEED_TMA ? 1 : FEED_THREADS;
    mbar_init(q_full, fills);
    for (int s = 0; s < KST; ++s) {
      mbar_init(k_full(s), fills);
      mbar_init(k_empty(s), CONSUMERS);
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(v_full(s), fills);
      mbar_init(v_empty(s), CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the boxes of V this slice reaches (none wholly past D)
  const int v_boxes = min(L::VBOXES, (D - c0 + BOX_COLS - 1) / BOX_COLS);
  if (wg >= NCW) {
    // ---- producers: keep both rings full
    if constexpr (NCW + NPROD > 2)
      setmaxnreg_dec<producer_regs(FEED, NCW)>();
  }
  if (wg >= NCW && FEED != FEED_TMA) {
    // every thread fills its share of each box, in the order of the TMA
    // producer below; each of the NPROD warpgroups takes every NPROD-th
    // fill of the sequence Q, then per tile V, K box 0, K box 1, ...
    const int p = wg - NCW;
    const int pt = threadIdx.x % FEED_THREADS;
    const long stride = (long)H * D;  // elements between rows
    const bf16* qh = q + ((long)b * Sq * H + h) * D;
    const bf16* kh = k + ((long)b * Sk * H + h) * D;
    const bf16* vh = v + ((long)b * Sk * H + h) * D;
    int f = 0;  // fills in sequence
    if constexpr (QRES) {
      if (f++ % NPROD == p) {
        for (int x = 0; x < nb; ++x)
          fill_box<BM, BOX_COLS, FILL_BATCH>(base + x * L::QBOX, qh, stride,
                                             q0, Sq, x * BOX_COLS, D, pt);
        fill_done(q_full, D);
      }
    }
    int i = 0;  // K boxes filled
    for (int j = 0; j < n_tiles; ++j) {
      const int sv = j % VST;
      if (f++ % NPROD == p) {
        mbar_wait_no_trap(v_empty(sv), ((j / VST) & 1) ^ 1);
        for (int y = 0; y < v_boxes; ++y)
          fill_box<BN, BOX_COLS, FILL_BATCH>(
              vring + sv * L::VTILE + y * DW_KBOX, vh, stride, j * BN, Sk,
              c0 + y * BOX_COLS, D, pt);
        fill_done(v_full(sv), D);
      }
      for (int x = 0; x < nb; ++x, ++i) {
        if (f++ % NPROD != p) continue;
        const int s = i % KST;
        mbar_wait_no_trap(k_empty(s), ((i / KST) & 1) ^ 1);
        fill_box<BN, BOX_COLS, FILL_BATCH>(ring + s * L::STAGE, kh, stride,
                                           j * BN, Sk, x * BOX_COLS, D, pt);
        if constexpr (!QRES)
          fill_box<BM, BOX_COLS, FILL_BATCH>(ring + s * L::STAGE + DW_KBOX,
                                             qh, stride, q0, Sq,
                                             x * BOX_COLS, D, pt);
        fill_done(k_full(s), D);
      }
    }
  } else if (wg == NCW) {
    // one thread issues every TMA load
    if (threadIdx.x == CONSUMERS) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      if constexpr (QRES) {
        mbar_expect_tx(q_full, nb * L::QBOX);
        for (int x = 0; x < nb; ++x)
          tma_load_4d(base + x * L::QBOX, &tm_q, q_full, x * BOX_COLS, h, q0,
                      b);
      }
      int i = 0;  // K boxes issued
      for (int j = 0; j < n_tiles; ++j) {
        // V's slice of tile j first: its stage frees once tile j - 2's
        // P V has landed, before tile j - 1's S, so it never waits on the
        // K boxes behind it
        const int sv = j % VST;
        mbar_wait_no_trap(v_empty(sv), ((j / VST) & 1) ^ 1);
        mbar_expect_tx(v_full(sv), v_boxes * DW_KBOX);
        for (int y = 0; y < v_boxes; ++y)
          tma_load_4d(vring + sv * L::VTILE + y * DW_KBOX, &tm_v, v_full(sv),
                      c0 + y * BOX_COLS, h, j * BN, b);
        for (int x = 0; x < nb; ++x, ++i) {
          const int s = i % KST;
          mbar_wait_no_trap(k_empty(s), ((i / KST) & 1) ^ 1);
          mbar_expect_tx(k_full(s), L::STAGE);
          tma_load_4d(ring + s * L::STAGE, &tm_k, k_full(s), x * BOX_COLS, h,
                      j * BN, b);
          if constexpr (!QRES)
            tma_load_4d(ring + s * L::STAGE + DW_KBOX, &tm_q, k_full(s),
                        x * BOX_COLS, h, q0, b);
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
    // the tiles this warpgroup's rows reach; a skipped tile's stages are
    // still released
    const int wg_kv = causal ? min(Sk, min(wg_row + 64, Sq)) : Sk;
    const int wg_tiles = wg_row < Sq ? (wg_kv + BN - 1) / BN : 0;
    const uint32_t q_rows = wg * 64 * SWIZZLE_ROW_BYTES;  // in a Q box

    float o[SWP / 2];
#pragma unroll
    for (int i = 0; i < SWP / 2; ++i) o[i] = 0.f;
    // running max (log2 domain: scores times scale * log2 e) and sum
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float sc[BN / 2];         // S of one tile, then its p in fp32
    uint32_t pa[BN / 16][4];  // p in bf16: the A operand of P V

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

    // S = Q K^T of the next tile over the head dim's boxes: box x's
    // product is issued, then box x - 1's stage released once its product
    // has landed; the last box's stage is the caller's to release
    int i = 0;  // K boxes consumed
    auto issue_s = [&] {
      for (int x = 0; x < nb; ++x, ++i) {
        const int s = i % KST;
        const uint32_t k_box = ring + s * L::STAGE;
        const uint32_t q_box = opaque(
            (QRES ? base + x * L::QBOX : k_box + DW_KBOX) + q_rows);
        feed_acquire<FEED>(k_full(s), (i / KST) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BOX_COLS / 16; ++kk)
          wgmma_ss_n64<0>(sc, sw128_desc(q_box + kk * 32, 16, 1024),
                          sw128_desc(k_box + kk * 32, 16, 1024),
                          x > 0 || kk > 0);
        wgmma_commit();
        if (x > 0) {
          wgmma_wait<1>();
          mbar_arrive(k_empty((i - 1) % KST));
        }
      }
    };
    // O += P V of tile j over 16-key steps: V is MN-major (head_dim
    // contiguous), N = SWP in box-aligned pieces
    auto issue_pv = [&](int j) {
      const int sv = j % VST;
      const uint32_t v_tile = vring + sv * L::VTILE;
      feed_acquire<FEED>(v_full(sv), (j / VST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs_cols<SWP>(o, pa[kc], v_tile + kc * 16 * SWIZZLE_ROW_BYTES,
                           DW_KBOX);
      wgmma_commit();
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

    // Each tile waits for its S before the softmax and for its P V before
    // the next S; the two warpgroups overlap each other's softmax and
    // products. Tile j's S issued beside tile j - 1's P V (as the padded
    // kernel does) ran slower at every shape tried.
    if constexpr (QRES) feed_acquire<FEED>(q_full, 0);
    float alpha[2];
    for (int j = 0; j < wg_tiles; ++j) {
      issue_s();
      wgmma_wait<0>();
      fence_operand(sc);
      mbar_arrive(k_empty((i - 1) % KST));
      softmax(j, alpha);
#pragma unroll
      for (int c = 0; c < SWP / 2; ++c) o[c] *= alpha[(c >> 1) & 1];
      pack_p();
      issue_pv(j);
      wgmma_wait<0>();
      fence_operand(o);
      mbar_arrive(v_empty(j % VST));
    }
    // the tiles past this warpgroup's rows: released unread, in the order
    // the producer fills them
    for (int j = wg_tiles; j < n_tiles; ++j) {
      for (int x = 0; x < nb; ++x, ++i) {
        const int s = i % KST;
        mbar_wait_no_trap(k_full(s), (i / KST) & 1);
        mbar_arrive(k_empty(s));
      }
      const int sv = j % VST;
      mbar_wait_no_trap(v_full(sv), (j / VST) & 1);
      mbar_arrive(v_empty(sv));
    }

    // this slice's real columns; c0 and sw are multiples of 8, so at even
    // D the slice's rows start 4-byte aligned and hold an even count
    const int cols = min(sw, D - c0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] >= Sq) continue;
      const float l_safe = fmaxf(l[r], 1e-20f);
      bf16* orow = out + (((long)b * Sq + qp[r]) * H + h) * D + c0;
#pragma unroll
      for (int j = 0; j < SWP / 8; ++j)
        store_pair_bf16(orow, 8 * j + 2 * t, cols, (D & 1) == 0,
                        o[4 * j + 2 * r] / l_safe,
                        o[4 * j + 2 * r + 1] / l_safe);
      if (t == 0 && blockIdx.z == 0)
        lse[((long)b * H + h) * Sq + qp[r]] = m[r] * LN2 + logf(l_safe);
    }
  }
}

template <int SWP, int NCW, bool QRES, int FEED>
cudaError_t launch_dw(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                      float* lse, int B, int H, int Sq, int Sk, int D, int sw,
                      int causal, float scale, cudaStream_t stream) {
  using L = DwLayout<SWP, NCW, QRES>;
  // the other feed reads q/k/v through their pointers: no tensor maps
  CUtensorMap tq{}, tk{}, tv{};
  if constexpr (FEED == FEED_TMA) {
    int err = encode_bshd(&tq, q, B, Sq, H, D, L::BM);
    if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, DW_BN);
    if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, DW_BN);
    if (err) return static_cast<cudaError_t>(err);
  }
  const int smem = L::alloc((D + BOX_COLS - 1) / BOX_COLS);
  if (smem > DW_SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t cerr = cudaFuncSetAttribute(
      fwd_dchunk_wgmma_kernel<SWP, NCW, QRES, FEED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sq + L::BM - 1) / L::BM, B * H, (D + sw - 1) / sw);
  fwd_dchunk_wgmma_kernel<SWP, NCW, QRES, FEED>
      <<<grid, 128 * (NCW + feed_producers(FEED, NCW)), smem, stream>>>(
          tq, tk, tv, q, k, v, out, lse, H, Sq, Sk, D, sw, causal,
          scale * LOG2E);
  return cudaGetLastError();
}

// K1 past 256 through the kernel fed by FEED: the slice plan, then the
// instantiation at the slice width and the layout that fits
template <int FEED>
cudaError_t fwd_dchunk_feed(const void* q, const void* k, const void* v,
                            void* out, float* lse, int B, int H, int Sq,
                            int Sk, int D, int causal, float scale,
                            cudaStream_t stream) {
  // ns balanced slices, each a multiple of 8 columns
  const int ns = (D + DW_MAX_SLICE - 1) / DW_MAX_SLICE;
  const int sw = ((D + ns - 1) / ns + 7) / 8 * 8;
  const int nb = (D + BOX_COLS - 1) / BOX_COLS;
  const long blocks128 =
      (long)((Sq + 127) / 128) * B * H * ((D + sw - 1) / sw);
  const auto pick = [&](auto width) -> cudaError_t {
    constexpr int SWP = decltype(width)::value;
    const auto launch = [&](auto launcher) {
      return launcher(static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(out),
                      lse, B, H, Sq, Sk, D, sw, causal, scale, stream);
    };
    // 64-row tiles when 128-row ones would leave SMs idle (Q resident)
    if (blocks128 < sm_count() &&
        DwLayout<SWP, 1, true>::alloc(nb) <= DW_SMEM_MAX)
      return launch(&launch_dw<SWP, 1, true, FEED>);
    if (DwLayout<SWP, 2, true>::alloc(nb) <= DW_SMEM_MAX)
      return launch(&launch_dw<SWP, 2, true, FEED>);
    return launch(&launch_dw<SWP, 2, false, FEED>);
  };
  switch ((sw + 31) / 32 * 32) {
    case 160: return pick(std::integral_constant<int, 160>{});
    case 192: return pick(std::integral_constant<int, 192>{});
    case 224: return pick(std::integral_constant<int, 224>{});
    default: return pick(std::integral_constant<int, 256>{});
  }
}

}  // namespace
