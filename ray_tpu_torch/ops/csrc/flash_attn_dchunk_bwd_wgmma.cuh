// K2 and K3 (flash-attention dq and dk/dv backward) in bf16 on wgmma past
// head dim 256, every D with no upper bound, on two routes by what fills
// the kernel's shared-memory boxes (the FEED parameter), as K1's kernel
// past 256 (flash_attn_dchunk_fwd_wgmma.cuh):
//   - "dchunk_wgmma_tma_ws" (FEED_TMA): D % 8 == 0, TMA's 16-byte row
//     stride; instantiated by flash_attn_dchunk_bwd_dq_wgmma.cu (K2) and
//     flash_attn_dchunk_bwd_dkdv_wgmma.cu (K3);
//   - "dchunk_wgmma_cp_async_ws" (FEED_CP_ASYNC): D % 8 != 0. The
//     producer warpgroups' threads fill the same 128-byte-swizzled boxes
//     with cp.async (8 or 4 bytes by the row's alignment) or, at odd D,
//     through registers (hopper_common.cuh: fill_box); each stage
//     completes on its full barrier, one arrival a producer thread (K3's
//     slice stage one more: its lse and delta rows stay 1-D TMA copies,
//     whose expect_tx arrival the barrier counts too); beside one consumer
//     warpgroup three producer warpgroups fill every third stage each.
//     Instantiated by flash_attn_dchunk_bwd_dq_cp_async.cu and
//     flash_attn_dchunk_bwd_dkdv_cp_async.cu. It replaced the chunked
//     mma.sync kernels, whose blocks each owned a 64-column chunk of the
//     output and recomputed S and dP over the whole head dim for it (5x
//     the products at D 300).
// Replace ray_tpu/ops/attention.py::_bwd_dq_kernel and ::_bwd_dkdv_kernel
// (launched by _pallas_bwd) for those inputs; flash_attn_bwd.cu's header
// describes the kernel family and its numerics, which these keep: bf16
// operands, fp32 accumulators, p = exp2(S scale log2e - lse log2e) from
// the forward's lse, ds = p (dP - delta) scale in fp32, p and ds rounded
// to bf16 before the products that consume them, the causal bound as the
// loop bound, top-left aligned at Sq != Sk, keys past Sk and rows past Sq
// masked in the kernel.
//
// What bounds them on the H100: at D 512 a kept (query, key) pair costs
// K2 6 D and K3 8 D FLOPs against rows that 64 or 128 of the other side
// share, so operations bound them (the kernel phase's B2 S2048 H8 D512
// row: 103 and 138 GFLOP, 0.1043 and 0.1390 ms at 989 TFLOP/s). The
// mma.sync kernels they replaced gave each 64-column chunk of the output
// a block of its own, so each block recomputed S and dP over the whole
// head dim: 8 times at D 512. Here a block owns a slice of its outputs'
// columns as wide as its accumulators allow, so S and dP are computed
// ceil(D / W) times a tile pair:
//   - K2 (DKDV false): a block per (q tile, batch*head, slice of dq); its
//     rows are queries (R1 = Q, R2 = dO), its tiles 64 keys (T1 = K,
//     T2 = V) up to the causal bound; dq [64, SWP] in fp32 is SWP/2
//     registers a consumer thread, so W = 256 (ns = ceil(D / 256));
//   - K3 (DKDV true): a block per (key tile, batch*head, slice of dk and
//     dv); its rows are keys (R1 = K, R2 = V), its tiles 64 queries
//     (T1 = Q, T2 = dO) from the first one at or past its first key; dk
//     and dv are SWP registers a consumer thread beside S^T's and dP^T's
//     64, so W = 128 (ns = ceil(D / 128));
//   - the slice width: ns balanced slices whose widths are multiples of 8
//     (D 264: 2 x 136 for K2, 3 x 88 for K3), instantiated at the width
//     rounded up to 32 (K2 160..256, K3 96 and 128);
//   - a producer warpgroup (one thread of which issues every TMA load,
//     or all of whose threads fill the boxes; three beside one consumer
//     warpgroup where they do) and one or two consumer warpgroups of 64
//     rows each (NCW): K2 two (128 rows a block, each tile serving 128
//     rows) when that fills the card and its rows stay resident, else
//     one; with two the producer lowers its registers to 24 (56 where it
//     fills the boxes, and then not at 256 columns, where the consumers'
//     224 spilled) and the consumers raise theirs to 240 (224).
//     K3 one: its dk and dv, 128 columns each, beside S^T and dP^T spill
//     in 240 with two (beside three filling producer warpgroups, which
//     take 72, its one takes 256);
//   - per tile, X = R1 T1^T (K2: S; K3: S^T = K Q^T) and Y = R2 T2^T (dP;
//     dP^T = V dO^T) run over the whole head dim in 64-column boxes of
//     128-byte swizzle filled past D with zeros: a ring stage
//     holds box x of T1 and of T2 (and of R1 and R2 where those are not
//     resident), each box's eight m64n64k16 wgmmas are issued as one
//     group and the stage released once they have landed, while the next
//     box's run. R1 and R2 stay resident when their boxes fit beside the
//     rings (RES; at D 512 with one consumer warpgroup: 128 KB), else
//     they stream beside T1's and T2's;
//   - then p and ds from X and Y in registers, packed to bf16 as the
//     register A operands of the slice products: K2 dq += ds K_slice, K3
//     dv += p^T dO_slice and dk += ds^T Q_slice, wgmma m64nSWPk16 in
//     box-aligned pieces (wgmma_rs_cols) over the slice tile [64 tile
//     rows, SWP columns from c0] of T1 (and T2), which goes round a ring
//     of its own (boxes wholly past D not loaded); K3's slice stage also
//     holds the tile's lse and delta rows (1-D TMA copies from the
//     16-byte boundary before its first row, read shifted, as
//     flash_attn_bwd_dkdv_padded.cu);
//   - the two rings' depths are the deepest that fit the 227 KB a block
//     may have beside resident R1/R2 (up to four box stages, then up to
//     two slice stages; at least two and one), chosen on the host;
//   - a consumer warpgroup whose rows a tile does not reach (K2: the
//     upper one at the causal diagonal, or one past Sq; K3: the upper one
//     before it, or one past Sk) releases that tile's stages unread;
//   - only the slice's real columns are written (4-byte stores at even D,
//     one element at a time at odd D); a key tile that no query reaches
//     writes zeros;
//   - every wait is mbar_wait_no_trap (a __trap() keeps ptxas from
//     allocating the consumers within setmaxnreg's count).
// ptxas (sm_90a, on the H100 host; tools/check_head_dims.py): fed by TMA,
// K2 168 registers at entry with two consumer warpgroups (they run in
// 240), 189-240 with one, K3 220-250; fed by cp.async, 168 at entry with
// two consumer warpgroups, 128 at the 512 threads beside three producer
// warpgroups; no spills and no serialised wgmma. Three things did
// serialise them: p and ds written back into the X and Y accumulators
// before packing (every instantiation), K3 with two consumer warpgroups
// (144 bytes spilled at 128 columns), and K3's one in 240 registers
// beside three filling producer warpgroups (144 bytes).

#pragma once

#include <type_traits>

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DB_BN = 64;                           // rows of a tile
constexpr int DB_TBOX = DB_BN * SWIZZLE_ROW_BYTES;  // 64 rows x 64 columns
constexpr int DB_SMEM_MAX = 232448;                 // 227 KB
constexpr int DB_MAX_KST = 4;  // box ring stages at most
constexpr int DB_MAX_SST = 2;  // slice ring stages at most
// lse/delta values a K3 slice stage holds: the tile's 64 from the 16-byte
// boundary at or before its first row, 4 more; delta's 512 bytes on
constexpr int DB_ROWS = DB_BN + 4;
constexpr int DB_DELTA_OFF = 512;
// output columns a block owns at most: dq's fp32 [64, 256] is 128
// registers a consumer thread; dk and dv [64, 128] the same together
constexpr int dchunk_bwd_max_slice(bool dkdv) { return dkdv ? 128 : 256; }

// A block's shared memory, in bytes from a 1024-aligned base (128-byte
// swizzle repeats every 1024 bytes): R1's and R2's nb boxes when RES, the
// box ring (T1's and T2's box x a stage, R1's and R2's too when they
// stream), the slice ring (T1's slice tile, and for K3 T2's and the lse
// and delta rows), the barriers.
template <int SWP, int NCW, bool RES, bool DKDV>
struct DbLayout {
  static_assert(SWP % 32 == 0 && SWP >= 96 &&
                    SWP <= dchunk_bwd_max_slice(DKDV),
                "SWP: a multiple of 32 up to the slice's most");
  static constexpr int BM = 64 * NCW;  // rows a block
  static constexpr int RBOX = BM * SWIZZLE_ROW_BYTES;
  static constexpr int VBOXES = (SWP + BOX_COLS - 1) / BOX_COLS;
  static constexpr int STAGE = 2 * DB_TBOX + (RES ? 0 : 2 * RBOX);
  static constexpr int SLICE_ROWS = (DKDV ? 2 : 1) * VBOXES * DB_TBOX;
  static constexpr int SLICE = SLICE_ROWS + (DKDV ? 1024 : 0);
  // r_full, then full and empty a box stage, full and empty a slice stage
  static constexpr int BARS = 8 * (1 + 2 * DB_MAX_KST + 2 * DB_MAX_SST);
  __host__ __device__ static int ring_off(int nb) {
    return RES ? 2 * nb * RBOX : 0;
  }
  __host__ __device__ static int slice_off(int nb, int kst) {
    return ring_off(nb) + kst * STAGE;
  }
  __host__ __device__ static int bar_off(int nb, int kst, int sst) {
    return slice_off(nb, kst) + sst * SLICE;
  }
  static int alloc(int nb, int kst, int sst) {
    return bar_off(nb, kst, sst) + BARS + 1024;
  }
  // the deepest rings that fit, box stages first (two box stages left
  // each box's TMA latency showing: K2 at D 512 ran 1.75x K3's time a tile
  // step, which had four); false when not even two box stages and one
  // slice stage do
  static bool plan(int nb, int* kst, int* sst) {
    for (int k = DB_MAX_KST; k >= 2; --k) {
      for (int s = DB_MAX_SST; s >= 1; --s) {
        if (alloc(nb, k, s) <= DB_SMEM_MAX) {
          *kst = k;
          *sst = s;
          return true;
        }
      }
    }
    return false;
  }
};

// a ring's stage and the parity of its current use
struct RingPos {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++s == n) {
      s = 0;
      ph ^= 1;
    }
  }
};

// DKDV false (K2): R1 = q, R2 = dout (rows: queries), T1 = k, T2 = v
// (tiles: keys), out1 = dq. DKDV true (K3): R1 = k, R2 = v (rows: keys),
// T1 = q, T2 = dout (tiles: queries), out1 = dk, out2 = dv; tm_lse and
// tm_delta the flat [B*H*Sq] lse and delta (unused by K2). The tile maps
// tm_r1 ... tm_t2 for FEED_TMA, the pointers r1 ... t2 for the other feed.
template <int SWP, int NCW, bool RES, bool DKDV, int FEED>
__global__ void __launch_bounds__(128 * (NCW + feed_producers(FEED, NCW)),
                                  1)
bwd_dchunk_wgmma_kernel(const __grid_constant__ CUtensorMap tm_r1,
                        const __grid_constant__ CUtensorMap tm_r2,
                        const __grid_constant__ CUtensorMap tm_t1,
                        const __grid_constant__ CUtensorMap tm_t2,
                        const __grid_constant__ CUtensorMap tm_lse,
                        const __grid_constant__ CUtensorMap tm_delta,
                        const bf16* __restrict__ r1,
                        const bf16* __restrict__ r2,
                        const bf16* __restrict__ t1,
                        const bf16* __restrict__ t2,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ out1, bf16* __restrict__ out2,
                        int H, int Sq, int Sk, int D, int sw, int kst,
                        int sst, int causal, float scale) {
  using L = DbLayout<SWP, NCW, RES, DKDV>;
  constexpr int BM = L::BM, BN = DB_BN;
  constexpr int CONSUMERS = 128 * NCW;
  constexpr int NPROD = feed_producers(FEED, NCW);
  // K3 beside producers that fill the boxes: its consumer warpgroup's dk,
  // dv, S^T and dP^T take 250 registers where nothing bounds them (fed
  // by TMA), and in consumer_regs' 240 ptxas spilled 144 bytes and
  // serialised the wgmmas; so 256, its three producers 72
  constexpr bool WIDE = DKDV && FEED != FEED_TMA;
  constexpr int PRODUCER_REGS = WIDE ? 72 : producer_regs(FEED, NCW);
  constexpr int CONSUMER_REGS = WIDE ? 256 : consumer_regs(FEED, NCW);
  // rows of odd-D loads a producer thread keeps in flight (fill_box):
  // fewer in the 56 (72) registers beside two consumer warpgroups (K3's)
  constexpr int FILL_BATCH = NCW == 2 || WIDE ? 8 : 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const int nb = (D + BOX_COLS - 1) / BOX_COLS;  // 64-column boxes a row
  const uint32_t ring = base + L::ring_off(nb);
  const uint32_t slice = base + L::slice_off(nb, kst);
  const uint32_t r_full = base + L::bar_off(nb, kst, sst);
  auto full = [&](int s) { return r_full + 8 * (1 + s); };
  auto empty = [&](int s) { return r_full + 8 * (1 + DB_MAX_KST + s); };
  auto s_full = [&](int s) {
    return r_full + 8 * (1 + 2 * DB_MAX_KST + s);
  };
  auto s_empty = [&](int s) {
    return r_full + 8 * (1 + 2 * DB_MAX_KST + DB_MAX_SST + s);
  };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int Sr = DKDV ? Sk : Sq;  // rows of R1/R2
  const int St = DKDV ? Sq : Sk;  // rows of T1/T2
  // K2: longest causal q tiles first; K3: the first key tiles have most
  const int r0 = (DKDV ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * BM;
  const int c0 = blockIdx.z * sw;  // this block's columns [c0, c0 + sw)
  // the tiles: K2 the keys up to the causal bound of the block's last
  // row; K3 the queries from the first tile at or past its first key
  int t_first, n_tiles;
  if constexpr (DKDV) {
    t_first = causal ? r0 / BN : 0;
    n_tiles = max(0, (Sq + BN - 1) / BN - t_first);
  } else {
    const int q_last = min(r0 + BM, Sq) - 1;
    const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
    t_first = 0;
    n_tiles = (kv_len + BN - 1) / BN;
  }
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    // TMA: one expect_tx arrival a fill; the other feed one a producer
    // thread, and K3's slice stage one more for its lse/delta copies
    const int fills = FEED == FEED_TMA ? 1 : FEED_THREADS;
    mbar_init(r_full, fills);
    for (int s = 0; s < kst; ++s) {
      mbar_init(full(s), fills);
      mbar_init(empty(s), CONSUMERS);
    }
    for (int s = 0; s < sst; ++s) {
      mbar_init(s_full(s), fills + (FEED != FEED_TMA && DKDV ? 1 : 0));
      mbar_init(s_empty(s), CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the boxes of the slice tile this slice reaches (none wholly past D)
  const int v_boxes = min(L::VBOXES, (D - c0 + BOX_COLS - 1) / BOX_COLS);
  // K3's lse/delta rows of the tile at t0 into a slice stage, as one flat
  // array: a tile past Sq reads the next head's rows (or zeros past the
  // end), masked below
  const auto load_rows = [&](uint32_t ss, uint32_t bar, int t0) {
    const int row0 = (bh * Sq + t0) & ~3;
    tma_load_1d(ss + L::SLICE_ROWS, &tm_lse, bar, row0);
    tma_load_1d(ss + L::SLICE_ROWS + DB_DELTA_OFF, &tm_delta, bar, row0);
  };
  if (wg >= NCW) {
    // ---- producers: keep both rings full
    if constexpr (NCW + NPROD > 2) setmaxnreg_dec<PRODUCER_REGS>();
  }
  if (wg >= NCW && FEED != FEED_TMA) {
    // every thread fills its share of each box, in the order of the TMA
    // producer below; each of the NPROD warpgroups takes every NPROD-th
    // fill of the sequence R, then per tile T box 0, T box 1, ..., slice
    if (n_tiles > 0) {
      const int p = wg - NCW;
      const int pt = threadIdx.x % FEED_THREADS;
      const long stride = (long)H * D;  // elements between rows
      const bf16* r1h = r1 + ((long)b * Sr * H + h) * D;
      const bf16* r2h = r2 + ((long)b * Sr * H + h) * D;
      const bf16* t1h = t1 + ((long)b * St * H + h) * D;
      const bf16* t2h = t2 + ((long)b * St * H + h) * D;
      int f = 0;  // fills in sequence
      if constexpr (RES) {
        if (f++ % NPROD == p) {
          for (int x = 0; x < nb; ++x) {
            fill_box<BM, BOX_COLS, FILL_BATCH>(base + x * L::RBOX, r1h,
                                               stride, r0, Sr, x * BOX_COLS,
                                               D, pt);
            fill_box<BM, BOX_COLS, FILL_BATCH>(base + (nb + x) * L::RBOX,
                                               r2h, stride, r0, Sr,
                                               x * BOX_COLS, D, pt);
          }
          fill_done(r_full, D);
        }
      }
      RingPos kp, sp;
      for (int j = 0; j < n_tiles; ++j) {
        const int t0 = (t_first + j) * BN;
        for (int x = 0; x < nb; ++x, kp.next(kst)) {
          if (f++ % NPROD != p) continue;
          const uint32_t st = ring + kp.s * L::STAGE;
          mbar_wait_no_trap(empty(kp.s), kp.ph ^ 1);
          fill_box<BN, BOX_COLS, FILL_BATCH>(st, t1h, stride, t0, St,
                                             x * BOX_COLS, D, pt);
          fill_box<BN, BOX_COLS, FILL_BATCH>(st + DB_TBOX, t2h, stride, t0,
                                             St, x * BOX_COLS, D, pt);
          if constexpr (!RES) {
            fill_box<BM, BOX_COLS, FILL_BATCH>(st + 2 * DB_TBOX, r1h, stride,
                                               r0, Sr, x * BOX_COLS, D, pt);
            fill_box<BM, BOX_COLS, FILL_BATCH>(st + 2 * DB_TBOX + L::RBOX,
                                               r2h, stride, r0, Sr,
                                               x * BOX_COLS, D, pt);
          }
          fill_done(full(kp.s), D);
        }
        if (f++ % NPROD == p) {
          const uint32_t ss = slice + sp.s * L::SLICE;
          mbar_wait_no_trap(s_empty(sp.s), sp.ph ^ 1);
          if (DKDV && pt == 0) {
            mbar_expect_tx(s_full(sp.s), 2 * DB_ROWS * 4);
            load_rows(ss, s_full(sp.s), t0);
          }
          for (int y = 0; y < v_boxes; ++y) {
            fill_box<BN, BOX_COLS, FILL_BATCH>(ss + y * DB_TBOX, t1h, stride,
                                               t0, St, c0 + y * BOX_COLS, D,
                                               pt);
            if constexpr (DKDV)
              fill_box<BN, BOX_COLS, FILL_BATCH>(
                  ss + (L::VBOXES + y) * DB_TBOX, t2h, stride, t0, St,
                  c0 + y * BOX_COLS, D, pt);
          }
          fill_done(s_full(sp.s), D);
        }
        sp.next(sst);
      }
    }
  } else if (wg == NCW) {
    // one thread issues every TMA load
    if (threadIdx.x == CONSUMERS && n_tiles > 0) {
      prefetch_tensor_map(&tm_t1);
      prefetch_tensor_map(&tm_t2);
      if constexpr (RES) {
        mbar_expect_tx(r_full, 2 * nb * L::RBOX);
        for (int x = 0; x < nb; ++x) {
          tma_load_4d(base + x * L::RBOX, &tm_r1, r_full, x * BOX_COLS, h,
                      r0, b);
          tma_load_4d(base + (nb + x) * L::RBOX, &tm_r2, r_full,
                      x * BOX_COLS, h, r0, b);
        }
      }
      RingPos kp, sp;
      for (int j = 0; j < n_tiles; ++j) {
        const int t0 = (t_first + j) * BN;
        for (int x = 0; x < nb; ++x, kp.next(kst)) {
          const uint32_t st = ring + kp.s * L::STAGE;
          mbar_wait_no_trap(empty(kp.s), kp.ph ^ 1);
          mbar_expect_tx(full(kp.s), L::STAGE);
          tma_load_4d(st, &tm_t1, full(kp.s), x * BOX_COLS, h, t0, b);
          tma_load_4d(st + DB_TBOX, &tm_t2, full(kp.s), x * BOX_COLS, h, t0,
                      b);
          if constexpr (!RES) {
            tma_load_4d(st + 2 * DB_TBOX, &tm_r1, full(kp.s), x * BOX_COLS,
                        h, r0, b);
            tma_load_4d(st + 2 * DB_TBOX + L::RBOX, &tm_r2, full(kp.s),
                        x * BOX_COLS, h, r0, b);
          }
        }
        // the tile's slice after its boxes: with one slice stage it waits
        // for the last tile's slice products
        const uint32_t ss = slice + sp.s * L::SLICE;
        mbar_wait_no_trap(s_empty(sp.s), sp.ph ^ 1);
        mbar_expect_tx(s_full(sp.s),
                       (DKDV ? 2 : 1) * v_boxes * DB_TBOX +
                           (DKDV ? 2 * DB_ROWS * 4 : 0));
        for (int y = 0; y < v_boxes; ++y) {
          tma_load_4d(ss + y * DB_TBOX, &tm_t1, s_full(sp.s),
                      c0 + y * BOX_COLS, h, t0, b);
          if constexpr (DKDV)
            tma_load_4d(ss + (L::VBOXES + y) * DB_TBOX, &tm_t2,
                        s_full(sp.s), c0 + y * BOX_COLS, h, t0, b);
        }
        if constexpr (DKDV) load_rows(ss, s_full(sp.s), t0);
        sp.next(sst);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [r0 + 64 wg, +64)
    if constexpr (NCW + NPROD > 2) setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wg_row = r0 + wg * 64;
    const int rows[2] = {wg_row + warp * 16 + g, wg_row + warp * 16 + g + 8};
    const float scale_log2 = scale * LOG2E;
    // the tiles [lo, hi) this warpgroup's rows reach. K2: the upper
    // warpgroup's rows end 64 before the lower one's, so at the causal
    // diagonal it skips the block's last tile; K3: the upper one's keys
    // start 64 after the lower one's, so it skips the first. A warpgroup
    // wholly past its rows' end skips them all.
    int lo = 0, hi = 0;
    if constexpr (DKDV) {
      lo = causal ? wg : 0;
      hi = wg_row < Sk ? n_tiles : 0;
    } else {
      const int wg_kv = causal ? min(Sk, min(wg_row + 64, Sq)) : Sk;
      hi = wg_row < Sq ? (wg_kv + BN - 1) / BN : 0;
    }
    // K2: this thread's two rows' lse (log2 domain) and delta; rows past
    // Sq take 0 and are never written
    float lse_l2[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
    if constexpr (!DKDV) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= Sq) continue;
        lse_l2[r] = lse[(long)bh * Sq + rows[r]] * LOG2E;
        delta_r[r] = delta[(long)bh * Sq + rows[r]];
      }
    }
    const uint32_t r_rows = wg * 64 * SWIZZLE_ROW_BYTES;  // in an R box

    float acc1[SWP / 2], acc2[DKDV ? SWP / 2 : 1];
#pragma unroll
    for (int i = 0; i < SWP / 2; ++i) {
      acc1[i] = 0.f;
      if constexpr (DKDV) acc2[i] = 0.f;
    }
    float xa[BN / 2], ya[BN / 2];  // X and Y of a tile
    uint32_t pa[BN / 16][4], da[BN / 16][4];  // p and ds in bf16

    if (RES && lo < hi) feed_acquire<FEED>(r_full, 0);
    RingPos kp, sp;
    for (int j = 0; j < n_tiles; ++j) {
      if (j < lo || j >= hi) {
        // a full barrier's phase completes only after every consumer
        // released this stage's previous fill: arriving before it could
        // count toward that release
        for (int x = 0; x < nb; ++x, kp.next(kst)) {
          mbar_wait_no_trap(full(kp.s), kp.ph);
          mbar_arrive(empty(kp.s));
        }
        mbar_wait_no_trap(s_full(sp.s), sp.ph);
        mbar_arrive(s_empty(sp.s));
        sp.next(sst);
        continue;
      }
      const int t0 = (t_first + j) * BN;

      // X and Y over the head dim's boxes: box x's products are issued,
      // then box x - 1's stage released once its products have landed
      int prev = 0;
      for (int x = 0; x < nb; ++x, kp.next(kst)) {
        const uint32_t st = ring + kp.s * L::STAGE;
        const uint32_t t1_box = opaque(st), t2_box = opaque(st + DB_TBOX);
        const uint32_t r1_box = opaque(
            (RES ? base + x * L::RBOX : st + 2 * DB_TBOX) + r_rows);
        const uint32_t r2_box = opaque(
            (RES ? base + (nb + x) * L::RBOX : st + 2 * DB_TBOX + L::RBOX) +
            r_rows);
        feed_acquire<FEED>(full(kp.s), kp.ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BOX_COLS / 16; ++kk)
          wgmma_ss_n64<0>(xa, sw128_desc(r1_box + kk * 32, 16, 1024),
                          sw128_desc(t1_box + kk * 32, 16, 1024),
                          x > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < BOX_COLS / 16; ++kk)
          wgmma_ss_n64<0>(ya, sw128_desc(r2_box + kk * 32, 16, 1024),
                          sw128_desc(t2_box + kk * 32, 16, 1024),
                          x > 0 || kk > 0);
        wgmma_commit();
        if (x > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty(prev));
        }
        prev = kp.s;
      }
      wgmma_wait<0>();
      fence_operand(xa);
      fence_operand(ya);
      mbar_arrive(empty(prev));

      // the slice stage (K3 reads its lse and delta rows now)
      const uint32_t ss = slice + sp.s * L::SLICE;
      feed_acquire<FEED>(s_full(sp.s), sp.ph);

      // p = exp2(X scale log2e - lse log2e) and ds = p (Y - delta) scale
      // in fp32, the mask only where the tile needs it: the causal
      // diagonal and the ragged ends (rows past S load as zeros: X = 0
      // there, p = exp(-lse) != 0). The accumulator element i is row
      // rows[(i >> 1) & 1], column 8 (i >> 2) + 2t + (i & 1) of the tile;
      // the pair {i, i + 1} with i = 8kc + 2x is register x of the A
      // operand of 16-row step kc, packed to bf16 straight from X and Y
      // (written back into X and Y, ptxas serialised every wgmma)
      const float* lse_s = nullptr;
      const float* delta_s = nullptr;
      bool edge;
      if constexpr (DKDV) {
        const unsigned char* rows_at = base_ptr + (ss - base) +
                                       L::SLICE_ROWS;
        const int shift = (bh * Sq + t0) & 3;  // the tile's first row
        lse_s = reinterpret_cast<const float*>(rows_at) + shift;
        delta_s = reinterpret_cast<const float*>(rows_at + DB_DELTA_OFF) +
                  shift;
        edge = (causal && t0 < wg_row + 63) || t0 + BN > Sq ||
               wg_row + 64 > Sk;
      } else {
        edge = (causal && t0 + BN - 1 > wg_row) || t0 + BN > Sk;
      }
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * kc + 2 * x + e;
            const int r = (i >> 1) & 1;
            const int col = 8 * (i >> 2) + 2 * t + (i & 1);
            if constexpr (DKDV) {
              p[e] = ex2(fmaf(xa[i], scale_log2, -lse_s[col] * LOG2E));
              if (edge) {
                const int qpos = t0 + col;
                p[e] = (qpos < Sq && rows[r] < Sk &&
                        (!causal || qpos >= rows[r])) ? p[e] : 0.f;
              }
              ds[e] = p[e] * (ya[i] - delta_s[col]) * scale;
            } else {
              p[e] = ex2(fmaf(xa[i], scale_log2, -lse_l2[r]));
              if (edge) {
                const int kpos = t0 + col;
                p[e] = (kpos < Sk && (!causal || kpos <= rows[r])) ? p[e]
                                                                   : 0.f;
              }
              ds[e] = p[e] * (ya[i] - delta_r[r]) * scale;
            }
          }
          da[kc][x] = pack_bf16(ds[0], ds[1]);
          if constexpr (DKDV) pa[kc][x] = pack_bf16(p[0], p[1]);
        }
      }

      // the slice products over 16-row steps: T1's and T2's slice tiles
      // are MN-major (head_dim contiguous), N = SWP in box-aligned pieces
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint32_t step = kc * 16 * SWIZZLE_ROW_BYTES;
        wgmma_rs_cols<SWP>(acc1, da[kc], ss + step, DB_TBOX);
        if constexpr (DKDV)
          wgmma_rs_cols<SWP>(acc2, pa[kc],
                             ss + L::VBOXES * DB_TBOX + step, DB_TBOX);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc1);
      if constexpr (DKDV) fence_operand(acc2);
      mbar_arrive(s_empty(sp.s));
      sp.next(sst);
    }

    // this slice's real columns; c0 and sw are multiples of 8, so at even
    // D the slice's rows start 4-byte aligned and hold an even count
    const int cols = min(sw, D - c0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= Sr) continue;
      const long at = (((long)b * Sr + rows[r]) * H + h) * D + c0;
#pragma unroll
      for (int jj = 0; jj < SWP / 8; ++jj) {
        store_pair_bf16(out1 + at, 8 * jj + 2 * t, cols, (D & 1) == 0,
                        acc1[4 * jj + 2 * r], acc1[4 * jj + 2 * r + 1]);
        if constexpr (DKDV)
          store_pair_bf16(out2 + at, 8 * jj + 2 * t, cols, (D & 1) == 0,
                          acc2[4 * jj + 2 * r], acc2[4 * jj + 2 * r + 1]);
      }
    }
  }
}

template <int SWP, int NCW, bool RES, bool DKDV, int FEED>
cudaError_t launch_db(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* dout, const float* lse, const float* delta,
                      bf16* out1, bf16* out2, int B, int H, int Sq, int Sk,
                      int D, int sw, int causal, float scale,
                      cudaStream_t stream) {
  using L = DbLayout<SWP, NCW, RES, DKDV>;
  const int nb = (D + BOX_COLS - 1) / BOX_COLS;
  int kst = 0, sst = 0;
  if (!L::plan(nb, &kst, &sst)) return cudaErrorInvalidValue;
  // R boxes of a block's rows, T boxes of a tile's; K3's lse and delta
  // rows as flat arrays
  const bf16 *r1 = DKDV ? k : q, *r2 = DKDV ? v : dout;
  const bf16 *t1 = DKDV ? q : k, *t2 = DKDV ? dout : v;
  const int Sr = DKDV ? Sk : Sq, St = DKDV ? Sq : Sk;
  // the other feed reads them through their pointers: no tile maps
  CUtensorMap tr1{}, tr2{}, tt1{}, tt2{}, tl{}, td{};
  int err = 0;
  if constexpr (FEED == FEED_TMA) {
    err = encode_bshd(&tr1, r1, B, Sr, H, D, L::BM);
    if (!err) err = encode_bshd(&tr2, r2, B, Sr, H, D, L::BM);
    if (!err) err = encode_bshd(&tt1, t1, B, St, H, D, DB_BN);
    if (!err) err = encode_bshd(&tt2, t2, B, St, H, D, DB_BN);
  }
  if (DKDV && !err) err = encode_rows(&tl, lse, (long)B * H * Sq, DB_ROWS);
  if (DKDV && !err) err = encode_rows(&td, delta, (long)B * H * Sq, DB_ROWS);
  if (err) return static_cast<cudaError_t>(err);
  const int smem = L::alloc(nb, kst, sst);
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dchunk_wgmma_kernel<SWP, NCW, RES, DKDV, FEED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sr + L::BM - 1) / L::BM, B * H, (D + sw - 1) / sw);
  bwd_dchunk_wgmma_kernel<SWP, NCW, RES, DKDV, FEED>
      <<<grid, 128 * (NCW + feed_producers(FEED, NCW)), smem, stream>>>(
          tr1, tr2, tt1, tt2, tl, td, r1, r2, t1, t2, lse, delta, out1, out2,
          H, Sq, Sk, D, sw, kst, sst, causal, scale);
  return cudaGetLastError();
}

// K2 (DKDV false: out1 = dq) or K3 (true: out1 = dk, out2 = dv) past 256
// through the kernel fed by FEED: the slice plan, then the instantiation
// at the slice width and the layout that fits. Given ``layout``, it
// launches nothing and writes the layout it would launch there: {SWP,
// slice width, consumer warpgroups, rows resident, box stages, slice
// stages, producer warpgroups}
template <bool DKDV, int FEED>
cudaError_t bwd_dchunk_feed(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* out1, void* out2,
                            int B, int H, int Sq, int Sk, int D, int causal,
                            float scale, cudaStream_t stream,
                            int* layout = nullptr) {
  if (FEED == FEED_TMA ? !rtt::dchunk_wgmma_head_dim(D)
                       : !rtt::dchunk_unaligned_head_dim(D))
    return cudaErrorInvalidValue;
  // ns balanced slices, each a multiple of 8 columns
  const int most = dchunk_bwd_max_slice(DKDV);
  const int ns = (D + most - 1) / most;
  const int sw = ((D + ns - 1) / ns + 7) / 8 * 8;
  const int nb = (D + BOX_COLS - 1) / BOX_COLS;
  const int rows = DKDV ? Sk : Sq;
  const long blocks128 =
      (long)((rows + 127) / 128) * B * H * ((D + sw - 1) / sw);
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  const auto pick = [&](auto width) -> cudaError_t {
    constexpr int SWP = decltype(width)::value;
    const auto take = [&](auto ncw, auto res) -> cudaError_t {
      constexpr int NCW = decltype(ncw)::value;
      constexpr bool RES = decltype(res)::value;
      if (layout) {
        int kst, sst;
        if (!DbLayout<SWP, NCW, RES, DKDV>::plan(nb, &kst, &sst))
          return cudaErrorInvalidValue;
        const int chosen[7] = {SWP, sw, NCW, RES, kst, sst,
                               feed_producers(FEED, NCW)};
        for (int i = 0; i < 7; ++i) layout[i] = chosen[i];
        return cudaSuccess;
      }
      return launch_db<SWP, NCW, RES, DKDV, FEED>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
          delta, static_cast<bf16*>(out1), static_cast<bf16*>(out2), B, H,
          Sq, Sk, D, sw, causal, scale, stream);
    };
    int kst, sst;
    // 64-row blocks when 128-row ones would leave SMs idle; R1/R2
    // resident where they fit, two consumer warpgroups before one. K3
    // takes one: its dk and dv beside S^T and dP^T outgrow setmaxnreg's
    // 240 registers (144 bytes spilled at 128 columns, its wgmmas
    // serialised); so does K2's dq at 256 columns in the 224 beside a
    // producer warpgroup that fills the boxes
    if constexpr (!DKDV && (FEED == FEED_TMA || SWP < 256)) {
      if (blocks128 >= sm_count() &&
          DbLayout<SWP, 2, true, DKDV>::plan(nb, &kst, &sst))
        return take(Two{}, std::true_type{});
    }
    if (DbLayout<SWP, 1, true, DKDV>::plan(nb, &kst, &sst))
      return take(One{}, std::true_type{});
    return take(One{}, std::false_type{});
  };
  if constexpr (DKDV) {
    if (sw <= 96) return pick(std::integral_constant<int, 96>{});
    return pick(std::integral_constant<int, 128>{});
  } else {
    switch ((sw + 31) / 32 * 32) {
      case 160: return pick(std::integral_constant<int, 160>{});
      case 192: return pick(std::integral_constant<int, 192>{});
      case 224: return pick(std::integral_constant<int, 224>{});
      default: return pick(std::integral_constant<int, 256>{});
    }
  }
}

}  // namespace
