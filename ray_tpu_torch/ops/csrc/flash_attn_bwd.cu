// Flash-attention backward for Hopper (sm_90a), plain CUDA C++: two
// kernels, the flash-attention-2 split of the JAX package's TPU kernels.
//
//   dq   (K2) replaces ray_tpu/ops/attention.py::_bwd_dq_kernel
//        one block per (batch*head, q tile: 128 rows on the wgmma route,
//        64 on the others); a loop over the key tiles up to the causal
//        diagonal accumulates dq = sum_k ds.K in fp32 registers;
//   dkdv (K3) replaces ray_tpu/ops/attention.py::_bwd_dkdv_kernel
//        one block per (batch*head, key tile: 128 keys on the wgmma
//        route, 64 on the others); a loop over the q tiles from the first
//        one at or below the diagonal to the end accumulates
//        dv = sum_q p^T.dO and dk = sum_q ds^T.Q.
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
//     host): 168 registers at entry, the consumers run in up to 240; no
//     spills and no serialised wgmmas at D 64 or 128. Leaving ds.K in
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
//     registers at entry, the consumers run in up to 240; at D 64 no
//     spills; at D 128 272 bytes of spills and the note that the wgmmas
//     are serialised for want of registers: that is what holds it back
//     (each wgmma waits for the last, so the products of one warpgroup
//     do not overlap its own elementwise work).
//   - K2 and K3 at head_dim 32 (a 64-byte row is under the 128-byte
//     swizzle box of the wgmma route): mma.sync.m16n8k16, bf16 operands,
//     fp32 accumulators, ldmatrix fragment loads from 16-byte padded
//     rows, cp.async double buffering of the streamed tiles.
//     K2: 4 warps of 16 q rows; S = Q K^T and dP = dO V^T share one pass
//     over head_dim; ds leaves the accumulators already in the A layout
//     of ds.K (as P does in the forward). K3: 4 warps of 16 keys; the
//     transposed tiles S^T = K Q^T and dP^T = V dO^T are computed, so
//     p^T and ds^T leave the accumulators in the A layout of p^T.dO and
//     ds^T.Q; lse and delta are indexed by column; the q tile is
//     consumed in 32-query register chunks.
//   - fp32: exact FMAs on the CUDA cores (the tensor cores would round to
//     tf32), 8 warps of 8 rows, the forward's fp32 layout.
// Causal tiles are skipped by the loop bounds; ragged edges are masked
// in the kernels (rows past the sequence load as zeros and are never
// written), Sq != Sk takes top-left causal alignment as the forward does.
//
// Plain C interface, loaded with ctypes: the caller allocates the outputs,
// passes the current stream and raises on a non-zero return.

#include <type_traits>

#include "flash_attn_common.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int TILE = 64;     // rows of every q and k tile
constexpr int Q_CHUNK = 32;  // K3: queries per register chunk

// A-operand fragment of rows [row0, row0+16) x cols [col0, col0+16) of a
// row-major bf16 tile in shared memory (matrices: rows lo/hi x cols lo/hi)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int row0, int col0,
                                       int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// rows [r0, r0+TILE) of a [S, H, D] slab -> shared memory via cp.async;
// rows past S read as zeros
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long row_stride, int r0, int S,
                                          int tid) {
  constexpr int LD = D + MMA_PAD;
  constexpr int CH = D / 8;
  for (int i = tid; i < TILE * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LD + c, src + (ok ? (r0 + r) * row_stride + c : 0),
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int H, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + MMA_PAD;
  constexpr int KD = D / 16;    // k-steps over head_dim
  constexpr int NT = TILE / 8;  // 8-key n-tiles of S
  constexpr int DT = D / 8;     // 8-wide n-tiles of dq

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

  copy_rows<D>(Qs, q + q_off, row_stride, q0, Sq, tid);
  copy_rows<D>(dOs, dout + q_off, row_stride, q0, Sq, tid);
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
    copy_rows<D>(Kd, k + k_off, row_stride, tile * TILE, Sk, tid);
    copy_rows<D>(Kd + TILE * LD, v + k_off, row_stride, tile * TILE, Sk,
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
    // (n*8 + 2t, +1); one ldmatrix x4 of K (or V) rows gives the B
    // fragments of two k-steps
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      uint32_t qa0[4], qa1[4], da0[4], da1[4];
      load_a(qa0, Qs, LD, wr, kk * 16, lane);
      load_a(qa1, Qs, LD, wr, kk * 16 + 16, lane);
      load_a(da0, dOs, LD, wr, kk * 16, lane);
      load_a(da1, dOs, LD, wr, kk * 16 + 16, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int off = (n * 8 + lm_row) * LD + kk * 16 + lm_mat * 8;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, Ks + off);
        ldmatrix_x4(bv, Vs + off);
        mma_bf16(s[n], qa0[0], qa0[1], qa0[2], qa0[3], bk[0], bk[1]);
        mma_bf16(s[n], qa1[0], qa1[1], qa1[2], qa1[3], bk[2], bk[3]);
        mma_bf16(dp[n], da0[0], da0[1], da0[2], da0[3], bv[0], bv[1]);
        mma_bf16(dp[n], da1[0], da1[1], da1[2], da1[3], bv[2], bv[3]);
      }
    }

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
      *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * row], acc[j][2 * row + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int Sq, int Sk, int causal,
                    float scale) {
  constexpr int LD = D + MMA_PAD;
  constexpr int KD = D / 16;
  constexpr int NT = Q_CHUNK / 8;  // 8-query n-tiles of a chunk
  constexpr int DT = D / 8;

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

  copy_rows<D>(Ks, k + k_off, row_stride, k0, Sk, tid);
  copy_rows<D>(Vs, v + k_off, row_stride, k0, Sk, tid);
  cp_async_commit();

  const int wr = warp * 16;
  const int kp[2] = {k0 + wr + g, k0 + wr + g + 8};  // rows g, g+8
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  // causal: queries before k0 never see this tile's keys
  const int qt_first = causal ? k0 / TILE : 0;
  const int n_qt = (Sq + TILE - 1) / TILE;
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;

  auto load_qtile = [&](int qt) {
    const int st = (qt - qt_first) & 1;
    bf16* Qd = QDs + st * STAGE;
    copy_rows<D>(Qd, q + q_off, row_stride, qt * TILE, Sq, tid);
    copy_rows<D>(Qd + TILE * LD, dout + q_off, row_stride, qt * TILE, Sq,
                 tid);
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
#pragma unroll
      for (int kk = 0; kk < KD; kk += 2) {
        uint32_t ka0[4], ka1[4], va0[4], va1[4];
        load_a(ka0, Ks, LD, wr, kk * 16, lane);
        load_a(ka1, Ks, LD, wr, kk * 16 + 16, lane);
        load_a(va0, Vs, LD, wr, kk * 16, lane);
        load_a(va1, Vs, LD, wr, kk * 16 + 16, lane);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int off = (c + n * 8 + lm_row) * LD + kk * 16 + lm_mat * 8;
          uint32_t bq[4], bd[4];
          ldmatrix_x4(bq, Qs + off);
          ldmatrix_x4(bd, dOs + off);
          mma_bf16(sT[n], ka0[0], ka0[1], ka0[2], ka0[3], bq[0], bq[1]);
          mma_bf16(sT[n], ka1[0], ka1[1], ka1[2], ka1[3], bq[2], bq[3]);
          mma_bf16(dpT[n], va0[0], va0[1], va0[2], va0[3], bd[0], bd[1]);
          mma_bf16(dpT[n], va1[0], va1[1], va1[2], va1[3], bd[2], bd[3]);
        }
      }

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
        const uint32_t p0 = pack_bf16(sT[2 * kc][0], sT[2 * kc][1]);
        const uint32_t p1 = pack_bf16(sT[2 * kc][2], sT[2 * kc][3]);
        const uint32_t p2 = pack_bf16(sT[2 * kc + 1][0], sT[2 * kc + 1][1]);
        const uint32_t p3 = pack_bf16(sT[2 * kc + 1][2], sT[2 * kc + 1][3]);
        const uint32_t d0 = pack_bf16(dpT[2 * kc][0], dpT[2 * kc][1]);
        const uint32_t d1 = pack_bf16(dpT[2 * kc][2], dpT[2 * kc][3]);
        const uint32_t d2 = pack_bf16(dpT[2 * kc + 1][0], dpT[2 * kc + 1][1]);
        const uint32_t d3 = pack_bf16(dpT[2 * kc + 1][2], dpT[2 * kc + 1][3]);
        const int off = (c + kc * 16 + (lm_mat & 1) * 8 + lm_row) * LD +
                        (lm_mat >> 1) * 8;
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t bd[4], bq[4];
          ldmatrix_x4_trans(bd, dOs + off + j * 8);
          mma_bf16(dva[j], p0, p1, p2, p3, bd[0], bd[1]);
          mma_bf16(dva[j + 1], p0, p1, p2, p3, bd[2], bd[3]);
          ldmatrix_x4_trans(bq, Qs + off + j * 8);
          mma_bf16(dka[j], d0, d1, d2, d3, bq[0], bq[1]);
          mma_bf16(dka[j + 1], d0, d1, d2, d3, bq[2], bq[3]);
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
      *reinterpret_cast<uint32_t*>(dk + o + j * 8 + 2 * t) =
          pack_bf16(dka[j][2 * row], dka[j][2 * row + 1]);
      *reinterpret_cast<uint32_t*>(dv + o + j * 8 + 2 * t) =
          pack_bf16(dva[j][2 * row], dva[j][2 * row + 1]);
    }
  }
}

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
constexpr int WS_THREADS = 384;  // two consumer warpgroups + the producer
constexpr int WS_CONSUMERS = 256;

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

// ---------------------------------------------------------------------------
// K2, bf16, head_dim 64 and 128: wgmma on a TMA-fed ring, warp-specialised.
// One block per (batch*head, 128-row q tile); warpgroups 0 and 1 each own
// 64 q rows and hold their dq accumulator [64, D] in registers for the
// whole loop; warpgroup 2 is the producer. Q and dO are loaded once and
// stay; K and V tiles of 64 keys go round a two-stage ring, each stage
// with its own full and empty barrier for K and for V: V is last read by
// dP, K by ds.K, so V's stage is released (and refilled) first.
// ---------------------------------------------------------------------------

constexpr int DQ_BM = 128;  // q rows per block
constexpr int DQ_BN = 64;   // keys per K/V tile

template <int D>
struct WsDqSmem {
  static constexpr int Q_BYTES = DQ_BM * D * 2;   // Q or dO, resident
  static constexpr int KV_BYTES = DQ_BN * D * 2;  // one K or one V tile
  static constexpr int Q_BOX = DQ_BM * SWIZZLE_ROW_BYTES;  // bytes a box
  static constexpr int KV_BOX = DQ_BN * SWIZZLE_ROW_BYTES;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + WS_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + WS_STAGES * KV_BYTES;
  // qdo_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int BYTES = BAR_OFF + (1 + 4 * WS_STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
bwd_dq_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int H, int Sq, int Sk, int causal, float scale) {
  using L = WsDqSmem<D>;
  constexpr int BOXES = D / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qdo_full = base + L::BAR_OFF;
  auto k_full = [&](int s) { return qdo_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return qdo_full + 8 * (1 + WS_STAGES + s); };
  auto k_empty = [&](int s) {
    return qdo_full + 8 * (1 + 2 * WS_STAGES + s);
  };
  auto v_empty = [&](int s) {
    return qdo_full + 8 * (1 + 3 * WS_STAGES + s);
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
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), WS_CONSUMERS);
      mbar_init(v_empty(s), WS_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: every warp lowers its register limit, one thread
    // keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      mbar_expect_tx(qdo_full, 2 * L::Q_BYTES);
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(base + x * L::Q_BOX, &tm_q, qdo_full, x * BOX_COLS, h,
                    q0, b);
        tma_load_4d(base + L::DO_OFF + x * L::Q_BOX, &tm_do, qdo_full,
                    x * BOX_COLS, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % WS_STAGES;
        const uint32_t free_parity = ((j / WS_STAGES) & 1) ^ 1;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), L::KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + x * L::KV_BOX,
                      &tm_k, k_full(s), x * BOX_COLS, h, j * DQ_BN, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + x * L::KV_BOX,
                      &tm_v, v_full(s), x * BOX_COLS, h, j * DQ_BN, b);
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

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_rows = base + wg * 64 * SWIZZLE_ROW_BYTES;
    const uint32_t do_rows = q_rows + L::DO_OFF;
    mbar_wait(qdo_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % WS_STAGES;
      const uint32_t parity = (j / WS_STAGES) & 1;
      const uint32_t k_tile = base + L::K_OFF + s * L::KV_BYTES;
      const uint32_t v_tile = base + L::V_OFF + s * L::KV_BYTES;
      if (j >= wg_tiles) {
        // a full barrier's phase completes only after every consumer
        // released this stage's previous fill: arriving before it could
        // count toward that release
        mbar_wait(k_full(s), parity);
        mbar_arrive(k_empty(s));
        mbar_wait(v_full(s), parity);
        mbar_arrive(v_empty(s));
        continue;
      }
      const int k0 = j * DQ_BN;

      // S = Q K^T and dP = dO V^T: [64 rows, 64 keys], both operands
      // K-major; two groups, so p is computed while dP is in flight
      float sc[32], dp[32];
      const uint32_t q_at = opaque(q_rows), do_at = opaque(do_rows);
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk & 3) * 32;
        wgmma_ss_n64<0>(
            sc, sw128_desc(q_at + (kk >> 2) * L::Q_BOX + in_box, 16, 1024),
            sw128_desc(k_tile + (kk >> 2) * L::KV_BOX + in_box, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      mbar_wait(v_full(s), parity);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
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
      mbar_arrive(v_empty(s));  // V is done with

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
      // contiguous), so B is transposed
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DQ_BN / 16; ++kc) {
        const uint64_t dk =
            sw128_desc(k_tile + kc * 16 * SWIZZLE_ROW_BYTES, L::KV_BOX, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128<1>(acc, da[kc], dk, 1);
        else
          wgmma_rs_n64<1>(acc, da[kc], dk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      mbar_arrive(k_empty(s));  // K is done with
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] >= Sq) continue;
      bf16* out = dq + (((long)b * Sq + qp[r]) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq_ws(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* dout, const float* lse,
                         const float* delta, bf16* dq, int B, int H, int Sq,
                         int Sk, int causal, float scale,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_bshd(&tq, q, B, Sq, H, D, DQ_BM);
  if (!err) err = encode_bshd(&tdo, dout, B, Sq, H, D, DQ_BM);
  if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, DQ_BN);
  if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, DQ_BN);
  if (err) return static_cast<cudaError_t>(err);
  constexpr int smem = WsDqSmem<D>::ALLOC;
  cudaError_t cerr = cudaFuncSetAttribute(
      bwd_dq_ws_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sq + DQ_BM - 1) / DQ_BM, B * H);
  bwd_dq_ws_kernel<D><<<grid, WS_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, dq, H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores, the forward's fp32 layout (8 warps of 8
// rows; a lane owns two columns of a 64-wide tile for the row products
// and D/32 head dims for the tile products).
// ---------------------------------------------------------------------------

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = TILE / NWARPS;

// rows [r0, r0+TILE) of a [S, H, D] fp32 slab -> shared memory; rows past
// S are zeros
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long row_stride, int r0, int S,
                                              int tid) {
  constexpr int LD = D + PAD;
  constexpr int CH = D / 4;
  for (int i = tid; i < TILE * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    float4 x = {};
    if (r0 + r < S) x = ld4(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// rows x (lane, lane+32) dot products of two row sets sharing head_dim:
// out[r][j] = A[r0 + r] . B[lane + 32 j]
template <int D>
__device__ __forceinline__ void row_dots(float (&out)[ROWS_PER_WARP][2],
                                         const float* A, int r0,
                                         const float* B, int lane) {
  constexpr int LD = D + PAD;
  const float* b_lo = B + lane * LD;
  const float* b_hi = B + (lane + 32) * LD;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float4 lo = ld4(b_lo + c);
    const float4 hi = ld4(b_hi + c);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const float4 x = ld4(A + (r0 + r) * LD + c);
      out[r][0] = fmaf(x.x, lo.x, out[r][0]);
      out[r][0] = fmaf(x.y, lo.y, out[r][0]);
      out[r][0] = fmaf(x.z, lo.z, out[r][0]);
      out[r][0] = fmaf(x.w, lo.w, out[r][0]);
      out[r][1] = fmaf(x.x, hi.x, out[r][1]);
      out[r][1] = fmaf(x.y, hi.y, out[r][1]);
      out[r][1] = fmaf(x.z, hi.z, out[r][1]);
      out[r][1] = fmaf(x.w, hi.w, out[r][1]);
    }
  }
}

// acc[r][i] += sum_j W[r][j] * X[j][lane*DPL + i] over a TILE-wide slab W
// (this warp's rows) and a row set X
template <int D>
__device__ __forceinline__ void slab_product(float (&acc)[ROWS_PER_WARP][D / 32],
                                             const float* W, const float* X,
                                             int lane) {
  constexpr int LD = D + PAD;
  constexpr int DPL = D / 32;
#pragma unroll 2
  for (int j = 0; j < TILE; ++j) {
    const float* x = X + j * LD + lane * DPL;
    float xv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) xv[i] = x[i];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const float w = W[r * TILE + j];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(w, xv[i], acc[r][i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int H, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int DPL = D / 32;

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

  load_rows_f32<D>(Qs, q + q_off, row_stride, q0, Sq, tid);
  load_rows_f32<D>(dOs, dout + q_off, row_stride, q0, Sq, tid);

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
    load_rows_f32<D>(Ks, k + k_off, row_stride, k0, Sk, tid);
    load_rows_f32<D>(Vs, v + k_off, row_stride, k0, Sk, tid);
    __syncthreads();

    float s[ROWS_PER_WARP][2] = {}, dp[ROWS_PER_WARP][2] = {};
    row_dots<D>(s, Qs, r0, Ks, lane);
    row_dots<D>(dp, dOs, r0, Vs, lane);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        const bool ok = kp < Sk && qp < Sq && (!causal || qp >= kp);
        const float p = ok ? expf(s[r][j] * scale - lse_r[r]) : 0.f;
        DSw[r * TILE + lane + 32 * j] = p * (dp[r][j] - delta_r[r]) * scale;
      }
    }
    __syncwarp();
    slab_product<D>(acc, DSw, Ks, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Sq) continue;
    float* o = dq + q_off + (long)qp * row_stride + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = acc[r][i];
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Sq, int Sk, int causal,
                    float scale) {
  constexpr int LD = D + PAD;
  constexpr int DPL = D / 32;

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

  load_rows_f32<D>(Ks, k + k_off, row_stride, k0, Sk, tid);
  load_rows_f32<D>(Vs, v + k_off, row_stride, k0, Sk, tid);

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
    load_rows_f32<D>(Qs, q + q_off, row_stride, q0, Sq, tid);
    load_rows_f32<D>(dOs, dout + q_off, row_stride, q0, Sq, tid);
    if (tid < TILE) {
      const int qpos = q0 + tid;
      lse_s[tid] = qpos < Sq ? lse[(long)bh * Sq + qpos] : 0.f;
      delta_s[tid] = qpos < Sq ? delta[(long)bh * Sq + qpos] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for this warp's keys x queries (lane, lane+32)
    float sT[ROWS_PER_WARP][2] = {}, dpT[ROWS_PER_WARP][2] = {};
    row_dots<D>(sT, Ks, r0, Qs, lane);
    row_dots<D>(dpT, Vs, r0, dOs, lane);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int key = k0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = lane + 32 * j;
        const int qpos = q0 + qi;
        const bool ok = qpos < Sq && key < Sk && (!causal || qpos >= key);
        const float p = ok ? expf(sT[r][j] * scale - lse_s[qi]) : 0.f;
        Pw[r * TILE + qi] = p;
        DSw[r * TILE + qi] = p * (dpT[r][j] - delta_s[qi]) * scale;
      }
    }
    __syncwarp();
    slab_product<D>(dva, Pw, dOs, lane);
    slab_product<D>(dka, DSw, Qs, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int key = k0 + r0 + r;
    if (key >= Sk) continue;
    const long o = k_off + (long)key * row_stride + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      dk[o + i] = dka[r][i];
      dv[o + i] = dva[r][i];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int Sgrid, int BH, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sgrid + TILE - 1) / TILE, BH);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <class F>
cudaError_t with_head_dim(int D, F&& f) {
  switch (D) {
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
size_t mma_smem() {  // four bf16 tiles of the loop + two resident ones
  return (size_t)6 * TILE * (D + MMA_PAD) * sizeof(bf16);
}

template <int D>
size_t f32_smem(bool dkdv) {  // four row tiles + one or two slabs (+rows)
  return (size_t)4 * TILE * (D + PAD) * sizeof(float) +
         (size_t)(dkdv ? 2 : 1) * TILE * TILE * sizeof(float) +
         (dkdv ? 2 * TILE * sizeof(float) : 0);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout/dq [B,Sq,H,D], k/v [B,Sk,H,D],
// all contiguous, 16-byte aligned and of one dtype; lse and delta
// [B,H,Sq] float32. Returns a cudaError_t (0 on success).
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
  return with_head_dim(D, [&](auto dim) -> cudaError_t {
    constexpr int kD = decltype(dim)::value;
    if (dtype == 1) {
      // head_dim 64 and 128: the wgmma kernel; 32 (one 64-byte row, no
      // 128-byte swizzle box) stays on mma.sync
      if constexpr (kD >= 64)
        return launch_dq_ws<kD>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l,
            dl, static_cast<bf16*>(dq), B, H, Sq, Sk, causal, scale, s);
      else
        return launch(bwd_dq_mma_kernel<kD>, Sq, B * H, MMA_THREADS,
                      mma_smem<kD>(), s, static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const bf16*>(dout), l, dl,
                      static_cast<bf16*>(dq), H, Sq, Sk, causal, scale);
    }
    if (dtype == 0)
      return launch(bwd_dq_f32_kernel<kD>, Sq, B * H, NTHREADS,
                    f32_smem<kD>(false), s, static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), l, dl,
                    static_cast<float*>(dq), H, Sq, Sk, causal, scale);
    return cudaErrorInvalidValue;
  });
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
  return with_head_dim(D, [&](auto dim) -> cudaError_t {
    constexpr int kD = decltype(dim)::value;
    if (dtype == 1) {
      // head_dim 64 and 128: the wgmma kernel; 32 (one 64-byte row, no
      // 128-byte swizzle box) stays on mma.sync
      if constexpr (kD >= 64) {
        const auto launch_ws = Sq % 4 == 0 ? &launch_dkdv_ws<kD, true>
                                           : &launch_dkdv_ws<kD, false>;
        return launch_ws(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l,
            dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, Sq, Sk,
            causal, scale, s);
      } else
        return launch(bwd_dkdv_mma_kernel<kD>, Sk, B * H, MMA_THREADS,
                      mma_smem<kD>() + 4 * TILE * sizeof(float), s,
                      static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const bf16*>(dout), l, dl,
                      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq,
                      Sk, causal, scale);
    }
    if (dtype == 0)
      return launch(bwd_dkdv_f32_kernel<kD>, Sk, B * H, NTHREADS,
                    f32_smem<kD>(true), s, static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), l, dl,
                    static_cast<float*>(dk), static_cast<float*>(dv), H, Sq,
                    Sk, causal, scale);
    return cudaErrorInvalidValue;
  });
}
