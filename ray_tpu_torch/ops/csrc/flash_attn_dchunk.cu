// K2 and K3 (flash-attention dq and dk/dv backward) in bf16 on mma.sync
// past head dim 256 at D % 8 != 0, a row stride TMA cannot take, with no
// upper bound: the route "dchunk". (K1 past 256 runs on wgmma,
// flash_attn_dchunk_fwd_wgmma.cuh; K2 and K3 at D % 8 == 0 too,
// flash_attn_dchunk_bwd_wgmma.cuh.) Replace
// ray_tpu/ops/attention.py::_bwd_dq_kernel and ::_bwd_dkdv_kernel for
// those bf16 inputs; flash_attn_bwd.cu describes the kernel family and
// its numerics, which these keep (bf16 operands, fp32 accumulators, P and
// ds rounded to bf16 before the products that consume them, causal
// skipping as a loop bound, the ragged edge masked).
//
// Past 256 a block cannot hold a 64-row tile of every operand it reads at
// full width (the per-head-dim routes keep Q or K/V resident and their
// output rows in registers), so the head dim is cut into 64-column chunks
// and each block owns one chunk of its output:
//   K2   (query tile, dq chunk c): per key tile S = Q K^T and dP = dO V^T
//        over every chunk, p from lse, ds = p (dP - delta) scale, and
//        dq_c += ds K_c;
//   K3   (key tile, dk/dv chunk c): per query tile S^T = K Q^T and
//        dP^T = V dO^T over every chunk, then dv_c += p^T dO_c and
//        dk_c += ds^T Q_c.
// The recompute costs D/64 times the S and dP products of one block per
// tile (PERF.md has the times): the wgmma kernels past 256 compute them
// ceil(D / W) times, and feeding those by cp.async is still to do.
//
// Each (tile, chunk) step's operand chunks go round a two-stage cp.async
// ring (the next step's loads are issued before this step's products);
// the chunk a block owns of K (K2) or Q and dO (K3) is loaded with a
// tile's first step into a buffer of its own, two of them by tile
// parity. One block of 4 warps, 16 rows each; A and B fragments by
// ldmatrix from padded shared rows, as flash_attn_bwd_dq_mma.cu.

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;          // rows of every q and k tile
constexpr int DC = 64;            // head-dim columns of a chunk
constexpr int LD = DC + MMA_PAD;  // shared row of a chunk tile
constexpr int CT = TILE * LD;     // elements of one chunk tile
constexpr int NT = TILE / 8;      // 8-wide n-tiles of a 64-wide S tile
constexpr int DT = DC / 8;        // 8-wide n-tiles of an output chunk

// rows [r0, r0 + TILE) x columns [c0, c0 + DC) of one head of a [S, H, D]
// bf16 tensor (``src`` at the head's first element) into a chunk tile;
// rows past S and columns past D load as zeros. load_rows_bf16 is told
// the columns left from c0: c0 is a multiple of 64, so they are as
// aligned as D's own rows.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           long row_stride, int r0, int S,
                                           int c0, int D, int tid) {
  load_rows_bf16<TILE, DC, THREADS>(dst, src + c0, row_stride, r0, S, D - c0,
                                    tid);
}

// the A fragment of rows (g, g+8) x 16 keys, from S-layout accumulators
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[NT][4],
                                       int kc) {
  a[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
  a[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
  a[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
  a[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
}

// acc += A (16 rows x 64 keys, as packed fragments of x) . B (a [64 keys]
// x [64 columns] chunk tile, B fragments by transposing ldmatrix)
__device__ __forceinline__ void tile_product(float (&acc)[DT][4],
                                             const float (&x)[NT][4],
                                             const bf16* B, int lane) {
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
#pragma unroll
  for (int kc = 0; kc < TILE / 16; ++kc) {
    uint32_t a[4];
    pack_a(a, x, kc);
    const bf16* bp =
        B + (kc * 16 + (lm_mat & 1) * 8 + lm_row) * LD + (lm_mat >> 1) * 8;
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bp + j * 8);
      mma_bf16(acc[j], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(acc[j + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
}

// rows (g, g+8) of a 16-row accumulator chunk into columns [c0, c0 + DC)
// of [S, H, D] rows ``row[0]``/``row[1]`` (null: past S), times ``mul``
__device__ __forceinline__ void store_chunk(bf16* const (&row)[2],
                                            const float (&acc)[DT][4],
                                            const float (&mul)[2], int c0,
                                            int D, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store_pair_bf16(row[r] + c0, j * 8 + 2 * t, D - c0,
                      acc[j][2 * r] * mul[r], acc[j][2 * r + 1] * mul[r]);
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_dq_dchunk_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int Sq, int Sk, int D,
                         int causal, float scale) {
  // two stages of (Q, K, dO, V chunks), then K's chunk c by tile parity
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  bf16* Kown = stages + 8 * CT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int c0 = blockIdx.z * DC;
  const int nc = (D + DC - 1) / DC;
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;

  const int wr = warp * 16;
  const int qp[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const long i = (long)bh * Sq + qp[row];
    lse_r[row] = qp[row] < Sq ? lse[i] : 0.f;
    delta_r[row] = qp[row] < Sq ? delta[i] : 0.f;
  }
  float acc[DT][4], s[NT][4], dp[NT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int q_last = min(q0 + TILE, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_steps = (kv_len + TILE - 1) / TILE * nc;

  auto load_step = [&](int i) {
    const int tile = i / nc, dc = i % nc;
    bf16* st = stages + (i & 1) * 4 * CT;
    load_chunk(st, q + q_off, row_stride, q0, Sq, dc * DC, D, tid);
    load_chunk(st + CT, k + k_off, row_stride, tile * TILE, Sk, dc * DC, D,
               tid);
    load_chunk(st + 2 * CT, dout + q_off, row_stride, q0, Sq, dc * DC, D,
               tid);
    load_chunk(st + 3 * CT, v + k_off, row_stride, tile * TILE, Sk, dc * DC,
               D, tid);
    if (dc == 0)
      load_chunk(Kown + (tile & 1) * CT, k + k_off, row_stride, tile * TILE,
                 Sk, c0, D, tid);
    cp_async_commit();
  };
  load_step(0);

  for (int i = 0; i < n_steps; ++i) {
    const int tile = i / nc, dc = i % nc;
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_steps) load_step(i + 1);
    const bf16* st = stages + (i & 1) * 4 * CT;
    if (dc == 0) {
      zero(s);
      zero(dp);
    }
    row_products<DC, NT>(s, st, st + CT, wr, 0, lane);
    row_products<DC, NT>(dp, st + 2 * CT, st + 3 * CT, wr, 0, lane);
    if (dc + 1 < nc) continue;

    // p from lse, then ds (kept in s), as bwd_dq_mma
    const int k0 = tile * TILE;
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
    tile_product(acc, s, Kown + (tile & 1) * CT, lane);  // dq_c += ds K_c
  }
  cp_async_wait<0>();

  bf16* rows[2];
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rows[r] = qp[r] < Sq ? dq + q_off + (long)qp[r] * row_stride : nullptr;
  store_chunk(rows, acc, one, c0, D, t);
}

__global__ void __launch_bounds__(THREADS)
bwd_dkdv_dchunk_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int Sq, int Sk, int D, int causal,
                           float scale) {
  // two stages of (K, Q, V, dO chunks), then Q's and dO's chunk c by
  // query tile parity, then the query tiles' lse and delta rows by parity
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  bf16* own = stages + 8 * CT;
  float* rows_s = reinterpret_cast<float*>(own + 4 * CT);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * TILE;
  const int c0 = blockIdx.z * DC;
  const int nc = (D + DC - 1) / DC;
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;

  const int wr = warp * 16;
  const int kp[2] = {k0 + wr + g, k0 + wr + g + 8};
  float dka[DT][4], dva[DT][4], sT[NT][4], dpT[NT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  // causal: queries before k0 never see this tile's keys
  const int qt_first = causal ? k0 / TILE : 0;
  const int n_qt = (Sq + TILE - 1) / TILE;
  const int n_steps = max(0, n_qt - qt_first) * nc;

  auto load_step = [&](int i) {
    const int qt = qt_first + i / nc, dc = i % nc;
    bf16* st = stages + (i & 1) * 4 * CT;
    load_chunk(st, k + k_off, row_stride, k0, Sk, dc * DC, D, tid);
    load_chunk(st + CT, q + q_off, row_stride, qt * TILE, Sq, dc * DC, D,
               tid);
    load_chunk(st + 2 * CT, v + k_off, row_stride, k0, Sk, dc * DC, D, tid);
    load_chunk(st + 3 * CT, dout + q_off, row_stride, qt * TILE, Sq,
               dc * DC, D, tid);
    if (dc == 0) {
      bf16* ob = own + (qt & 1) * 2 * CT;
      load_chunk(ob, q + q_off, row_stride, qt * TILE, Sq, c0, D, tid);
      load_chunk(ob + CT, dout + q_off, row_stride, qt * TILE, Sq, c0, D,
                 tid);
      if (tid < TILE) {
        const int qpos = qt * TILE + tid;
        const long r = (long)bh * Sq + qpos;
        rows_s[(qt & 1) * 2 * TILE + tid] = qpos < Sq ? lse[r] : 0.f;
        rows_s[(qt & 1) * 2 * TILE + TILE + tid] = qpos < Sq ? delta[r] : 0.f;
      }
    }
    cp_async_commit();
  };
  if (n_steps > 0) load_step(0);

  for (int i = 0; i < n_steps; ++i) {
    const int qt = qt_first + i / nc, dc = i % nc;
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_steps) load_step(i + 1);
    const bf16* st = stages + (i & 1) * 4 * CT;
    if (dc == 0) {
      zero(sT);
      zero(dpT);
    }
    row_products<DC, NT>(sT, st, st + CT, wr, 0, lane);
    row_products<DC, NT>(dpT, st + 2 * CT, st + 3 * CT, wr, 0, lane);
    if (dc + 1 < nc) continue;

    // p^T (kept in sT) and ds^T (kept in dpT); lse/delta by column
    const int q0 = qt * TILE;
    const float* lse_s = rows_s + (qt & 1) * 2 * TILE;
    const float* delta_s = lse_s + TILE;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);
        const int qpos = q0 + qi;
        const int key = kp[e >> 1];
        const bool ok = qpos < Sq && key < Sk && (!causal || qpos >= key);
        const float p = ok ? expf(sT[n][e] * scale - lse_s[qi]) : 0.f;
        sT[n][e] = p;
        dpT[n][e] = p * (dpT[n][e] - delta_s[qi]) * scale;
      }
    }
    const bf16* ob = own + (qt & 1) * 2 * CT;
    tile_product(dva, sT, ob + CT, lane);  // dv_c += p^T dO_c
    tile_product(dka, dpT, ob, lane);      // dk_c += ds^T Q_c
  }
  cp_async_wait<0>();

  bf16 *krows[2], *vrows[2];
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long o = k_off + (long)kp[r] * row_stride;
    krows[r] = kp[r] < Sk ? dk + o : nullptr;
    vrows[r] = kp[r] < Sk ? dv + o : nullptr;
  }
  store_chunk(krows, dka, one, c0, D, t);
  store_chunk(vrows, dva, one, c0, D, t);
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int Sgrid, int BH, int D,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sgrid + TILE - 1) / TILE, BH, (D + DC - 1) / DC);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

constexpr size_t CHUNK_BYTES = (size_t)CT * sizeof(bf16);

}  // namespace

cudaError_t rtt::bwd_dq_dchunk_mma(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int H, int Sq, int Sk,
                                   int D, int causal, float scale,
                                   cudaStream_t stream) {
  if (!dchunk_unaligned_head_dim(D)) return cudaErrorInvalidValue;
  return launch(bwd_dq_dchunk_mma_kernel, Sq, B * H, D, 10 * CHUNK_BYTES,
                stream, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const bf16*>(dout), lse, delta,
                static_cast<bf16*>(dq), H, Sq, Sk, D, causal, scale);
}

cudaError_t rtt::bwd_dkdv_dchunk_mma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int B, int H,
                                     int Sq, int Sk, int D, int causal,
                                     float scale, cudaStream_t stream) {
  if (!dchunk_unaligned_head_dim(D)) return cudaErrorInvalidValue;
  return launch(bwd_dkdv_dchunk_mma_kernel, Sk, B * H, D,
                12 * CHUNK_BYTES + 4 * TILE * sizeof(float), stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                H, Sq, Sk, D, causal, scale);
}
