// K1, K2 and K3 in fp32 on the CUDA cores at every head dim past 256, with
// no upper bound. Replace ray_tpu/ops/attention.py::_flash_kernel (lines
// 202-259), ::_bwd_dq_kernel and ::_bwd_dkdv_kernel for those inputs.
//
// K2 and K3 (route "dchunk"): flash_attn_dchunk.cu describes the design
// (the head dim cut into 64-column chunks, a block per tile and output
// chunk, S recomputed over every chunk by each of a tile's blocks,
// bit-identically) and flash_attn_bwd_fma.cu the fp32 kernels' layout,
// which these keep at DP 64: exact fp32 FMAs, 8 warps of 8 rows over
// 64-row tiles, a lane owning two keys (or queries) of the S tile and two
// columns of its output chunk, plain loads.
//
// K1 (route "dchunk_fma_f32_ring", fwd_dchunk_ring_f32_kernel): exact fp32
// FMAs (the tensor cores would round fp32 to tf32, and 3xTF32 also moves
// the result), so the card's 67 TFLOP/s on the CUDA cores bounds it: at
// the kernel phase's B1 S1000 H4 D320 row 2.6 GFLOP, 0.038 ms. The kernel
// it replaced recomputed S in each of a tile's D/64 blocks (6 units of
// S-or-P V work a pair at D 320 where 2 would do), gave each lane two
// output columns (one shared-memory read a FMA) and loaded with plain
// loads between barriers. This one:
//   - a block owns 32 q rows and a slice of O's columns: ns = ceil(D /
//     320) slices of ceil(D / ns) columns rounded up to 64 (NCG = 3, 4 or
//     5 groups of 64; the last slice short, its groups wholly past D
//     skipped), so S is computed ns times a tile pair: once up to D 320
//     (2 units of work at D 320), twice up to 640; slices of at most 256
//     (S twice at D 320) ran slower at D 320 in a trial;
//   - two key groups of 128 threads split the key tiles (even, odd), each
//     with its own ring, p^T and running max and sum, merged at the end
//     through shared memory: at the small causal rows the longest q
//     tile's block sets the time, and one group a block ran them slower
//     in a trial (no shape ran faster with one);
//   - both products are register-blocked over a group's 8 x 16 threads:
//     thread (ty, tx) computes S for rows 4ty..4ty+3 and keys tx + 16jj
//     (4 x 4: a float4 of Q and one of K feed 16 FMAs) and O for the same
//     rows and columns 4tx + 64c..+3 (4 x 4 NCG: a float4 of p^T and NCG
//     of V feed 16 NCG FMAs); a row of S lives on 16 lanes of a warp, so
//     the softmax reduces with shuffles, and p^T goes through shared
//     memory to be read back by the same warp;
//   - Q, K and V stream through a group's three-stage cp.async ring of
//     steps: per 64-key tile, ceil(D / 64) steps of a Q chunk [32 x 64]
//     and a K chunk [64 x 64], then four of V's slice [16 keys x 64 NCG];
//     the copies of step i + 2 are in flight while step i computes.
//     16-byte copies at D % 4 == 0, 4-byte ones otherwise (VEC), so it
//     takes every D past 256;
//   - S is summed over the head dim in the same order in every slice
//     block, so m, l and p are bit-identical across slices; slice 0
//     writes lse. Numerics as the FMA route's: scale, -1e30 masks, expf,
//     l summing p, lse = m + log(max(l, 1e-20)).
// What holds it back (PERF.md): shared memory. An SM reads 128 bytes of it
// a cycle, one warp-wide 16-byte load every 4 cycles, and issues 4 warp
// FMAs a cycle, so it needs 16 FMAs a 16-byte load; S's 4 x 4 blocking
// gives 8 (at most half the FMA rate), P V's 13.3 at NCG 5. A larger S
// block needs more keys a tile or more rows a thread, and O's registers
// (16 NCG: 80 at 320 columns) leave no room for either.
// ptxas (sm_90a, on the H100 host; tools/check_head_dims.py):
// K1 196-236 registers (one block of 256 threads an SM), no spills.

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

constexpr int TILE = 64;              // rows of every q and k tile
constexpr int NWARPS = TILE / FMA_ROWS;
constexpr int NTHREADS = NWARPS * 32;
constexpr int DC = 64;                // head-dim columns of a chunk
constexpr int LD = DC + PAD;          // shared row of a chunk tile
constexpr int CT = TILE * LD;         // floats of one chunk tile
constexpr int NC = TILE / 32;         // S columns a lane owns
constexpr int DPL = DC / 32;          // output columns a lane owns

// rows [r0, r0 + TILE) x columns [c0, c0 + DC) of one head of a [S, H, D]
// fp32 tensor into a chunk tile; rows past S and columns past D are zeros
// (load_rows_f32 is told the columns left from c0, as aligned as D's)
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           long row_stride, int r0, int S,
                                           int c0, int D, int tid) {
  load_rows_f32<TILE, DC, NTHREADS>(dst, src + c0, row_stride, r0, S, D - c0,
                                    tid);
}

__device__ __forceinline__ void zero(float (&x)[FMA_ROWS][NC]) {
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < NC; ++j) x[r][j] = 0.f;
  }
}

// columns [c0, c0 + DC) of a warp's rows (null: past S) from a lane's two
__device__ __forceinline__ void store_chunk(float* const (&rows)[FMA_ROWS],
                                            const float (&acc)[FMA_ROWS][DPL],
                                            const float (&mul)[FMA_ROWS],
                                            int c0, int D, int lane) {
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    if (rows[r] == nullptr) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = c0 + lane * DPL + i;
      if (c < D) rows[r][c] = acc[r][i] * mul[r];
    }
  }
}

// ---------------------------------------------------------------------------
// K1: register-blocked FMAs fed by a cp.async ring (see the header).
// ---------------------------------------------------------------------------

constexpr int RF_M = 32;          // q rows a block
constexpr int RF_N = 64;          // keys a tile
constexpr int RF_K = 64;          // head-dim columns an S step reads
constexpr int RF_VK = 16;         // keys a P V step reads
constexpr int RF_GROUP = 128;     // threads of a key group: 8 x 16 (ty, tx)
constexpr int RF_NG = 2;          // key groups a block
constexpr int RF_ST = 3;          // ring stages
constexpr int RF_MAX_SLICE = 320;     // O columns a block owns at most
constexpr int RF_QK_LD = RF_K + PAD;  // shared row of a Q or K chunk
constexpr int RF_P_LD = RF_M + PAD;   // shared row of p^T: [key][q row]

// A key group's shared memory, in floats: its ring's stages, then p^T of
// its current tile. NCG groups of 64 O columns a block.
template <int NCG>
struct RfLayout {
  static constexpr int SW = NCG * 64;  // O columns a block
  static constexpr int V_LD = SW + PAD;
  static constexpr int Q_FL = RF_M * RF_QK_LD;  // floats of a Q chunk
  static constexpr int K_FL = RF_N * RF_QK_LD;
  static constexpr int V_FL = RF_VK * V_LD;
  static constexpr int STAGE = Q_FL + K_FL > V_FL ? Q_FL + K_FL : V_FL;
  static constexpr int P_OFF = RF_ST * STAGE;
  static constexpr int GROUP_FL = P_OFF + RF_N * RF_P_LD;
  // what key group 1 hands group 0 at the end: m, l and O a thread
  static constexpr int HANDOFF = 2 * 4 + 4 * NCG * 4;
  static_assert(HANDOFF * RF_GROUP <= P_OFF, "the hand-off fits the ring");
};

__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src,
                                               bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// bar.sync on named barrier `id` (1..15) for the 128 threads of one key
// group
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(RF_GROUP) : "memory");
}

// rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of one head of a [S, H, D]
// fp32 tensor (``src`` at the head's first element) into shared rows of SLD
// floats, as cp.async copies the caller commits (``gt``: this thread in
// its key group); rows past S and columns past D are zeros. VEC (D % 4 ==
// 0): 16 bytes a copy, else 4.
template <int ROWS, int COLS, int SLD, bool VEC>
__device__ __forceinline__ void ring_load(float* dst, const float* src,
                                          long row_stride, int r0, int S,
                                          int c0, int D, int gt) {
  constexpr int CH = COLS / 4;
  static_assert(ROWS * CH % RF_GROUP == 0, "whole rounds of copies");
#pragma unroll
  for (int n = 0; n < ROWS * CH / RF_GROUP; ++n) {
    const int i = gt + n * RF_GROUP;
    const int r = i / CH, c = (i % CH) * 4;
    const bool row_ok = r0 + r < S;
    const long at = (long)(r0 + r) * row_stride + c0 + c;
    float* d = dst + r * SLD + c;
    if constexpr (VEC) {
      const bool ok = row_ok && c0 + c < D;
      cp_async_f32x4(d, src + (ok ? at : 0), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && c0 + c + e < D;
        cp_async_f32(d + e, src + (ok ? at + e : 0), ok);
      }
    }
  }
}

// Two key groups of 128 threads: group g takes the key tiles j with j % 2
// == g, each with its own ring, p^T and online softmax; group 1 hands its
// m, l and O to group 0 through shared memory at the end, and group 0
// merges them and writes the block's rows.
template <int NCG, bool VEC>
__global__ void __launch_bounds__(RF_GROUP * RF_NG, 1)
fwd_dchunk_ring_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
                           int H, int Sq, int Sk, int D, int causal,
                           float scale) {
  using L = RfLayout<NCG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int grp = threadIdx.x / RF_GROUP;
  const int gt = threadIdx.x % RF_GROUP;
  float* ring = reinterpret_cast<float*>(smem_raw) + grp * L::GROUP_FL;
  float* Pt = ring + L::P_OFF;

  const int ty = gt >> 4;  // rows 4ty..4ty+3
  const int tx = gt & 15;  // keys tx + 16jj; O columns 4tx + 64c..+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * RF_M;  // longest first
  const int c0 = blockIdx.z * L::SW;
  const long row_stride = (long)H * D;
  const float* qb = q + ((long)b * Sq * H + h) * D;
  const float* kb = k + ((long)b * Sk * H + h) * D;
  const float* vb = v + ((long)b * Sk * H + h) * D;

  const int q_last = min(q0 + RF_M, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + RF_N - 1) / RF_N;
  const int my_tiles =
      n_tiles > grp ? (n_tiles - grp + RF_NG - 1) / RF_NG : 0;
  const int n_sq = (D + RF_K - 1) / RF_K;  // S steps a tile
  const int spt = n_sq + RF_N / RF_VK;     // steps a tile
  const int n_steps = my_tiles * spt;
  const int live = D - c0;  // this slice's columns before D's end

  float s[4][4], o[4][NCG][4], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCG; ++c)
      o[r][c][0] = o[r][c][1] = o[r][c][2] = o[r][c][3] = 0.f;
  }

  // step i's copies into stage i % RF_ST (one commit group each, empty
  // past the last step, so that the waits count alike)
  auto load_step = [&](int i) {
    if (i < n_steps) {
      const int j = grp + RF_NG * (i / spt), u = i % spt;
      float* st = ring + (i % RF_ST) * L::STAGE;
      if (u < n_sq) {
        ring_load<RF_M, RF_K, RF_QK_LD, VEC>(st, qb, row_stride, q0, Sq,
                                             u * RF_K, D, gt);
        ring_load<RF_N, RF_K, RF_QK_LD, VEC>(st + L::Q_FL, kb, row_stride,
                                             j * RF_N, Sk, u * RF_K, D, gt);
      } else {
        ring_load<RF_VK, L::SW, L::V_LD, VEC>(
            st, vb, row_stride, j * RF_N + (u - n_sq) * RF_VK, Sk, c0, D,
            gt);
      }
    }
    cp_async_commit();
  };

  // the online softmax of tile j's S (a row on the 16 lanes of one tx
  // range): p^T into shared memory, O rescaled
  auto softmax = [&](int j) {
    const int k0 = j * RF_N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + 4 * ty + r;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k0 + tx + 16 * jj;
        const bool ok = key < Sk && (!causal || row >= key);
        s[r][jj] = ok ? s[r][jj] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[r][jj] = expf(s[r][jj] - m_new);
        sum += s[r][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NCG; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][c][e] *= alpha;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(Pt + (tx + 16 * jj) * RF_P_LD + 4 * ty) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
  };

#pragma unroll
  for (int i = 0; i < RF_ST - 1; ++i) load_step(i);
  for (int i = 0; i < n_steps; ++i) {
    // step i's stage has landed, and every thread of the group is done
    // with step i - 1's, which the copies issued next refill
    cp_async_wait<RF_ST - 2>();
    group_sync(1 + grp);
    load_step(i + RF_ST - 1);
    const float* st = ring + (i % RF_ST) * L::STAGE;
    const int u = i % spt;
    if (u < n_sq) {
      // S += Q_u K_u^T over this step's columns
      if (u == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
      }
      const float* Qs = st + 4 * ty * RF_QK_LD;
      const float* Ks = st + L::Q_FL + tx * RF_QK_LD;
#pragma unroll 8
      for (int c = 0; c < RF_K; c += 4) {
        float4 a[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = ld4(Qs + r * RF_QK_LD + c);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kv[jj] = ld4(Ks + 16 * jj * RF_QK_LD + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[r][jj] = fmaf(a[r].x, kv[jj].x, s[r][jj]);
            s[r][jj] = fmaf(a[r].y, kv[jj].y, s[r][jj]);
            s[r][jj] = fmaf(a[r].z, kv[jj].z, s[r][jj]);
            s[r][jj] = fmaf(a[r].w, kv[jj].w, s[r][jj]);
          }
        }
      }
      if (u == n_sq - 1) softmax(grp + RF_NG * (i / spt));
    } else {
      // O += P V over this step's 16 keys; p^T rows of this thread's q
      // rows were written by its own warp
      const float* Pk = Pt + (u - n_sq) * RF_VK * RF_P_LD + 4 * ty;
      const float* Vs = st + 4 * tx;
#pragma unroll 4
      for (int kk = 0; kk < RF_VK; ++kk) {
        const float4 p = ld4(Pk + kk * RF_P_LD);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int c = 0; c < NCG; ++c) {
          if (64 * c >= live) break;  // column groups wholly past D
          const float4 x = ld4(Vs + kk * L::V_LD + 64 * c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            o[r][c][0] = fmaf(pr[r], x.x, o[r][c][0]);
            o[r][c][1] = fmaf(pr[r], x.y, o[r][c][1]);
            o[r][c][2] = fmaf(pr[r], x.z, o[r][c][2]);
            o[r][c][3] = fmaf(pr[r], x.w, o[r][c][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // group 1's m, l and O, thread by thread, in its ring; group 0 merges
  // them (the two sets of keys, each with its own running max)
  float* hand = reinterpret_cast<float*>(smem_raw) + L::GROUP_FL;
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hand[(2 * r) * RF_GROUP + gt] = m[r];
      hand[(2 * r + 1) * RF_GROUP + gt] = l[r];
#pragma unroll
      for (int c = 0; c < NCG; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hand[(8 + (r * NCG + c) * 4 + e) * RF_GROUP + gt] = o[r][c][e];
      }
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float m1 = hand[(2 * r) * RF_GROUP + gt];
    const float l1 = hand[(2 * r + 1) * RF_GROUP + gt];
    const float m_new = fmaxf(m[r], m1);
    const float a0 = expf(m[r] - m_new), a1 = expf(m1 - m_new);
    l[r] = a0 * l[r] + a1 * l1;
    m[r] = m_new;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[r][c][e] = a0 * o[r][c][e] +
                     a1 * hand[(8 + (r * NCG + c) * 4 + e) * RF_GROUP + gt];
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / l_safe;
    float* orow = out + (((long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      const int col = c0 + 4 * tx + 64 * c;
      if constexpr (VEC) {
        if (col < D)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(o[r][c][0] * inv, o[r][c][1] * inv,
                          o[r][c][2] * inv, o[r][c][3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) orow[col + e] = o[r][c][e] * inv;
      }
    }
    if (tx == 0 && blockIdx.z == 0)
      lse[((long)b * H + h) * Sq + row] = m[r] + logf(l_safe);
  }
}

template <int NCG, bool VEC>
cudaError_t launch_fwd_ring(const float* q, const float* k, const float* v,
                            float* out, float* lse, int B, int H, int Sq,
                            int Sk, int D, int causal, float scale,
                            cudaStream_t stream) {
  using L = RfLayout<NCG>;
  constexpr int smem = RF_NG * L::GROUP_FL * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_dchunk_ring_f32_kernel<NCG, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + RF_M - 1) / RF_M, B * H, (D + L::SW - 1) / L::SW);
  fwd_dchunk_ring_f32_kernel<NCG, VEC>
      <<<grid, RF_GROUP * RF_NG, smem, stream>>>(q, k, v, out, lse, H, Sq,
                                                 Sk, D, causal, scale);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(NTHREADS)
bwd_dq_dchunk_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int Sq, int Sk, int D,
                         int causal, float scale) {
  // Q, K, dO and V chunks, K's chunk c, the ds slab [TILE q rows][TILE keys]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + CT;
  float* dOs = Ks + CT;
  float* Vs = dOs + CT;
  float* Kown = Vs + CT;
  float* DSs = Kown + CT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int c0 = blockIdx.z * DC;
  const int nc = (D + DC - 1) / DC;
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;

  const int r0 = warp * FMA_ROWS;
  float* DSw = DSs + r0 * TILE;
  float lse_r[FMA_ROWS], delta_r[FMA_ROWS], acc[FMA_ROWS][DPL];
  float s[FMA_ROWS][NC], dp[FMA_ROWS][NC];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
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
    zero(s);
    zero(dp);
    for (int dc = 0; dc < nc; ++dc) {
      __syncthreads();
      load_chunk(Qs, q + q_off, row_stride, q0, Sq, dc * DC, D, tid);
      load_chunk(Ks, k + k_off, row_stride, k0, Sk, dc * DC, D, tid);
      load_chunk(dOs, dout + q_off, row_stride, q0, Sq, dc * DC, D, tid);
      load_chunk(Vs, v + k_off, row_stride, k0, Sk, dc * DC, D, tid);
      if (dc + 1 == nc)
        load_chunk(Kown, k + k_off, row_stride, k0, Sk, c0, D, tid);
      __syncthreads();
      row_dots<DC, NC>(s, Qs, r0, Ks, lane);
      row_dots<DC, NC>(dp, dOs, r0, Vs, lane);
    }
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kp = k0 + lane + 32 * j;
        const bool ok = kp < Sk && qp < Sq && (!causal || qp >= kp);
        const float p = ok ? expf(s[r][j] * scale - lse_r[r]) : 0.f;
        DSw[r * TILE + lane + 32 * j] = p * (dp[r][j] - delta_r[r]) * scale;
      }
    }
    __syncwarp();
    slab_product<DC, TILE>(acc, DSw, Kown, lane);  // dq_c += ds K_c
    __syncwarp();
  }

  float* rows[FMA_ROWS];
  float one[FMA_ROWS];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    const int qp = q0 + r0 + r;
    one[r] = 1.f;
    rows[r] = qp < Sq ? dq + q_off + (long)qp * row_stride : nullptr;
  }
  store_chunk(rows, acc, one, c0, D, lane);
}

__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_dchunk_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int Sq, int Sk, int D, int causal,
                           float scale) {
  // K, Q, V and dO chunks, Q's and dO's chunk c, the p and ds slabs [TILE
  // keys][TILE queries], then the q tile's lse and delta
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Qs = Ks + CT;
  float* Vs = Qs + CT;
  float* dOs = Vs + CT;
  float* Qown = dOs + CT;
  float* dOown = Qown + CT;
  float* Ps = dOown + CT;
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
  const int c0 = blockIdx.z * DC;
  const int nc = (D + DC - 1) / DC;
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;

  const int r0 = warp * FMA_ROWS;  // this warp's keys
  float* Pw = Ps + r0 * TILE;
  float* DSw = DSs + r0 * TILE;
  float dka[FMA_ROWS][DPL], dva[FMA_ROWS][DPL];
  float sT[FMA_ROWS][NC], dpT[FMA_ROWS][NC];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) dka[r][i] = dva[r][i] = 0.f;
  }

  const int qt_first = causal ? k0 / TILE : 0;
  const int n_qt = (Sq + TILE - 1) / TILE;

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * TILE;
    zero(sT);
    zero(dpT);
    for (int dc = 0; dc < nc; ++dc) {
      __syncthreads();
      load_chunk(Ks, k + k_off, row_stride, k0, Sk, dc * DC, D, tid);
      load_chunk(Qs, q + q_off, row_stride, q0, Sq, dc * DC, D, tid);
      load_chunk(Vs, v + k_off, row_stride, k0, Sk, dc * DC, D, tid);
      load_chunk(dOs, dout + q_off, row_stride, q0, Sq, dc * DC, D, tid);
      if (dc + 1 == nc) {
        load_chunk(Qown, q + q_off, row_stride, q0, Sq, c0, D, tid);
        load_chunk(dOown, dout + q_off, row_stride, q0, Sq, c0, D, tid);
        if (tid < TILE) {
          const int qpos = q0 + tid;
          lse_s[tid] = qpos < Sq ? lse[(long)bh * Sq + qpos] : 0.f;
          delta_s[tid] = qpos < Sq ? delta[(long)bh * Sq + qpos] : 0.f;
        }
      }
      __syncthreads();
      row_dots<DC, NC>(sT, Ks, r0, Qs, lane);
      row_dots<DC, NC>(dpT, Vs, r0, dOs, lane);
    }
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      const int key = k0 + r0 + r;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int qi = lane + 32 * j;
        const int qpos = q0 + qi;
        const bool ok = qpos < Sq && key < Sk && (!causal || qpos >= key);
        const float p = ok ? expf(sT[r][j] * scale - lse_s[qi]) : 0.f;
        Pw[r * TILE + qi] = p;
        DSw[r * TILE + qi] = p * (dpT[r][j] - delta_s[qi]) * scale;
      }
    }
    __syncwarp();
    slab_product<DC, TILE>(dva, Pw, dOown, lane);  // dv_c += p^T dO_c
    slab_product<DC, TILE>(dka, DSw, Qown, lane);  // dk_c += ds^T Q_c
    __syncwarp();
  }

  float *krows[FMA_ROWS], *vrows[FMA_ROWS];
  float one[FMA_ROWS];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    const int key = k0 + r0 + r;
    const long o = k_off + (long)key * row_stride;
    one[r] = 1.f;
    krows[r] = key < Sk ? dk + o : nullptr;
    vrows[r] = key < Sk ? dv + o : nullptr;
  }
  store_chunk(krows, dka, one, c0, D, lane);
  store_chunk(vrows, dva, one, c0, D, lane);
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int Sgrid, int BH, int D,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sgrid + TILE - 1) / TILE, BH, (D + DC - 1) / DC);
  kernel<<<grid, NTHREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

constexpr size_t CHUNK_BYTES = (size_t)CT * sizeof(float);
constexpr size_t SLAB_BYTES = (size_t)TILE * TILE * sizeof(float);

}  // namespace

cudaError_t rtt::fwd_dchunk_fma(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int H, int Sq,
                                int Sk, int D, int causal, float scale,
                                cudaStream_t stream) {
  if (!dchunk_head_dim(D)) return cudaErrorInvalidValue;
  // ns = ceil(D / 320) slices of ceil(D / ns) columns rounded up to 64:
  // 192, 256 or 320 (D / ns > 160 past 256; one slice up to 320)
  const int ns = (D + RF_MAX_SLICE - 1) / RF_MAX_SLICE;
  const int ncg = ((D + ns - 1) / ns + 63) / 64;
  const auto launch = [&](auto launcher) {
    return launcher(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(out),
                    lse, B, H, Sq, Sk, D, causal, scale, stream);
  };
  const auto pick = [&](auto vec) -> cudaError_t {
    constexpr bool VEC = decltype(vec)::value;
    switch (ncg) {
      case 3: return launch(&launch_fwd_ring<3, VEC>);
      case 4: return launch(&launch_fwd_ring<4, VEC>);
      default: return launch(&launch_fwd_ring<5, VEC>);
    }
  };
  if (D % 4 == 0) return pick(std::true_type{});
  return pick(std::false_type{});
}

cudaError_t rtt::bwd_dq_dchunk_fma(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int H, int Sq, int Sk,
                                   int D, int causal, float scale,
                                   cudaStream_t stream) {
  if (!dchunk_head_dim(D)) return cudaErrorInvalidValue;
  return launch(bwd_dq_dchunk_f32_kernel, Sq, B * H, D,
                5 * CHUNK_BYTES + SLAB_BYTES, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, delta,
                static_cast<float*>(dq), H, Sq, Sk, D, causal, scale);
}

cudaError_t rtt::bwd_dkdv_dchunk_fma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int B, int H,
                                     int Sq, int Sk, int D, int causal,
                                     float scale, cudaStream_t stream) {
  if (!dchunk_head_dim(D)) return cudaErrorInvalidValue;
  return launch(bwd_dkdv_dchunk_f32_kernel, Sk, B * H, D,
                6 * CHUNK_BYTES + 2 * SLAB_BYTES + 2 * TILE * sizeof(float),
                stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, delta,
                static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
                D, causal, scale);
}
