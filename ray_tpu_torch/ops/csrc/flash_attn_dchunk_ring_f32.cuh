// The fp32 kernels past head dim 256 on the CUDA cores: what K1's
// register-blocked ring kernel (flash_attn_dchunk_fma.cu) and K2's and
// K3's (bwd_dchunk_ring_f32_kernel below, instantiated in
// flash_attn_dchunk_bwd_{dq,dkdv}_fma.cu) share -- a key group's cp.async
// ring, its copies and its barrier -- and the backward kernel itself.
//
// K2 and K3 in fp32 past 256 (route "dchunk_fma_f32_ring"): replace
// ray_tpu/ops/attention.py::_bwd_dq_kernel and ::_bwd_dkdv_kernel
// (launched by _pallas_bwd) for those inputs. Numerics as the FMA route's
// (flash_attn_bwd_fma.cu): exact fp32 FMAs (the tensor cores would round
// to tf32, and 3xTF32 also moves the result), p = expf(s scale - lse)
// from the forward's lse, ds = p (dp - delta) scale, the causal bound
// and the ragged edges masked. What bounds them on the H100: at the
// kernel phase's B1 S1000 H4 D320 row K2 does 3 and K3 4 products of 2 D
// FLOPs a kept pair, 3.8 and 5.1 GFLOP, 0.057 and 0.077 ms at 67 TFLOP/s
// on the CUDA cores. The kernels they replaced cut the head dim into
// 64-column chunks, a block per output chunk, so each block recomputed
// S and dP over the whole head dim: D / 64 times the products at D 320.
// One template serves both (DKDV), as the two are the same computation
// with the roles of the queries and the keys exchanged:
//   - a block owns 32 rows (K2: queries, of Q and dO; K3: keys, of K and
//     V) and a slice of its outputs' columns (K2: dq; K3: dk and dv),
//     ns = ceil(D / 320) slices of ceil(D / ns) columns rounded up to 64
//     (NCG = 3, 4 or 5 groups of 64, as K1's), so S and dP are computed
//     once a tile pair up to D 320 and twice up to 640;
//   - it walks the 64-row tiles of the other side (K2: keys of K and V
//     up to the causal bound; K3: queries of Q and dO from the first one
//     at or past the diagonal); two key groups of 128 threads split them
//     (even, odd), each with its own ring, and add their sums at the end
//     through shared memory (as K1's key groups merge theirs);
//   - per tile, X = R1 T1^T (S; K3: S^T = K Q^T) over the head dim in
//     64-column steps, then Y = R2 T2^T (dP; K3: dP^T = V dO^T), both
//     register-blocked over a group's 8 x 16 threads as K1's S: thread
//     (ty, tx) computes rows 4ty..4ty+3 and columns tx + 16jj; then p and
//     ds in fp32 into shared memory as [column][row] (ds^T, and p^T for
//     K3), read back by the same warp; then out1 += ds T1s (K2: dq += ds
//     K_slice; K3: dk += ds^T Q_slice) and for K3 out2 += p T2s (dv +=
//     p^T dO_slice) over 16-row steps of the slice, as K1's P V: thread
//     (ty, tx) owns rows 4ty..4ty+3 and columns 4tx + 64c..+3;
//   - every step's operands stream through the group's three-stage
//     cp.async ring, the copies of step i + 2 in flight while step i
//     computes; 16-byte copies at D % 4 == 0, 4-byte ones otherwise (VEC),
//     so every D past 256 is taken.
// ptxas (sm_90a, on the H100 host; tools/check_head_dims.py): K2 226-254
// registers, no spills; K3 254 at 3 and 4 column groups, 255 and 28-32
// bytes spilled at 5. K3 at slices of 256 (no spills, S twice at D 320)
// ran slower at D 320 than at 320 with the spill.

#pragma once

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

constexpr int RF_M = 32;          // rows a block (K1: q rows)
constexpr int RF_N = 64;          // rows of a streamed tile (K1: keys)
constexpr int RF_K = 64;          // head-dim columns an S step reads
constexpr int RF_VK = 16;         // rows of a slice step (K1: keys of V)
constexpr int RF_GROUP = 128;     // threads of a key group: 8 x 16 (ty, tx)
constexpr int RF_NG = 2;          // key groups a block
constexpr int RF_ST = 3;          // ring stages
constexpr int RF_MAX_SLICE = 320;     // output columns a block owns at most
constexpr int RF_QK_LD = RF_K + PAD;  // shared row of a Q or K chunk
constexpr int RF_P_LD = RF_M + PAD;   // shared row of p^T: [key][q row]

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

// ---------------------------------------------------------------------------
// K2 and K3 (see the header).
// ---------------------------------------------------------------------------

// A key group's shared memory, in floats: its ring's stages, then ds^T
// and (K3) p^T of its current tile, [column][row]. NCG groups of 64
// output columns a block.
template <int NCG, bool DKDV>
struct RbLayout {
  static constexpr int SW = NCG * 64;  // output columns a block
  static constexpr int V_LD = SW + PAD;
  static constexpr int R_FL = RF_M * RF_QK_LD;  // floats of a row chunk
  static constexpr int T_FL = RF_N * RF_QK_LD;  // ... of a tile chunk
  static constexpr int V_FL = RF_VK * V_LD;     // ... of a slice step
  static constexpr int STAGE = R_FL + T_FL > V_FL ? R_FL + T_FL : V_FL;
  static constexpr int P_OFF = RF_ST * STAGE;
  static constexpr int TILES = DKDV ? 2 : 1;  // ds^T, p^T
  static constexpr int GROUP_FL = P_OFF + TILES * RF_N * RF_P_LD;
  // what key group 1 hands group 0 at the end: its sums, a thread's
  static constexpr int HANDOFF = TILES * 16 * NCG;
  static_assert(HANDOFF * RF_GROUP <= RF_NG * GROUP_FL,
                "the hand-off fits the block's shared memory");
};

// DKDV false (K2): rows are queries, R1 = q, R2 = dout, the tiles keys,
// T1 = k, T2 = v, out1 = dq. DKDV true (K3): rows are keys, R1 = k, R2 =
// v, the tiles queries, T1 = q, T2 = dout, out1 = dk, out2 = dv.
template <int NCG, bool VEC, bool DKDV>
__global__ void __launch_bounds__(RF_GROUP * RF_NG, 1)
bwd_dchunk_ring_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ out1, float* __restrict__ out2,
                           int H, int Sq, int Sk, int D, int causal,
                           float scale) {
  using L = RbLayout<NCG, DKDV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int grp = threadIdx.x / RF_GROUP;
  const int gt = threadIdx.x % RF_GROUP;
  float* ring = reinterpret_cast<float*>(smem_raw) + grp * L::GROUP_FL;
  float* DSt = ring + L::P_OFF;    // ds^T of the current tile
  float* Pt = DSt + RF_N * RF_P_LD;  // p^T (K3)

  const int ty = gt >> 4;  // rows 4ty..4ty+3
  const int tx = gt & 15;  // tile rows tx + 16jj; columns 4tx + 64c..+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  // K2: longest causal q tiles first; K3: the first key tiles have most
  const int r0 = (DKDV ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * RF_M;
  const int c0 = blockIdx.z * L::SW;
  const int Sr = DKDV ? Sk : Sq;  // rows of R1/R2
  const int St = DKDV ? Sq : Sk;  // rows of T1/T2
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq * H + h) * D;
  const long k_off = ((long)b * Sk * H + h) * D;
  const float* r1 = DKDV ? k + k_off : q + q_off;
  const float* r2 = DKDV ? v + k_off : dout + q_off;
  const float* t1 = DKDV ? q + q_off : k + k_off;
  const float* t2 = DKDV ? dout + q_off : v + k_off;

  // the tiles: K2 the keys up to the causal bound of the block's last
  // row; K3 the queries from the first tile at or past its first key
  int t_first, n_tiles;
  if constexpr (DKDV) {
    t_first = causal ? r0 / RF_N : 0;
    n_tiles = max(0, (Sq + RF_N - 1) / RF_N - t_first);
  } else {
    const int q_last = min(r0 + RF_M, Sq) - 1;
    const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
    t_first = 0;
    n_tiles = (kv_len + RF_N - 1) / RF_N;
  }
  const int my_tiles =
      n_tiles > grp ? (n_tiles - grp + RF_NG - 1) / RF_NG : 0;
  const int n_sq = (D + RF_K - 1) / RF_K;  // X (then Y) steps a tile
  constexpr int N_SLICE = L::TILES * (RF_N / RF_VK);  // slice steps
  const int spt = 2 * n_sq + N_SLICE;                  // steps a tile
  const int n_steps = my_tiles * spt;
  const int live = D - c0;  // this slice's columns before D's end

  // K2: the lse and delta of this thread's rows
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ty + r;
    const bool ok = !DKDV && row < Sq;
    lse_r[r] = ok ? lse[(long)bh * Sq + row] : 0.f;
    delta_r[r] = ok ? delta[(long)bh * Sq + row] : 0.f;
  }
  float x[4][4], y[4][4], o1[4][NCG][4], o2[DKDV ? 4 : 1][NCG][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o1[r][c][e] = 0.f;
        if constexpr (DKDV) o2[r][c][e] = 0.f;
      }
    }
  }

  // step i's copies into stage i % RF_ST (one commit group each, empty
  // past the last step, so that the waits count alike)
  auto load_step = [&](int i) {
    if (i < n_steps) {
      const int t0 = (t_first + grp + RF_NG * (i / spt)) * RF_N;
      const int u = i % spt;
      float* st = ring + (i % RF_ST) * L::STAGE;
      if (u < 2 * n_sq) {
        const bool second = u >= n_sq;
        const int col = (second ? u - n_sq : u) * RF_K;
        ring_load<RF_M, RF_K, RF_QK_LD, VEC>(st, second ? r2 : r1,
                                             row_stride, r0, Sr, col, D,
                                             gt);
        ring_load<RF_N, RF_K, RF_QK_LD, VEC>(st + L::R_FL,
                                             second ? t2 : t1, row_stride,
                                             t0, St, col, D, gt);
      } else {
        const int w = u - 2 * n_sq;  // K3: T1's 4 steps, then T2's
        ring_load<RF_VK, L::SW, L::V_LD, VEC>(
            st, w < RF_N / RF_VK ? t1 : t2, row_stride,
            t0 + (w % (RF_N / RF_VK)) * RF_VK, St, c0, D, gt);
      }
    }
    cp_async_commit();
  };

  // p and ds of tile t0 from X and Y, into DSt (and Pt) as [column][row]
  auto p_ds = [&](int t0) {
    float lse_c[4], delta_c[4];  // K3: by column
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int qc = t0 + tx + 16 * jj;
      const bool ok = DKDV && qc < Sq;
      lse_c[jj] = ok ? lse[(long)bh * Sq + qc] : 0.f;
      delta_c[jj] = ok ? delta[(long)bh * Sq + qc] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + 4 * ty + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = t0 + tx + 16 * jj;
        const int qpos = DKDV ? col : row, key = DKDV ? row : col;
        const bool ok = qpos < Sq && key < Sk && (!causal || qpos >= key);
        const float l = DKDV ? lse_c[jj] : lse_r[r];
        const float d = DKDV ? delta_c[jj] : delta_r[r];
        const float p = ok ? expf(x[r][jj] * scale - l) : 0.f;
        x[r][jj] = p;
        y[r][jj] = p * (y[r][jj] - d) * scale;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int at = (tx + 16 * jj) * RF_P_LD + 4 * ty;
      *reinterpret_cast<float4*>(DSt + at) =
          make_float4(y[0][jj], y[1][jj], y[2][jj], y[3][jj]);
      if constexpr (DKDV)
        *reinterpret_cast<float4*>(Pt + at) =
            make_float4(x[0][jj], x[1][jj], x[2][jj], x[3][jj]);
    }
  };

  // acc += A X over a slice step's 16 tile rows: A's [column][row] rows
  // of this thread's rows (written by its own warp), X the step's rows
  auto slice_step = [&](float (&acc)[4][NCG][4], const float* A,
                        const float* st) {
    const float* Vs = st + 4 * tx;
#pragma unroll 4
    for (int kk = 0; kk < RF_VK; ++kk) {
      const float4 p = ld4(A + kk * RF_P_LD);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NCG; ++c) {
        if (64 * c >= live) break;  // column groups wholly past D
        const float4 xv = ld4(Vs + kk * L::V_LD + 64 * c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][c][0] = fmaf(pr[r], xv.x, acc[r][c][0]);
          acc[r][c][1] = fmaf(pr[r], xv.y, acc[r][c][1]);
          acc[r][c][2] = fmaf(pr[r], xv.z, acc[r][c][2]);
          acc[r][c][3] = fmaf(pr[r], xv.w, acc[r][c][3]);
        }
      }
    }
  };

  // acc (+)= the step's R rows of this thread T^T over its 64 columns:
  // a float4 of R and one of T feed 16 FMAs (X or Y, a call each, so
  // that both stay in registers)
  auto row_step = [&](float (&acc)[4][4], const float* st, bool first) {
    if (first) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    }
    const float* Rs = st + 4 * ty * RF_QK_LD;
    const float* Ts = st + L::R_FL + tx * RF_QK_LD;
#pragma unroll 8
    for (int c = 0; c < RF_K; c += 4) {
      float4 a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(Rs + r * RF_QK_LD + c);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        bv[jj] = ld4(Ts + 16 * jj * RF_QK_LD + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[r][jj] = fmaf(a[r].x, bv[jj].x, acc[r][jj]);
          acc[r][jj] = fmaf(a[r].y, bv[jj].y, acc[r][jj]);
          acc[r][jj] = fmaf(a[r].z, bv[jj].z, acc[r][jj]);
          acc[r][jj] = fmaf(a[r].w, bv[jj].w, acc[r][jj]);
        }
      }
    }
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
    if (u < 2 * n_sq) {
      // X (then Y) += R_u T_u^T over this step's 64 columns
      if (u < n_sq)
        row_step(x, st, u == 0);
      else
        row_step(y, st, u == n_sq);
      if (u == 2 * n_sq - 1)
        p_ds((t_first + grp + RF_NG * (i / spt)) * RF_N);
    } else {
      // out1 += ds T1_slice (K3 then out2 += p T2_slice) over this step's
      // 16 tile rows
      const int w = u - 2 * n_sq;
      const int at = (w % (RF_N / RF_VK)) * RF_VK * RF_P_LD + 4 * ty;
      if constexpr (DKDV) {
        if (w >= RF_N / RF_VK)
          slice_step(o2, Pt + at, st);
        else
          slice_step(o1, DSt + at, st);
      } else {
        slice_step(o1, DSt + at, st);
      }
    }
  }
  cp_async_wait<0>();

  // group 1's sums, thread by thread, in the block's shared memory;
  // group 0 adds them
  float* hand = reinterpret_cast<float*>(smem_raw);
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < NCG; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = (r * NCG + c) * 4 + e;
          hand[n * RF_GROUP + gt] = o1[r][c][e];
          if constexpr (DKDV) hand[(16 * NCG + n) * RF_GROUP + gt] =
              o2[r][c][e];
        }
      }
    }
  }
  __syncthreads();
  if (grp == 1) return;

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ty + r;
    if (row >= Sr) continue;
    const long at = (DKDV ? k_off : q_off) + (long)row * row_stride;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      const int col = c0 + 4 * tx + 64 * c;
      float s1[4], s2[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (r * NCG + c) * 4 + e;
        s1[e] = o1[r][c][e] + hand[n * RF_GROUP + gt];
        if constexpr (DKDV)
          s2[e] = o2[r][c][e] + hand[(16 * NCG + n) * RF_GROUP + gt];
      }
      if constexpr (VEC) {
        if (col < D) {
          *reinterpret_cast<float4*>(out1 + at + col) =
              make_float4(s1[0], s1[1], s1[2], s1[3]);
          if constexpr (DKDV)
            *reinterpret_cast<float4*>(out2 + at + col) =
                make_float4(s2[0], s2[1], s2[2], s2[3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e >= D) continue;
          out1[at + col + e] = s1[e];
          if constexpr (DKDV) out2[at + col + e] = s2[e];
        }
      }
    }
  }
}

template <int NCG, bool VEC, bool DKDV>
cudaError_t launch_bwd_ring(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* out1, float* out2,
                            int B, int H, int Sq, int Sk, int D, int causal,
                            float scale, cudaStream_t stream) {
  using L = RbLayout<NCG, DKDV>;
  constexpr int smem = RF_NG * L::GROUP_FL * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dchunk_ring_f32_kernel<NCG, VEC, DKDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = DKDV ? Sk : Sq;
  const dim3 grid((rows + RF_M - 1) / RF_M, B * H, (D + L::SW - 1) / L::SW);
  bwd_dchunk_ring_f32_kernel<NCG, VEC, DKDV>
      <<<grid, RF_GROUP * RF_NG, smem, stream>>>(q, k, v, dout, lse, delta,
                                                 out1, out2, H, Sq, Sk, D,
                                                 causal, scale);
  return cudaGetLastError();
}

// K2 (DKDV false: out1 = dq) or K3 (true: out1 = dk, out2 = dv) in fp32
// past 256: the slice plan of K1's ring kernel (ns = ceil(D / 320)
// slices of ceil(D / ns) columns rounded up to 64), then the
// instantiation at that width and the row's copy size
template <bool DKDV>
cudaError_t bwd_dchunk_ring(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* out1, void* out2,
                            int B, int H, int Sq, int Sk, int D, int causal,
                            float scale, cudaStream_t stream) {
  if (!rtt::dchunk_head_dim(D)) return cudaErrorInvalidValue;
  const int ns = (D + RF_MAX_SLICE - 1) / RF_MAX_SLICE;
  const int ncg = ((D + ns - 1) / ns + 63) / 64;
  const auto launch = [&](auto launcher) {
    return launcher(static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), lse, delta,
                    static_cast<float*>(out1), static_cast<float*>(out2), B,
                    H, Sq, Sk, D, causal, scale, stream);
  };
  const auto pick = [&](auto vec) -> cudaError_t {
    constexpr bool VEC = decltype(vec)::value;
    switch (ncg) {
      case 3: return launch(&launch_bwd_ring<3, VEC, DKDV>);
      case 4: return launch(&launch_bwd_ring<4, VEC, DKDV>);
      default: return launch(&launch_bwd_ring<5, VEC, DKDV>);
    }
  };
  if (D % 4 == 0) return pick(std::true_type{});
  return pick(std::false_type{});
}

}  // namespace
