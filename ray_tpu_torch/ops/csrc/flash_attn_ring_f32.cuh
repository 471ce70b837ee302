// The fp32 kernels of K1, K2 and K3 on the CUDA cores: register-blocked
// exact FMAs fed by cp.async rings (route "fma_f32_ring" up to head dim
// 256, "dchunk_fma_f32_ring" past it, for all three). One template a
// kernel (K1: fwd_ring_f32_kernel; K2 and K3: bwd_ring_f32_kernel),
// instantiated at a block shape (RingShape) per head-dim class: past 256
// in flash_attn_dchunk_fma.cu (K1) and
// flash_attn_dchunk_bwd_{dq,dkdv}_fma.cu, up to 256 in
// flash_attn_fwd_fma_ring.cu (K1) and flash_attn_bwd_{dq,dkdv}_fma_ring.cu
// (K2, K3). Replace ray_tpu/ops/attention.py::_flash_kernel (K1, launched by
// _pallas_fwd), ::_bwd_dq_kernel and ::_bwd_dkdv_kernel (K2, K3, launched
// by _pallas_bwd) for float32 inputs.
//
// Numerics as the FMA route's: exact fp32 FMAs (the tensor cores would
// round fp32 to tf32, and 3xTF32 also moves the result); K1: scale, -1e30
// masks, expf, l summing p, lse = m + log(max(l, 1e-20)); K2/K3: p =
// expf(s scale - lse) from the forward's lse, ds = p (dp - delta) scale,
// the causal bound (top-left) and the ragged edges masked. What bounds
// them on the H100: 67 TFLOP/s on the CUDA cores, 2 D FLOPs a kept pair
// and product (K1 2 products, K2 3, K3 4): at B2 S2048 H16 D128 causal K1
// 34.4 GFLOP, 0.513 ms. An SM reads 128 bytes of shared memory a cycle
// (one warp-wide 16-byte load every 4 cycles) and issues 4 warp FMAs a
// cycle, so a product needs 16 FMAs a 16-byte load to run at the FMA
// rate; the register blocking below sets that ratio.
//
// The design (both kernels):
//   - a block owns 8 RM rows (K1: queries; K2: queries of Q and dO; K3:
//     keys of K and V) and NCG groups of CW output columns: past 256 a
//     slice of ns = ceil(D / 320) of ceil(D / ns) columns rounded up to 64
//     (RM 4, CW 64, NCG 3..5), so S (and dP) are computed ns times a tile
//     pair; up to 256 one slice, all of D, rounded up to 16, 32 or 64
//     under 64 (NCG 1, CW the same: no work on columns past that) and to
//     64 from there (NCG 2..4), so S and dP are computed once;
//   - two key groups of 128 threads split the streamed 64-row tiles (K1,
//     K2: keys, up to the causal bound; K3: queries from the first tile
//     at or past the diagonal), even and odd, each with its own ring, p^T
//     (and ds^T) and for K1 its own online softmax, merged at the end
//     through shared memory; the longest causal tiles go first;
//   - both products are register-blocked over a group's 8 x 16 threads:
//     thread (ty, tx) computes S (K3: S^T, and dP or dP^T) for rows
//     RM ty..RM ty + RM - 1 and tile rows tx + 16 jj, jj < 4 (RM x 4: a
//     float4 of RM rows and of 4 tile rows feed 16 RM FMAs: 8 a load at
//     RM 4, 10.7 at RM 8), and the outputs for the same rows and columns
//     CW c + CW/16 tx..+CW/16 (a float4 of p^T or ds^T per 4 rows and one
//     CW/16-wide load a group feed RM CW/16 NCG FMAs); a row of S lives
//     on 16 lanes of a warp, so the softmax reduces with shuffles, and
//     p^T (ds^T) goes through shared memory, [tile row][row];
//   - the operands stream through a group's three-stage cp.async ring of
//     steps, the copies of step i + 2 in flight while step i computes: per
//     tile, ceil(D / DK) row steps (K1: a K chunk [64 x DK]; K2/K3: T1's,
//     then T2's) and 64/VK slice steps (K1: V [VK keys x the slice]; K2:
//     K's rows; K3: Q's then dO's rows); the block's own rows either
//     stream beside each row step (past 256: a Q, or R1/R2, chunk [8 RM x
//     DK]) or stay resident in shared memory for the whole loop (up to
//     256: Q for K1, Q and dO for K2, K and V for K3, loaded once by the
//     block, so the ring carries only the streamed tiles); K2 at D <= 64
//     reads its slice step's K rows from the S step's chunk (the same
//     [64 x DK] rows), two steps a tile on four stages; 16-byte copies at
//     D % 4 == 0, 4-byte ones otherwise (VEC), so every D is taken;
//   - S is summed over the head dim in the same order in every slice
//     block, so m, l and p are bit-identical across slices; slice 0
//     writes lse.
// Up to 256 the shape follows D (one_slice_shape below): 64 rows a block
// (RM 8) where the outputs' registers leave room (K1 up to 128 columns,
// K2's dq beside S, dP and its rows' lse and delta up to 128, K3's dK and
// dV up to 64), else 32; DK = CW = D rounded up to 16, 32 or 64 under 64
// (the JAX package's fp32 configs run at d 16: a 64-column step would do
// 4x their S and P V work on zero columns); VK so that a slice step's
// stage is about a K chunk's (64 keys up to 64 columns, 32 at 128, 16
// past). Trials on the H100 (compare_kernels, PERF.md): K1 at
// 128 columns ran 1.19x slower at 4 x 4 rows a thread, and 8 x 8
// (128-key tiles, DK 32) gained nothing (1.00x) and left a key group idle
// at S 128; K3 at 128 columns ran the same at 8 x 4 (DK 32, 255
// registers) and 4 % slower at 4 x 8; two blocks an SM (128 registers)
// ran K1 at 128 columns 1.14x slower, and at 16 columns 7 % faster but
// spilled 8 bytes; K2 at 128 columns ran 1.18x faster at 8 x 4 than at
// 4 x 4, and at 16 columns its ds K from the S step's chunk 1.07x faster
// than from a slice step's copy.
// ptxas (sm_90a, on the H100 host; tools/check_head_dims.py), no spills
// in any instantiation but K3's past 256 at 5 column groups: up to 256 K1
// 168 registers at 16..64 columns, 230 at 128, 196-198 past; K2 200 at 16
// columns, 210-212 at 32, 254 at 64 and 128, 222 at 192, 228 at 256; K3
// 168 at 16 columns, 214-216 at 32, 254 at 64, 210-214 at 128, 252-254
// past; past 256 K1 196-230 registers, K2 226-254; K3 254 at 3 and 4 column
// groups, 255 and 28-32 bytes spilled at 5 (K3 at slices of 256 ran
// slower at D 320 than at 320 with the spill).

#pragma once

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

constexpr int RF_N = 64;          // rows of a streamed tile (K1: keys)
constexpr int RF_GROUP = 128;     // threads of a key group: 8 x 16 (ty, tx)
constexpr int RF_NG = 2;          // key groups a block
constexpr int RF_THREADS = RF_GROUP * RF_NG;
constexpr int RF_ST = 3;          // ring stages
constexpr int RF_MAX_SLICE = 320;     // output columns a block owns at most
constexpr int RF_MAX_SMEM = 232448;   // bytes a block may have on sm_90

// A ring kernel's block shape: RM rows a thread (8 RM a block), the row
// products in steps of DK head-dim columns, NCG groups of CW output
// columns (CW / 16 a thread), VK streamed-tile rows a slice step, RES: the
// block's own rows resident in shared memory (one slice, D <= 256) or
// streamed beside each row step (slices, past 256). Sizes in floats.
template <int RM, int DK, int CW, int NCG, int VK, bool RES>
struct RingShape {
  static_assert(RM % 4 == 0 && DK % 4 == 0 && CW % 16 == 0 &&
                    RF_N % VK == 0,
                "whole float4s of rows and columns, whole slice steps");
  static constexpr int rm = RM, dk = DK, cw = CW, ncg = NCG, vk = VK;
  static constexpr bool res = RES;
  static constexpr int BM = 8 * RM;       // rows a block
  static constexpr int CPT = CW / 16;     // output columns a thread a group
  static constexpr int SW = NCG * CW;     // output columns a block
  static constexpr int QK_LD = DK + PAD;  // shared row of a row-step chunk
  static constexpr int P_LD = BM + PAD;   // shared row of p^T / ds^T
  static constexpr int V_LD = SW + PAD;   // ... of a slice step, resident rows
  static constexpr int R_FL = RES ? 0 : BM * QK_LD;  // own rows in a stage
  static constexpr int T_FL = RF_N * QK_LD;          // a tile chunk
  static constexpr int V_FL = VK * V_LD;             // a slice step
  static constexpr int STAGE = R_FL + T_FL > V_FL ? R_FL + T_FL : V_FL;
  static constexpr int P_OFF = RF_ST * STAGE;        // p^T after the ring
  static constexpr int RES_FL = RES ? BM * V_LD : 0;  // one resident tile
  // a key group's ring and p^T (and ds^T: ``tiles`` 2 for K3) on
  // ``stages`` stages
  __host__ __device__ static constexpr int group_fl(int tiles,
                                                    int stages = RF_ST) {
    return stages * STAGE + tiles * RF_N * P_LD;
  }
  // The ring stages of K2 (``dkdv`` false) or K3. With the rows resident,
  // one row step and one slice step a tile (D <= 64), a tile chunk's
  // [64][DK + PAD] rows are a slice step's too: K2 reads its ds K step's
  // rows from the S step's stage, so a tile is two steps, on a fourth
  // stage (the copies of step i + 2 go to step i - 2's, whose chunk step
  // i - 1 read last)
  __host__ __device__ static constexpr int bwd_stages(bool dkdv) {
    return !dkdv && RES && DK == SW && VK == RF_N ? RF_ST + 1 : RF_ST;
  }
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
// floats, as cp.async copies the caller commits, issued by NT threads
// (``t``: this one among them); rows past S and columns past D are zeros.
// VEC (D % 4 == 0): 16 bytes a copy, else 4.
template <int ROWS, int COLS, int SLD, bool VEC, int NT = RF_GROUP>
__device__ __forceinline__ void ring_load(float* dst, const float* src,
                                          long row_stride, int r0, int S,
                                          int c0, int D, int t) {
  constexpr int CH = COLS / 4;
  static_assert(ROWS * CH % NT == 0, "whole rounds of copies");
#pragma unroll
  for (int n = 0; n < ROWS * CH / NT; ++n) {
    const int i = t + n * NT;
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

// N consecutive floats (N = 1, 2 or 4, aligned to N) into registers
template <int N>
__device__ __forceinline__ void ld_cols(float (&x)[N], const float* p) {
  static_assert(N == 1 || N == 2 || N == 4, "a float, float2 or float4");
  if constexpr (N == 4) {
    const float4 v = ld4(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

// columns col..col + N - 1 of an output row, those under D: one vector
// store when VEC (D % 4 == 0: the row starts 16-byte aligned, col is a
// multiple of N and col < D puts the whole vector under D), else one
// element at a time
template <int N, bool VEC>
__device__ __forceinline__ void st_cols(float* row, int col, int D,
                                        const float (&x)[N]) {
  if constexpr (VEC && N == 4) {
    if (col < D)
      *reinterpret_cast<float4*>(row + col) =
          make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC && N == 2) {
    if (col < D) *reinterpret_cast<float2*>(row + col) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (col + e < D) row[col + e] = x[e];
  }
}

// acc += R T^T over one row step's DK columns: this thread's RM rows of R
// (shared rows of RLD floats) against tile rows tx + 16 jj of T (rows of
// TLD), ``R`` and ``T`` at the thread's first row and the step's first
// column: a float4 of each of RM rows and of 4 tile rows feed 16 RM FMAs
template <int RM, int DK, int RLD, int TLD>
__device__ __forceinline__ void row_product(float (&acc)[RM][4],
                                            const float* R, const float* T) {
#pragma unroll 8
  for (int c = 0; c < DK; c += 4) {
    float4 a[RM], kv[4];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = ld4(R + r * RLD + c);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) kv[jj] = ld4(T + 16 * jj * TLD + c);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc[r][jj] = fmaf(a[r].x, kv[jj].x, acc[r][jj]);
        acc[r][jj] = fmaf(a[r].y, kv[jj].y, acc[r][jj]);
        acc[r][jj] = fmaf(a[r].z, kv[jj].z, acc[r][jj]);
        acc[r][jj] = fmaf(a[r].w, kv[jj].w, acc[r][jj]);
      }
    }
  }
}

// acc += A X over a slice step's VK tile rows: A's [tile row][row] rows
// (p^T or ds^T, at this thread's first row), X the step's rows of V_LD
// floats (at this thread's first column); column groups from ``live`` on
// (past D) skipped
template <int RM, int CW, int NCG, int VK, int P_LD, int V_LD, bool ALL>
__device__ __forceinline__ void slice_product(
    float (&acc)[RM][NCG][CW / 16], const float* A, const float* X,
    int live) {
  constexpr int CPT = CW / 16;
#pragma unroll 4
  for (int kk = 0; kk < VK; ++kk) {
    float pr[RM];
#pragma unroll
    for (int r = 0; r < RM; r += 4) {
      const float4 p = ld4(A + kk * P_LD + r);
      pr[r] = p.x;
      pr[r + 1] = p.y;
      pr[r + 2] = p.z;
      pr[r + 3] = p.w;
    }
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      if (!ALL && CW * c >= live) break;  // column groups wholly past D
      float x[CPT];
      ld_cols<CPT>(x, X + kk * V_LD + CW * c);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
#pragma unroll
        for (int e = 0; e < CPT; ++e)
          acc[r][c][e] = fmaf(pr[r], x[e], acc[r][c][e]);
      }
    }
  }
}

// RM x 4 values of this thread, [row][tile row], into a [tile row][row]
// tile (rows of P_LD floats) at tile rows tx + 16 jj and rows RM ty..
template <int RM, int P_LD>
__device__ __forceinline__ void store_transposed(float* dst,
                                                 const float (&x)[RM][4],
                                                 int ty, int tx) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int r = 0; r < RM; r += 4)
      *reinterpret_cast<float4*>(dst + (tx + 16 * jj) * P_LD + RM * ty + r) =
          make_float4(x[r][jj], x[r + 1][jj], x[r + 2][jj], x[r + 3][jj]);
  }
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// Two key groups of 128 threads: group g takes the key tiles j with j % 2
// == g, each with its own ring, p^T and online softmax; group 1 hands its
// m, l and O to group 0 through shared memory at the end, and group 0
// merges them and writes the block's rows. Shared memory: RES: Q [8 RM
// rows][V_LD]; then each group's ring stages and p^T [64 keys][P_LD].
template <int RM, int DK, int CW, int NCG, int VK, bool RES, bool VEC>
__global__ void __launch_bounds__(RF_THREADS, 1)
fwd_ring_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int H, int Sq, int Sk, int D,
                    int causal, float scale) {
  using S = RingShape<RM, DK, CW, NCG, VK, RES>;
  constexpr int CPT = S::CPT;
  constexpr int GROUP_FL = S::group_fl(1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qres = reinterpret_cast<float*>(smem_raw);
  const int grp = threadIdx.x / RF_GROUP;
  const int gt = threadIdx.x % RF_GROUP;
  float* ring = Qres + S::RES_FL + grp * GROUP_FL;
  float* Pt = ring + S::P_OFF;

  const int ty = gt >> 4;  // rows RM ty..RM ty + RM - 1
  const int tx = gt & 15;  // keys tx + 16jj; columns CW c + CPT tx..
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * S::BM;  // longest first
  const int c0 = blockIdx.z * S::SW;
  const long row_stride = (long)H * D;
  const float* qb = q + ((long)b * Sq * H + h) * D;
  const float* kb = k + ((long)b * Sk * H + h) * D;
  const float* vb = v + ((long)b * Sk * H + h) * D;

  const int q_last = min(q0 + S::BM, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + RF_N - 1) / RF_N;
  const int my_tiles =
      n_tiles > grp ? (n_tiles - grp + RF_NG - 1) / RF_NG : 0;
  const int n_sq = (D + DK - 1) / DK;  // S steps a tile
  const int spt = n_sq + RF_N / VK;    // steps a tile
  const int n_steps = my_tiles * spt;
  const int live = D - c0;  // this slice's columns before D's end

  float s[RM][4], o[RM][NCG][CPT], m[RM], l[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) o[r][c][e] = 0.f;
    }
  }

  // step i's copies into stage i % RF_ST (one commit group each, empty
  // past the last step, so that the waits count alike)
  auto load_step = [&](int i) {
    if (i < n_steps) {
      const int j = grp + RF_NG * (i / spt), u = i % spt;
      float* st = ring + (i % RF_ST) * S::STAGE;
      if (u < n_sq) {
        if constexpr (!RES)
          ring_load<S::BM, DK, S::QK_LD, VEC>(st, qb, row_stride, q0, Sq,
                                              u * DK, D, gt);
        ring_load<RF_N, DK, S::QK_LD, VEC>(st + S::R_FL, kb, row_stride,
                                           j * RF_N, Sk, u * DK, D, gt);
      } else {
        ring_load<VK, S::SW, S::V_LD, VEC>(
            st, vb, row_stride, j * RF_N + (u - n_sq) * VK, Sk, c0, D, gt);
      }
    }
    cp_async_commit();
  };

  // the online softmax of tile j's S (a row on the 16 lanes of one tx
  // range): p^T into shared memory, O rescaled
  auto softmax = [&](int j) {
    const int k0 = j * RF_N;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = q0 + RM * ty + r;
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
        for (int e = 0; e < CPT; ++e) o[r][c][e] *= alpha;
      }
    }
    store_transposed<RM, S::P_LD>(Pt, s, ty, tx);
  };

  if constexpr (RES) {
    // Q once, by the whole block, ahead of the ring's first steps
    ring_load<S::BM, S::SW, S::V_LD, VEC, RF_THREADS>(
        Qres, qb, row_stride, q0, Sq, 0, D, threadIdx.x);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < RF_ST - 1; ++i) load_step(i);
  if constexpr (RES) {
    // this thread's Q copies have landed, then everyone's
    cp_async_wait<RF_ST - 1>();
    __syncthreads();
  }
  for (int i = 0; i < n_steps; ++i) {
    // step i's stage has landed, and every thread of the group is done
    // with step i - 1's, which the copies issued next refill
    cp_async_wait<RF_ST - 2>();
    group_sync(1 + grp);
    load_step(i + RF_ST - 1);
    const float* st = ring + (i % RF_ST) * S::STAGE;
    const int u = i % spt;
    if (u < n_sq) {
      // S += Q_u K_u^T over this step's columns
      if (u == 0) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
      }
      const float* Kt = st + S::R_FL + tx * S::QK_LD;
      if constexpr (RES)
        row_product<RM, DK, S::V_LD, S::QK_LD>(
            s, Qres + RM * ty * S::V_LD + u * DK, Kt);
      else
        row_product<RM, DK, S::QK_LD, S::QK_LD>(
            s, st + RM * ty * S::QK_LD, Kt);
      if (u == n_sq - 1) softmax(grp + RF_NG * (i / spt));
    } else {
      // O += P V over this step's VK keys; p^T rows of this thread's q
      // rows were written by its own warp
      slice_product<RM, CW, NCG, VK, S::P_LD, S::V_LD, RES>(
          o, Pt + (u - n_sq) * VK * S::P_LD + RM * ty, st + CPT * tx, live);
    }
  }
  cp_async_wait<0>();

  // group 1's m, l and O, thread by thread, in its ring; group 0 merges
  // them (the two sets of keys, each with its own running max)
  constexpr int HANDOFF = 2 * RM + RM * NCG * CPT;  // floats a thread
  static_assert(HANDOFF * RF_GROUP <= S::P_OFF, "the hand-off fits a ring");
  float* hand = Qres + S::RES_FL + GROUP_FL;
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      hand[(2 * r) * RF_GROUP + gt] = m[r];
      hand[(2 * r + 1) * RF_GROUP + gt] = l[r];
#pragma unroll
      for (int c = 0; c < NCG; ++c) {
#pragma unroll
        for (int e = 0; e < CPT; ++e)
          hand[(2 * RM + (r * NCG + c) * CPT + e) * RF_GROUP + gt] =
              o[r][c][e];
      }
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float m1 = hand[(2 * r) * RF_GROUP + gt];
    const float l1 = hand[(2 * r + 1) * RF_GROUP + gt];
    const float m_new = fmaxf(m[r], m1);
    const float a0 = expf(m[r] - m_new), a1 = expf(m1 - m_new);
    l[r] = a0 * l[r] + a1 * l1;
    m[r] = m_new;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        o[r][c][e] =
            a0 * o[r][c][e] +
            a1 * hand[(2 * RM + (r * NCG + c) * CPT + e) * RF_GROUP + gt];
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = q0 + RM * ty + r;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / l_safe;
    float* orow = out + (((long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      float x[CPT];
#pragma unroll
      for (int e = 0; e < CPT; ++e) x[e] = o[r][c][e] * inv;
      st_cols<CPT, VEC>(orow, c0 + CW * c + CPT * tx, D, x);
    }
    if (tx == 0 && blockIdx.z == 0)
      lse[((long)b * H + h) * Sq + row] = m[r] + logf(l_safe);
  }
}

// K1 at block shape S (a RingShape) and copy size VEC
template <class S, bool VEC>
cudaError_t launch_fwd_ring(const float* q, const float* k, const float* v,
                            float* out, float* lse, int B, int H, int Sq,
                            int Sk, int D, int causal, float scale,
                            cudaStream_t stream) {
  constexpr int smem =
      (S::RES_FL + RF_NG * S::group_fl(1)) * (int)sizeof(float);
  static_assert(smem <= RF_MAX_SMEM, "a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      fwd_ring_f32_kernel<S::rm, S::dk, S::cw, S::ncg, S::vk, S::res, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + S::BM - 1) / S::BM, B * H, (D + S::SW - 1) / S::SW);
  fwd_ring_f32_kernel<S::rm, S::dk, S::cw, S::ncg, S::vk, S::res, VEC>
      <<<grid, RF_THREADS, smem, stream>>>(q, k, v, out, lse, H, Sq, Sk, D,
                                           causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 and K3
// ---------------------------------------------------------------------------

// One template serves both (DKDV), as the two are the same computation
// with the roles of the queries and the keys exchanged. DKDV false (K2):
// rows are queries, R1 = q, R2 = dout, the tiles keys, T1 = k, T2 = v,
// out1 = dq. DKDV true (K3): rows are keys, R1 = k, R2 = v, the tiles
// queries, T1 = q, T2 = dout, out1 = dk, out2 = dv. Per tile, X = R1 T1^T
// (S; K3: S^T) then Y = R2 T2^T (dP; K3: dP^T) over the head dim, then p
// and ds in fp32 into shared memory as [tile row][row] (ds^T, and p^T for
// K3), then out1 += ds T1 (K2: dq += ds K; K3: dk += ds^T Q) and for K3
// out2 += p T2 (dv += p^T dO) over VK-row slice steps. Shared memory:
// RES: R1's and R2's rows [8 RM][V_LD]; then each group's ring stages,
// ds^T and (K3) p^T [64][P_LD].
template <int RM, int DK, int CW, int NCG, int VK, bool RES, bool VEC,
          bool DKDV>
__global__ void __launch_bounds__(RF_THREADS, 1)
bwd_ring_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ out1, float* __restrict__ out2, int H,
                    int Sq, int Sk, int D, int causal, float scale) {
  using S = RingShape<RM, DK, CW, NCG, VK, RES>;
  constexpr int CPT = S::CPT;
  constexpr int TILES = DKDV ? 2 : 1;  // ds^T, p^T
  constexpr int NST = S::bwd_stages(DKDV);  // ring stages
  constexpr bool SHARE = NST > RF_ST;  // K2's ds K reads S's K chunk
  constexpr int GROUP_FL = S::group_fl(TILES, NST);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const int grp = threadIdx.x / RF_GROUP;
  const int gt = threadIdx.x % RF_GROUP;
  float* R1s = base;  // RES: the block's rows of R1, then of R2
  float* R2s = base + S::RES_FL;
  float* ring = base + 2 * S::RES_FL + grp * GROUP_FL;
  float* DSt = ring + NST * S::STAGE;  // ds^T of the current tile
  float* Pt = DSt + RF_N * S::P_LD;    // p^T (K3)

  const int ty = gt >> 4;  // rows RM ty..RM ty + RM - 1
  const int tx = gt & 15;  // tile rows tx + 16jj; columns CW c + CPT tx..
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  // K2: longest causal q tiles first; K3: the first key tiles have most
  const int r0 = (DKDV ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * S::BM;
  const int c0 = blockIdx.z * S::SW;
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
    const int q_last = min(r0 + S::BM, Sq) - 1;
    const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
    t_first = 0;
    n_tiles = (kv_len + RF_N - 1) / RF_N;
  }
  const int my_tiles =
      n_tiles > grp ? (n_tiles - grp + RF_NG - 1) / RF_NG : 0;
  const int n_sq = (D + DK - 1) / DK;  // X (then Y) steps a tile
  constexpr int N_SLICE = SHARE ? 0 : TILES * (RF_N / VK);  // slice steps
  const int spt = 2 * n_sq + N_SLICE;            // steps a tile
  const int n_steps = my_tiles * spt;
  const int live = D - c0;  // this slice's columns before D's end

  // K2: the lse and delta of this thread's rows
  float lse_r[RM], delta_r[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = r0 + RM * ty + r;
    const bool ok = !DKDV && row < Sq;
    lse_r[r] = ok ? lse[(long)bh * Sq + row] : 0.f;
    delta_r[r] = ok ? delta[(long)bh * Sq + row] : 0.f;
  }
  float x[RM][4], y[RM][4], o1[RM][NCG][CPT], o2[DKDV ? RM : 1][NCG][CPT];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        o1[r][c][e] = 0.f;
        if constexpr (DKDV) o2[r][c][e] = 0.f;
      }
    }
  }

  // step i's copies into stage i % NST (one commit group each, empty
  // past the last step, so that the waits count alike)
  auto load_step = [&](int i) {
    if (i < n_steps) {
      const int t0 = (t_first + grp + RF_NG * (i / spt)) * RF_N;
      const int u = i % spt;
      float* st = ring + (i % NST) * S::STAGE;
      if (u < 2 * n_sq) {
        const bool second = u >= n_sq;
        const int col = (second ? u - n_sq : u) * DK;
        if constexpr (!RES)
          ring_load<S::BM, DK, S::QK_LD, VEC>(st, second ? r2 : r1,
                                              row_stride, r0, Sr, col, D,
                                              gt);
        ring_load<RF_N, DK, S::QK_LD, VEC>(st + S::R_FL, second ? t2 : t1,
                                           row_stride, t0, St, col, D, gt);
      } else {
        const int w = u - 2 * n_sq;  // K3: T1's steps, then T2's
        ring_load<VK, S::SW, S::V_LD, VEC>(
            st, w < RF_N / VK ? t1 : t2, row_stride,
            t0 + (w % (RF_N / VK)) * VK, St, c0, D, gt);
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
    for (int r = 0; r < RM; ++r) {
      const int row = r0 + RM * ty + r;
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
    store_transposed<RM, S::P_LD>(DSt, y, ty, tx);
    if constexpr (DKDV) store_transposed<RM, S::P_LD>(Pt, x, ty, tx);
  };

  // acc (+)= the step's R rows of this thread T^T over its DK columns
  // (``us``: the step among X's or Y's; ``res``: R's resident rows)
  auto row_step = [&](float (&acc)[RM][4], const float* st, int us,
                      const float* res) {
    if (us == 0) {
#pragma unroll
      for (int r = 0; r < RM; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    }
    const float* Ts = st + S::R_FL + tx * S::QK_LD;
    if constexpr (RES)
      row_product<RM, DK, S::V_LD, S::QK_LD>(
          acc, res + RM * ty * S::V_LD + us * DK, Ts);
    else
      row_product<RM, DK, S::QK_LD, S::QK_LD>(acc, st + RM * ty * S::QK_LD,
                                              Ts);
  };

  if constexpr (RES) {
    // the block's rows of R1 and R2 once, by the whole block, ahead of
    // the ring's first steps
    ring_load<S::BM, S::SW, S::V_LD, VEC, RF_THREADS>(
        R1s, r1, row_stride, r0, Sr, 0, D, threadIdx.x);
    ring_load<S::BM, S::SW, S::V_LD, VEC, RF_THREADS>(
        R2s, r2, row_stride, r0, Sr, 0, D, threadIdx.x);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < RF_ST - 1; ++i) load_step(i);
  if constexpr (RES) {
    // this thread's copies of the rows have landed, then everyone's
    cp_async_wait<RF_ST - 1>();
    __syncthreads();
  }
  for (int i = 0; i < n_steps; ++i) {
    // step i's stage has landed, and every thread of the group is done
    // with step i - 1's, which the copies issued next refill
    cp_async_wait<RF_ST - 2>();
    group_sync(1 + grp);
    load_step(i + RF_ST - 1);
    const float* st = ring + (i % NST) * S::STAGE;
    const int u = i % spt;
    if (u < 2 * n_sq) {
      // X (then Y) += R_u T_u^T over this step's DK columns (a call each,
      // so that both stay in registers)
      if (u < n_sq)
        row_step(x, st, u, R1s);
      else
        row_step(y, st, u - n_sq, R2s);
      if (u == 2 * n_sq - 1) {
        p_ds((t_first + grp + RF_NG * (i / spt)) * RF_N);
        if constexpr (SHARE) {
          // dq += ds K from step i - 1's K chunk; the ds^T rows of this
          // thread's q rows were written by its own warp
          __syncwarp();
          slice_product<RM, CW, NCG, VK, S::P_LD, S::V_LD, RES>(
              o1, DSt + RM * ty,
              ring + ((i - 1) % NST) * S::STAGE + S::R_FL + CPT * tx, live);
        }
      }
    } else {
      // out1 += ds T1_slice (K3 then out2 += p T2_slice) over this
      // step's VK tile rows
      const int w = u - 2 * n_sq;
      const int at = (w % (RF_N / VK)) * VK * S::P_LD + RM * ty;
      const float* Xs = st + CPT * tx;
      if (DKDV && w >= RF_N / VK) {
        if constexpr (DKDV)
          slice_product<RM, CW, NCG, VK, S::P_LD, S::V_LD, RES>(
              o2, Pt + at, Xs, live);
      } else {
        slice_product<RM, CW, NCG, VK, S::P_LD, S::V_LD, RES>(
            o1, DSt + at, Xs, live);
      }
    }
  }
  cp_async_wait<0>();

  // group 1's sums, thread by thread, in the block's shared memory;
  // group 0 adds them
  constexpr int PER = RM * NCG * CPT;     // floats of one output a thread
  static_assert(TILES * PER * RF_GROUP <= 2 * S::RES_FL + RF_NG * GROUP_FL,
                "the hand-off fits the block's shared memory");
  float* hand = base;
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int c = 0; c < NCG; ++c) {
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          const int n = (r * NCG + c) * CPT + e;
          hand[n * RF_GROUP + gt] = o1[r][c][e];
          if constexpr (DKDV) hand[(PER + n) * RF_GROUP + gt] = o2[r][c][e];
        }
      }
    }
  }
  __syncthreads();
  if (grp == 1) return;

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = r0 + RM * ty + r;
    if (row >= Sr) continue;
    const long at = (DKDV ? k_off : q_off) + (long)row * row_stride;
#pragma unroll
    for (int c = 0; c < NCG; ++c) {
      const int col = c0 + CW * c + CPT * tx;
      float s1[CPT], s2[CPT];
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        const int n = (r * NCG + c) * CPT + e;
        s1[e] = o1[r][c][e] + hand[n * RF_GROUP + gt];
        if constexpr (DKDV)
          s2[e] = o2[r][c][e] + hand[(PER + n) * RF_GROUP + gt];
      }
      st_cols<CPT, VEC>(out1 + at, col, D, s1);
      if constexpr (DKDV) st_cols<CPT, VEC>(out2 + at, col, D, s2);
    }
  }
}

// K2 or K3 (DKDV) at block shape S (a RingShape) and copy size VEC
template <class S, bool VEC, bool DKDV>
cudaError_t launch_bwd_ring(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* out1, float* out2,
                            int B, int H, int Sq, int Sk, int D, int causal,
                            float scale, cudaStream_t stream) {
  constexpr int smem = (2 * S::RES_FL +
                        RF_NG * S::group_fl(DKDV ? 2 : 1,
                                            S::bwd_stages(DKDV))) *
                       (int)sizeof(float);
  static_assert(smem <= RF_MAX_SMEM, "a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      bwd_ring_f32_kernel<S::rm, S::dk, S::cw, S::ncg, S::vk, S::res, VEC,
                          DKDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = DKDV ? Sk : Sq;
  const dim3 grid((rows + S::BM - 1) / S::BM, B * H,
                  (D + S::SW - 1) / S::SW);
  bwd_ring_f32_kernel<S::rm, S::dk, S::cw, S::ncg, S::vk, S::res, VEC, DKDV>
      <<<grid, RF_THREADS, smem, stream>>>(q, k, v, dout, lse, delta, out1,
                                           out2, H, Sq, Sk, D, causal,
                                           scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The shapes each head dim takes
// ---------------------------------------------------------------------------

// launch(std::integral_constant<bool, VEC>{}) with VEC = (D % 4 == 0):
// 16-byte copies where a row's width is a multiple of 16 bytes
template <class F>
cudaError_t with_copy_size(int D, F&& launch) {
  if (D % 4 == 0) return launch(std::true_type{});
  return launch(std::false_type{});
}

// Past 256 (K1, K2 and K3): ns = ceil(D / 320) slices of ceil(D / ns)
// columns rounded up to 64 (192, 256 or 320: NCG 3, 4 or 5), 32 rows a
// block, the rows streamed beside each row step
template <class F>
cudaError_t dchunk_shape(int D, F&& launch) {
  const int ns = (D + RF_MAX_SLICE - 1) / RF_MAX_SLICE;
  const int ncg = ((D + ns - 1) / ns + 63) / 64;
  switch (ncg) {
    case 3: return launch(RingShape<4, 64, 64, 3, 16, false>{});
    case 4: return launch(RingShape<4, 64, 64, 4, 16, false>{});
    default: return launch(RingShape<4, 64, 64, 5, 16, false>{});
  }
}

// Up to 256 (K1, K2 and K3): one slice, the rows resident; DK = CW = D
// rounded up to 16, 32 or 64 under 64 (NCG 1), 64 from there (NCG 2, 3
// or 4); 64 rows a block (RM 8) up to WIDE_RM columns, else 32; VK 64
// keys up to 64 columns, 32 at 128, 16 past
template <int WIDE_RM, class F>
cudaError_t one_slice_shape(int D, F&& launch) {
  constexpr int RM128 = WIDE_RM >= 128 ? 8 : 4;  // rows a thread at 128
  if (D <= 16) return launch(RingShape<8, 16, 16, 1, 64, true>{});
  if (D <= 32) return launch(RingShape<8, 32, 32, 1, 64, true>{});
  if (D <= 64) return launch(RingShape<8, 64, 64, 1, 64, true>{});
  if (D <= 128) return launch(RingShape<RM128, 64, 64, 2, 32, true>{});
  if (D <= 192) return launch(RingShape<4, 64, 64, 3, 16, true>{});
  return launch(RingShape<4, 64, 64, 4, 16, true>{});
}

// K1 at block shape S and the row's copy size
template <class S>
cudaError_t fwd_ring_at(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int H, int Sq, int Sk,
                        int D, int causal, float scale, cudaStream_t stream) {
  return with_copy_size(D, [&](auto vec) {
    return launch_fwd_ring<S, decltype(vec)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, B, H, Sq,
        Sk, D, causal, scale, stream);
  });
}

// K2 (DKDV false: out1 = dq) or K3 (true: out1 = dk, out2 = dv) at block
// shape S and the row's copy size
template <class S, bool DKDV>
cudaError_t bwd_ring_at(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* out1, void* out2, int B,
                        int H, int Sq, int Sk, int D, int causal, float scale,
                        cudaStream_t stream) {
  return with_copy_size(D, [&](auto vec) {
    return launch_bwd_ring<S, decltype(vec)::value, DKDV>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(out1), static_cast<float*>(out2), B, H,
        Sq, Sk, D, causal, scale, stream);
  });
}

}  // namespace
