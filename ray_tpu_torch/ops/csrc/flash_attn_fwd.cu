// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_flash_kernel
// (launched by _pallas_fwd): online softmax over K/V tiles with a running
// max and denominator, fp32 accumulation, P rounded to V's dtype before
// P.V (bf16 for the served type), causal skipping of tiles above the
// diagonal, and the outputs out [B,Sq,H,D] (q's dtype) and
// lse = m + log(l) [B,H,Sq] fp32.
//
// What bounds it on an H100: at the served shape (b1: B2 S2048 H16 D128,
// causal) the work is ~34 GFLOP against ~34 MB of HBM traffic, ~1000
// FLOP/byte, far above the card's ~295 FLOP/byte ridge: attention is
// bound by arithmetic, so the bf16 path must run on the tensor cores.
// Two kernels, one per input dtype:
//   - bf16 (the served type): mma.sync.m16n8k16 tensor-core tiles, bf16
//     operands, fp32 accumulators. One block per (batch*head, 64-row q
//     tile), 4 warps of 16 rows; each warp holds its Q fragments in
//     registers for the whole K/V loop (the TPU grid's sequential k axis
//     becomes a loop inside the block). K/V tiles of 64 keys are double
//     buffered in shared memory: cp.async brings tile t+1 while tile t
//     is computed. Rows are padded by 16 bytes so the ldmatrix fragment
//     loads (transposing for V) are bank-conflict free, and P never
//     leaves registers between S = Q K^T and O += P V. wgmma, TMA and
//     warp specialisation (the way to the bound) are later work.
//   - fp32: exact fp32 FMAs on the CUDA cores (the tensor cores would
//     round fp32 to tf32). 8 warps of 8 rows; each lane owns two keys of
//     a 64-key tile for S and D/32 output columns for P.V; Q reads are
//     warp broadcasts, so each K element loaded feeds 8 rows of FMAs.
// Both skip every tile above the causal diagonal by making it the loop
// bound (the TPU kernel's index-map clamp has no counterpart), schedule
// the longest q tiles first, and mask ragged lengths themselves
// (k_pos < Sk; rows past Sq load as zeros and are never written), so no
// block-size divisibility is required.
//
// Plain C interface, loaded with ctypes (no PyTorch headers): the caller
// allocates out/lse, passes the current stream, and raises on a non-zero
// return (cudaGetLastError right after the launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// fp32 path: FMAs on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int BLOCK_M = 64;  // query rows per block
constexpr int BLOCK_N = 64;  // keys per K/V tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BLOCK_M / NWARPS;
constexpr int PAD = 4;
constexpr float NEG_INF = -1e30f;  // the JAX package's _NEG_INF

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     int causal, float scale) {
  using T = float;
  using V4 = float4;
  constexpr int LD = D + PAD;  // padded row length in shared memory
  constexpr int CH = D / 4;    // vector chunks per row
  constexpr int DPL = D / 32;  // output dims per lane

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BLOCK_M * LD;
  T* Vs = Ks + BLOCK_N * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BLOCK_N * LD);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  // longest causal tiles first: the last q tile has the most K tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;
  const long row_stride = (long)H * D;  // [B,S,H,D]: one step in s
  const T* qb = q + ((long)b * Sq * H + h) * D;
  const T* kb = k + ((long)b * Sk * H + h) * D;
  const T* vb = v + ((long)b * Sk * H + h) * D;
  const V4 zero = {};

  for (int i = tid; i < BLOCK_M * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    V4 x = zero;
    if (q0 + r < Sq)
      x = *reinterpret_cast<const V4*>(qb + (q0 + r) * row_stride + c);
    *reinterpret_cast<V4*>(Qs + r * LD + c) = x;
  }

  const int r0 = warp * ROWS_PER_WARP;
  float* Pw = Ps + r0 * BLOCK_N;  // this warp's P slab
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // causal: keys past this tile's last row are never needed
  const int q_last = min(q0 + BLOCK_M, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + BLOCK_N - 1) / BLOCK_N;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BLOCK_N * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      V4 kx = zero, vx = zero;
      if (k0 + r < Sk) {
        kx = *reinterpret_cast<const V4*>(kb + (k0 + r) * row_stride + c);
        vx = *reinterpret_cast<const V4*>(vb + (k0 + r) * row_stride + c);
      }
      *reinterpret_cast<V4*>(Ks + r * LD + c) = kx;
      *reinterpret_cast<V4*>(Vs + r * LD + c) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's rows; lane owns keys lane and lane+32
    float s[ROWS_PER_WARP][2];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) s[r][0] = s[r][1] = 0.f;
    const T* k_lo = Ks + lane * LD;
    const T* k_hi = Ks + (lane + 32) * LD;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 a = ld4(k_lo + c);
      const float4 e = ld4(k_hi + c);
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const float4 x = ld4(Qs + (r0 + r) * LD + c);
        s[r][0] = fmaf(x.x, a.x, s[r][0]);
        s[r][0] = fmaf(x.y, a.y, s[r][0]);
        s[r][0] = fmaf(x.z, a.z, s[r][0]);
        s[r][0] = fmaf(x.w, a.w, s[r][0]);
        s[r][1] = fmaf(x.x, e.x, s[r][1]);
        s[r][1] = fmaf(x.y, e.y, s[r][1]);
        s[r][1] = fmaf(x.z, e.z, s[r][1]);
        s[r][1] = fmaf(x.w, e.w, s[r][1]);
      }
    }

    // online softmax, one row at a time across the warp
    const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int qp = q0 + r0 + r;
      const bool ok0 = kp0 < Sk && (!causal || qp >= kp0);
      const bool ok1 = kp1 < Sk && (!causal || qp >= kp1);
      const float x0 = ok0 ? s[r][0] * scale : NEG_INF;
      const float x1 = ok1 ? s[r][1] * scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      Pw[r * BLOCK_N + lane] = p0;
      Pw[r * BLOCK_N + lane + 32] = p1;
    }
    __syncwarp();

    // O += P V; lane owns output dims [lane*DPL, lane*DPL + DPL)
#pragma unroll 2
    for (int j = 0; j < BLOCK_N; j += 4) {
      float4 p[ROWS_PER_WARP];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
        p[r] = *reinterpret_cast<const float4*>(Pw + r * BLOCK_N + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* vrow = Vs + (j + jj) * LD + lane * DPL;
        float vv[DPL];
        if constexpr (DPL == 4) {
          const float4 x = ld4(vrow);
          vv[0] = x.x;
          vv[1] = x.y;
          vv[2] = x.z;
          vv[3] = x.w;
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) vv[i] = vrow[i];
        }
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const float pj = jj == 0 ? p[r].x
                         : jj == 1 ? p[r].y
                         : jj == 2 ? p[r].z
                                   : p[r].w;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Sq) continue;
    const float l_safe = fmaxf(l[r], 1e-20f);
    T* o = out + (((long)b * Sq + qp) * H + h) * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = acc[r][i] / l_safe;
    if (lane == 0) lse[((long)b * H + h) * Sq + qp] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// bf16 path: tensor cores through mma.sync.m16n8k16 (bf16 in, fp32 acc).
// 4 warps, 16 query rows each; S = Q K^T and O += P V both run as mma
// tiles, with P handed from the S accumulators to the P.V A operand in
// registers (the accumulator layout of two 8-key n-tiles is the A layout
// of one 16-key k-tile), rounded to bf16 on the way as the TPU kernel
// casts p to v.dtype.
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_BM = MMA_WARPS * 16;  // query rows per block
constexpr int MMA_BN = 64;              // keys per K/V tile
constexpr int MMA_PAD = 8;              // bf16 elements of row padding

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> packed bf16x2, the first in the low half (lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 bf16 matrices from shared memory; lane l names row l%8 of
// matrix l/8. Without .trans lane (g,t) receives row g, columns 2t..2t+1
// of each; with .trans, rows 2t..2t+1 of column g (a B operand read from
// a row-major [k][n] tile).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16-byte global -> shared copy that bypasses registers; ``valid`` false
// writes zeros (the ragged edge past Sk)
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     int causal, float scale) {
  constexpr int LD = D + MMA_PAD;  // 16-byte rows stay 16-byte aligned
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int KD = D / 16;       // k-steps of S = Q K^T
  constexpr int NT = MMA_BN / 8;   // 8-key n-tiles of S
  constexpr int DT = D / 8;        // 8-wide n-tiles of O

  // Q tile, then two stages of (K tile, V tile): tile t+1 is in flight
  // (cp.async) while tile t is computed
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* KVs = Qs + MMA_BM * LD;
  constexpr int STAGE = 2 * MMA_BN * LD;  // K then V of one tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // row within the 8-row group
  const int t = lane & 3;   // column pair
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BM;  // longest first
  const long row_stride = (long)H * D;
  const __nv_bfloat16* qb = q + ((long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Sk * H + h) * D;
  const __nv_bfloat16* vb = v + ((long)b * Sk * H + h) * D;
  const uint4 zero = {};

  for (int i = tid; i < MMA_BM * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 x = zero;
    if (q0 + r < Sq)
      x = *reinterpret_cast<const uint4*>(qb + (q0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = x;
  }
  __syncthreads();

  // this warp's Q rows as mma A fragments, held for the whole loop
  const int wr = warp * 16;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = ld_u32(Qs + (wr + g) * LD + c);
    qf[kk][1] = ld_u32(Qs + (wr + g + 8) * LD + c);
    qf[kk][2] = ld_u32(Qs + (wr + g) * LD + c + 8);
    qf[kk][3] = ld_u32(Qs + (wr + g + 8) * LD + c + 8);
  }

  // rows g and g+8 of this warp's 16
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const int qp[2] = {q0 + wr + g, q0 + wr + g + 8};

  const int q_last = min(q0 + MMA_BM, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + MMA_BN - 1) / MMA_BN;

  // lane's row within an ldmatrix x4 (row l%8 of matrix l/8)
  const int lm_row = lane & 7;
  const int lm_mat = lane >> 3;
  auto load_tile = [&](int tile) {
    __nv_bfloat16* Kd = KVs + (tile & 1) * STAGE;
    __nv_bfloat16* Vd = Kd + MMA_BN * LD;
    const int k0 = tile * MMA_BN;
    for (int i = tid; i < MMA_BN * CH; i += MMA_THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = k0 + r < Sk;
      const long off = ok ? (k0 + r) * row_stride + c : 0;
      cp_async16(Kd + r * LD + c, kb + off, ok);
      cp_async16(Vd + r * LD + c, vb + off, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * MMA_BN;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1);  // its stage was last read before the
      cp_async_wait<1>();   // trailing barrier of the previous tile
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Ks = KVs + (tile & 1) * STAGE;
    const __nv_bfloat16* Vs = Ks + MMA_BN * LD;

    // S = Q K^T: s[n] holds rows (g, g+8) x keys (n*8 + 2t, +1)
    // one ldmatrix x4 gives the B fragments of two k-steps (kk, kk+1)
    // for one 8-key n-tile: matrices (kk lo, kk hi, kk+1 lo, kk+1 hi)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kp = Ks + (n * 8 + lm_row) * LD + lm_mat * 8;
#pragma unroll
      for (int kk = 0; kk < KD; kk += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kp + kk * 16);
        mma_bf16(s[n], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], b[0],
                 b[1]);
        mma_bf16(s[n], qf[kk + 1][0], qf[kk + 1][1], qf[kk + 1][2],
                 qf[kk + 1][3], b[2], b[3]);
      }
    }

    // scale, mask, online softmax; each row lives on the 4 lanes of a
    // quad (same g), so row reductions are two xor-shuffles
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e >> 1;
        const bool ok = kp < Sk && (!causal || qp[row] >= kp);
        s[n][e] = ok ? s[n][e] * scale : NEG_INF;
        mx[row] = fmaxf(mx[row], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      const float m_new = fmaxf(m[row], mx[row]);
      alpha[row] = expf(m[row] - m_new);
      m[row] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 1);
      sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 2);
      l[row] = alpha[row] * l[row] + sum[row];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V over 16-key steps; P's A fragment comes from s[2kc],
    // s[2kc+1] in bf16; one transposing ldmatrix x4 gives V's B
    // fragments for two 8-wide d-tiles: matrices (keys lo, d j),
    // (keys hi, d j), (keys lo, d j+1), (keys hi, d j+1)
#pragma unroll
    for (int kc = 0; kc < MMA_BN / 16; ++kc) {
      const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vp =
          Vs + (kc * 16 + (lm_mat & 1) * 8 + lm_row) * LD + (lm_mat >> 1) * 8;
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vp + j * 8);
        mma_bf16(o[j], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(o[j + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qp[row] >= Sq) continue;
    const float l_safe = fmaxf(l[row], 1e-20f);
    __nv_bfloat16* orow = out + (((long)b * Sq + qp[row]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(o[j][2 * row] / l_safe, o[j][2 * row + 1] / l_safe);
    if (t == 0)
      lse[((long)b * H + h) * Sq + qp[row]] = m[row] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int Sq, int Sk,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(MMA_BM + 4 * MMA_BN) * (D + MMA_PAD) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + MMA_BM - 1) / MMA_BM, B * H);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int Sq, int Sk,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BLOCK_M + 2 * BLOCK_N) * (D + PAD)
                    * sizeof(float)
                    + (size_t)BLOCK_M * BLOCK_N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_f32_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, Sq, Sk,
      causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int Sq, int Sk,
                       int D, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_fma<32>(q, k, v, out, lse, B, H, Sq, Sk, causal,
                               scale, stream);
    case 64:
      return launch_fma<64>(q, k, v, out, lse, B, H, Sq, Sk, causal,
                               scale, stream);
    case 128:
      return launch_fma<128>(q, k, v, out, lse, B, H, Sq, Sk, causal,
                                scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int H, int Sq, int Sk,
                        int D, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_mma<32>(q, k, v, out, lse, B, H, Sq, Sk, causal, scale,
                            stream);
    case 64:
      return launch_mma<64>(q, k, v, out, lse, B, H, Sq, Sk, causal, scale,
                            stream);
    case 128:
      return launch_mma<128>(q, k, v, out, lse, B, H, Sq, Sk, causal, scale,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B,Sq,H,D], k/v [B,Sk,H,D], out
// [B,Sq,H,D], all contiguous and 16-byte aligned; lse [B,H,Sq] float32.
// Returns a cudaError_t (0 on success).
extern "C" int rtt_flash_attn_fwd(const void* q, const void* k,
                                  const void* v, void* out, void* lse, int B,
                                  int H, int Sq, int Sk, int D, int causal,
                                  float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_f32(q, k, v, out, lse_f, B, H, Sq, Sk, D, causal, scale,
                      s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, lse_f, B, H, Sq, Sk, D, causal, scale,
                       s);
  return cudaErrorInvalidValue;
}
