// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_flash_kernel
// (launched by _pallas_fwd): online softmax over K/V tiles with a running
// max and denominator, fp32 accumulation, P rounded to V's dtype before
// P.V (bf16 for the served type), causal skipping of tiles above the
// diagonal, and the outputs out [B,Sq,H,D] (q's dtype) and
// lse = m + log(l) [B,H,Sq] fp32.
//
// What bounds it on an H100: at b1's shapes (B2 or B8, S2048 H16 D128,
// causal) the work is ~500 FLOP per byte of HBM traffic, far above the
// card's ~295 FLOP/byte ridge: operations bound it, so the bf16 path must
// keep the tensor cores fed. Three kernels, by dtype and head_dim
// (attention.py::kernel_route names the one each launch takes):
//   - bf16, head_dim 64 and 128 (the served and trained route):
//     flash_fwd_ws_kernel, wgmma on TMA-fed shared-memory rings with warp
//     specialisation. One block per (batch*head, 128-row q tile); a
//     producer warpgroup lowers its registers (setmaxnreg.dec to 24) and
//     one of its threads issues every TMA load; two consumer warpgroups
//     raise theirs (setmaxnreg.inc to 240) and each owns 64 q rows. Q
//     stays resident; K and V tiles of 128 keys go round a two-stage
//     ring with full/empty mbarriers, so loads run ahead of the products
//     and each K/V tile fetched serves 128 query rows. S = Q K^T is
//     wgmma m64n128k16 with both operands in shared memory (K-major);
//     O += P V takes P from registers (the fp32 accumulator repacked to
//     bf16 pairs) and V MN-major through the transpose bit. The softmax
//     runs in the log2 domain with scale * log2 e folded into the
//     exponent's FMA; masks (causal diagonal, ragged end) run only on
//     the tiles that need them. Tensor maps are 4-D {D, H, S, B} with
//     128-byte swizzle, so a box past S reads zeros of its own batch;
//     they are built per call on the host (hopper_common.cuh). ptxas
//     (sm_90a, CUDA 12.9, on the H100 host): 168 registers at entry, the
//     consumers run in up to 240, no spills at either head_dim.
//     What holds it back: a consumer warpgroup waits for S before its
//     softmax and for P V before the next S, so its softmax overlaps only
//     the other warpgroup's products. Overlapping them inside a
//     warpgroup (S_{j+1} in flight beside P_j V_j) or taking turns on
//     the tensor cores (ping-pong over named barriers) both ran slower
//     here: with two accumulators in flight ptxas serialises the wgmmas
//     for want of registers.
//   - bf16, head_dim 32 (entry()'s shape: launch overhead bounds it; a
//     64-byte row is under the 128-byte swizzle box the wgmma route is
//     built on): flash_fwd_mma_kernel, mma.sync.m16n8k16 tiles. One
//     block per (batch*head, 64-row q tile), 4 warps of 16 rows holding
//     their Q fragments in registers; K/V tiles of 64 keys double
//     buffered by cp.async, ldmatrix fragment loads from 16-byte padded
//     rows; P goes from the S accumulators to P V's A operand in
//     registers.
//   - fp32: exact fp32 FMAs on the CUDA cores (the tensor cores would
//     round fp32 to tf32). 8 warps of 8 rows; each lane owns two keys of
//     a 64-key tile for S and D/32 output columns for P.V; Q reads are
//     warp broadcasts, so each K element loaded feeds 8 rows of FMAs.
// All skip every tile above the causal diagonal by making it the loop
// bound (the TPU kernel's index-map clamp has no counterpart), schedule
// the longest q tiles first, and mask ragged lengths themselves
// (k_pos < Sk; rows past Sq load as zeros and are never written), so no
// block-size divisibility is required. Numerics as the TPU kernel's:
// fp32 accumulation and running max/sum, P rounded to bf16 only as the
// operand of P V with l summing the unrounded P, masked scores at -1e30,
// lse = m + log(max(l, 1e-20)) in the natural log.
//
// Plain C interface, loaded with ctypes (no PyTorch headers): the caller
// allocates out/lse, passes the current stream, and raises on a non-zero
// return (cudaGetLastError right after the launch).

#include "flash_attn_common.cuh"
#include "hopper_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 path: FMAs on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int BLOCK_M = 64;  // query rows per block
constexpr int BLOCK_N = 64;  // keys per K/V tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BLOCK_M / NWARPS;

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

// ---------------------------------------------------------------------------
// bf16, head_dim 64 and 128: wgmma on TMA-fed rings, warp-specialised.
// One block per (batch*head, 128-row q tile); warpgroups 0 and 1 each own
// 64 q rows, warpgroup 2 is the producer (one thread issues every TMA
// load). Q is loaded once and stays; K and V tiles of 128 keys go round a
// two-stage ring, each stage with its own full (TMA bytes landed) and
// empty (all 256 consumer threads done reading) barrier for K and for V,
// so the producer refills K while the consumers still read V.
// ---------------------------------------------------------------------------

constexpr int WS_BM = 128;  // q rows per block
constexpr int WS_BN = 128;  // keys per K/V tile
constexpr int WS_STAGES = 2;
constexpr int WS_THREADS = 384;  // two consumer warpgroups + the producer
constexpr int WS_CONSUMERS = 256;

template <int D>
struct WsFwdSmem {
  static constexpr int Q_BYTES = WS_BM * D * 2;
  static constexpr int KV_BYTES = WS_BN * D * 2;  // one K or one V tile
  static constexpr int Q_BOX = WS_BM * SWIZZLE_ROW_BYTES;   // bytes a box
  static constexpr int KV_BOX = WS_BN * SWIZZLE_ROW_BYTES;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + WS_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + WS_STAGES * KV_BYTES;
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int BYTES = BAR_OFF + (1 + 4 * WS_STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int H, int Sq, int Sk, int causal, float scale_log2) {
  using L = WsFwdSmem<D>;
  constexpr int BOXES = D / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + WS_STAGES + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * WS_STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * WS_STAGES + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WS_BM;  // longest first
  // causal: keys past this tile's last row are never needed
  const int q_last = min(q0 + WS_BM, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + WS_BN - 1) / WS_BN;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int x = 0; x < BOXES; ++x)
        tma_load_4d(base + x * L::Q_BOX, &tm_q, q_full, x * BOX_COLS, h, q0,
                    b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % WS_STAGES;
        const uint32_t free_parity = ((j / WS_STAGES) & 1) ^ 1;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), L::KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + x * L::KV_BOX,
                      &tm_k, k_full(s), x * BOX_COLS, h, j * WS_BN, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + x * L::KV_BOX,
                      &tm_v, v_full(s), x * BOX_COLS, h, j * WS_BN, b);
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

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // running max (log2 domain: scores times scale * log2 e) and sum
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float sc[64];              // S of one tile, then its p in fp32
    uint32_t pa[WS_BN / 16][4];  // p in bf16: the A operand of P V
    const uint32_t q_tile = base + wg * 64 * SWIZZLE_ROW_BYTES;

    // S = Q K^T of tile j: [64 rows, 128 keys], both operands K-major
    auto issue_s = [&](int j) {
      const int s = j % WS_STAGES;
      const uint32_t k_tile = base + L::K_OFF + s * L::KV_BYTES;
      const uint32_t q_at = opaque(q_tile);
      mbar_wait(k_full(s), (j / WS_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk & 3) * 32;
        wgmma_ss_n128<0>(
            sc, sw128_desc(q_at + (kk >> 2) * L::Q_BOX + in_box, 16, 1024),
            sw128_desc(k_tile + (kk >> 2) * L::KV_BOX + in_box, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile j, 16 keys a step: V is MN-major (head_dim
    // contiguous), so B is transposed
    auto issue_pv = [&](int j) {
      const int s = j % WS_STAGES;
      const uint32_t v_tile = base + L::V_OFF + s * L::KV_BYTES;
      mbar_wait(v_full(s), (j / WS_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < WS_BN / 16; ++kc) {
        const uint64_t dv =
            sw128_desc(v_tile + kc * 16 * SWIZZLE_ROW_BYTES, L::KV_BOX, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128<1>(o, pa[kc], dv, 1);
        else
          wgmma_rs_n64<1>(o, pa[kc], dv, 1);
      }
      wgmma_commit();
    };
    // online softmax of tile j in sc (a row lives on the 4 lanes of a
    // quad): scale into the log2 domain, mask only the tiles that need it
    // (the causal diagonal, the ragged end), update m and l, leave p in
    // sc and O's rescale factor in alpha
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = j * WS_BN;
      if ((causal && k0 + WS_BN - 1 > wg_row) || k0 + WS_BN > Sk) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (kp >= Sk || (causal && kp > qp[(i >> 1) & 1])) sc[i] = NEG_INF;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 64; ++i)
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
      for (int i = 0; i < 64; ++i) {
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
    auto pack_p = [&] {
#pragma unroll
      for (int kc = 0; kc < WS_BN / 16; ++kc) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kc][x] = pack_bf16(sc[8 * kc + 2 * x], sc[8 * kc + 2 * x + 1]);
      }
    };

    // Within a warpgroup each step waits for the last (one accumulator in
    // flight: registers allow no more without ptxas serialising the
    // wgmmas); the two warpgroups overlap each other's softmax and
    // products, and the ring keeps the next tiles' loads in flight.
    float alpha[2];
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      issue_s(j);
      wgmma_wait<0>();
      fence_operand(sc);
      mbar_arrive(k_empty(j % WS_STAGES));
      softmax(j, alpha);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
      issue_pv(j);
      wgmma_wait<0>();
      fence_operand(o);
      mbar_arrive(v_empty(j % WS_STAGES));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] >= Sq) continue;
      const float l_safe = fmaxf(l[r], 1e-20f);
      __nv_bfloat16* orow = out + (((long)b * Sq + qp[r]) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) = pack_bf16(
            o[4 * j + 2 * r] / l_safe, o[4 * j + 2 * r + 1] / l_safe);
      if (t == 0)
        lse[((long)b * H + h) * Sq + qp[r]] = m[r] * LN2 + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_ws(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int H, int Sq, int Sk, int causal,
                      float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, q, B, Sq, H, D, WS_BM);
  if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, WS_BN);
  if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, WS_BN);
  if (err) return static_cast<cudaError_t>(err);
  constexpr int smem = WsFwdSmem<D>::ALLOC;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_ws_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sq + WS_BM - 1) / WS_BM, B * H);
  flash_fwd_ws_kernel<D><<<grid, WS_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, H, Sq, Sk, causal,
      scale * LOG2E);
  return cudaGetLastError();
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
      return launch_ws<64>(q, k, v, out, lse, B, H, Sq, Sk, causal, scale,
                           stream);
    case 128:
      return launch_ws<128>(q, k, v, out, lse, B, H, Sq, Sk, causal, scale,
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
