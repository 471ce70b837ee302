// K1 (flash-attention forward) in bf16 on mma.sync, for every head dim
// 1..256 that the wgmma kernels (d 64 and 128, flash_attn_fwd.cu; the
// padded head dims, D % 8 == 0 from 72 to 256, flash_attn_fwd_padded.cu)
// do not take: under 64, and off the multiples of 8. Replaces
// ray_tpu/ops/attention.py::_flash_kernel for those bf16 q/k/v;
// flash_attn_fwd.cu describes the kernel family and its numerics.
//
// mma.sync.m16n8k16 tiles (bf16 in, fp32 accumulate): one block per
// (batch*head, 64-row q tile), 4 warps of 16 q rows; K/V tiles of 64
// keys double buffered; A and B fragments by ldmatrix from padded shared
// rows. S = Q K^T runs over head-dim steps of 16 (an odd last step takes
// one ldmatrix x2), and P goes from the S accumulators to P V's A operand
// in registers, rounded to bf16 as the TPU kernel casts p to v.dtype. The
// kernel is instantiated at DP = D rounded up to 16 and told the real D:
// columns past D load as zeros, stores past D are dropped, and a row
// whose 2 D bytes are not a multiple of 16 loads element by element.
// Q's fragments are read from shared memory at each tile (at DP 256 the
// fp32 O accumulator alone is 128 registers a thread). What bounds it:
// at the narrow rows and short lengths it runs (d 16 and 20, S ~1000)
// bytes and launch overhead; at long S and wide rows operations, where
// the mma.sync issue rate holds it back (3.2x SDPA at d 160, PERF.md,
// before the padded wgmma route took that width).

#include "flash_attn_common.cuh"
#include "flash_attn_routes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_BM = MMA_WARPS * 16;  // query rows per block
constexpr int MMA_BN = 64;              // keys per K/V tile

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk, int D,
                     int causal, float scale) {
  constexpr int LD = DP + MMA_PAD;  // 16-byte rows stay 16-byte aligned
  constexpr int NT = MMA_BN / 8;    // 8-key n-tiles of S
  constexpr int DT = DP / 8;        // 8-wide n-tiles of O

  // Q tile, then two stages of (K tile, V tile): tile t+1 is in flight
  // while tile t is computed
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + MMA_BM * LD;
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
  const bf16* qb = q + ((long)b * Sq * H + h) * D;
  const bf16* kb = k + ((long)b * Sk * H + h) * D;
  const bf16* vb = v + ((long)b * Sk * H + h) * D;

  load_rows_bf16<MMA_BM, DP, MMA_THREADS>(Qs, qb, row_stride, q0, Sq, D, tid);
  cp_async_commit();

  const int wr = warp * 16;
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
    bf16* Kd = KVs + (tile & 1) * STAGE;
    load_rows_bf16<MMA_BN, DP, MMA_THREADS>(Kd, kb, row_stride,
                                            tile * MMA_BN, Sk, D, tid);
    load_rows_bf16<MMA_BN, DP, MMA_THREADS>(Kd + MMA_BN * LD, vb, row_stride,
                                            tile * MMA_BN, Sk, D, tid);
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
    const bf16* Ks = KVs + (tile & 1) * STAGE;
    const bf16* Vs = Ks + MMA_BN * LD;

    // S = Q K^T: s[n] holds rows (g, g+8) x keys (n*8 + 2t, +1)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    row_products<DP, NT>(s, Qs, Ks, wr, 0, lane);

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
      const bf16* vp =
          Vs + (kc * 16 + (lm_mat & 1) * 8 + lm_row) * LD + (lm_mat >> 1) * 8;
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vp + j * 8);
        mma_bf16(o[j], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16(o[j + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qp[row] >= Sq) continue;
    const float l_safe = fmaxf(l[row], 1e-20f);
    bf16* orow = out + (((long)b * Sq + qp[row]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store_pair_bf16(orow, j * 8 + 2 * t, D, o[j][2 * row] / l_safe,
                      o[j][2 * row + 1] / l_safe);
    if (t == 0)
      lse[((long)b * H + h) * Sq + qp[row]] = m[row] + logf(l_safe);
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int H, int Sq, int Sk, int D,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(MMA_BM + 4 * MMA_BN) * (DP + MMA_PAD) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + MMA_BM - 1) / MMA_BM, B * H);
  flash_fwd_mma_kernel<DP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, H, Sq, Sk,
      D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t rtt::fwd_mma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int H, int Sq, int Sk,
                         int D, int causal, float scale,
                         cudaStream_t stream) {
  return with_padded_dim<16>(D, [&](auto dim) -> cudaError_t {
    return launch_mma<decltype(dim)::value>(q, k, v, out, lse, B, H, Sq, Sk,
                                            D, causal, scale, stream);
  });
}
