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
// keep the tensor cores fed. The routes, by dtype and head_dim
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
//   - bf16, every other head_dim 1..256 (bench.py's xl width at 16
//     heads, d 160; the entry() shape's 32, the debug configs' 16, the
//     head dims off the multiples of 8): flash_fwd_padded_kernel<DP, NCW,
//     FEED> in flash_attn_fwd_padded.cuh, instantiated at DP = D rounded
//     up to 32 over rows padded with zeros to 64-column boxes: this
//     kernel's warp roles and two-stage ring with K/V tiles as wide as
//     shared memory allows beside resident Q (128 keys at a padded row of
//     64 or 128 columns, 96 at 192, 64 at 256; 128-key tiles do not fit
//     the 227 KB at 192), S over DP/16 k steps, O += P V in box-aligned N
//     pieces (wgmma_rs_cols), software-pipelined inside each warpgroup
//     (tile j's S beside tile j - 1's P V), 64-row tiles (one consumer
//     warpgroup) where 128-row ones would leave SMs idle, every wait
//     mbar_wait_no_trap. At D % 8 == 0 TMA fills its boxes (route
//     "wgmma_tma_ws_padded", flash_attn_fwd_padded.cu); at D % 8 != 0,
//     a row stride TMA cannot take, the producer warpgroup fills the
//     same swizzled boxes by cp.async or, at odd D, through registers
//     ("wgmma_cp_async_ws_padded", flash_attn_fwd_padded_cp_async.cu);
//   - fp32, every head_dim 1..256: exact fp32 FMAs on the CUDA cores (the
//     tensor cores would round fp32 to tf32), register-blocked and fed by
//     a cp.async ring, one slice of O (all of D) a block with Q resident
//     (route "fma_f32_ring", flash_attn_fwd_fma_ring.cu; the kernel in
//     flash_attn_ring_f32.cuh);
//   - bf16 and fp32, every head_dim past 256, where a block no longer
//     holds full-width tiles beside its rings in the 227 KB of shared
//     memory it may have: a block owns a slice of O's columns, up to 256
//     wide (320 in fp32), and computes S over the whole head dim,
//     ceil(D / 256) times a tile pair. bf16 on wgmma with S's operands
//     streamed through rings of 64-column boxes
//     (flash_attn_dchunk_fwd_wgmma.cuh), filled by TMA at D % 8 == 0
//     (route "dchunk_wgmma_tma_ws") and by cp.async or through registers
//     at D % 8 != 0 ("dchunk_wgmma_cp_async_ws"); fp32 on register-blocked
//     FMAs fed by a cp.async ring ("dchunk_fma_f32_ring",
//     flash_attn_dchunk_fma.cu), the kernel of "fma_f32_ring" with its q
//     rows streamed.
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
#include "flash_attn_routes.cuh"
#include "hopper_common.cuh"

namespace {

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim D >= 1. q [B,Sq,H,D],
// k/v [B,Sk,H,D], out [B,Sq,H,D], all contiguous with 16-byte aligned
// bases; lse [B,H,Sq] float32.
// Returns a cudaError_t (0 on success).
extern "C" int rtt_flash_attn_fwd(const void* q, const void* k,
                                  const void* v, void* out, void* lse, int B,
                                  int H, int Sq, int Sk, int D, int causal,
                                  float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (rtt::dchunk_head_dim(D) && dtype == 0)
    return rtt::fwd_dchunk_fma(q, k, v, out, lse_f, B, H, Sq, Sk, D, causal,
                               scale, s);
  if (rtt::dchunk_wgmma_head_dim(D) && dtype == 1)
    return rtt::fwd_dchunk_wgmma(q, k, v, out, lse_f, B, H, Sq, Sk, D,
                                 causal, scale, s);
  if (rtt::dchunk_unaligned_head_dim(D) && dtype == 1)
    return rtt::fwd_dchunk_wgmma_cp_async(q, k, v, out, lse_f, B, H, Sq, Sk,
                                          D, causal, scale, s);
  if (rtt::fma_ring_head_dim(D) && dtype == 0)
    return rtt::fwd_fma_ring(q, k, v, out, lse_f, B, H, Sq, Sk, D, causal,
                             scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (D == 64)
    return launch_ws<64>(q, k, v, out, lse_f, B, H, Sq, Sk, causal, scale, s);
  if (D == 128)
    return launch_ws<128>(q, k, v, out, lse_f, B, H, Sq, Sk, causal, scale,
                          s);
  if (rtt::wgmma_padded_head_dim(D))
    return rtt::fwd_padded(q, k, v, out, lse_f, B, H, Sq, Sk, D, causal,
                           scale, s);
  return rtt::fwd_padded_cp_async(q, k, v, out, lse_f, B, H, Sq, Sk, D,
                                  causal, scale, s);
}
