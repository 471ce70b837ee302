// K1 in fp32 on the CUDA cores at every head dim past 256, with no upper
// bound. Replaces ray_tpu/ops/attention.py::_flash_kernel (lines 202-259)
// for those inputs. K2 and K3 in fp32 past 256 are the backward kernel of
// flash_attn_dchunk_ring_f32.cuh, which also holds the ring this kernel
// streams through.
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

#include "flash_attn_dchunk_ring_f32.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: register-blocked FMAs fed by a cp.async ring (see the header).
// ---------------------------------------------------------------------------

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
