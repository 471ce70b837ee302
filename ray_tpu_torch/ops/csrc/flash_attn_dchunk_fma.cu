// K1, K2 and K3 in fp32 on the CUDA cores at every head dim past 256, with
// no upper bound: the route "dchunk" for float32 inputs. Replace
// ray_tpu/ops/attention.py::_flash_kernel, ::_bwd_dq_kernel and
// ::_bwd_dkdv_kernel for those inputs; flash_attn_dchunk.cu describes the
// design (the head dim cut into 64-column chunks, a block per tile and
// output chunk, S recomputed over every chunk by each of a tile's blocks,
// bit-identically, and lse written by chunk 0) and flash_attn_fwd_fma.cu
// and flash_attn_bwd_fma.cu the fp32 kernels' layout, which these keep at
// DP 64: exact fp32 FMAs, 8 warps of 8 rows over 64-row tiles, a lane
// owning two keys (or queries) of the S tile and two columns of its
// output chunk. Loads are plain (no cp.async ring): fp32 runs at
// 67 TFLOP/s, and these kernels are bound by the recompute, not by the
// loads.

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

__global__ void __launch_bounds__(NTHREADS)
fwd_dchunk_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int H, int Sq, int Sk, int D,
                      int causal, float scale) {
  // Q chunk, K chunk, V's chunk c, the P slab [TILE q rows][TILE keys]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + CT;
  float* Vs = Ks + CT;
  float* Ps = Vs + CT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // longest first
  const int c0 = blockIdx.z * DC;
  const int nc = (D + DC - 1) / DC;
  const long row_stride = (long)H * D;
  const float* qb = q + ((long)b * Sq * H + h) * D;
  const float* kb = k + ((long)b * Sk * H + h) * D;
  const float* vb = v + ((long)b * Sk * H + h) * D;

  const int r0 = warp * FMA_ROWS;
  float* Pw = Ps + r0 * TILE;
  float m[FMA_ROWS], l[FMA_ROWS], acc[FMA_ROWS][DPL], s[FMA_ROWS][NC];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int q_last = min(q0 + TILE, Sq) - 1;
  const int kv_len = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (kv_len + TILE - 1) / TILE;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * TILE;
    zero(s);
    for (int dc = 0; dc < nc; ++dc) {
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      load_chunk(Qs, qb, row_stride, q0, Sq, dc * DC, D, tid);
      load_chunk(Ks, kb, row_stride, k0, Sk, dc * DC, D, tid);
      if (dc + 1 == nc) load_chunk(Vs, vb, row_stride, k0, Sk, c0, D, tid);
      __syncthreads();
      row_dots<DC, NC>(s, Qs, r0, Ks, lane);
    }

    // online softmax, one row at a time across the warp (as fwd_fma)
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r) {
      const int qp = q0 + r0 + r;
      float x[NC];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kp = k0 + lane + 32 * j;
        const bool ok = kp < Sk && (!causal || qp >= kp);
        x[j] = ok ? s[r][j] * scale : NEG_INF;
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = expf(x[j] - m_new);
        sum += p;
        Pw[r * TILE + lane + 32 * j] = p;
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();
    slab_product<DC, TILE>(acc, Pw, Vs, lane);  // O_c += P V_c
    __syncwarp();
  }

  float* rows[FMA_ROWS];
  float inv[FMA_ROWS];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    const int qp = q0 + r0 + r;
    const float l_safe = fmaxf(l[r], 1e-20f);
    inv[r] = 1.f / l_safe;
    rows[r] = qp < Sq ? out + (((long)b * Sq + qp) * H + h) * D : nullptr;
    if (rows[r] && lane == 0 && blockIdx.z == 0)
      lse[((long)b * H + h) * Sq + qp] = m[r] + logf(l_safe);
  }
  store_chunk(rows, acc, inv, c0, D, lane);
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
  return launch(fwd_dchunk_f32_kernel, Sq, B * H, D,
                3 * CHUNK_BYTES + SLAB_BYTES, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(out), lse,
                H, Sq, Sk, D, causal, scale);
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
