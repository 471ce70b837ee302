// C entry points of the emulated fp32 kernels (tools/emulate_ring.py):
// each calls the launcher the C dispatch in flash_attn_fwd.cu and
// flash_attn_bwd.cu calls for fp32, and returns its cudaError_t.
#include "flash_attn_routes.cuh"

#define FWD_ARGS                                                        \
  const void *q, const void *k, const void *v, void *out, float *lse, \
      int B, int H, int Sq, int Sk, int D, int causal, float scale
#define FWD_PASS q, k, v, out, lse, B, H, Sq, Sk, D, causal, scale, nullptr
#define BWD_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *dout,        \
      const float *lse, const float *delta, void *o1, void *o2, int B,   \
      int H, int Sq, int Sk, int D, int causal, float scale
#define BWD_PASS(...) \
  q, k, v, dout, lse, delta, __VA_ARGS__, B, H, Sq, Sk, D, causal, scale, nullptr

extern "C" int emu_fwd_fma_ring(FWD_ARGS) { return rtt::fwd_fma_ring(FWD_PASS); }
extern "C" int emu_fwd_dchunk_fma(FWD_ARGS) {
  return rtt::fwd_dchunk_fma(FWD_PASS);
}
extern "C" int emu_bwd_dkdv_fma_ring(BWD_ARGS) {
  return rtt::bwd_dkdv_fma_ring(BWD_PASS(o1, o2));
}
extern "C" int emu_bwd_dkdv_dchunk_fma(BWD_ARGS) {
  return rtt::bwd_dkdv_dchunk_fma(BWD_PASS(o1, o2));
}
extern "C" int emu_bwd_dq_dchunk_fma(BWD_ARGS) {
  return rtt::bwd_dq_dchunk_fma(BWD_PASS(o1));
}
extern "C" int emu_bwd_dq_fma(BWD_ARGS) { return rtt::bwd_dq_fma(BWD_PASS(o1)); }
