// bf16 types for the emulated sources' shared helpers (none of the fp32
// kernels computes in bf16); see cuda_runtime.h
#pragma once
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { return {}; }
inline __nv_bfloat16 __float2bfloat16_rn(float) { return {}; }
