// Shared helpers of the jcf_tpu_torch kernels (sm_90a).
//
// Rounding follows the JAX reference: every float -> int8 quantization
// rounds half to even (rintf), never roundf. Products and sums whose
// rounding the reference fixes use the _rn intrinsics, which nvcc never
// contracts into an FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// round half to even, saturate to [-127, 127]
__device__ __forceinline__ int8_t round_clip_int8(float x) {
  return (int8_t)fminf(fmaxf(rintf(x), -127.0f), 127.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row statistics of one LayerNorm row held by a warp: PER values per
// lane, element j = lane + 32 * k, valid while j < n. Returns
// (mean, rstd) with mean = sum / n and var = mean((x - mean)^2).
template <int PER>
__device__ __forceinline__ float2 warp_row_stats(const float (&v)[PER], int lane, int n) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (lane + 32 * k < n) s += v[k];
  const float mean = warp_sum(s) / (float)n;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (lane + 32 * k < n) {
      const float d = v[k] - mean;
      q = fmaf(d, d, q);
    }
  const float var = warp_sum(q) / (float)n;
  return make_float2(mean, rsqrtf(var + 1e-5f));
}
