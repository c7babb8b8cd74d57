// The row bodies of the int8 row kernels, shared by the halves' vector
// kernels (block.cu: ln_quant_vec_kernel, quant_rows_vec_kernel) and the
// row phases of the persistent int8 layer kernel (block_int8.cuh). A body
// takes a row already in registers, so each caller keeps its own loads
// (the halves' next row in flight; the persistent phases through L2, since
// the launch wrote their rows) and its own walk over the rows.
#pragma once

#include "common.cuh"

// four int8 values round(y * inv) clipped to +-127, packed little-endian
__device__ __forceinline__ unsigned quant_pack4(const float* y, float inv) {
  unsigned w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w |= (unsigned)(uint8_t)round_clip_int8(__fmul_rn(y[i], inv)) << (8 * i);
  return w;
}

// LayerNorm + int8 quantization of one row held by a warp: a lane holds
// the 16-byte chunks c = lane + 32 k of the row (V = 8 bf16 or 4 f32
// values each; live[k] where chunk c lies in the row, E wide), ga / ba the
// f32 affine's values of those chunks (AFFINE). z = (x - mean) * rsqrt(var
// + 1e-5), y = z (the folded tree) or z * g + b (a product and a sum each
// rounded, _ln_rows); static: q = round(y * inv_static); DYN (_quant_rows):
// amax = max(max |y|, 1e-8), q = round(y * (127 / amax)), *scale = amax *
// f32(1/127) (lane 0). The int8 values leave packed at o, 8 bytes a bf16
// chunk and 4 an f32 chunk.
template <typename T, int CPL, bool DYN, bool AFFINE>
__device__ __forceinline__ void ln_quant_vec_row(const uint4 (&cur)[CPL], const bool (&live)[CPL],
                                                 int E,
                                                 const float (&ga)[AFFINE ? CPL : 1][16 / sizeof(T)],
                                                 const float (&ba)[AFFINE ? CPL : 1][16 / sizeof(T)],
                                                 float inv_static, int8_t* o, float* scale) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  float v[CPL][V];
#pragma unroll
  for (int k = 0; k < CPL; ++k) lnv_unpack(cur[k], v[k]);
  const float2 st = ln_vec_stats<CPL, V>(v, live, E);
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < CPL; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float y = __fmul_rn(__fsub_rn(v[k][i], st.x), st.y);
      if constexpr (AFFINE) y = __fadd_rn(__fmul_rn(y, ga[k][i]), ba[k][i]);
      v[k][i] = y;
      if constexpr (DYN) {
        if (live[k]) amax = fmaxf(amax, fabsf(y));
      }
    }
  float inv = inv_static;
  if constexpr (DYN) {
    amax = fmaxf(warp_max(amax), 1e-8f);
    inv = __fdiv_rn(127.0f, amax);
    if (lane == 0) *scale = __fmul_rn(amax, 1.0f / 127.0f);
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (!live[k]) continue;
    const int c = lane + 32 * k;
    if constexpr (V == 8) {
      reinterpret_cast<uint2*>(o)[c] =
          make_uint2(quant_pack4(&v[k][0], inv), quant_pack4(&v[k][4], inv));
    } else {
      reinterpret_cast<unsigned*>(o)[c] = quant_pack4(&v[k][0], inv);
    }
  }
}

// QuickGELU in its tanh form (_quick_gelu32), or the value itself
template <bool GELU>
__device__ __forceinline__ float quick_gelu_tanh(float h) {
  if (!GELU) return h;
  return __fmul_rn(h, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.851f, h)))));
}

// The dynamic row quantization (_quant_rows, after QuickGELU where GELU)
// of one f32 row held by a group of G warps: thread t of the group holds
// the float4 chunks t + 32 G k (live[k] where that chunk lies in the row).
// group_max(a) returns the group's max of a (a warp's shuffles, then, for
// G > 1, the warps' maxima exchanged by the caller's means); amax =
// max(max |g|, 1e-8), q = round(g * (127 / amax)) packed 4 bytes a chunk at
// o, *scale = amax * f32(1/127) (thread 0 of the group).
template <bool GELU, int G, int CPL, class GroupMax>
__device__ __forceinline__ void quant_rows_vec_row(const uint4 (&cur)[CPL], const bool (&live)[CPL],
                                                   int t, unsigned* o, float* scale,
                                                   GroupMax group_max) {
  float v[CPL][4];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    lnv_unpack(cur[k], v[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[k][i] = quick_gelu_tanh<GELU>(v[k][i]);
      if (live[k]) amax = fmaxf(amax, fabsf(v[k][i]));
    }
  }
  amax = fmaxf(group_max(amax), 1e-8f);
  const float inv = __fdiv_rn(127.0f, amax);
  if (t == 0) *scale = __fmul_rn(amax, 1.0f / 127.0f);
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (live[k]) o[t + 32 * G * k] = quant_pack4(v[k], inv);
}
