// The int8 GEMM's epilogues (int8_gemm.cu), shared with the GEMM phases of
// the persistent int8 layer kernel (block_int8.cuh): C[m, n] = sum_k A[m,
// k] * B[n, k] exact in int32, then one of the forms int8_gemm.cu lists.
// Epilogue arithmetic uses the _rn intrinsics so it rounds exactly like
// the separate elementwise ops of the reference and the plain version.
#pragma once

#include "wgmma_gemm.cuh"

namespace {

enum {
  EPI_S32 = 0, EPI_BF16 = 1, EPI_RESID = 2, EPI_GELU_Q = 3, EPI_ROWSCALE = 4,
  EPI_BF16_ROWS = 5, EPI_RESID_ROWS = 6, EPI_F32 = 7, EPI_F32_ROWS = 8, EPI_RESID_F32 = 9,
  EPI_RESID_ROWS_F32 = 10
};

struct Epilogue {
  void* out;               // [M, N] int32 / bf16 / f32 / int8
  const float* scale;      // [N]
  const float* bias;       // [N]
  const void* resid;       // [M, N] bf16, or f32 (EPI_RESID*_F32)
  const float* gelu_c;     // scalar: 0.851 / h_inv
  const float* row_scale;  // [M]
};

// a float the epilogue reads: through L2 (CG: written earlier in the same
// launch, which the L1 and non-coherent paths may hold stale), or as is
template <bool CG>
__device__ __forceinline__ float ep_ldf(const float* p) {
  if constexpr (CG) return __ldcg(p);
  else return *p;
}

// the f32 values of the pair (acc * scale[n]) [* row_scale[m]] + bias[n]
// (EPI_ROWSCALE: (acc * row_scale[m]) * scale[n] + bias[n]), before the
// epilogue's store: the GELU-quant epilogue's h, the others' y
template <int EPI, bool CG = false>
__device__ __forceinline__ float2 dequant_pair(const Epilogue& ep, int m, int n, int v0, int v1) {
  float a0 = __int2float_rn(v0), a1 = __int2float_rn(v1);
  if (EPI == EPI_ROWSCALE) {
    a0 = __fmul_rn(a0, ep_ldf<CG>(ep.row_scale + m));
    a1 = __fmul_rn(a1, ep_ldf<CG>(ep.row_scale + m));
  }
  float y0 = __fmul_rn(a0, ep.scale[n]), y1 = __fmul_rn(a1, ep.scale[n + 1]);
  if (EPI == EPI_BF16_ROWS || EPI == EPI_RESID_ROWS || EPI == EPI_F32_ROWS ||
      EPI == EPI_RESID_ROWS_F32) {
    y0 = __fmul_rn(y0, ep_ldf<CG>(ep.row_scale + m));
    y1 = __fmul_rn(y1, ep_ldf<CG>(ep.row_scale + m));
  }
  y0 = __fadd_rn(y0, ep.bias[n]);
  y1 = __fadd_rn(y1, ep.bias[n + 1]);
  return make_float2(y0, y1);
}

// the bf16 pair at p as two floats, through L2 where CG
template <bool CG>
__device__ __forceinline__ float2 ep_ld_bf16x2(const bf16* p) {
  if constexpr (CG) {
    const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
  } else {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p);
    return make_float2(__low2float(r), __high2float(r));
  }
}

template <int EPI, bool CG = false>
__device__ __forceinline__ void store_pair(const Epilogue& ep, int m, int n, int N, int v0, int v1) {
  const long long idx = (long long)m * N + n;
  if (EPI == EPI_S32) {
    *reinterpret_cast<int2*>(static_cast<int32_t*>(ep.out) + idx) = make_int2(v0, v1);
    return;
  }
  const float2 y = dequant_pair<EPI, CG>(ep, m, n, v0, v1);
  const float y0 = y.x, y1 = y.y;
  if (EPI == EPI_BF16 || EPI == EPI_ROWSCALE || EPI == EPI_BF16_ROWS) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + idx) =
        __floats2bfloat162_rn(y0, y1);
  } else if (EPI == EPI_RESID || EPI == EPI_RESID_ROWS) {
    const float2 r = ep_ld_bf16x2<CG>(static_cast<const bf16*>(ep.resid) + idx);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + idx) =
        __floats2bfloat162_rn(__fadd_rn(r.x, y0), __fadd_rn(r.y, y1));
  } else if (EPI == EPI_RESID_F32 || EPI == EPI_RESID_ROWS_F32) {
    const float2* rp = reinterpret_cast<const float2*>(static_cast<const float*>(ep.resid) + idx);
    float2 r;
    if constexpr (CG) r = __ldcg(rp);
    else r = *rp;
    *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + idx) =
        make_float2(__fadd_rn(r.x, y0), __fadd_rn(r.y, y1));
  } else if (EPI == EPI_F32 || EPI == EPI_F32_ROWS) {
    *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + idx) = make_float2(y0, y1);
  } else {
    const float c = *ep.gelu_c;
    const float g0 = __fmul_rn(y0, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(c, y0)))));
    const float g1 = __fmul_rn(y1, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(c, y1)))));
    char2 q;
    q.x = round_clip_int8(g0);
    q.y = round_clip_int8(g1);
    *reinterpret_cast<char2*>(static_cast<int8_t*>(ep.out) + idx) = q;
  }
}

}  // namespace
