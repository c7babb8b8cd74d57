// f32 x f32 -> f32 CUDA-core GEMM with fused epilogues: the products of the
// f32 tower halves.
//
// C[m, n] = sum_k A[m, k] * B[n, k] for A [M, K] f32 row-major
// activations and B [N, K] f32 row-major weights ([out, in]), each
// product an f32 FMA. Replaces the f32 dot_generals of
// jcf_tpu/ops/block_kernel.py::_attn_half_kernel (qkv, out-proj) and
// ::_mlp_half_kernel (c_fc, c_proj), which the TPU runs inside those
// kernels at Precision.HIGHEST. No TF32: its 10-bit mantissa cannot hold
// the f32 reference's per-block parity. Epilogues (bias in f32):
//   EPI_BIAS   acc + bias[n]                                        (qkv)
//   EPI_RESID  resid[m, n] + (acc + bias[n])              (out-proj, c_proj)
//   EPI_GELU   h * (0.5 + 0.5 tanh(0.851 h)), h = acc + bias[n]     (c_fc;
//              QuickGELU in the tanh form of _quick_gelu32)
// The epilogue arithmetic uses the _rn intrinsics so it rounds like the
// reference's separate elementwise ops.
//
// What bounds it on the H100: f32 operations (67 TFLOP/s outside the
// tensor cores; the vision tower's products at 8192 crops x 50 rows are
// 2 x 409,600 x 768 x 2304 flops for qkv, far above the f32 ridge point).
// This first version is the classic register-blocked SGEMM: 128 x 128
// block tiles, 8-deep K steps, 256 threads of 8 x 8 outputs (two 4-wide
// column groups 64 apart and two 4-row groups 64 apart, so the 16-byte
// shared reads of a warp are conflict-free), both operands loaded as
// float4 along K and stored transposed into shared memory (rows padded by
// 4 floats against bank conflicts), double-buffered through registers
// with one barrier per K step.
#include "common.cuh"

namespace {

enum { EPI_BIAS = 0, EPI_RESID = 1, EPI_GELU = 2 };

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int LDT = BM + 4;  // padded transposed row, floats
constexpr int GEMM_THREADS = 256;

struct Epilogue {
  float* out;          // [M, N]
  const float* bias;   // [N]
  const float* resid;  // [M, N]
};

template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float bias, const float* resid) {
  const float h = __fadd_rn(acc, bias);
  if (EPI == EPI_GELU)
    return __fmul_rn(h, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.851f, h)))));
  if (EPI == EPI_RESID) return __fadd_rn(*resid, h);
  return h;
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) f32_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K, Epilogue ep) {
  __shared__ __align__(16) float As[2][BK * LDT];  // [k][m]
  __shared__ __align__(16) float Bs[2][BK * LDT];  // [k][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 16 x 16 threads
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // each thread loads one float4 along K of A's tile and one of B's:
  // row lr = tid / 2 of the tile, K offset lk = (tid & 1) * 4
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const int gm = m0 + lr, gn = n0 + lr;
  const float* a_row = A + (long long)(gm < M ? gm : 0) * K;
  const float* b_row = B + (long long)(gn < N ? gn : 0) * K;

  auto fetch = [&](const float* row, bool ok, int k0) {
    // K % 4 == 0: a float4 is wholly inside or wholly outside the matrix
    if (ok && k0 + lk < K) return *reinterpret_cast<const float4*>(row + k0 + lk);
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  auto stash = [&](float* s, float4 v) {
    s[(lk + 0) * LDT + lr] = v.x;
    s[(lk + 1) * LDT + lr] = v.y;
    s[(lk + 2) * LDT + lr] = v.z;
    s[(lk + 3) * LDT + lr] = v.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int k_tiles = (K + BK - 1) / BK;
  stash(As[0], fetch(a_row, gm < M, 0));
  stash(Bs[0], fetch(b_row, gn < N, 0));
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    float4 na, nb;
    const bool more = kt + 1 < k_tiles;
    if (more) {
      na = fetch(a_row, gm < M, (kt + 1) * BK);
      nb = fetch(b_row, gn < N, (kt + 1) * BK);
    }
    const float* as = As[cur];
    const float* bs = Bs[cur];
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * LDT + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * LDT + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * LDT + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * LDT + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      stash(As[cur ^ 1], na);
      stash(Bs[cur ^ 1], nb);
    }
    __syncthreads();
  }

  // N % 4 == 0: a 4-wide column group is wholly inside or outside
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int jg = 0; jg < 2; ++jg) {
      const int n = n0 + jg * 64 + tx * 4;
      if (n >= N) continue;
      const long long idx = (long long)m * N + n;
      float4 y;
      y.x = epilogue<EPI>(acc[i][jg * 4 + 0], ep.bias[n + 0], ep.resid + idx + 0);
      y.y = epilogue<EPI>(acc[i][jg * 4 + 1], ep.bias[n + 1], ep.resid + idx + 1);
      y.z = epilogue<EPI>(acc[i][jg * 4 + 2], ep.bias[n + 2], ep.resid + idx + 2);
      y.w = epilogue<EPI>(acc[i][jg * 4 + 3], ep.bias[n + 3], ep.resid + idx + 3);
      *reinterpret_cast<float4*>(ep.out + idx) = y;
    }
  }
}

}  // namespace

extern "C" int jcf_f32_gemm(const void* A, const void* B, void* out, int M, int N, int K,
                            int epilogue, const void* bias, const void* resid, void* stream) {
  if (K % 4 || N % 4 || M < 1 || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  Epilogue ep{static_cast<float*>(out), static_cast<const float*>(bias),
              static_cast<const float*>(resid)};
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_BIAS: f32_gemm_kernel<EPI_BIAS><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    case EPI_RESID: f32_gemm_kernel<EPI_RESID><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    case EPI_GELU: f32_gemm_kernel<EPI_GELU><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
