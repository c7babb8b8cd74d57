// bf16 x bf16 -> f32 tensor-core GEMM with fused epilogues: the products
// of the bf16 tower halves.
//
// C[m, n] = sum_k A[m, k] * B[n, k] for A [M, K] bf16 row-major
// activations and B [N, K] bf16 row-major weights ([out, in], cast from
// f32 as the reference's .astype(x.dtype)), accumulated in f32. Replaces
// the bf16 dot_generals of jcf_tpu/ops/block_kernel.py::_attn_half_kernel
// (qkv, out-proj) and ::_mlp_half_kernel (c_fc, c_proj), which the TPU
// runs inside those kernels. The bias stays f32. Epilogues:
//   EPI_BIAS   bf16(acc + bias[n])                                   (qkv)
//   EPI_RESID  bf16(resid[m, n] + (acc + bias[n]))          (out-proj, c_proj)
//   EPI_GELU   bf16(h * (0.5 + 0.5 tanh(0.851 h))), h = acc + bias[n]  (c_fc;
//              QuickGELU in the tanh form of _quick_gelu32, in f32)
// The epilogue arithmetic uses the _rn intrinsics so it rounds like the
// reference's separate elementwise ops.
//
// What bounds it on the H100: tensor-core throughput. The text tower's
// products at 512 prompts x 77 tokens (M = 39,424, K = 512 or 2048) sit
// far above the bf16 ridge point. This first version is the int8 GEMM's
// design (int8_gemm.cu) at bf16: warp-level mma.sync m16n8k16 (f32
// accumulation) from a two-stage cp.async ring, 128x128 block tiles,
// 32-deep K steps (64 bytes, the int8 kernel's byte layout), eight warps
// of 64x32, shared rows padded to 80 bytes against bank conflicts. wgmma
// with TMA, which reaches the full bf16 rate, is a later step.
#include "common.cuh"

namespace {

enum { EPI_BIAS = 0, EPI_RESID = 1, EPI_GELU = 2 };

constexpr int BM = 128, BN = 128, BK = 32;  // BK in bf16 elements
constexpr int LDS = BK + 8;                 // padded shared row, elements
constexpr int GEMM_THREADS = 256;

struct Epilogue {
  bf16* out;           // [M, N]
  const float* bias;   // [N]
  const bf16* resid;   // [M, N]
};

template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float bias) {
  const float h = __fadd_rn(acc, bias);
  if (EPI == EPI_GELU) return __fmul_rn(h, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.851f, h)))));
  return h;
}

template <int EPI>
__device__ __forceinline__ void store_pair(const Epilogue& ep, int m, int n, int N, float v0,
                                           float v1) {
  const long long idx = (long long)m * N + n;
  float y0 = epilogue<EPI>(v0, ep.bias[n]);
  float y1 = epilogue<EPI>(v1, ep.bias[n + 1]);
  if (EPI == EPI_RESID) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(ep.resid + idx);
    y0 = __fadd_rn(__low2float(r), y0);
    y1 = __fadd_rn(__high2float(r), y1);
  }
  *reinterpret_cast<__nv_bfloat162*>(ep.out + idx) = __floats2bfloat162_rn(y0, y1);
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) bf16_gemm_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B, int M, int N, int K, Epilogue ep) {
  __shared__ __align__(16) bf16 As[2][BM * LDS];
  __shared__ __align__(16) bf16 Bs[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;

  // each tile is 128 rows x 32 elements = 512 chunks of 8 elements; K % 8
  // == 0 so a chunk is wholly inside or wholly outside the matrix
  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += GEMM_THREADS) {
      const int row = c >> 2, col = (c & 3) * 8, gk = k0 + col;
      const int gm = m0 + row, gn = n0 + row;
      const bool ok_a = gm < M && gk < K, ok_b = gn < N && gk < K;
      cp_async16(&As[stage][row * LDS + col], ok_a ? A + (long long)gm * K + gk : A, ok_a ? 16 : 0);
      cp_async16(&Bs[stage][row * LDS + col], ok_b ? B + (long long)gn * K + gk : B, ok_b ? 16 : 0);
    }
    cp_async_commit();
  };

  const int k_tiles = (K + BK - 1) / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < k_tiles) {
      load_tile(cur ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[cur];
    const bf16* bs = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(as + r * LDS + kk + tig * 2);
        af[mi][1] = *reinterpret_cast<const unsigned*>(as + (r + 8) * LDS + kk + tig * 2);
        af[mi][2] = *reinterpret_cast<const unsigned*>(as + r * LDS + kk + 8 + tig * 2);
        af[mi][3] = *reinterpret_cast<const unsigned*>(as + (r + 8) * LDS + kk + 8 + tig * 2);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bfr[ni][0] = *reinterpret_cast<const unsigned*>(bs + n * LDS + kk + tig * 2);
        bfr[ni][1] = *reinterpret_cast<const unsigned*>(bs + n * LDS + kk + 8 + tig * 2);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int m = m0 + wm * 64 + mi * 16 + g;
      const int n = n0 + wn * 32 + ni * 8 + tig * 2;  // N % 8 == 0: n + 1 < N iff n < N
      if (n < N) {
        if (m < M) store_pair<EPI>(ep, m, n, N, acc[mi][ni][0], acc[mi][ni][1]);
        if (m + 8 < M) store_pair<EPI>(ep, m + 8, n, N, acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
}

}  // namespace

extern "C" int jcf_bf16_gemm(const void* A, const void* B, void* out, int M, int N, int K,
                             int epilogue, const void* bias, const void* resid, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  Epilogue ep{static_cast<bf16*>(out), static_cast<const float*>(bias),
              static_cast<const bf16*>(resid)};
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_BIAS: bf16_gemm_kernel<EPI_BIAS><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    case EPI_RESID: bf16_gemm_kernel<EPI_RESID><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    case EPI_GELU: bf16_gemm_kernel<EPI_GELU><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
