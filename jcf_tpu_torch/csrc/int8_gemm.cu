// int8 x int8 -> int32 tensor-core GEMM with fused epilogues.
//
// C[m, n] = sum_k A[m, k] * B[n, k] for A [M, K] int8 row-major
// activations and B [N, K] int8 row-major weights ([out, in], the JAX
// layout), accumulated exactly in int32. Replaces the s8 x s8 -> s32
// products of jcf_tpu/ops/block_kernel.py::_attn_half_int8_kernel (qkv,
// out-proj) and ::_mlp_half_int8_kernel (c_fc, c_proj), which the TPU
// runs inside those kernels, and the patch-embed product (an XLA conv in
// jcf_tpu/infer/engine.py). The epilogue is a template argument:
//   EPI_S32       raw int32 (patch embed; K2 applies the scale and bias)
//   EPI_BF16      bf16(acc * scale[n] + bias[n])                  (qkv)
//   EPI_RESID     bf16(resid[m, n] + (acc * scale[n] + bias[n]))  (out-proj, c_proj)
//   EPI_GELU_Q    int8 round(h * (0.5 + 0.5 tanh(c h))), h = acc * scale[n] + bias[n]
//                 (c_fc: the static hidden scale is pre-folded into scale
//                 and bias, so QuickGELU runs in the quantized domain,
//                 _gelu_quant_static)
// Epilogue arithmetic uses the _rn intrinsics so it rounds exactly like
// the separate elementwise ops of the reference and the plain version.
//
// What bounds it on the H100: tensor-core throughput at the tower's
// shapes (M = 409,600 rows at b1024 x 8 views, K = 768 or 3072: far
// above the int8 ridge point). This first version uses warp-level
// mma.sync m16n8k32 (s8, s32 accumulation) from a two-stage cp.async
// ring in shared memory: 128x128
// block tiles, 64-deep K steps, eight warps of 64x32 each. Rows of the
// shared tiles are padded to 80 bytes so the fragment loads are free of
// bank conflicts. wgmma with TMA, which reaches the full int8 rate, is a
// later step.
#include "common.cuh"

namespace {

enum { EPI_S32 = 0, EPI_BF16 = 1, EPI_RESID = 2, EPI_GELU_Q = 3 };

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // padded shared row, bytes
constexpr int GEMM_THREADS = 256;

struct Epilogue {
  void* out;               // [M, N] int32 / bf16 / int8
  const float* scale;      // [N]
  const float* bias;       // [N]
  const bf16* resid;       // [M, N]
  const float* gelu_c;     // scalar: 0.851 / h_inv
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int EPI>
__device__ __forceinline__ void store_pair(const Epilogue& ep, int m, int n, int N, int v0, int v1) {
  const long long idx = (long long)m * N + n;
  if (EPI == EPI_S32) {
    *reinterpret_cast<int2*>(static_cast<int32_t*>(ep.out) + idx) = make_int2(v0, v1);
    return;
  }
  const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(v0), ep.scale[n]), ep.bias[n]);
  const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(v1), ep.scale[n + 1]), ep.bias[n + 1]);
  if (EPI == EPI_BF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + idx) =
        __floats2bfloat162_rn(y0, y1);
  } else if (EPI == EPI_RESID) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(ep.resid + idx);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + idx) =
        __floats2bfloat162_rn(__fadd_rn(__low2float(r), y0), __fadd_rn(__high2float(r), y1));
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

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) int8_gemm_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N, int K,
    Epilogue ep) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  // each tile is 128 rows x 64 bytes = 512 chunks of 16 bytes; K % 16 == 0
  // so a chunk is wholly inside or wholly outside the matrix (zero-filled)
  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int c = tid; c < BM * BK / 16; c += GEMM_THREADS) {
      const int row = c >> 2, col = (c & 3) * 16, gk = k0 + col;
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
    const int8_t* as = As[cur];
    const int8_t* bs = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(as + r * LDS + kk + tig * 4);
        af[mi][1] = *reinterpret_cast<const unsigned*>(as + (r + 8) * LDS + kk + tig * 4);
        af[mi][2] = *reinterpret_cast<const unsigned*>(as + r * LDS + kk + 16 + tig * 4);
        af[mi][3] = *reinterpret_cast<const unsigned*>(as + (r + 8) * LDS + kk + 16 + tig * 4);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bfr[ni][0] = *reinterpret_cast<const unsigned*>(bs + n * LDS + kk + tig * 4);
        bfr[ni][1] = *reinterpret_cast<const unsigned*>(bs + n * LDS + kk + 16 + tig * 4);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
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

extern "C" int jcf_int8_gemm(const void* A, const void* B, void* out, int M, int N, int K,
                             int epilogue, const void* scale, const void* bias,
                             const void* resid, const void* gelu_c, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  Epilogue ep{out, static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<const bf16*>(resid), static_cast<const float*>(gelu_c)};
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_S32: int8_gemm_kernel<EPI_S32><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    case EPI_BF16: int8_gemm_kernel<EPI_BF16><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    case EPI_RESID: int8_gemm_kernel<EPI_RESID><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    case EPI_GELU_Q: int8_gemm_kernel<EPI_GELU_Q><<<grid, GEMM_THREADS, 0, s>>>(a, b, M, N, K, ep); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
