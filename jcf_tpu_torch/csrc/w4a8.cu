// Probe P1's kernels: one MLP half with int4 weights
// (jcf_tpu_torch/scripts/exp_w4a8.py). The weights are int4 values in
// [-8, 7] packed two to a byte: byte j of a row of c columns holds column
// j in its low nibble and column j + c/2 in its high one.
//
// w4a8_gemm replaces the int4 products of k_w4_step
// (scripts/exp_w4a8.py:87, pallas_call :121), which unpacks both weights
// to int8 on every grid step and runs the int8 MLP math on them. Here it
// is the port's int8 GEMM (int8_gemm.cu: mma.sync m16n8k32 s8 with s32
// sums, 128 x 128 block tiles, eight warps of 64 x 32, 80-byte padded
// shared rows) with B read from the packed bytes: C[m, n] = sum_k A[m, k]
// * W[n, k] for A [M, K] int8 and W [N, K] given as packed [N, K/2]. A
// step takes packed columns j0..j0+31: one 16-byte load a thread carries
// 32 nibbles of one row, k = j0.. in the low nibbles and k = K/2 + j0..
// in the high ones. The load goes through registers, where each nibble is
// sign-extended to a byte (four at a time with __vsub4), and is stored to
// shared memory as the 64-deep int8 tile of k = j0..j0+31 and K/2 +
// j0..j0+31; A's tile (cp.async, two stages) takes the same k. The sum
// runs over k in another order, exact in int32, so the result equals the
// int8 GEMM's on the unpacked weights bit for bit. Its epilogues are
// int8_gemm.cu's EPI_GELU_Q (c_fc) and EPI_RESID (c_proj), the same
// arithmetic. The B ring of the int8 GEMM's cp.async becomes a register
// stage: the next step's packed load is in flight over this step's mma.
//
// unpack_int4 replaces k_w4_cache's unpack into VMEM scratch at grid step
// 0 (:93, pallas_call :124). Blocks run in no order and none holds the
// 2.4 MB weight, so "once a call" is a kernel of its own before the int8
// GEMMs: packed [N, K/2] -> int8 [N, K], one 16-byte load and two 16-byte
// stores a thread.
//
// What bounds them on the H100: w4a8_gemm the int8 tensor-core rate at
// the probe's shapes (M = 409,600 rows, K = 768 or 3072), as the int8
// GEMM; it reads half the weight bytes, which the int8 GEMM's blocks
// fetch from L2 anyway. unpack_int4 bytes (3 x N x K/2).
#include "common.cuh"

namespace {

enum { W4_GELU_Q = 0, W4_RESID = 1 };

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // padded shared row, bytes
constexpr int THREADS = 256;
constexpr int STEP_BYTES = BK / 2;  // packed bytes of a row per step

struct Epilogue {
  void* out;            // [M, N] int8 (W4_GELU_Q) or bf16 (W4_RESID)
  const float* scale;   // [N]
  const float* bias;    // [N]
  const bf16* resid;    // [M, N] bf16
  const float* gelu_c;  // scalar
};

// int8_gemm.cu's store_pair for EPI_GELU_Q and EPI_RESID, op for op
template <int EPI>
__device__ __forceinline__ void store_pair(const Epilogue& ep, int m, int n, int N, int v0, int v1) {
  const long long idx = (long long)m * N + n;
  float y0 = __fmul_rn(__int2float_rn(v0), ep.scale[n]);
  float y1 = __fmul_rn(__int2float_rn(v1), ep.scale[n + 1]);
  y0 = __fadd_rn(y0, ep.bias[n]);
  y1 = __fadd_rn(y1, ep.bias[n + 1]);
  if (EPI == W4_RESID) {
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

// four packed bytes -> their four low / high nibbles as signed bytes
__device__ __forceinline__ unsigned sext_lo(unsigned w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ unsigned sext_hi(unsigned w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

template <int EPI>
__global__ void __launch_bounds__(THREADS) w4a8_gemm_kernel(
    const int8_t* __restrict__ A, const uint8_t* __restrict__ W4, int M, int N, int K,
    Epilogue ep) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half = K / 2;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  // A's tile of step t: columns t*32..+31 to tile columns 0..31 and K/2 +
  // t*32..+31 to 32..63; 512 chunks of 16 bytes, rows >= M zero-filled
  auto load_a = [&](int stage, int t) {
#pragma unroll
    for (int c = tid; c < BM * BK / 16; c += THREADS) {
      const int row = c >> 2, q = c & 3, col = q * 16;
      const int gk = (q >= 2 ? half : 0) + t * STEP_BYTES + (q & 1) * 16;
      const int gm = m0 + row;
      const bool ok = gm < M;
      cp_async16(&As[stage][row * LDS + col], ok ? A + (long long)gm * K + gk : A, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // W's packed bytes of step t: thread tid takes 16 bytes of row tid / 2
  const int b_row = tid >> 1, b_col = (tid & 1) * 16;
  const int b_n = n0 + b_row;
  uint4 breg;
  auto load_b = [&](int t) {
    breg = b_n < N ? __ldg(reinterpret_cast<const uint4*>(W4 + (long long)b_n * half +
                                                          t * STEP_BYTES + b_col))
                   : make_uint4(0u, 0u, 0u, 0u);
  };
  auto store_b = [&](int stage) {
    int8_t* dst = &Bs[stage][b_row * LDS + b_col];
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(sext_lo(breg.x), sext_lo(breg.y), sext_lo(breg.z), sext_lo(breg.w));
    *reinterpret_cast<uint4*>(dst + STEP_BYTES) =
        make_uint4(sext_hi(breg.x), sext_hi(breg.y), sext_hi(breg.z), sext_hi(breg.w));
  };

  const int steps = half / STEP_BYTES;
  load_a(0, 0);
  load_b(0);
  store_b(0);
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) {
      load_a(cur ^ 1, t + 1);
      load_b(t + 1);
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
    // the next step's B tile: its stage was last read before the previous
    // step's closing barrier
    if (t + 1 < steps) store_b(cur ^ 1);
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

__global__ void unpack_int4_kernel(const uint4* __restrict__ packed, int8_t* __restrict__ out,
                                   int N, int half) {
  const int per_row = half / 16;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * per_row) return;
  const long long n = i / per_row;
  const int j = (int)(i % per_row) * 16;
  const uint4 w = packed[i];
  int8_t* row = out + n * 2 * half;
  *reinterpret_cast<uint4*>(row + j) = make_uint4(sext_lo(w.x), sext_lo(w.y), sext_lo(w.z),
                                                  sext_lo(w.w));
  *reinterpret_cast<uint4*>(row + half + j) =
      make_uint4(sext_hi(w.x), sext_hi(w.y), sext_hi(w.z), sext_hi(w.w));
}

}  // namespace

extern "C" {

// A int8 [M, K], W4 packed int8 [N, K/2] (K % 64 == 0, N % 8 == 0, both
// 16-byte aligned); epilogue 0: int8 GELU-quant out [M, N] (gelu_c a
// scalar), 1: bf16 resid + ... out [M, N]. Returns a cudaError_t.
int jcf_w4a8_gemm(const void* A, const void* W4, void* out, int M, int N, int K, int epilogue,
                  const void* scale, const void* bias, const void* resid, const void* gelu_c,
                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 64 != 0 || N % 8 != 0 ||
      ((uintptr_t)A | (uintptr_t)W4) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  Epilogue ep{out, static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<const bf16*>(resid), static_cast<const float*>(gelu_c)};
  const int8_t* a = static_cast<const int8_t*>(A);
  const uint8_t* w = static_cast<const uint8_t*>(W4);
  cudaStream_t s = (cudaStream_t)stream;
  if (epilogue == W4_GELU_Q)
    w4a8_gemm_kernel<W4_GELU_Q><<<grid, THREADS, 0, s>>>(a, w, M, N, K, ep);
  else if (epilogue == W4_RESID)
    w4a8_gemm_kernel<W4_RESID><<<grid, THREADS, 0, s>>>(a, w, M, N, K, ep);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// packed int8 [N, K/2] -> int8 [N, K] (K/2 % 16 == 0, 16-byte aligned).
int jcf_unpack_int4(const void* packed, void* out, int N, int K, void* stream) {
  if (N <= 0 || K <= 0 || (K / 2) % 16 != 0 || K % 2 != 0 ||
      ((uintptr_t)packed | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long chunks = (long long)N * (K / 32);
  unpack_int4_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(packed), static_cast<int8_t*>(out), N, K / 2);
  return (int)cudaGetLastError();
}

}  // extern "C"
