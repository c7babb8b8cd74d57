// f32 x f32 -> f32 GEMM with fused epilogues on the tensor cores, each
// product as three TF32 products: the products of the f32 tower halves.
//
// C[m, n] = sum_k A[m, k] * B[n, k] for A [M, K] f32 row-major
// activations and B [N, K] f32 row-major weights ([out, in]). Replaces the
// f32 dot_generals of jcf_tpu/ops/block_kernel.py::_attn_half_kernel
// (qkv, out-proj) and ::_mlp_half_kernel (c_fc, c_proj), which the TPU
// runs inside those kernels at Precision.HIGHEST, itself several bf16
// passes of its matrix unit. Epilogues (bias in f32):
//   EPI_BIAS   acc + bias[n]                                        (qkv)
//   EPI_RESID  resid[m, n] + (acc + bias[n])              (out-proj, c_proj)
//   EPI_GELU   h * (0.5 + 0.5 tanh(0.851 h)), h = acc + bias[n]     (c_fc;
//              QuickGELU in the tanh form of _quick_gelu32)
// The epilogue arithmetic uses the _rn intrinsics so it rounds like the
// reference's separate elementwise ops.
//
// The split. Each operand x is hi + lo, hi = tf32(x), lo = tf32(x - hi),
// both rounded to nearest with ties away from zero as cvt.rna.tf32.f32
// does (tf32_rna: two integer ops on the bits; x - hi is exact in f32).
// Then |x - hi - lo| <= 2^-22 |x| (while x - hi is a normal number), and
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (the small products first) is
// off by about 3 2^-22 |a b|. Each TF32 product of 10-bit mantissas is
// exact in f32, but the tensor cores' adds into the accumulator truncate:
// one accumulator over K = 3072 (1152 wgmma adds) drifts past the f32 bar
// of the kernel against its FMA plain version (1e-5 + 1e-5 |ref| + 1e-6
// sum_k |a w|; seen on an H100). So each 32-deep stage of K sums its 12
// products into a fresh partial (wgmma's scale-d 0 starts it), and the
// partial joins the tile's sum by an f32 add rounded to nearest.
// - B (the weights) comes split: tf32_split_kernel below writes its hi and
//   lo planes [2, N, K] once a layer and weight, when a tree is made for
//   serving (ops/f32_gemm.py with_tf32_planes), never once a call.
// - A (the activations) is split in the consumer warps: wgmma takes A from
//   registers, so each thread reads its fragment out of the swizzled tile
//   in shared memory, splits it and hands wgmma both halves; the
//   activations are read once and never written split.
//
// What bounds it on the H100: the TF32 rate (495 TFLOP/s, 165 for f32
// products three passes each) at the towers' shapes (8192 crops x 50 rows:
// 2 x 409,600 x 768 x 2304 flops for qkv). The mainloop is the GEMMs' of
// wgmma_gemm.cuh: a producer thread in a ninth warp loads 128-byte K slices
// (32 floats) of A and of both B planes by TMA (2D boxes, 128-byte
// swizzle) into a ring of 4 stages of 48 KB; two consumer warpgroups (64
// rows each of a 128 x 128 tile) run per k8 step three
// wgmma.mma_async m64n128k8 f32 += tf32 x tf32 (A from registers, B
// K-major from shared memory) as one group, one group in flight while the
// next step's fragment is read and split; at the stage's end they wait for
// its last group, release the stage and fold the partial in. One block an
// SM (the ring, the 64 accumulators and the 64 partial sums do not fit
// twice), the grid persistent at every K (ops/f32_gemm.py gemm_plan), so
// the producer loads the next tile while the consumers store this one;
// two blocks an SM with 2 stages each and one accumulator were no faster
// (an H100). The epilogue stores from the accumulators (wgmma's m64nN f32
// layout: per n8 column group rows g and g + 8 of the warp's 16, columns
// 2t, 2t + 1).
#include "wgmma_gemm.cuh"

namespace {

enum { EPI_BIAS = 0, EPI_RESID = 1, EPI_GELU = 2 };

constexpr int BN = 128;
constexpr int BLOCKS_PER_SM = 1;
using R = Ring<4, BN, 2>;

struct Epilogue {
  float* out;          // [M, N]
  const float* bias;   // [N]
  const float* resid;  // [M, N]
};

template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float bias, float resid) {
  const float h = __fadd_rn(acc, bias);
  if (EPI == EPI_GELU)
    return __fmul_rn(h, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(0.851f, h)))));
  if (EPI == EPI_RESID) return __fadd_rn(resid, h);
  return h;
}

template <int EPI>
__device__ __forceinline__ void store_pair(const Epilogue& ep, int m, int n, int N, float v0,
                                           float v1) {
  const long long idx = (long long)m * N + n;
  float2 r = make_float2(0.0f, 0.0f);
  if (EPI == EPI_RESID) r = *reinterpret_cast<const float2*>(ep.resid + idx);
  *reinterpret_cast<float2*>(ep.out + idx) =
      make_float2(epilogue<EPI>(v0, ep.bias[n], r.x), epilogue<EPI>(v1, ep.bias[n + 1], r.y));
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS_WG, BLOCKS_PER_SM)
    f32_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_hi,
                    const __grid_constant__ CUtensorMap map_lo, int M, int N, int K, Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full0 = ring + R::STAGES * R::STAGE_BYTES, empty0 = full0 + R::STAGES * 8;
  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + GEMM_BM - 1) / GEMM_BM) * tiles_n;
  const int k_steps = (4 * K + GEMM_BK_BYTES - 1) / GEMM_BK_BYTES;

  ring_init<R>(full0, empty0);
  if (tid >= 32 * GEMM_CONSUMER_WARPS) {
    if (tid == 32 * GEMM_CONSUMER_WARPS)
      ring_produce<R>(&map_a, &map_hi, &map_lo, tiles, tiles_n, k_steps, ring, full0, empty0);
    return;
  }
  const int cw = tid >> 7;  // consumer warpgroup: rows 64 cw of the tile
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, tig = lane & 3;
  // wgmma's tf32 A fragment of a k8 step: a0 (row g, k t), a1 (g + 8, t),
  // a2 (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows. Step kk reads
  // the 16-byte chunks 2 kk and 2 kk + 1 of rows g and g + 8, which the
  // 128-byte swizzle moves to chunk ^ g (both rows are g mod 8): the 32
  // lanes hit 32 banks.
  const uint32_t row_off = (uint32_t)(cw * 64 + warp * 16 + g) * GEMM_BK_BYTES + 4 * tig;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * GEMM_BM, n0 = (t % tiles_n) * BN;
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;
    uint32_t hi[2][4], lo[2][4];  // two k8 steps' fragments
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      __syncwarp();  // the warp issues the .aligned wgmma instructions together
      const uint32_t base = ring + stage * R::STAGE_BYTES;
      const uint32_t a = base + row_off;
      const uint32_t b_hi = base + R::A_BYTES, b_lo = b_hi + R::B_BYTES;
#pragma unroll
      for (int kk = 0; kk < GEMM_BK_BYTES / 32; ++kk) {
        const uint32_t c0 = (uint32_t)((2 * kk) ^ g) << 4, c1 = (uint32_t)((2 * kk + 1) ^ g) << 4;
        const uint32_t x[4] = {lds_u32(a + c0), lds_u32(a + 8 * GEMM_BK_BYTES + c0), lds_u32(a + c1),
                               lds_u32(a + 8 * GEMM_BK_BYTES + c1)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[kk & 1][i] = tf32_rna(x[i]);
          lo[kk & 1][i] =
              tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(x[i]), __uint_as_float(hi[kk & 1][i]))));
        }
        fence_acc(part);
        wgmma_fence();
        // the stage's first product starts the partial sum afresh
        wgmma_tf32_n128(part, lo[kk & 1], sw128_desc(b_hi + 32 * kk), kk > 0);
        wgmma_tf32_n128(part, hi[kk & 1], sw128_desc(b_lo + 32 * kk), 1);
        wgmma_tf32_n128(part, hi[kk & 1], sw128_desc(b_hi + 32 * kk), 1);
        wgmma_commit();
        fence_acc(part);
        wgmma_wait<1>();
        fence_acc(part);
      }
      wgmma_wait<0>();
      fence_acc(part);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      // the stage's 12 products (32 of K) into the tile's sum, rounded to
      // nearest: the tensor cores' own adds truncate, so over K = 3072 in
      // one accumulator their error would pass the f32 bar
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      ring_advance(stage, phase, R::STAGES);
    }

    const int m = m0 + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + j * 8 + tig * 2;  // N % 4 == 0: n + 1 < N iff n < N
      if (n < N) {
        if (m < M) store_pair<EPI>(ep, m, n, N, acc[4 * j], acc[4 * j + 1]);
        if (m + 8 < M) store_pair<EPI>(ep, m + 8, n, N, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int EPI>
int launch_gemm(const void* A, const float* hi, int M, int N, int K, int blocks, const Epilogue& ep,
                cudaStream_t s) {
  CUtensorMap map_a, map_hi, map_lo;
  int err = tensor_map(&map_a, A, M, 4LL * K, GEMM_BM);
  if (!err) err = tensor_map(&map_hi, hi, N, 4LL * K, BN);
  if (!err) err = tensor_map(&map_lo, hi + (long long)N * K, N, 4LL * K, BN);
  if (!err) err = set_smem(f32_gemm_kernel<EPI>, R::SMEM);
  if (err) return err;
  f32_gemm_kernel<EPI><<<blocks, GEMM_THREADS_WG, R::SMEM, s>>>(map_a, map_hi, map_lo, M, N, K, ep);
  return (int)cudaGetLastError();
}

// w -> its hi plane (out[0, n)) and lo plane (out[n, 2n)), four floats a
// thread
__global__ void tf32_split_kernel(const float4* __restrict__ w, float4* __restrict__ out,
                                  long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 x = w[i];
  const uint32_t h0 = tf32_rna(__float_as_uint(x.x)), h1 = tf32_rna(__float_as_uint(x.y));
  const uint32_t h2 = tf32_rna(__float_as_uint(x.z)), h3 = tf32_rna(__float_as_uint(x.w));
  out[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(h2),
                       __uint_as_float(h3));
  out[n4 + i] = make_float4(
      __uint_as_float(tf32_rna(__float_as_uint(__fsub_rn(x.x, __uint_as_float(h0))))),
      __uint_as_float(tf32_rna(__float_as_uint(__fsub_rn(x.y, __uint_as_float(h1))))),
      __uint_as_float(tf32_rna(__float_as_uint(__fsub_rn(x.z, __uint_as_float(h2))))),
      __uint_as_float(tf32_rna(__float_as_uint(__fsub_rn(x.w, __uint_as_float(h3))))));
}

}  // namespace

// split: the [2, N, K] hi and lo planes of B (jcf_tf32_split); blocks: the
// grid, which walks the ceil(M / 128) x ceil(N / 128) tiles N-fastest. TMA
// takes 16-byte aligned A and planes with 16-byte rows only (K % 4 == 0);
// the epilogue stores column pairs (N % 4 == 0)
extern "C" int jcf_f32_gemm(const void* A, const void* split, void* out, int M, int N, int K,
                            int epilogue, const void* bias, const void* resid, int blocks,
                            void* stream) {
  if (M < 1 || N < 4 || N % 4 || K < 4 || K % 4 || blocks < 1 || ((uintptr_t)A & 15) ||
      ((uintptr_t)split & 15))
    return (int)cudaErrorInvalidValue;
  Epilogue ep{static_cast<float*>(out), static_cast<const float*>(bias),
              static_cast<const float*>(resid)};
  const float* hi = static_cast<const float*>(split);
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_BIAS: return launch_gemm<EPI_BIAS>(A, hi, M, N, K, blocks, ep, s);
    case EPI_RESID: return launch_gemm<EPI_RESID>(A, hi, M, N, K, blocks, ep, s);
    case EPI_GELU: return launch_gemm<EPI_GELU>(A, hi, M, N, K, blocks, ep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// w [n] f32 (n % 4 == 0, 16-byte aligned) -> out [2, n]: tf32(w), then
// tf32(w - tf32(w))
extern "C" int jcf_tf32_split(const void* w, void* out, long long n, void* stream) {
  if (n < 4 || n % 4 || ((uintptr_t)w & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const int threads = 256;
  tf32_split_kernel<<<(unsigned)((n4 + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(w), static_cast<float4*>(out), n4);
  return (int)cudaGetLastError();
}
