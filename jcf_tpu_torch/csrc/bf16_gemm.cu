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
// What bounds it on the H100: tensor-core throughput. The products of the
// text tower (512 prompts x 77 tokens: M = 39,424, K = 512 or 2048) and
// of the vision tower (8192 crops x 50: M = 409,600, K = 768 or 3072) sit
// far above the bf16 ridge point, and only wgmma reaches the bf16 rate. So
// the mainloop is the int8 GEMM's (int8_gemm.cu) at bf16, on the helpers
// of wgmma_gemm.cuh:
// - a producer thread in a ninth warp loads 128-byte K slices (64 bf16) of
//   the A and B tiles with TMA (2D boxes, 128-byte swizzle) into a ring of
//   3 stages, each guarded by a full and an empty mbarrier;
// - two consumer warpgroups (64 rows each of a 128 x 128 tile) run
//   wgmma.mma_async m64n128k16 f32 += bf16 x bf16, both operands K-major
//   from shared memory as stored, four k16 steps a stage, one group in
//   flight; a stage is released once the group that read it is done;
// - BN = 128 and two blocks an SM (32 KB a stage): one block's epilogue
//   runs beside the other's products. The 128 x 128 tile loads a byte of
//   stage for every 64 flops: at 41-46% of the bf16 rate the vision
//   products already pull 6.2-7.2 TB/s out of L2 (an H100), which seems
//   to be the bound. BN = 256 at one block an SM loads a quarter less but
//   stalls the tensor cores in the epilogue; it was slower at every shape
//   but vision c_proj;
// - the epilogue stores from the accumulators: wgmma's m64nN f32 layout
//   gives each thread, per n8 column group, rows g and g + 8 of its warp's
//   16 at columns 2t, 2t + 1, the pairs store_pair takes.
// The grid comes from the caller (ops/bf16_gemm.py gemm_plan): from K =
// 2048 on, as many blocks as fit on the card at once, each walking the
// tiles N-fastest (the producer loads the next tile while the consumers
// store this one); below it, one block a tile. wgmma sums each k16 step in
// another order than the earlier mma.sync kernel, so an output may move by
// a bf16 tie.
#include "wgmma_gemm.cuh"

namespace {

enum { EPI_BIAS = 0, EPI_RESID = 1, EPI_GELU = 2 };

constexpr int BN = 128;
using R = Ring<3, BN, 1>;

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
__global__ void __launch_bounds__(GEMM_THREADS_WG, 2)
    bf16_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, int M, int N, int K, Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full0 = ring + R::STAGES * R::STAGE_BYTES, empty0 = full0 + R::STAGES * 8;
  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + GEMM_BM - 1) / GEMM_BM) * tiles_n;
  const int k_steps = (2 * K + GEMM_BK_BYTES - 1) / GEMM_BK_BYTES;

  ring_init<R>(full0, empty0);
  if (tid >= 32 * GEMM_CONSUMER_WARPS) {
    if (tid == 32 * GEMM_CONSUMER_WARPS)
      ring_produce<R>(&map_a, &map_b, nullptr, tiles, tiles_n, k_steps, ring, full0, empty0);
    return;
  }
  const int cw = tid >> 7;  // consumer warpgroup: rows 64 cw of the tile
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, tig = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * GEMM_BM, n0 = (t % tiles_n) * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int held = -1;  // the stage the group in flight reads
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      __syncwarp();  // the warp issues the .aligned wgmma instructions together
      const uint32_t a = ring + stage * R::STAGE_BYTES + cw * 64 * GEMM_BK_BYTES;
      const uint32_t b = ring + stage * R::STAGE_BYTES + R::A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GEMM_BK_BYTES / 32; ++kk)
        wgmma_bf16_n128(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();
      fence_acc(acc);
      if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);
      held = stage;
      ring_advance(stage, phase, R::STAGES);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);

    const int m = m0 + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + j * 8 + tig * 2;  // N % 8 == 0: n + 1 < N iff n < N
      if (n < N) {
        if (m < M) store_pair<EPI>(ep, m, n, N, acc[4 * j], acc[4 * j + 1]);
        if (m + 8 < M) store_pair<EPI>(ep, m + 8, n, N, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int EPI>
int launch_gemm(const void* A, const void* B, int M, int N, int K, int blocks, const Epilogue& ep,
                cudaStream_t s) {
  CUtensorMap map_a, map_b;
  int err = tensor_map(&map_a, A, M, 2LL * K, GEMM_BM);
  if (!err) err = tensor_map(&map_b, B, N, 2LL * K, BN);
  if (!err) err = set_smem(bf16_gemm_kernel<EPI>, R::SMEM);
  if (err) return err;
  bf16_gemm_kernel<EPI><<<blocks, GEMM_THREADS_WG, R::SMEM, s>>>(map_a, map_b, M, N, K, ep);
  return (int)cudaGetLastError();
}

}  // namespace

// blocks: the grid, which walks the ceil(M / 128) x ceil(N / 128) tiles
// N-fastest. TMA takes 16-byte aligned A and B with 16-byte rows only
// (K % 8 == 0); the epilogue stores column pairs (N % 8 == 0)
extern "C" int jcf_bf16_gemm(const void* A, const void* B, void* out, int M, int N, int K,
                             int epilogue, const void* bias, const void* resid, int blocks,
                             void* stream) {
  if (M < 1 || N < 8 || N % 8 || K < 8 || K % 8 || blocks < 1 || ((uintptr_t)A & 15) ||
      ((uintptr_t)B & 15))
    return (int)cudaErrorInvalidValue;
  Epilogue ep{static_cast<bf16*>(out), static_cast<const float*>(bias),
              static_cast<const bf16*>(resid)};
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_BIAS: return launch_gemm<EPI_BIAS>(A, B, M, N, K, blocks, ep, s);
    case EPI_RESID: return launch_gemm<EPI_RESID>(A, B, M, N, K, blocks, ep, s);
    case EPI_GELU: return launch_gemm<EPI_GELU>(A, B, M, N, K, blocks, ep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
