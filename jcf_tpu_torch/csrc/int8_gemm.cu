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
//   EPI_ROWSCALE  bf16((acc * row_scale[m]) * scale[n] + bias[n])
//                 (the dynamic per-row int8 linear of the composable tower,
//                 jcf_tpu/ops/quant.py::int8_linear, in its op order)
// and, for the fused tower's dynamic activation scales, the fused
// kernels' op order (acc * scale[n]) * row_scale[m] + bias[n]
// (block_kernel.py::_int8_gemm), that is, y_r below:
//   EPI_BF16_ROWS   bf16(y_r)             (qkv; K5's K/V and CLS Q)
//   EPI_RESID_ROWS  bf16(resid + y_r)     (out-proj after a dynamic ctx,
//                                          c_proj after a dynamic hidden)
//   EPI_F32         f32(acc * scale[n] + bias[n])  (c_fc before a dynamic
//   EPI_F32_ROWS    f32(y_r)                        hidden quantization)
// and, for the f32 int8 text tower, whose residual stream stays f32
// through the halves (_attn_half_int8_kernel and _mlp_half_int8_kernel
// add the f32 projection to r.astype(f32) and store in the rows' dtype):
//   EPI_RESID_F32       f32(resid[m, n] + (acc * scale[n] + bias[n]))
//   EPI_RESID_ROWS_F32  f32(resid + y_r)
// Epilogue arithmetic uses the _rn intrinsics so it rounds exactly like
// the separate elementwise ops of the reference and the plain version.
//
// What bounds it on the H100: tensor-core throughput at the tower's
// shapes (M = 409,600 rows at b1024 x 8 views, K = 768 or 3072: far
// above the int8 ridge point), and only wgmma reaches the int8 rate. So
// the mainloop is Hopper's: blocks that walk the 128 x BN output tiles
// N-fastest (the blocks in flight share their A rows in L2), each block
// eight consumer warps (two warpgroups of 64 rows) and a producer warp.
// - The producer (one thread) loads 128-byte K slices of the A and B
//   tiles with TMA (2D boxes, 128-byte swizzle) into a ring of STAGES
//   stages, each guarded by a full and an empty mbarrier. TMA zero-fills
//   the boxes past M, N and K and still counts whole boxes, so every
//   stage expects STAGE_BYTES.
// - Each consumer warpgroup runs wgmma.mma_async m64nBNk32 s8 x s8 ->
//   s32, both operands K-major from shared memory (int8 wgmma takes no
//   transposed operand; A [M, K] and B [N, K] are K-major as stored), four
//   k32 steps a stage, one group in flight, and releases a stage once the
//   group that read it is done. While the consumers store one tile, the
//   producer already loads the next one's stages.
// - BN = 256 (one block an SM, 4 stages) reads the least of L2 for each
//   product, and serves the raw int32 product, whose epilogue is light
//   (the patch embed 1.46 ms against 1.65 at BN = 128 on an H100). Every
//   other epilogue holds the block's 8 warps while the tensor cores idle
//   (c_fc's GELU-quant 6.42 ms at BN = 256); BN = 128 (two blocks an SM,
//   3 stages each) gives 16 warps, one block's epilogue beside the
//   other's products (4.89 ms). Two consumer warpgroups on 64-row tiles in turn (ping-pong)
//   lost to both: B read twice as often, one warpgroup's epilogue stalls.
// - The epilogue stores from the accumulators: wgmma's m64nN s32 layout
//   gives each thread, per n8 column group, rows g and g + 8 of its
//   warp's 16 at columns 2t, 2t + 1, the pairs store_pair takes. The
//   int32 sums are exact, so every epilogue's output is that of any
//   exact product (the earlier mma.sync kernel's) bit for bit.
// BN (256 for the s32 epilogue, built for it alone; 128 for the others)
// and the grid come from the caller (ops/int8_gemm.py gemm_plan): from
// K = 2048 on, as many blocks as fit on the card at once
// (the producer loads the next tile while the consumers store this one);
// below it, one block a tile, whose blocks start apart and so keep their
// epilogues apart, where two persistent blocks on an SM run in step.
// The ring (its layout, barriers, producer and stage walk) and the TMA,
// mbarrier and descriptor helpers are wgmma_gemm.cuh's, shared with the
// bf16 and f32 GEMMs; the epilogues (store_pair) are int8_epilogue.cuh's,
// shared with the persistent int8 layer kernel (block_int8.cuh).
#include "int8_epilogue.cuh"

namespace {

constexpr int BM = GEMM_BM, BK = GEMM_BK_BYTES, CONSUMER_WARPS = GEMM_CONSUMER_WARPS;
constexpr int GEMM_THREADS = GEMM_THREADS_WG;

// BN = 256: one block an SM, a 4-stage ring; BN = 128: two blocks an SM
// (the one's epilogue beside the other's products), 3 stages each
template <int BN>
struct Tile : Ring<BN == 256 ? 4 : 3, BN, 1> {
  static constexpr int BLOCKS_PER_SM = BN == 256 ? 1 : 2;
};

// d (m64 x n256 s32, 128 a thread) += A (64 x 32 s8) * B (256 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_s8_n256(d, da, db);
  else
    wgmma_s8_n128(d, da, db);
}

template <int EPI, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, Tile<BN>::BLOCKS_PER_SM)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, int M, int N, int K, Epilogue ep) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full0 = ring + T::STAGES * T::STAGE_BYTES, empty0 = full0 + T::STAGES * 8;
  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * tiles_n;
  const int k_steps = (K + BK - 1) / BK;

  ring_init<T>(full0, empty0);
  if (tid >= 32 * CONSUMER_WARPS) {
    // the producer warp: one thread keeps the ring full
    if (tid == 32 * CONSUMER_WARPS)
      ring_produce<T>(&map_a, &map_b, nullptr, tiles, tiles_n, k_steps, ring, full0, empty0);
  } else {
    const int cw = tid >> 7;  // consumer warpgroup: rows 64 cw of the tile
    const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, tig = lane & 3;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int held = -1;  // the stage the group in flight reads
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(full0 + 8 * stage, phase);
        __syncwarp();  // the warp issues the .aligned wgmma instructions together
        const uint32_t a = ring + stage * T::STAGE_BYTES + cw * 64 * BK;
        const uint32_t b = ring + stage * T::STAGE_BYTES + T::A_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        fence_acc(acc);
        if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);
        held = stage;
        ring_advance(stage, phase, T::STAGES);
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
}

template <int EPI, int BN>
int launch_gemm(const void* A, const void* B, int M, int N, int K, int blocks, const Epilogue& ep,
                cudaStream_t s) {
  CUtensorMap map_a, map_b;
  int err = tensor_map(&map_a, A, M, K, BM);
  if (!err) err = tensor_map(&map_b, B, N, K, BN);
  if (!err) err = set_smem(int8_gemm_kernel<EPI, BN>, Tile<BN>::SMEM);
  if (err) return err;
  int8_gemm_kernel<EPI, BN><<<blocks, GEMM_THREADS, Tile<BN>::SMEM, s>>>(map_a, map_b, M, N, K, ep);
  return (int)cudaGetLastError();
}

}  // namespace

// bn: the N tile, 256 for EPI_S32 only, else 128; blocks: the grid, which
// walks the ceil(M / 128) x ceil(N / bn) tiles N-fastest. TMA takes
// 16-byte aligned A and B only (K % 16 == 0 keeps every row aligned)
extern "C" int jcf_int8_gemm(const void* A, const void* B, void* out, int M, int N, int K,
                             int epilogue, const void* scale, const void* bias,
                             const void* resid, const void* gelu_c, const void* row_scale,
                             int bn, int blocks, void* stream) {
  if (M < 1 || N < 8 || N % 8 || K < 16 || K % 16 || blocks < 1 || ((uintptr_t)A & 15) ||
      ((uintptr_t)B & 15) || (bn != 128 && !(bn == 256 && epilogue == EPI_S32)))
    return (int)cudaErrorInvalidValue;
  Epilogue ep{out, static_cast<const float*>(scale), static_cast<const float*>(bias),
              resid, static_cast<const float*>(gelu_c),
              static_cast<const float*>(row_scale)};
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 256) return launch_gemm<EPI_S32, 256>(A, B, M, N, K, blocks, ep, s);
  switch (epilogue) {
#define JCF_EPI(E) \
  case E: return launch_gemm<E, 128>(A, B, M, N, K, blocks, ep, s);
    JCF_EPI(EPI_S32)
    JCF_EPI(EPI_BF16)
    JCF_EPI(EPI_RESID)
    JCF_EPI(EPI_GELU_Q)
    JCF_EPI(EPI_ROWSCALE)
    JCF_EPI(EPI_BF16_ROWS)
    JCF_EPI(EPI_RESID_ROWS)
    JCF_EPI(EPI_F32)
    JCF_EPI(EPI_F32_ROWS)
    JCF_EPI(EPI_RESID_F32)
    JCF_EPI(EPI_RESID_ROWS_F32)
#undef JCF_EPI
    default: return (int)cudaErrorInvalidValue;
  }
}
