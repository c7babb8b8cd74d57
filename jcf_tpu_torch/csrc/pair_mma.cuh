// The mask-free paired attention on the tensor cores, one template for
// every output form: K3's attention of the int8 halves (block.cu: the
// static int8 context and the f32 context of a dynamic one), K6a's bf16
// pair attention (text_block.cu: the bf16 context), and the attention
// phase of the persistent int8 layer kernel (block_int8.cuh: its staging
// and row bodies, pair_stage and pair_rows, with q read through L2). It replaces the
// attention section of jcf_tpu/ops/block_kernel.py::_attn_half_int8_kernel
// and ::_attn_half_kernel, _paired_attention_nomask, for bf16 qkv at head
// dim 64. Per crop and head pair (lo, hi), as the row loop of
// pair_attention.cuh:
//   s     = q . k [* scale]                 (SCALED: the unfolded tree and
//                                            the float towers)
//   m     = max(floor, max over both heads' keys of s), or the layer's
//           calibrated shift (SHIFT: no max, no floor)
//   p     = bf16(exp(s - m)),  l = sum_j p (per head, f32 sums of bf16 p)
//   out   = int8(round(ctx_u * (ctx_inv / max(l, 1e-30))))   (O = int8_t)
//         = O(ctx_u * (1 / max(l, 1e-30)))                    (O = f32, bf16)
// with ctx_u = sum_j p_j v_j.
//
// A unit is one (crop, pair); a block holds PM_UNITS units, four warps
// each. The block stages each unit's K and V, [16 NC keys, 128] bf16 for
// both heads, with 16-byte cp.async from the packed [crops * S, 3E] rows
// (rows past S zero-filled). A warp takes a 16-row query tile of both
// heads: its q fragments from device memory, both heads' scores in
// registers through qk_chunk (exact bf16 products, f32 sums per k16 step:
// another order than the reference's, so a p near a bf16 tie may round to
// the other side; the bars of these contexts allow that, K7's bf16
// forward's does not and takes scores_seq), the pair shift as the max
// over both heads' registers and the quad shuffle, then the floor; the
// rounded p go straight into PV's A fragments (V through ldmatrix.trans),
// l is the quad's sum of the same rounded p, and each head's context
// leaves in 16-byte stores of packed rows (8-byte for f32). The
// calibrated shift needs no max, so there one head's scores go through
// PV before the other's are taken: half the live scores (with both heads
// held, the "+score" instance spilled 56 bytes and ran 9% slower than the
// pair max; ab_attention.py, H100 80GB HBM3, 700 W).
//
// Bound on the H100: bytes. At 8192 crops x 50 tokens a pair reads q, k,
// v (4 x 50 x 128 x 2 B with the context) against 4 x 50 x 50 x 128 flop
// of products: 25 flop a byte, far under the bf16 ridge point (295).
//
// The output form, SCALED and SHIFT are template parameters: a run-time
// test of the scale cost the f32 row loop 18%, and a multiply by a
// literal 1 cost K3 4.8% at S = 82 (pair_attention.cuh), so each
// combination compiles to its own code and K6a's bf16 instance to the
// code it had before K3 shared it.
#pragma once

#include "attn_mma.cuh"

// internal to each source that includes it (block.cu, text_block.cu), as
// those sources' own kernels are
namespace {

constexpr int PM_UNITS = 2;             // (crop, pair) units a block
constexpr int PM_WARPS = 4 * PM_UNITS;  // four a unit
constexpr int PM_LD = 2 * ATT_D + 8;    // padded shared row of a pair's K or V (bf16)

// the context's stores of one head's 16 x 64 tile from its unnormalized
// acc and this thread's parts of the row sums l (reduced over the quad
// here); cinv: the int8 context's scale
__device__ __forceinline__ void store_pair_ctx(float (&acc)[8][4], const float (&l)[2], float,
                                               bf16* dst, long long ld, int n_rows) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = __fdiv_rn(1.0f, fmaxf(quad_sum(l[r]), 1e-30f));
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fmul_rn(acc[nt][e], inv[e >> 1]);
  store_tile_bf16(acc, dst, ld, n_rows);
}

__device__ __forceinline__ void store_pair_ctx(float (&acc)[8][4], const float (&l)[2], float,
                                               float* dst, long long ld, int n_rows) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = __fdiv_rn(1.0f, fmaxf(quad_sum(l[r]), 1e-30f));
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fmul_rn(acc[nt][e], inv[e >> 1]);
  store_tile_f32(acc, dst, ld, n_rows);
}

__device__ __forceinline__ void store_pair_ctx(float (&acc)[8][4], const float (&l)[2],
                                               float cinv, int8_t* dst, long long ld,
                                               int n_rows) {
  float c[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) c[r] = __fdiv_rn(cinv, fmaxf(quad_sum(l[r]), 1e-30f));
  store_tile_int8(acc, c, dst, ld, n_rows);
}

// one head's scores of the warp's 16-row query tile (q: its row 0, ld its
// row stride, rows >= n_rows as 0) against the 16 NC staged keys at ks,
// x scale where SCALED, keys past S at -inf
template <int NC, bool SCALED, bool CG>
__device__ __forceinline__ void head_scores(float (&sc)[2 * NC][4], const bf16* q, long long ld,
                                            int n_rows, const bf16* ks, int S, float scale) {
  const int tig = threadIdx.x & 3;
  unsigned a[4][4];
  load_q_tile<CG>(a, q, ld, n_rows);
#pragma unroll
  for (int c = 0; c < NC; ++c) qk_chunk<PM_LD>(sc[2 * c], sc[2 * c + 1], a, ks + 16 * c * PM_LD);
#pragma unroll
  for (int t = 0; t < 2 * NC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = SCALED ? __fmul_rn(sc[t][e], scale) : sc[t][e];
      sc[t][e] = 8 * t + tig * 2 + (e & 1) < S ? s : -INFINITY;
    }
}

// one head's context from its scores and the rows' shift m: bf16(exp(s -
// m)) into PV (V's row 0 at vs) and l, then the store
template <int NC, typename O>
__device__ __forceinline__ void head_context(float (&sc)[2 * NC][4], const float (&m)[2],
                                             const bf16* vs, float cinv, O* dst, long long ld,
                                             int n_rows) {
  float l[2] = {0.0f, 0.0f}, acc[8][4];
  exp_tile<NC, true>(sc, m, l);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  pv_tile<NC, PM_LD>(acc, sc, vs);
  store_pair_ctx(acc, l, cinv, dst, ld, n_rows);
}

// stages the K and V of U units from unit0 ([16 NC keys, 128] bf16 each,
// both heads, rows past S zero-filled) at smem with 16-byte cp.async (L2
// only: the launch may have written qkv), all the block's threads
template <int NC, int U>
__device__ __forceinline__ void pair_stage(bf16* smem, const bf16* qkv, int unit0, int n_units,
                                           int S, int H) {
  constexpr int KP = 16 * NC;
  const int E = H * ATT_D, E3 = 3 * E, n_pairs = H >> 1;
  for (int c = threadIdx.x; c < U * 2 * KP * 16; c += blockDim.x) {
    const int r = c >> 4, ub = r / (2 * KP), t = (r / KP) & 1, row = r % KP;
    const int unit = unit0 + ub, col = (c & 15) * 8;
    const bool ok = unit < n_units && row < S;
    const long long crop = unit / n_pairs;
    const bf16* src = qkv + (crop * S + row) * E3 + (1 + t) * E +
                      (unit - crop * n_pairs) * 2 * ATT_D + col;
    cp_async16(smem + r * PM_LD + col, ok ? src : qkv, ok ? 16 : 0);
  }
}

// one warp's 16-row query tiles m0 = m_first, m_first + m_step, .. < S of
// one unit (crop, pair), its K and V staged at ks, vs: the pair attention
// of the header, the context to out ([crops * S, E]); cinv: the int8
// context's scale; CG: q through L2 (written earlier in the same launch)
template <int NC, typename O, bool SCALED, bool SHIFT, bool CG>
__device__ __forceinline__ void pair_rows(const bf16* qkv, O* out, int unit, const bf16* ks,
                                          const bf16* vs, float cinv, const float* shift, int S,
                                          int H, float scale, float m_floor, int m_first,
                                          int m_step) {
  const int E = H * ATT_D, E3 = 3 * E, n_pairs = H >> 1;
  const long long crop = unit / n_pairs;
  const int pair = unit - (int)(crop * n_pairs);
  const bf16* qb = qkv + crop * S * E3 + pair * 2 * ATT_D;
  O* ob = out + crop * S * E + pair * 2 * ATT_D;
  for (int m0 = m_first; m0 < S; m0 += m_step) {
    const bf16* q = qb + m0 * E3;
    O* o = ob + m0 * E;
    if constexpr (SHIFT) {
      // the calibrated shift needs no max: each head's scores go through
      // PV before the other head's are taken (half the live registers)
      const float m[2] = {__ldg(shift), __ldg(shift)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sc[2 * NC][4];
        head_scores<NC, SCALED, CG>(sc, q + h * ATT_D, E3, S - m0, ks + h * ATT_D, S, scale);
        head_context<NC>(sc, m, vs + h * ATT_D, cinv, o + h * ATT_D, E, S - m0);
      }
    } else {
      // the pair shift: both heads' max, then the floor
      float sc[2][2 * NC][4];
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        head_scores<NC, SCALED, CG>(sc[h], q + h * ATT_D, E3, S - m0, ks + h * ATT_D, S, scale);
        tile_max<NC>(sc[h], m);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = fmaxf(quad_max(m[r]), m_floor);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        head_context<NC>(sc[h], m, vs + h * ATT_D, cinv, o + h * ATT_D, E, S - m0);
    }
  }
}

// NC: 16-key chunks a head holds in registers (16 NC >= S); 16 NC key
// rows a unit are staged, zero-filled past S. O: the context's type (bf16,
// float, or int8_t x ctx_inv); SCALED: the scores x scale; SHIFT: *shift
// in place of the pair max (m_floor unused)
template <int NC, typename O, bool SCALED, bool SHIFT>
__global__ void __launch_bounds__(PM_WARPS * 32, NC <= 4 ? 2 : 1) pair_attention_mma_kernel(
    const bf16* __restrict__ qkv,       // [n_crops * S, 3E]
    const float* __restrict__ ctx_inv,  // scalar (int8 context)
    const float* __restrict__ shift,    // scalar (SHIFT)
    O* __restrict__ out,                // [n_crops * S, E]
    int n_units, int S, int H, float scale, float m_floor) {
  constexpr int KP = 16 * NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);  // per unit: [KP][PM_LD] K, then V
  const int unit0 = blockIdx.x * PM_UNITS;
  pair_stage<NC, PM_UNITS>(smem, qkv, unit0, n_units, S, H);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, unit = unit0 + (warp >> 2);
  if (unit >= n_units) return;
  const bf16* ks = smem + (warp >> 2) * 2 * KP * PM_LD;
  const float cinv = std::is_same<O, int8_t>::value ? __ldg(ctx_inv) : 0.0f;
  pair_rows<NC, O, SCALED, SHIFT, false>(qkv, out, unit, ks, ks + KP * PM_LD, cinv, shift, S, H,
                                         scale, m_floor, (warp & 3) * 16, 64);
}

// launches pair_attention_mma_kernel<NC, O, SCALED, SHIFT> over n_crops x
// H / 2 units; the caller checks D = 64, S <= 16 NC and 16-byte alignment
template <int NC, typename O, bool SCALED, bool SHIFT>
int launch_pair_mma(const void* qkv, const void* ctx_inv, const void* shift, void* out,
                    int n_crops, int S, int H, float scale, float m_floor, cudaStream_t stream) {
  const long long n_units = (long long)n_crops * (H / 2);
  if (n_units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)PM_UNITS * 2 * 16 * NC * PM_LD * sizeof(bf16);
  const int err = set_smem(pair_attention_mma_kernel<NC, O, SCALED, SHIFT>, smem);
  if (err) return err;
  pair_attention_mma_kernel<NC, O, SCALED, SHIFT>
      <<<(unsigned)((n_units + PM_UNITS - 1) / PM_UNITS), PM_WARPS * 32, smem, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const float*>(ctx_inv),
          static_cast<const float*>(shift), static_cast<O*>(out), (int)n_units, S, H, scale,
          m_floor);
  return (int)cudaGetLastError();
}

}  // namespace
