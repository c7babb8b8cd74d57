// Whole transformer layers in one kernel: K9a, K9c and K9d (the int8
// W8A8 serving layer) and K9b (the bf16 text layer).
//
// Replaces jcf_tpu/ops/block_kernel.py::
//   _block_int8_kernel         (K9a, _FUSE = "block":  one int8 layer, f32 mid)
//   _layer_fused_int8_kernel   (K9d, _FUSE = "layer":  one int8 layer, bf16 mid,
//                               MLP in _LAYER_NSPLIT hidden chunks)
//   _stream_tower_int8_kernel  (K9c, _FUSE = "stream": every int8 layer in one
//                               launch, bf16 mid and residual between halves)
//   _block_kernel              (K9b, _FUSE = "block" on the text tower: one bf16
//                               layer with an additive [S, S] bias, f32 mid)
// The int8 kernels take every tree and route of the reference's
// run_fused_tower below 128 tokens. On the folded dense route (mask-free
// attention, S <= 64), in every quantization mode (each of the LN, context
// and hidden quantizations static, the calibrated scale, or dynamic per
// row, and the softmax shift the pair max or the calibrated score_shift),
// the options are template parameters (one instance per set): chosen at
// run time, such a choice cost these kernels 4.8-7.9% (PERF.md). Every
// other branch (the unfolded tree, the masked attention of the text tower
// and of an odd head count, the non-dense route at S a multiple of 16, f32
// rows, 65 to 127 tokens) takes the general instances, which read the mode
// and the branch from the run-time flags (fused_layer.cuh). The
// dynamic quantizations are the reference's _quant_rows: LN rows per row
// (the scales multiply the s32 sums after the weight scale, before the
// bias, _int8_gemm's order); the context per E-wide row over all head
// pairs, so the f32 context of a crop goes through a global f32 scratch
// (shared with K9a's mid, dead by then) and is quantized once every pair
// is done; the hidden per row and per MLP chunk (nsp chunks of F / nsp
// columns), from the row amax of each chunk, which a first c_fc pass
// collects and a second pass (the same exact sums) applies: 32 rows of an
// f32 hidden (393 KB at F = 3072) would not fit in shared memory.
//
// The TPU tiles many crops into VMEM with a whole layer's weights. On the
// H100 a block owns one crop (one prompt for K9b) for the whole layer, or
// for the whole tower in K9c (a loop over layers inside the block takes
// the place of the TPU's sequential half-step grid axis). Its shared
// memory holds, at ViT-B/32 widths (E = 768, S = 50, hidden 3072):
//   B ring      4 x 128 rows x 80 B (weight tiles)           40,960 B
//   LN rows     [64, E + 16] int8 (LN1, then LN2 quantized)   50,176 B
//   then either the attention's tiles
//     ctx       [64, E + 16] int8                             50,176 B
//     q, k^T, v one head pair, bf16, 3 x S x 128 x 2          38,400 B
//     p         8 warps x 2 x S f32                            3,200 B
//   or the MLP's hidden, 32 rows at a time
//     h_q       [32, hidden + 16] int8                        98,816 B
//   and the dynamic row scales (LN, context, hidden per chunk)  1,536 B
// = 191,488 B (nsp = 4), one block per SM. The qkv of all heads (230 KB
// in bf16) would not fit, so qkv is produced one head pair at a time and feeds the
// pair's attention at once (the row loop of pair_attention.cuh, K3's), and
// the int8 context gathers in its [64, E] tile. The mid residual of K9a
// (f32, 153.6 KB per crop) does not fit beside them either: it goes to a
// per-row f32 scratch in global memory that the wrapper allocates, read
// back by LN2 and the c_proj epilogue (it mostly stays in the 50 MB L2).
// The bf16 mid of K9c/K9d goes to the output rows themselves, which the
// last epilogue then overwrites element by element. K9b (E = 512, S = 77,
// hidden 2048): LN rows and ctx [80, E + 8] bf16 (83,200 B each), one
// head's q, k^T, v (29,568 B), p (2,464 B), the MLP hidden [16, hidden +
// 8] bf16 (65,792 B) in place of ctx, a 3-stage ring (30,720 B);
// 229,152 B in all, f32 mid in the same kind of global scratch. At the
// vision tower's E = 768 (the bf16 unquantized tower under "block", S =
// 50, hidden 3072) ctx alone would take 124,160 B beside as much for the
// LN rows, so ctx and then the hidden go to a bf16 scratch in global
// memory, [80, E + 8] per sequence, that the wrapper allocates when
// jcf_block_bf16_scratch says so (the products read their A operand
// through the same loads from there): 175,680 B of shared memory.
//
// The products are mma.sync (m16n8k32 s8 or m16n8k16 bf16) of the
// resident activation tile against weight tiles streamed through a
// cp.async ring (3 depth steps in flight for int8, 2 for bf16), one
// 128-column output tile (64 for K9b's per-head q, k, v) at a time, each
// block starting at its own tile so that blocks read different weights.
// int32 sums are exact in any order; the f32 chunk partials of the MLP
// (nsp > 1) are added in chunk order, as the reference adds them.
// Epilogues use the _rn intrinsics, so nvcc fuses no rounding the
// reference does separately.
//
// The tile machinery and the int8 kernel template live in fused_layer.cuh;
// the int8 kernel's 32 instances (two mids x the four static options) are
// built in four sources, fused_int8_*.cu, that nvcc compiles in parallel
// (one source with all of them took 119 s to build on the card's host).
// This file holds K9b, the int8 launcher and the C entries.
//
// What bounds it on the H100: the int8 operations (5.8e12 per ViT-B/32
// layer at 8192 crops, 2.93 ms at the int8 peak). This first version is
// far from it (profile_fused.py splits its time by phase): one block of 8
// warps per SM, all the shared memory a crop needs, hides little latency;
// the attention runs on CUDA cores with two shared-memory loads per
// multiply-add; every block re-reads its layer's weights from L2 (7.08
// MB, the MLP's twice: about 97 GB per layer at 8192 crops). A dynamic
// hidden adds the second c_fc pass: a third more s8 products (the modes
// dynamic and "ln").
#include "fused_layer.cuh"

using namespace jcf_fused;

#ifdef JCF_FUSED_PROFILE
#include <initializer_list>

extern "C" int jcf_fused_profile_mid32_dyn(void*);
extern "C" int jcf_fused_profile_mid32_static(void*);
extern "C" int jcf_fused_profile_bf16mid_dyn(void*);
extern "C" int jcf_fused_profile_bf16mid_static(void*);
extern "C" int jcf_fused_profile_general(void*);

// the per-phase cycles of every int8 instance, summed over the five
// sources that hold them, then cleared
extern "C" int jcf_fused_profile(void* host) {
  unsigned long long* sum = static_cast<unsigned long long*>(host);
  unsigned long long part[7];
  for (int i = 0; i < 7; ++i) sum[i] = 0;
  for (auto fn : {jcf_fused_profile_mid32_dyn, jcf_fused_profile_mid32_static,
                  jcf_fused_profile_bf16mid_dyn, jcf_fused_profile_bf16mid_static,
                  jcf_fused_profile_general}) {
    const int err = fn(part);
    if (err) return err;
    for (int i = 0; i < 7; ++i) sum[i] += part[i];
  }
  return 0;
}
#endif

namespace {

int launch_int8(bool mid_f32, const void* x, void* out, void* scratch32, void* xq_g,
                const LayerInt8& w, int n_crops, int S, int H, int F, int n_layers, int nsp,
                int flags, cudaStream_t stream) {
  const int E = H * 64;
  flags |= mid_f32 ? FLAG_MID_F32 : 0;
  const bool act = flags & FLAG_STATIC_ACT, ctx = flags & FLAG_STATIC_CTX,
             hs = flags & FLAG_STATIC_H, shift = flags & FLAG_STATIC_SHIFT;
  bool fast, gmem;
  if (!int8_route(S, H, F, nsp, n_layers, flags, &fast, &gmem) || n_crops < 1 ||
      ((mid_f32 || !ctx || !fast) && scratch32 == nullptr) || (gmem && xq_g == nullptr) ||
      (act && (!w.ln1_inv || !w.ln2_inv)) || (ctx && !w.ctx_inv) || (shift && !w.shift) ||
      !w.gelu_c || (!(flags & FLAG_FOLDED) && (!w.ln1_s || !w.ln1_b || !w.ln2_s || !w.ln2_b)))
    return (int)cudaErrorInvalidValue;
  const Int8Launch a{x, out, static_cast<float*>(scratch32), static_cast<int8_t*>(xq_g), w,
                     n_crops, S, H, F, n_layers, nsp, flags,
                     int8_layout(!fast, gmem, S, E, F, nsp).total, stream};
  if (!fast) {
    if (flags & FLAG_F32_ROWS) return launch_int8_general<float, false>(a);
    return gmem ? launch_int8_general<bf16, true>(a) : launch_int8_general<bf16, false>(a);
  }
  if (mid_f32)
    return act ? launch_int8_part<true, true>(a, ctx, hs, shift)
               : launch_int8_part<true, false>(a, ctx, hs, shift);
  return act ? launch_int8_part<false, true>(a, ctx, hs, shift)
             : launch_int8_part<false, false>(a, ctx, hs, shift);
}

// ---------------------------------------------------------------------------
// K9b: the bf16 text layer
// ---------------------------------------------------------------------------

constexpr int SEQ_ROWS = 80;      // a sequence's rows, padded: S <= 80
constexpr int TEXT_MLP_ROWS = 16;  // rows per pass of the MLP

struct LayerBf16 {
  const bf16 *ln1_s, *ln1_b, *ln2_s, *ln2_b;      // [E]
  const bf16 *w_qkv, *w_out, *w_fc, *w_proj;      // [3E, E] [E, E] [F, E] [E, F]
  const float *b_qkv, *b_out, *b_fc, *b_proj;     // [3E] [E] [F] [E]
};

// K9b's shared memory: ring, LN rows, then ctx + one head's q, k^T, v and
// p, or the MLP hidden in ctx's place; with `global_ctx` ctx and the
// hidden live in the global scratch instead
size_t bf16_smem(int S, int E, int F, bool global_ctx) {
  const size_t lda = (size_t)(E + 8) * 2, ldh = (size_t)(F + 8) * 2;
  const size_t head = (size_t)3 * S * 64 * 2 + (size_t)WARPS * S * 4;
  if (global_ctx) return BF16_STAGES * RING_STAGE + SEQ_ROWS * lda + head;
  const size_t attn = SEQ_ROWS * lda + head;
  const size_t mlp = TEXT_MLP_ROWS * ldh;
  return BF16_STAGES * RING_STAGE + SEQ_ROWS * lda + (attn > mlp ? attn : mlp);
}

// the global scratch per sequence (bf16 elements) when the shared tiling
// does not fit, else 0: ctx [80, E + 8], then the hidden [16, F + 8]
size_t bf16_scratch(int S, int E, int F) {
  if (bf16_smem(S, E, F, false) <= 232448) return 0;
  const size_t ctx = (size_t)SEQ_ROWS * (E + 8), hid = (size_t)TEXT_MLP_ROWS * (F + 8);
  return ctx > hid ? ctx : hid;
}

// One head's attention rows with an additive [S, S] f32 bias (K6a's math,
// _paired_attention per head): s = (q . k) * scale + bias[i, j], the
// head's row max, p = exp(s - m), l = sum p (f32), then
// ctx = bf16(sum_j bf16(p_j / l) v_j). q_s [S, 64], kt_s [64, S], v_s
// [S, 64] bf16; p_s [8, S] f32; row i's 64 outputs go to out + i * out_stride.
__device__ __forceinline__ void head_attention_rows(const bf16* q_s, const bf16* kt_s,
                                                    const bf16* v_s, float* p_s,
                                                    const float* bias, int S, float scale,
                                                    bf16* out, int out_stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pw = p_s + warp * S;
  for (int i = warp; i < S; i += WARPS) {
    const bf16* qi = q_s + i * 64;
    float s[3];  // key j = lane + 32 * kb: S <= 96
    float m = -INFINITY;
#pragma unroll
    for (int kb = 0; kb < 3; ++kb) {
      const int j = lane + 32 * kb;
      float acc = -INFINITY;
      if (j < S) {
        acc = 0.0f;
        for (int d = 0; d < 64; ++d) acc = fmaf(bf2f(qi[d]), bf2f(kt_s[d * S + j]), acc);
        acc = __fadd_rn(__fmul_rn(acc, scale), bias[(long long)i * S + j]);
      }
      s[kb] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int kb = 0; kb < 3; ++kb) {
      const int j = lane + 32 * kb;
      s[kb] = j < S ? expf(__fsub_rn(s[kb], m)) : 0.0f;
      sum += s[kb];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int kb = 0; kb < 3; ++kb) {
      const int j = lane + 32 * kb;
      if (j < S) pw[j] = round_bf16(__fdiv_rn(s[kb], sum));
    }
    __syncwarp();
    for (int d = lane; d < 64; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < S; ++j) acc = fmaf(pw[j], bf2f(v_s[j * 64 + d]), acc);
      out[i * out_stride + d] = __float2bfloat16_rn(acc);
    }
    __syncwarp();
  }
}

// One block per sequence of S rows: x + attention(LN1 x) -> f32 mid (in
// mid32), then mid + c_proj(QuickGELU(c_fc(LN2 mid))) -> bf16 out.
// GLOBAL_CTX (ctx and the hidden in the global scratch) is a template
// parameter so that each instance knows which pointers address shared
// memory: chosen at run time, q, k^T, v, p and ctx took generic loads and
// stores, 7.6% slower at 512 x 77 (profile_attention.py, H100 80GB HBM3,
// 700 W).
template <bool GLOBAL_CTX>
__global__ void __launch_bounds__(THREADS, 1) block_bf16_kernel(
    const bf16* x, bf16* out, float* mid32, bf16* scratch, long long scratch_elems, LayerBf16 w,
    const float* bias, int S, int H, int F, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = H * 64, lda = E + 8, ldh = F + 8;  // row strides in elements
  unsigned char* ring = smem;
  // [80, lda]: the LN1, then the LN2 rows
  bf16* hs = reinterpret_cast<bf16*>(smem + BF16_STAGES * RING_STAGE);
  // [80, lda]: in shared memory, or this sequence's part of the scratch
  bf16* ctx = GLOBAL_CTX ? scratch + blockIdx.x * scratch_elems : hs + SEQ_ROWS * lda;
  bf16* q_s = GLOBAL_CTX ? hs + SEQ_ROWS * lda : ctx + SEQ_ROWS * lda;  // [S, 64]
  bf16* kt_s = q_s + S * 64;                              // [64, S]
  bf16* v_s = kt_s + 64 * S;                              // [S, 64]
  float* p_s = reinterpret_cast<float*>(v_s + S * 64);    // [8, S]
  bf16* hid = ctx;                                        // [16, ldh] (after the attention)
  const int warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * S;
  const unsigned char* hs_b = reinterpret_cast<const unsigned char*>(hs);
  const unsigned char* w_qkv = reinterpret_cast<const unsigned char*>(w.w_qkv);

  for (int r = warp; r < SEQ_ROWS; r += WARPS) {
    if (r < S) ln_affine_row(x + (row0 + r) * E, E, w.ln1_s, w.ln1_b, hs + r * lda);
    else zero_row(hs + r * lda, E);
  }
  // per head: its q, k, v columns (bf16), then its attention
  for (int hi = 0; hi < H; ++hi) {
    const int h = (hi + blockIdx.x % H) % H;
    block_gemm<BF16_STAGES, 5, 1, 8, float>(
        3, (int)(blockIdx.x % 3), [&](int) { return hs_b; }, lda * 2,
        [&](int t) { return w_qkv + (long long)(t * E + h * 64) * E * 2; }, E * 2, E * 2, ring,
        [&](int t, const float (&acc)[5][1][4]) {
      for_each_pair<5, 1, 8>(acc, [&](int r, int c, float a0, float a1) {
        if (r >= S) return;
        const int n = t * E + h * 64 + c;
        const __nv_bfloat162 y =
            __floats2bfloat162_rn(__fadd_rn(a0, w.b_qkv[n]), __fadd_rn(a1, w.b_qkv[n + 1]));
        if (t == 0) {
          *reinterpret_cast<__nv_bfloat162*>(q_s + r * 64 + c) = y;
        } else if (t == 1) {
          kt_s[c * S + r] = y.x;
          kt_s[(c + 1) * S + r] = y.y;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(v_s + r * 64 + c) = y;
        }
      });
    });
    head_attention_rows(q_s, kt_s, v_s, p_s, bias, S, scale, ctx + h * 64, lda);
    __syncthreads();
  }
  // out-proj + residual -> f32 mid
  block_gemm<BF16_STAGES, 5, 2, 8, float>(
      E / 128, (int)(blockIdx.x % (E / 128)),
      [&](int) { return reinterpret_cast<const unsigned char*>(ctx); }, lda * 2,
      [&](int t) {
        return reinterpret_cast<const unsigned char*>(w.w_out + (long long)t * 128 * E);
      },
      E * 2, E * 2, ring, [&](int t, const float (&acc)[5][2][4]) {
    for_each_pair<5, 2, 8>(acc, [&](int r, int c, float a0, float a1) {
      if (r >= S) return;
      const int n = t * 128 + c;
      const long long idx = (row0 + r) * E + n;
      const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(x + idx);
      *reinterpret_cast<float2*>(mid32 + idx) =
          make_float2(__fadd_rn(__low2float(res), __fadd_rn(a0, w.b_out[n])),
                      __fadd_rn(__high2float(res), __fadd_rn(a1, w.b_out[n + 1])));
    });
  });  // ends on a barrier: mid, in global memory, is visible to the whole block
  for (int r = warp; r < SEQ_ROWS; r += WARPS) {
    if (r < S) ln_affine_row(mid32 + (row0 + r) * E, E, w.ln2_s, w.ln2_b, hs + r * lda);
    else zero_row(hs + r * lda, E);
  }
  // the MLP, 16 rows at a time: c_fc + QuickGELU (sigmoid form) -> bf16
  // hidden, then c_proj + f32 mid
  for (int rt = 0; rt * TEXT_MLP_ROWS < S; ++rt) {
    const unsigned char* a = hs_b + rt * TEXT_MLP_ROWS * lda * 2;
    block_gemm<BF16_STAGES, 1, 2, 8, float>(
        F / 128, (int)(blockIdx.x % (F / 128)), [&](int) { return a; }, lda * 2,
        [&](int t) {
          return reinterpret_cast<const unsigned char*>(w.w_fc + (long long)t * 128 * E);
        },
        E * 2, E * 2, ring, [&](int t, const float (&acc)[1][2][4]) {
      for_each_pair<1, 2, 8>(acc, [&](int r, int c, float a0, float a1) {
        const int n = t * 128 + c;
        const float g0 = __fadd_rn(a0, w.b_fc[n]), g1 = __fadd_rn(a1, w.b_fc[n + 1]);
        const float s0 = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn(1.702f, g0))));
        const float s1 = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn(1.702f, g1))));
        *reinterpret_cast<__nv_bfloat162*>(hid + r * ldh + n) =
            __floats2bfloat162_rn(__fmul_rn(g0, s0), __fmul_rn(g1, s1));
      });
    });
    block_gemm<BF16_STAGES, 1, 2, 8, float>(
        E / 128, (int)(blockIdx.x % (E / 128)),
        [&](int) { return reinterpret_cast<const unsigned char*>(hid); }, ldh * 2,
        [&](int t) {
          return reinterpret_cast<const unsigned char*>(w.w_proj + (long long)t * 128 * F);
        },
        F * 2, F * 2, ring, [&](int t, const float (&acc)[1][2][4]) {
      for_each_pair<1, 2, 8>(acc, [&](int r, int c, float a0, float a1) {
        const int row = rt * TEXT_MLP_ROWS + r;
        if (row >= S) return;
        const int n = t * 128 + c;
        const long long idx = (row0 + row) * E + n;
        const float2 m = *reinterpret_cast<const float2*>(mid32 + idx);
        *reinterpret_cast<__nv_bfloat162*>(out + idx) =
            __floats2bfloat162_rn(__fadd_rn(m.x, __fadd_rn(a0, w.b_proj[n])),
                                  __fadd_rn(m.y, __fadd_rn(a1, w.b_proj[n + 1])));
      });
    });
  }
}

}  // namespace

// K9a (_block_int8_kernel): one int8 layer, f32 mid in scratch32.
// K9d (_layer_fused_int8_kernel): one int8 layer, bf16 mid.
// K9c (_stream_tower_int8_kernel): n_layers int8 layers, bf16 mid.
// The same argument list for the three: x [n_crops * S, E] bf16 (f32 for
// K9a with FLAG_F32_ROWS) and out (same shape and type); scratch32
// [n_crops * S, E] f32, needed by K9a, by a dynamic context and by every
// branch off the folded dense route (else null); xq_g: n_crops x
// jcf_int8_xq_scratch(...) bytes where that is not 0 (else null); the
// stacked weights, scales and biases of LayerInt8 (fc scale and bias with
// h_inv folded and gelu_c = 0.851 / h_inv per layer where the hidden's
// scale is static, else gelu_c = 0.851; for an odd head count w_qkv padded
// by 64 rows and w_out, w_proj to a multiple of 128 rows); the static
// scalars the flags name (ln1_inv and ln2_inv, ctx_inv, shift), null where
// the quantization is dynamic; the unfolded tree's LN affines [L, E] in
// the rows' dtype, null when folded; nsp MLP hidden chunks; flags: the
// reference's options (FLAG_FOLDED, the static ones, FLAG_DENSE,
// FLAG_USE_MASK) and FLAG_CAUSAL, FLAG_F32_ROWS.
#define INT8_LAYER_ARGS                                                                        \
  const void *x, void *out, void *scratch32, void *xq_g, const void *w_qkv, const void *qkv_sc,  \
      const void *qkv_b, const void *w_out, const void *out_sc, const void *out_b,             \
      const void *w_fc, const void *fc_sc, const void *fc_b, const void *w_proj,               \
      const void *proj_sc, const void *proj_b, const void *ln1_inv, const void *ctx_inv,       \
      const void *ln2_inv, const void *gelu_c, const void *shift, const void *ln1_s,            \
      const void *ln1_b, const void *ln2_s, const void *ln2_b, int n_crops, int S, int H,         \
      int F, int n_layers, int nsp, int flags, void *stream
#define INT8_LAYER_STRUCT                                                                     \
  LayerInt8 {                                                                                 \
    static_cast<const int8_t*>(w_qkv), static_cast<const int8_t*>(w_out),                     \
        static_cast<const int8_t*>(w_fc), static_cast<const int8_t*>(w_proj),                 \
        static_cast<const float*>(qkv_sc), static_cast<const float*>(qkv_b),                  \
        static_cast<const float*>(out_sc), static_cast<const float*>(out_b),                  \
        static_cast<const float*>(fc_sc), static_cast<const float*>(fc_b),                    \
        static_cast<const float*>(proj_sc), static_cast<const float*>(proj_b),                \
        static_cast<const float*>(ln1_inv), static_cast<const float*>(ctx_inv),               \
        static_cast<const float*>(ln2_inv), static_cast<const float*>(gelu_c),                \
        static_cast<const float*>(shift), ln1_s, ln1_b, ln2_s, ln2_b                          \
  }

extern "C" int jcf_block_int8(INT8_LAYER_ARGS) {
  if (n_layers != 1) return (int)cudaErrorInvalidValue;
  return launch_int8(true, x, out, scratch32, xq_g, INT8_LAYER_STRUCT, n_crops, S, H, F, 1, nsp, flags,
                     (cudaStream_t)stream);
}

extern "C" int jcf_layer_fused_int8(INT8_LAYER_ARGS) {
  if (n_layers != 1) return (int)cudaErrorInvalidValue;
  return launch_int8(false, x, out, scratch32, xq_g, INT8_LAYER_STRUCT, n_crops, S, H, F, 1, nsp, flags,
                     (cudaStream_t)stream);
}

// the bytes of global LN rows per crop that a launch with these arguments
// needs (E = 768 at S > 96 off the folded dense route), else 0; -1 where
// no instance takes them
extern "C" long long jcf_int8_xq_scratch(int S, int H, int F, int nsp, int n_layers, int flags) {
  bool fast, gmem;
  if (!int8_route(S, H, F, nsp, n_layers, flags | FLAG_MID_F32, &fast, &gmem)) return -1;
  return gmem ? (long long)general_rows(S) * (H * 64 + 16) : 0;
}

extern "C" int jcf_stream_tower_int8(INT8_LAYER_ARGS) {
  return launch_int8(false, x, out, scratch32, xq_g, INT8_LAYER_STRUCT, n_crops, S, H, F, n_layers, nsp,
                     flags, (cudaStream_t)stream);
}

// K9b (_block_kernel, bf16): x [n_seq * S, E] bf16 -> out; mid32 [rows, E]
// f32 scratch; LN params bf16 [E]; weights bf16 [out, in]; biases f32;
// bias [S, S] f32 additive; scale = 1/sqrt(64). S <= 80, head dim 64.
// scratch: n_seq x jcf_block_bf16_scratch(S, E, F) bf16, or null where
// that is 0.
extern "C" long long jcf_block_bf16_scratch(int S, int E, int F) {
  return (long long)bf16_scratch(S, E, F);
}

extern "C" int jcf_block_bf16(const void* x, void* out, void* mid32, void* scratch,
                              const void* ln1_s,
                              const void* ln1_b, const void* w_qkv, const void* b_qkv,
                              const void* w_out, const void* b_out, const void* ln2_s,
                              const void* ln2_b, const void* w_fc, const void* b_fc,
                              const void* w_proj, const void* b_proj, const void* bias,
                              int n_seq, int S, int H, int F, float scale, void* stream) {
  const int E = H * 64;
  if (n_seq < 1 || S < 1 || S > SEQ_ROWS || H < 1 || E > 1024 || E % 128 || F < 128 ||
      F % 128 || mid32 == nullptr || bias == nullptr ||
      (scratch == nullptr) != (bf16_scratch(S, E, F) == 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_smem(S, E, F, scratch != nullptr);
  const auto kernel = scratch != nullptr ? block_bf16_kernel<true> : block_bf16_kernel<false>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const LayerBf16 w{static_cast<const bf16*>(ln1_s),  static_cast<const bf16*>(ln1_b),
                    static_cast<const bf16*>(ln2_s),  static_cast<const bf16*>(ln2_b),
                    static_cast<const bf16*>(w_qkv),  static_cast<const bf16*>(w_out),
                    static_cast<const bf16*>(w_fc),   static_cast<const bf16*>(w_proj),
                    static_cast<const float*>(b_qkv), static_cast<const float*>(b_out),
                    static_cast<const float*>(b_fc),  static_cast<const float*>(b_proj)};
  kernel<<<n_seq, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<float*>(mid32),
      static_cast<bf16*>(scratch), (long long)bf16_scratch(S, E, F), w,
      static_cast<const float*>(bias), S, H, F, scale);
  return (int)cudaGetLastError();
}
