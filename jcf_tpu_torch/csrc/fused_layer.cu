// Whole int8 transformer layers in one kernel: K9d (the int8 W8A8
// serving layer, bf16 mid) on every branch, and K9a off the folded dense
// route (the masked attention, f32 rows, the non-dense route). This file
// holds their launcher and C entries; the tile machinery and the kernel
// template live in fused_layer.cuh, its instances in the three
// fused_int8_*.cu. (K9a's dense branches and K9c are the persistent kernel
// of block_int8.cu; K9b, the float layer, is block_float.cu.)
//
// Replaces jcf_tpu/ops/block_kernel.py::
//   _layer_fused_int8_kernel   (K9d, _FUSE = "layer":  one int8 layer, bf16 mid,
//                               MLP in _LAYER_NSPLIT hidden chunks)
//   _block_int8_kernel         (K9a, _FUSE = "block":  one int8 layer, f32 mid;
//                               here its masked and non-dense branches)
// The kernels take every tree and route of the reference's
// run_fused_tower below 128 tokens that reaches them. On the folded dense
// route (mask-free attention, S <= 64), in every quantization mode (each
// of the LN, context and hidden quantizations static, the calibrated
// scale, or dynamic per row, and the softmax shift the pair max or the
// calibrated score_shift), K9d's options are template parameters (one
// instance per set): chosen at run time, such a choice cost these kernels
// 4.8-7.9% (PERF.md). Every other branch (the unfolded tree, the masked
// attention of the text tower and of an odd head count, the non-dense
// route at S a multiple of 16, f32 rows, 65 to 127 tokens) takes the
// general instances, which read the mode and the branch from the run-time
// flags (fused_layer.cuh). The dynamic quantizations are the reference's
// _quant_rows: LN rows per row (the scales multiply the s32 sums after
// the weight scale, before the bias, _int8_gemm's order); the context per
// E-wide row over all head pairs, so the f32 context of a crop goes
// through a global f32 scratch (shared with K9a's mid, dead by then) and
// is quantized once every pair is done; the hidden per row and per MLP
// chunk (nsp chunks of F / nsp columns), from the row amax of each chunk,
// which a first c_fc pass collects and a second pass (the same exact
// sums) applies: 32 rows of an f32 hidden (393 KB at F = 3072) would not
// fit in shared memory.
//
// The TPU tiles many crops into VMEM with a whole layer's weights. On the
// H100 a block owns one crop for the whole layer. Its shared memory
// holds, at ViT-B/32 widths (E = 768, S = 50, hidden 3072):
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
// in bf16) would not fit, so qkv is produced one head pair at a time and
// feeds the pair's attention at once (the row loop of pair_attention.cuh,
// K3's), and the int8 context gathers in its [64, E] tile. The mid
// residual of K9a (f32) goes to a per-row f32 scratch in global memory
// that the wrapper allocates, read back by LN2 and the c_proj epilogue.
// The bf16 mid of K9d goes to the output rows themselves, which the last
// epilogue then overwrites element by element.
//
// The products are mma.sync m16n8k32 s8 of the resident activation tile
// against weight tiles streamed through a cp.async ring (3 depth steps in
// flight), one 128-column output tile at a time, each block starting at
// its own tile so that blocks read different weights. int32 sums are
// exact in any order; the f32 chunk partials of the MLP (nsp > 1) are
// added in chunk order, as the reference adds them. Epilogues use the _rn
// intrinsics, so nvcc fuses no rounding the reference does separately.
// K9d's 16 folded dense instances (the four static options) are built in
// two sources, fused_int8_bf16mid_*.cu, beside the general instances'
// fused_int8_general.cu, which nvcc compiles in parallel.
//
// What bounds it on the H100: the int8 operations (5.8e12 per ViT-B/32
// layer at 8192 crops, 2.93 ms at the int8 peak). These kernels are far
// from it (profile_fused.py splits K9d's time by phase): one block of 8
// warps per SM, all the shared memory a crop needs, hides little latency;
// the attention runs on CUDA cores with two shared-memory loads per
// multiply-add; every block re-reads its layer's weights from L2 (7.08
// MB, the MLP's twice: about 97 GB per layer at 8192 crops). A dynamic
// hidden adds the second c_fc pass: a third more s8 products (the modes
// dynamic and "ln"). K9a's dense branches and K9c moved to the persistent
// design of K9b (block_int8.cu); the same redesign is what K9d waits for.
#include "fused_layer.cuh"

using namespace jcf_fused;

#ifdef JCF_FUSED_PROFILE
#include <initializer_list>

extern "C" int jcf_fused_profile_bf16mid_dyn(void*);
extern "C" int jcf_fused_profile_bf16mid_static(void*);
extern "C" int jcf_fused_profile_general(void*);

// the per-phase cycles of every int8 instance, summed over the three
// sources that hold them, then cleared
extern "C" int jcf_fused_profile(void* host) {
  unsigned long long* sum = static_cast<unsigned long long*>(host);
  unsigned long long part[7];
  for (int i = 0; i < 7; ++i) sum[i] = 0;
  for (auto fn : {jcf_fused_profile_bf16mid_dyn, jcf_fused_profile_bf16mid_static,
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
  // K9a's folded dense route is block_int8.cu's
  if (mid_f32) return (int)cudaErrorInvalidValue;
  return act ? launch_int8_part<false, true>(a, ctx, hs, shift)
             : launch_int8_part<false, false>(a, ctx, hs, shift);
}

}  // namespace

// K9a (_block_int8_kernel) off the folded dense route: one int8 layer,
// f32 mid in scratch32. K9d (_layer_fused_int8_kernel): one int8 layer,
// bf16 mid. The same argument list for the two: x [n_crops * S, E] bf16
// (f32 for K9a with FLAG_F32_ROWS) and out (same shape and type);
// scratch32 [n_crops * S, E] f32, needed by K9a, by a dynamic context and
// by every branch off the folded dense route (else null); xq_g: n_crops x
// jcf_int8_xq_scratch(...) bytes where that is not 0 (else null); the
// weights, scales and biases of LayerInt8 (fc scale and bias with h_inv
// folded and gelu_c = 0.851 / h_inv where the hidden's scale is static,
// else gelu_c = 0.851; for an odd head count w_qkv padded by 64 rows and
// w_out, w_proj to a multiple of 128 rows); the static scalars the flags
// name (ln1_inv and ln2_inv, ctx_inv, shift), null where the quantization
// is dynamic; the unfolded tree's LN affines [E] in the rows' dtype, null
// when folded; nsp MLP hidden chunks; n_layers = 1; flags: the
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
