// K9a, K9c and K9d: whole int8 W8A8 transformer layers in one persistent
// launch, on every tree and route of the reference's run_fused_tower below
// 128 tokens.
//
// Replaces jcf_tpu/ops/block_kernel.py::
//   _block_int8_kernel         (K9a, :732, pallas_call :1426; _FUSE = "block":
//                               one int8 layer, the mid residual kept in f32)
//   _stream_tower_int8_kernel  (K9c, :833, pallas_call :1308; _FUSE = "stream":
//                               every int8 layer in one launch, the mid
//                               rounded to bf16 as the halves round it)
//   _layer_fused_int8_kernel   (K9d, :1672, pallas_call :1846; _FUSE = "layer":
//                               one int8 layer, bf16 mid, the MLP in
//                               _LAYER_NSPLIT hidden chunks: K9c's body, one
//                               layer, bit for bit)
// The folded tree in each of its modes (dynamic; "ln": static LN scales;
// "hidden": and the hidden's; "full": and the context's; each with or
// without the calibrated softmax shift) and the unfolded tree (every scale
// dynamic, the LN affines as operands, the scores x 1/sqrt(64)). K9c and
// K9d run the dense route (no mask, an even head count, S not a multiple
// of 16, S <= 127); K9a also the others: the masked per-head attention of
// the causal text tower and of an odd head count, the mask-free pair
// attention without its floor at S a multiple of 16, and f32 rows (the
// f32 text tower: the folded dynamic and the unfolded trees).
// Per layer, on rows x [M = crops * S, E] (E = 64 H), the halves' math:
//   LN1 + int8 quant (static ln_inv, or per row) -> xq
//   qkv  = bf16((xq W_qkv^T) * scale [* row scale] + bias)
//   ctx  = the pair attention of K3 (pair_mma.cuh), or its masked per-head
//          attention (attn_mma.cuh): int8 x ctx_inv, or f32 then
//          quantized per E-wide row
//   mid  = x + (ctx W_out^T) * scale [* row scale] + bias     (f32 or bf16)
//   LN2 + int8 quant of mid
//   h    = GELU-quant of (h2 W_fc^T) (the static hidden scale folded), or
//          the f32 hidden, then QuickGELU + int8 per row and hidden chunk
//   out  = x's type(mid + (sum over the nsp hidden chunks, in chunk order,
//          of f32((h_c W_proj,c^T) * scale [* the chunk's row scale])) + bias)
// block_kernel.py's block_int8_plain, layer_fused_int8_plain and
// stream_tower_int8_plain are the plain versions.
//
// The design is K9b's (block_float.cu, persistent.cuh): one cooperative
// launch of as many blocks as fit on the card at once (the occupancy API;
// a grid that cannot be co-resident is refused, never split), its phases
// separated by a grid barrier that the C entry zeroes; each phase walks
// all the rows, every intermediate through device memory as between the
// halves. The phases run the halves' own device code:
// - LN + quant and the row quantizations: row_quant.cuh's row bodies of
//   block.cu's vector kernels, a warp a row (a block a row past 1024
//   columns), the next row in flight;
// - the products: the int8 GEMM's wgmma ring (wgmma_gemm.cuh, BN = 128,
//   3 stages, two blocks an SM) and its epilogues (int8_epilogue.cuh),
//   tiles drawn from a global counter one tile ahead (int8 tiles are
//   short: 6 stages at K = 768, whose loads the counter's round trip
//   would otherwise stall); TMA zero-fills the boxes past N and K (an odd
//   head count: N = 3E and E, K = E not multiples of 128) and the
//   epilogues store nothing past N; c_proj's hidden chunks (nsp > 1) as
//   one int32 sum a chunk inside a tile, each chunk's epilogue outside
//   the wgmma pipeline, its f32 partial folded into the earlier ones in
//   chunk order, the hidden and the weights read through 3-D maps whose
//   boxes stop at a chunk's end;
// - the attention, one kind a launch: pair_mma.cuh's body on mma.sync,
//   per (crop, head pair) unit, rounds of two units (one past 64 keys)
//   drawn from a counter; or text_block.cu's masked kernel's body
//   (attn_mma.cuh: scores in the reference's order on the CUDA cores, PV
//   on mma.sync), per (sequence, head) unit, 8 / NC units a round.
// Scratch written in the launch is read back only through L2 (TMA,
// cp.async, __ldcg). K9c runs the phases layer after layer on the same
// scratch, its bf16 mid in the output rows; at one hidden chunk its layers
// equal the halves' bit for bit (the same bodies and roundings), and K9d
// is its one-layer launch.
//
// What bounds it on the H100: the int8 operations, E (4E + 2F) multiply-
// adds a row (2.99 ms a ViT-B/32 layer at 8192 crops at the int8 peak).
// The GEMM phases run at about the halves' GEMMs' rates; what one launch
// adds is the grid barriers and the phases' last waves, an attention
// that has only the persistent blocks' 16 warps an SM and stages each
// round's keys and values before it computes them, and for K9a the f32 mid
// (LN2 and c_proj read 4 bytes an element, the halves' mid 2). Two blocks
// an SM cap the kernel at 96 registers, and the phases spill (PERF.md).
#include "block_int8.cuh"

namespace jcf_k9 {
// built in block_int8_{bf16mid,mid32,masked}*.cu and block_int8_rows32.cu
JCF_K9_FOLDED_MODES(JCF_K9_EXTERN, float, false, false)
JCF_K9_FOLDED_MODES(JCF_K9_EXTERN, float, false, true)
JCF_K9_FOLDED_MODES(JCF_K9_EXTERN, float, true, false)
JCF_K9_FOLDED_MODES(JCF_K9_EXTERN, bf16, false, false)
JCF_K9_FOLDED_MODES(JCF_K9_EXTERN, bf16, false, true)
JCF_K9_UNFOLDED(JCF_K9_EXTERN, float, false)
JCF_K9_UNFOLDED(JCF_K9_EXTERN, float, true)
JCF_K9_UNFOLDED(JCF_K9_EXTERN, bf16, false)
JCF_K9_ROWS32(JCF_K9_EXTERN)
}  // namespace jcf_k9

using namespace jcf_k9;

namespace {

// the options of the reference's int8 kernels and the port's own
// (block_kernel.py's FLAG_*)
constexpr int FLAG_FOLDED = 1, FLAG_STATIC_ACT = 2, FLAG_STATIC_CTX = 4, FLAG_STATIC_H = 8,
              FLAG_STATIC_SHIFT = 16, FLAG_DENSE = 32, FLAG_USE_MASK = 64, FLAG_CAUSAL = 128,
              FLAG_F32_ROWS = 256;

template <typename MID, bool MK, bool SHIFT>
int dispatch_folded(const Maps& maps, const Params& p, int grid, cudaStream_t s, bool act,
                    bool ctx, bool hs) {
  if (!act && !ctx && !hs)
    return launch<bf16, MID, MK, false, false, false, SHIFT, true>(maps, p, grid, s);
  if (act && !ctx && !hs)
    return launch<bf16, MID, MK, true, false, false, SHIFT, true>(maps, p, grid, s);
  if (act && !ctx && hs) return launch<bf16, MID, MK, true, false, true, SHIFT, true>(maps, p, grid, s);
  if (act && ctx && hs) return launch<bf16, MID, MK, true, true, true, SHIFT, true>(maps, p, grid, s);
  return (int)cudaErrorInvalidValue;  // no tree carries these static scales
}

template <typename MID, bool MK>
int dispatch(const Maps& maps, const Params& p, int grid, cudaStream_t s, int flags) {
  const bool act = flags & FLAG_STATIC_ACT, ctx = flags & FLAG_STATIC_CTX,
             hs = flags & FLAG_STATIC_H, shift = flags & FLAG_STATIC_SHIFT;
  if (!(flags & FLAG_FOLDED))
    return act || ctx || hs || shift
               ? (int)cudaErrorInvalidValue
               : launch<bf16, MID, MK, false, false, false, false, false>(maps, p, grid, s);
  return shift ? dispatch_folded<MID, MK, true>(maps, p, grid, s, act, ctx, hs)
               : dispatch_folded<MID, MK, false>(maps, p, grid, s, act, ctx, hs);
}

// f32 rows: the folded tree's dynamic mode and the unfolded tree
int dispatch_rows32(const Maps& maps, const Params& p, int grid, cudaStream_t s, int flags) {
  if (flags & (FLAG_STATIC_ACT | FLAG_STATIC_CTX | FLAG_STATIC_H | FLAG_STATIC_SHIFT))
    return (int)cudaErrorInvalidValue;
  return flags & FLAG_FOLDED
             ? launch<float, float, true, false, false, false, false, true>(maps, p, grid, s)
             : launch<float, float, true, false, false, false, false, false>(maps, p, grid, s);
}

bool aligned(const void* q) { return ((uintptr_t)q & 15) == 0; }

}  // namespace

// K9a (mid_f32 = 1) and K9c / K9d (mid_f32 = 0) on x [n_crops * S, E] bf16
// (f32 with FLAG_F32_ROWS: K9a, one layer, the folded dynamic or the
// unfolded tree) -> out (same shape and type), E = 64 H <= 1024, S <= 127,
// F a multiple of 128, nsp hidden chunks of a multiple of 64 columns, at
// least 128; the route from the flags: FLAG_DENSE (the pair attention, its
// shift floored at 0, H even), neither FLAG_DENSE nor FLAG_USE_MASK (the
// pair attention without the floor, H even), or FLAG_USE_MASK (K9a, the
// per-head attention, FLAG_CAUSAL for the causal mask); an odd H (E not a
// multiple of 128) takes one layer; n_layers layers of
// stacked weights (the tree's [L, ...] leaves: w_qkv [L, 3E, E] int8 and
// its f32 scale and bias [L, 3E]; w_out [L, E, E]; w_fc [L, F, E] with its
// scale and bias h_inv-folded where the hidden is static; w_proj [L, E,
// F]), the static scalars [L] that the flags name (ln1_inv, ln2_inv,
// ctx_inv, shift; gelu_c = 0.851 / h_inv, or 0.851), the unfolded tree's
// LN affines [L, E] in f32 (null when folded). Scratch, all 16-byte
// aligned: xq [M, E] int8; big [M, max(3E bf16, F f32 where the hidden is
// dynamic)]; hq [M, F] int8; f32s [M, E] f32 where the context is dynamic
// or nsp > 1; mid32 [M, E] f32 (K9a); rsc [M] f32 where a scale is
// dynamic; hsc [M, nsp] f32 where the hidden is; bar 3 unsigned. grid: 0
// for the occupancy's (a larger one is refused by the runtime).
extern "C" int jcf_int8_layers(int mid_f32, const void* x, void* out, void* xq, void* big,
                               void* hq, void* f32s, void* mid32, void* rsc, void* hsc, void* bar,
                               const void* w_qkv, const void* qkv_sc, const void* qkv_b,
                               const void* w_out, const void* out_sc, const void* out_b,
                               const void* w_fc, const void* fc_sc, const void* fc_b,
                               const void* w_proj, const void* proj_sc, const void* proj_b,
                               const void* ln1_inv, const void* ctx_inv, const void* ln2_inv,
                               const void* gelu_c, const void* shift, const void* ln1_s,
                               const void* ln1_b, const void* ln2_s, const void* ln2_b,
                               int n_crops, int S, int H, int F, int n_layers, int nsp, int flags,
                               int grid, void* stream) {
  const int E = 64 * H;
  const int known = FLAG_FOLDED | FLAG_STATIC_ACT | FLAG_STATIC_CTX | FLAG_STATIC_H |
                    FLAG_STATIC_SHIFT | FLAG_DENSE | FLAG_USE_MASK | FLAG_CAUSAL | FLAG_F32_ROWS;
  const bool folded = flags & FLAG_FOLDED, act = flags & FLAG_STATIC_ACT,
             ctx = flags & FLAG_STATIC_CTX, hs = flags & FLAG_STATIC_H,
             shift_st = flags & FLAG_STATIC_SHIFT, dense = flags & FLAG_DENSE,
             masked = flags & FLAG_USE_MASK, causal = flags & FLAG_CAUSAL,
             rows32 = flags & FLAG_F32_ROWS;
  bool ok = (flags & ~known) == 0 && !(dense && masked) && (masked || !causal) &&
            (masked || H % 2 == 0) && (!masked || mid_f32) &&
            (!rows32 || (mid_f32 && n_layers == 1)) && (E % 128 == 0 || n_layers == 1) &&
            n_crops >= 1 && S >= 1 && S <= K9_MAX_SEQ && H >= 1 && E <= 1024 && F >= 128 &&
            F % 128 == 0 && nsp >= 1 && F % nsp == 0 && (F / nsp) % 64 == 0 && F / nsp >= 128 &&
            n_layers >= 1 && grid >= 0 && (long long)n_crops * S * nsp < (1LL << 31);
  ok = ok && x && out && xq && big && hq && bar && (!mid_f32 || mid32) && (ctx || rsc) &&
       ((ctx && nsp == 1) || f32s) && (hs || hsc) && (act || rsc);
  ok = ok && (!act || (ln1_inv && ln2_inv)) && (!ctx || ctx_inv) && (!shift_st || shift) &&
       gelu_c && (folded || (ln1_s && ln1_b && ln2_s && ln2_b));
  for (const void* q : {x, (const void*)out, (const void*)xq, (const void*)big, (const void*)hq,
                        (const void*)f32s, (const void*)mid32, w_qkv, w_out, w_fc, w_proj, ln1_s,
                        ln1_b, ln2_s, ln2_b})
    ok = ok && aligned(q);
  for (const void* q : {w_qkv, qkv_sc, qkv_b, w_out, out_sc, out_b, w_fc, fc_sc, fc_b, w_proj,
                        proj_sc, proj_b})
    ok = ok && q != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  const int M = n_crops * S;
  Params p;
  p.x = x;
  p.out = out;
  p.xq = static_cast<int8_t*>(xq);
  p.qkv = static_cast<bf16*>(big);
  p.hid32 = static_cast<float*>(big);
  p.hq = static_cast<int8_t*>(hq);
  p.f32s = static_cast<float*>(f32s);
  p.mid32 = static_cast<float*>(mid32);
  p.rsc = static_cast<float*>(rsc);
  p.hsc = static_cast<float*>(hsc);
  p.bar = static_cast<unsigned*>(bar);
  p.qkv_sc = static_cast<const float*>(qkv_sc);
  p.qkv_b = static_cast<const float*>(qkv_b);
  p.out_sc = static_cast<const float*>(out_sc);
  p.out_b = static_cast<const float*>(out_b);
  p.fc_sc = static_cast<const float*>(fc_sc);
  p.fc_b = static_cast<const float*>(fc_b);
  p.proj_sc = static_cast<const float*>(proj_sc);
  p.proj_b = static_cast<const float*>(proj_b);
  p.ln1_inv = static_cast<const float*>(ln1_inv);
  p.ctx_inv = static_cast<const float*>(ctx_inv);
  p.ln2_inv = static_cast<const float*>(ln2_inv);
  p.gelu_c = static_cast<const float*>(gelu_c);
  p.shift = static_cast<const float*>(shift);
  p.ln1_s = static_cast<const float*>(ln1_s);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.ln2_s = static_cast<const float*>(ln2_s);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.n_crops = n_crops, p.S = S, p.H = H, p.F = F, p.n_layers = n_layers, p.nsp = nsp;
  p.attn = masked ? (causal ? K9_ATT_CAUSAL : K9_ATT_HEADS)
                  : (dense ? K9_ATT_PAIR : K9_ATT_PAIR_NOFLOOR);
  Maps maps;
  const int L = n_layers;
  int err = tensor_map(&maps.a_x, xq, M, E, GEMM_BM);
  if (!err) err = tensor_map(&maps.b_qkv, w_qkv, L * 3 * E, E, PHASE_BN);
  if (!err) err = tensor_map(&maps.b_out, w_out, L * E, E, PHASE_BN);
  if (!err) err = tensor_map(&maps.b_fc, w_fc, L * F, E, PHASE_BN);
  // c_proj's hidden chunks: 3-D maps whose boxes stop at a chunk's end
  if (!err) err = tensor_map_chunks(&maps.a_h, hq, M, nsp, F / nsp, GEMM_BM);
  if (!err) err = tensor_map_chunks(&maps.b_proj, w_proj, L * E, nsp, F / nsp, PHASE_BN);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows32) return dispatch_rows32(maps, p, grid, s, flags);
  // the masked attention reads no shift: a static one takes the shift-free instance
  if (masked) return dispatch<float, true>(maps, p, grid, s, flags & ~FLAG_STATIC_SHIFT);
  return mid_f32 ? dispatch<float, false>(maps, p, grid, s, flags)
                 : dispatch<bf16, false>(maps, p, grid, s, flags);
}
