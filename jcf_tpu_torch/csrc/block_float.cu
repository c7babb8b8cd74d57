// K9b: one whole pre-LN transformer layer of the float towers in one
// launch, in bf16 (block_bf16) or f32 (block_f32): one template, T the
// rows' type.
//
// Replaces jcf_tpu/ops/block_kernel.py::_block_kernel (:948, pallas_call
// at :1475), _FUSE = "block" on a float tower: the text tower (causal
// bias) and the float vision towers (an all-zero bias). Per sequence of S
// rows (S <= 80), E = 64 H, with the additive [S, S] f32 bias:
//   h    = T(LN1(x))                      (f32 statistics, the affine in T)
//   qkv  = T(h W_qkv^T + b_qkv)
//   ctx  = T(per head: sum_j T(p_ij) v_j), p = exp(s - max s) / sum,
//          s = (q . k) / sqrt(64) + bias   (p normalized in f32, then T)
//   mid  = x + (ctx W_out^T + b_out)      (f32)
//   h2   = T(LN2(mid))
//   hid  = T(g * sigmoid(1.702 g)), g = h2 W_fc^T + b_fc   (QuickGELU)
//   out  = T(mid + (hid W_proj^T + b_proj))
// block_kernel.py::_block_float_plain is the plain version. Epilogues use
// the _rn intrinsics, so nvcc fuses no rounding the reference does apart.
//
// The TPU holds a group of sequences and a whole layer's weights in VMEM.
// On the H100 a sequence's activations do not fit beside the weight tiles
// in shared memory, and a block that owns one sequence re-reads the
// layer's weights for every sequence (the design this file replaced: 347
// GB of L2 reads a bf16 layer at 8192 x 50). So the layer runs as phases
// over the rows, like the halves, inside one persistent launch:
// - the grid is as many blocks as fit on the card at once (the occupancy
//   API), launched cooperatively, so that a grid-wide barrier (an atomic
//   counter that the C entry zeroes before the launch) may separate the
//   phases; a grid that cannot be co-resident is refused, never split;
// - the rows go in chunks of whole sequences (the wrapper passes one
//   chunk of all rows; chunks small enough that a phase's operands stay in
//   the 50 MB L2 were 36-52% slower on one H100, as PERF.md records), each
//   chunk through seven phases with a barrier after each of the first six
//   (the next chunk's LayerNorm writes nothing the last phase reads):
//     LN1 (x -> rows_e), qkv (rows_e -> rows_b), attention (rows_b ->
//     rows_e), out-proj (rows_e, x -> mid), LN2 (mid -> rows_e), c_fc
//     (rows_e -> rows_b), c_proj (rows_b, mid -> out);
//   rows_e [C, E] and rows_b [C, max(3E, F)] in T and mid [C, E] f32 are
//   the chunk's scratch (C its rows), which the wrapper allocates;
// - every product is a GEMM phase on the ring of wgmma_gemm.cuh: a
//   producer thread in a ninth warp loads 128-byte K slices of the A rows
//   and the weights by TMA into a ring of full / empty mbarriers; two
//   consumer warpgroups run wgmma on 128 x 128 output tiles and store
//   through the phase's epilogue. The producer draws the phase's tiles
//   (N-fastest) from a global counter and hands each tile's index to the
//   consumers in a slot of its first stage: drawn statically (block b:
//   tiles b, b + grid, ...), the slowest blocks set each phase's end, and
//   qkv and c_fc took 16% and 19% longer on one H100 (PERF.md).
//   bf16: m64n128k16, a ring of 3 stages, two blocks an SM (the halves'
//   bf16 GEMM; 96 registers). f32: three TF32 products a k8 step as
//   f32_gemm.cu takes them (A split in registers, the weights' hi and lo
//   planes by TMA, a fresh partial per 32-deep stage added in by
//   __fadd_rn), a ring of 4 stages, one block an SM; the weights' planes
//   [2, N, K] come from the tree, split once when it was made
//   (ops/f32_gemm.py with_tf32_planes), so the layer is one launch and
//   splits nothing;
// - LayerNorm: a warp a row, 16-byte chunks a lane, the affine held in
//   registers across the warp's rows (text_block.cu's vector row kernel);
// - the attention: a unit is one (sequence, head). The bias is staged in
//   shared memory once a phase (loaded from L1 score by score it cost the
//   bf16 phase 0.9 of its 2.9 ms); a round stages the Q, K and V of 2 or 4
//   units (bf16) or 2 (f32) in the ring's shared memory with 16-byte
//   cp.async. bf16: a warp takes a 16-row query tile on mma.sync
//   (attn_mma.cuh: load_a_tile, qk_chunk; PV from p packed as its A
//   fragments), p normalized in registers; f32: a warp takes 16 rows on
//   the CUDA cores (attn_f32.cuh's register tiles, twice the rows),
//   skipping the 32-key slots the bias masks for all of them (causal).
// Scratch written in the launch is read back only through L2 (cp.async,
// __ldcg, TMA), never the non-coherent or L1 paths, and each phase ends
// with a proxy fence so that TMA sees the generic writes. Every wait is
// bounded by the global timer: a barrier that does not complete within
// PHASE_WAIT_NS traps instead of holding the card. The grid barrier, the
// producer, the tile walk and the launch are persistent.cuh's, shared with
// the int8 layer kernel (block_int8.cuh).
//
// What bounds it on the H100: the products' operations, E (4E + 2F)
// multiply-adds a row: 5.9 ms at the bf16 peak for 8192 x 50 at E = 768;
// in f32 three TF32 products each, 17.6 ms at 4104 x 50. The GEMM phases
// run at about the halves' GEMMs' rate; what one launch adds over the
// halves' seven is the f32 mid (LN2 reads 4 bytes an element where the
// halves read 2), the sigmoid QuickGELU epilogue (expf and an IEEE
// reciprocal), and an attention that shares the SM with nothing: 18 (bf16)
// or 9 (f32) warps an SM, where the halves' attention kernels run more.
#include "attn_f32.cuh"
#include "persistent.cuh"

namespace {

constexpr int BF_THREADS = GEMM_THREADS_WG;  // 8 consumer warps + the producer warp
constexpr int BF_WARPS = BF_THREADS / 32;
constexpr int BF_BN = PHASE_BN;
constexpr int BF_MAX_SEQ = 80;
constexpr int BF_ATT_LD = 72;  // padded shared row of one head's Q, K or V (bf16)
// floats of one f32 attention unit's Q [80][AF_LD], K [96][AF_LD] and V
// [80][64]; the nine warps' p buffers ([16][AF_LDP] each) follow the units
constexpr int BF_F32_UNIT = (BF_MAX_SEQ + 96) * AF_LD + BF_MAX_SEQ * AF_D;
constexpr int BF_F32_P = BF_WARPS * 16 * AF_LDP;
// the bias staged in shared memory: [S][bias_ld(S)] floats, an even row
// (8-byte pairs) padded off a multiple of 32 banks
__host__ __device__ constexpr int bias_ld(int S) { return ((S + 7) & ~7) + 4; }
constexpr int BF_BIAS_BYTES = BF_MAX_SEQ * bias_ld(BF_MAX_SEQ) * 4;
// bf16: (sequence, head) units staged a round for 16 NC-row tiles: the
// Q, K and V of U units and the bias fill at most the ring's stages
__host__ __device__ constexpr int att_units(int NC) { return NC <= 3 ? 4 : 2; }
__host__ __device__ constexpr int att_unit_bytes(int NC) { return 3 * 16 * NC * BF_ATT_LD * 2; }
// a round's tiles and the bias at their longest sequence, 16 NC rows
__host__ __device__ constexpr int att_bytes(int NC) {
  return att_units(NC) * att_unit_bytes(NC) + 16 * NC * bias_ld(16 * NC) * 4;
}

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  using R = Ring<3, BF_BN, 1>;
  static constexpr int MIN_BLOCKS = 2;
};
template <>
struct Cfg<float> {
  using R = Ring<4, BF_BN, 2>;
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int UNITS = 2;  // (sequence, head) units a round
};
constexpr int BF16_STAGE_AREA = Cfg<bf16>::R::STAGES * Cfg<bf16>::R::STAGE_BYTES;
static_assert(att_bytes(1) <= BF16_STAGE_AREA && att_bytes(2) <= BF16_STAGE_AREA &&
                  att_bytes(3) <= BF16_STAGE_AREA && att_bytes(4) <= BF16_STAGE_AREA &&
                  att_bytes(5) <= BF16_STAGE_AREA,
              "the bf16 attention's tiles and bias fit in the ring's stages");
static_assert((Cfg<float>::UNITS * BF_F32_UNIT + BF_F32_P) * 4 + BF_BIAS_BYTES + 4 * 5 <=
                  Cfg<float>::R::STAGES * Cfg<float>::R::STAGE_BYTES,
              "the f32 attention's tiles, p buffers, bias and slot counts fit in the ring's stages");

// the tensor maps: A rows [C, E] (rows_e: LN1, the context, LN2) and [C,
// F] (rows_b as the hidden); per weight (qkv, out-proj, c_fc, c_proj) its
// bf16 [N, K] rows, or its f32 hi and lo planes
struct Maps {
  CUtensorMap a_e, a_f;
  CUtensorMap b[4][2];
};

template <typename T>
struct Params {
  const T* x;          // [n_seq * S, E]
  T* out;              // [n_seq * S, E]
  T* rows_e;           // [C, E]
  T* rows_b;           // [C, max(3E, F)]: qkv [C, 3E], then the hidden [C, F]
  float* mid;          // [C, E]
  const T *ln1_s, *ln1_b, *ln2_s, *ln2_b;
  const float *b_qkv, *b_out, *b_fc, *b_proj;
  const float* bias;   // [S, S]
  unsigned* bar;       // the grid barrier's counter, then the tile counter; 0 at the launch
  int n_seq, S, H, F, chunk;  // chunk: sequences a chunk
  float scale;
};

// the consumer warpgroups, bf16: per tile and stage four k16 wgmma, one
// group in flight; a stage is released once the group that read it is done
template <class R, class Epi>
__device__ __forceinline__ void consume(bf16*, int M, int N, int tiles_n, int k_steps,
                                        uint32_t ring, uint32_t full0, uint32_t empty0,
                                        const volatile int* slots, RingPos& rp, Epi& epi) {
  const int cw = threadIdx.x >> 7, lane = threadIdx.x & 31;
  for (int t; (t = next_tile<R>(full0, empty0, slots, rp)) >= 0;) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    int held = -1;
    for (int ks = 0; ks < k_steps; ++ks) {
      ring_wait(full0 + 8 * rp.stage, rp.phase);
      __syncwarp();
      const uint32_t a = ring + rp.stage * R::STAGE_BYTES + cw * 64 * GEMM_BK_BYTES;
      const uint32_t b = ring + rp.stage * R::STAGE_BYTES + R::A_BYTES;
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
      held = rp.stage;
      ring_advance(rp.stage, rp.phase, R::STAGES);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);
    store_tile(acc, (t / tiles_n) * GEMM_BM, (t % tiles_n) * BF_BN, M, N, epi);
  }
}

// the consumer warpgroups, f32: per k8 step a_lo b_hi, a_hi b_lo, a_hi
// b_hi into the stage's fresh partial (A split from the swizzled tile in
// registers), the partial added to the tile's sum rounded to nearest
template <class R, class Epi>
__device__ __forceinline__ void consume(float*, int M, int N, int tiles_n, int k_steps,
                                        uint32_t ring, uint32_t full0, uint32_t empty0,
                                        const volatile int* slots, RingPos& rp, Epi& epi) {
  const int tid = threadIdx.x, cw = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3,
            g = lane >> 2, tig = lane & 3;
  const uint32_t row_off = (uint32_t)(cw * 64 + warp * 16 + g) * GEMM_BK_BYTES + 4 * tig;
  for (int t; (t = next_tile<R>(full0, empty0, slots, rp)) >= 0;) {
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
    uint32_t hi[2][4], lo[2][4];
    for (int ks = 0; ks < k_steps; ++ks) {
      ring_wait(full0 + 8 * rp.stage, rp.phase);
      __syncwarp();
      const uint32_t base = ring + rp.stage * R::STAGE_BYTES;
      const uint32_t a = base + row_off;
      const uint32_t b_hi = base + R::A_BYTES, b_lo = b_hi + R::B_BYTES;
#pragma unroll
      for (int kk = 0; kk < GEMM_BK_BYTES / 32; ++kk) {
        const uint32_t c0 = (uint32_t)((2 * kk) ^ g) << 4, c1 = (uint32_t)((2 * kk + 1) ^ g) << 4;
        const uint32_t x[4] = {lds_u32(a + c0), lds_u32(a + 8 * GEMM_BK_BYTES + c0),
                               lds_u32(a + c1), lds_u32(a + 8 * GEMM_BK_BYTES + c1)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[kk & 1][i] = tf32_rna(x[i]);
          lo[kk & 1][i] = tf32_rna(
              __float_as_uint(__fsub_rn(__uint_as_float(x[i]), __uint_as_float(hi[kk & 1][i]))));
        }
        fence_acc(part);
        wgmma_fence();
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
      if (lane == 0) mbar_arrive(empty0 + 8 * rp.stage);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      ring_advance(rp.stage, rp.phase, R::STAGES);
    }
    store_tile(acc, (t / tiles_n) * GEMM_BM, (t % tiles_n) * BF_BN, M, N, epi);
  }
}

// one GEMM phase: C[m, n] = sum_k A[m, k] W[n, k] over the chunk's M rows
// and N columns, depth K, through epi; the producer warp's lane 0 loads,
// warps 0-7 consume; slots: one tile index a ring stage; ctr: the tile
// counter
template <typename T, class Epi>
__device__ __forceinline__ void gemm_phase(const CUtensorMap* ma, const CUtensorMap (&mb)[2], int M,
                                           int N, int K, uint32_t ring, uint32_t full0,
                                           uint32_t empty0, volatile int* slots, unsigned* ctr,
                                           RingPos& rp, Epi epi) {
  using R = typename Cfg<T>::R;
  const int tiles_n = (N + BF_BN - 1) / BF_BN;
  const int tiles = ((M + GEMM_BM - 1) / GEMM_BM) * tiles_n;
  const int k_steps = (int)(((long long)K * sizeof(T) + GEMM_BK_BYTES - 1) / GEMM_BK_BYTES);
  if (threadIdx.x >= 32 * GEMM_CONSUMER_WARPS) {
    if (threadIdx.x == 32 * GEMM_CONSUMER_WARPS)
      produce<R>(ma, &mb[0], &mb[1], tiles, tiles_n, k_steps, ring, full0, empty0, slots, ctr, rp);
    __syncwarp();
  } else {
    consume<R>(static_cast<T*>(nullptr), M, N, tiles_n, k_steps, ring, full0, empty0, slots, rp,
               epi);
  }
}

// ---------------------------------------------------------------------------
// stores and loads of T pairs and 16-byte chunks
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}

// the V = 16 / sizeof(T) values of one output chunk from its input row
// (the rows x, input; mid, written in the launch: through L2)
__device__ __forceinline__ void load_chunk(const bf16* p, float (&v)[8]) {
  lnv_unpack(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

// ---------------------------------------------------------------------------
// LayerNorm rows
// ---------------------------------------------------------------------------

// out[r] = T(LN(in[r]) * scale + bias) for r < M, a warp a row over the
// grid's warps; a lane holds the 16-byte output chunks lane + 32 k of T
// (V values), and its chunks of the affine across its rows
template <typename T, typename I>
__device__ __forceinline__ void ln_phase(const I* in, T* out, const T* scale, const T* bias, int M,
                                         int E) {
  constexpr int V = 16 / sizeof(T), CPL = 1024 / (32 * V);
  const int lane = threadIdx.x & 31, chunks = E / V;
  bool live[CPL];
  uint4 sc[CPL], bi[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    live[k] = c < chunks;
    sc[k] = bi[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live[k]) {
      sc[k] = reinterpret_cast<const uint4*>(scale)[c];
      bi[k] = reinterpret_cast<const uint4*>(bias)[c];
    }
  }
  for (int row = blockIdx.x * BF_WARPS + (threadIdx.x >> 5); row < M; row += gridDim.x * BF_WARPS) {
    float v[CPL][V];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (live[k]) {
        load_chunk(in + (long long)row * E + (lane + 32 * k) * V, v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[k][i] = 0.0f;
      }
    }
    const float2 st = ln_vec_stats<CPL, V>(v, live, E);
    uint4* dst = reinterpret_cast<uint4*>(out + (long long)row * E);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (!live[k]) continue;
      float s[V], b[V], y[V];
      lnv_unpack(sc[k], s);
      lnv_unpack(bi[k], b);
#pragma unroll
      for (int i = 0; i < V; ++i)
        y[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[k][i], st.x), st.y), s[i]), b[i]);
      dst[lane + 32 * k] = lnv_pack(y);
    }
  }
}

// ---------------------------------------------------------------------------
// the attention
// ---------------------------------------------------------------------------

// the bias [S, S] into shared memory at sb, rows of bias_ld(S) floats
__device__ __forceinline__ void stage_bias(float* sb, const float* bias, int S) {
  const int ld = bias_ld(S);
  for (int i = threadIdx.x; i < S * S; i += BF_THREADS) {
    const int r = i / S;
    sb[r * ld + (i - r * S)] = __ldg(bias + i);
  }
}

// one head's 16-row query tile (row m0 of the sequence; its Q rows at qs)
// against its S staged keys, on mma.sync: s = (q . k) * scale + bias (the
// staged bias sb), the row max, p = exp(s - m) / l in f32 (the IEEE
// quotient from one reciprocal a row, div_rcp), p packed as PV's A
// fragments (so that the scores are dead before the context's sums are
// live), the context rounded to bf16 at dst (row m0; ld E)
template <int NC>
__device__ __forceinline__ void head_tile_bf16(const bf16* qs, const bf16* ks, const bf16* vs,
                                               const float* sb, int S, int m0, float scale,
                                               bf16* dst, long long ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3, bld = bias_ld(S);
  float sc[2 * NC][4];
  {
    unsigned a[4][4];
    load_a_tile<BF_ATT_LD>(a, qs);
#pragma unroll
    for (int c = 0; c < NC; ++c) qk_chunk<BF_ATT_LD>(sc[2 * c], sc[2 * c + 1], a, ks + 16 * c * BF_ATT_LD);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + g + 8 * h;
    const float* br = sb + row * bld + 2 * tig;
#pragma unroll
    for (int t = 0; t < 2 * NC; ++t) {
      const int key = 8 * t + 2 * tig;
      const float2 b = row < S && key < S ? *reinterpret_cast<const float2*>(br + 8 * t)
                                          : make_float2(0.0f, 0.0f);
      const float s0 = __fadd_rn(__fmul_rn(sc[t][2 * h], scale), b.x);
      const float s1 = __fadd_rn(__fmul_rn(sc[t][2 * h + 1], scale), b.y);
      sc[t][2 * h] = key < S ? s0 : -INFINITY;
      sc[t][2 * h + 1] = key + 1 < S ? s1 : -INFINITY;
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, y[2];
  tile_max<NC>(sc, m);
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
  exp_tile<NC, false>(sc, m, l);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    y[r] = __frcp_rn(l[r]);
  }
  unsigned pa[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        pa[c][2 * h + r] = pack_bf16(div_rcp(sc[2 * c + h][2 * r], l[r], y[r]),
                                     div_rcp(sc[2 * c + h][2 * r + 1], l[r], y[r]));
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  const int mat = lane >> 3;
  const bf16* vrow = vs + ((mat & 1) * 8 + (lane & 7)) * BF_ATT_LD + (mat >> 1) * 8;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm_x4_trans(b, vrow + c * 16 * BF_ATT_LD + np * 16);
      const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[2 * np], pa[c], b0);
      mma_bf16(acc[2 * np + 1], pa[c], b1);
    }
  store_tile_bf16(acc, dst, ld, S - m0);
}

// bf16: the bias is staged once; each round stages the Q, K and V of U
// (sequence, head) units (16 NC rows each, zero past S) with 16-byte
// cp.async, then the block's nine warps take the round's 16-row query
// tiles
template <int NC>
__device__ __forceinline__ void attention_bf16(const Params<bf16>& p, int n_seq,
                                               unsigned char* smem) {
  constexpr int U = att_units(NC), KP = 16 * NC, UNIT = 3 * KP * BF_ATT_LD;
  const int S = p.S, H = p.H, E = 64 * H, E3 = 3 * E, units = n_seq * H, T = (S + 15) >> 4;
  const int warp = threadIdx.x >> 5;
  bf16* const tiles = reinterpret_cast<bf16*>(smem);
  float* const sb = reinterpret_cast<float*>(smem + U * att_unit_bytes(NC));
  stage_bias(sb, p.bias, S);
  for (int base = blockIdx.x * U; base < units; base += gridDim.x * U) {
    for (int c = threadIdx.x; c < U * 3 * KP * 8; c += BF_THREADS) {
      // row r of the round: unit r / (3 KP), its Q, K or V (r / KP % 3)
      const int r = c >> 3, ub = r / (3 * KP), t = (r / KP) % 3, row = r % KP, col = (c & 7) * 8;
      const int unit = base + ub;
      const bool ok = unit < units && row < S;
      const bf16* src = p.rows_b + ((long long)(unit / H) * S + row) * E3 + t * E +
                        (unit % H) * 64 + col;
      cp_async16(tiles + r * BF_ATT_LD + col, ok ? src : p.rows_b, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = warp; i < U * T; i += BF_WARPS) {
      const int ub = i / T, m0 = (i - ub * T) * 16, unit = base + ub;
      if (unit >= units) break;
      const bf16* qs = tiles + ub * UNIT;
      head_tile_bf16<NC>(qs + m0 * BF_ATT_LD, qs + KP * BF_ATT_LD, qs + 2 * KP * BF_ATT_LD, sb,
                         S, m0, p.scale,
                         p.rows_e + ((long long)(unit / H) * S + m0) * E + (unit % H) * 64, E);
    }
    __syncthreads();
  }
}

// The f32 attention of one warp on 16 query rows: attn_f32.cuh's register
// tiles with twice the rows, so that each key (and value) read from shared
// memory feeds 16 rows; the same sums in the same order (q . k over d,
// one FMA a step; PV over the keys in order). Lane l holds the scores of
// keys l + 32 t; for PV lane (rh, c) holds o[i] = columns 4 c .. 4 c + 3
// of row 8 rh + i.
template <int NT>
__device__ __forceinline__ void scores16_n(float (&acc)[16][3], const float* q_s, const float* kl) {
#pragma unroll 2
  for (int d = 0; d < AF_D; d += 4) {
    float4 kv[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) kv[t] = *reinterpret_cast<const float4*>(kl + 32 * t * AF_LD + d);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + i * AF_LD + d);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float a = acc[i][t];
        a = fmaf(qv.x, kv[t].x, a);
        a = fmaf(qv.y, kv[t].y, a);
        a = fmaf(qv.z, kv[t].z, a);
        a = fmaf(qv.w, kv[t].w, a);
        acc[i][t] = a;
      }
    }
  }
}

// the scores of 16 rows from row0 (q_s its Q row, k_s the staged key 0):
// x scale, + the staged bias, -inf past the nt slots and keys >= S; then p
// = exp(s - m) / l per row (af_softmax's sums and quotient)
__device__ __forceinline__ void probs16(float (&acc)[16][3], const float* q_s, const float* k_s,
                                        int row0, int nt, int S, const float* sb, float scale) {
  const int lane = threadIdx.x & 31, bld = bias_ld(S);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int t = 0; t < 3; ++t) acc[i][t] = 0.0f;
  const float* kl = k_s + lane * AF_LD;
  if (nt == 1) scores16_n<1>(acc, q_s, kl);
  else if (nt == 2) scores16_n<2>(acc, q_s, kl);
  else scores16_n<3>(acc, q_s, kl);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = row0 + i;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int j = lane + 32 * t;
      float sv = -INFINITY;
      if (t < nt && j < S) {
        sv = __fmul_rn(acc[i][t], scale);
        if (row < S) sv = __fadd_rn(sv, sb[row * bld + j]);
      }
      acc[i][t] = sv;
    }
    float mx = fmaxf(fmaxf(acc[i][0], acc[i][1]), acc[i][2]);
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float e = t < nt ? expf(__fsub_rn(acc[i][t], mx)) : 0.0f;
      acc[i][t] = e;
      sum += e;
    }
    sum = af_lane_sum(sum);
    const float y = __frcp_rn(sum);
#pragma unroll
    for (int t = 0; t < 3; ++t) acc[i][t] = div_rcp(acc[i][t], sum, y);
  }
}

// o += p . V over the keys [0, 32 nt) clipped to n_keys (a multiple of 4),
// p through the warp's [16][AF_LDP] buffer pw, v_s the staged value 0
__device__ __forceinline__ void pv16(float (&o)[8][4], const float (&p)[16][3], float* pw,
                                     const float* v_s, int nt, int n_keys) {
  const int lane = threadIdx.x & 31;
  const float* pr = pw + (lane >> 4) * 8 * AF_LDP;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t < nt) {
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16; ++i) pw[i * AF_LDP + lane] = p[i][t];
      __syncwarp();
      const int jn = min(32, n_keys - 32 * t);
      const float* vt = v_s + 32 * t * AF_D + (lane & 15) * 4;
#pragma unroll 2
      for (int jj = 0; jj < jn; jj += 4) {
        float4 vv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) vv[x] = *reinterpret_cast<const float4*>(vt + (jj + x) * AF_D);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + i * AF_LDP + jj);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            o[i][0] = fmaf(pj[x], vv[x].x, o[i][0]);
            o[i][1] = fmaf(pj[x], vv[x].y, o[i][1]);
            o[i][2] = fmaf(pj[x], vv[x].z, o[i][2]);
            o[i][3] = fmaf(pj[x], vv[x].w, o[i][3]);
          }
        }
      }
    }
  }
}

// f32: the bias is staged once; each round stages the Q, K and V of 2
// units (Q and K rows of AF_LD floats, Q zero-filled to 16-row units, K
// to 32-key slots), then the block's nine warps take its 16-row units
__device__ __forceinline__ void attention_f32(const Params<float>& p, int n_seq,
                                              unsigned char* smem) {
  constexpr int U = Cfg<float>::UNITS;
  const int S = p.S, H = p.H, E = 64 * H, E3 = 3 * E, units = n_seq * H;
  const int S16 = (S + 15) & ~15, SK = (S + 31) & ~31, S4 = (S + 3) & ~3, R16 = S16 >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const sm = reinterpret_cast<float*>(smem);
  float* const pw = sm + U * BF_F32_UNIT + warp * 16 * AF_LDP;
  float* const sb = sm + U * BF_F32_UNIT + BF_F32_P;
  // key slots a 16-row unit takes: those before its rows' last key the
  // bias leaves finite (a causal mask halves the text tower's); the slots
  // after it hold exp(-inf) = 0 for every row, so skipping them changes
  // no bit
  int* const unit_slots = reinterpret_cast<int*>(sb + S * bias_ld(S));
  stage_bias(sb, p.bias, S);
  __syncthreads();
  if (warp < R16) {
    const int row = warp * 16 + (lane & 15);
    int last = -1;
    if (lane < 16 && row < S)
      for (int j = S - 1; j >= 0 && last < 0; --j)
        if (sb[row * bias_ld(S) + j] != -INFINITY) last = j;
    for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    if (lane == 0) unit_slots[warp] = max(1, (last + 32) >> 5);
  }
  for (int base = blockIdx.x * U; base < units; base += gridDim.x * U) {
    for (int ub = 0; ub < U && base + ub < units; ++ub) {
      const int unit = base + ub;
      float* q_s = sm + ub * BF_F32_UNIT;
      const float* src = p.rows_b + (long long)(unit / H) * S * E3 + (unit % H) * 64;
      af_stage(q_s, AF_LD, src, E3, S16, S);
      af_stage(q_s + S16 * AF_LD, AF_LD, src + E, E3, SK, S);
      af_stage(q_s + (S16 + SK) * AF_LD, AF_D, src + 2 * E, E3, S4, S);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = warp; i < U * R16; i += BF_WARPS) {
      const int ub = i / R16, r0 = (i - ub * R16) * 16, unit = base + ub;
      if (unit >= units) break;
      const float* q_s = sm + ub * BF_F32_UNIT;
      const float* k_s = q_s + S16 * AF_LD;
      const int ns = unit_slots[r0 >> 4];
      float acc[16][3];
      probs16(acc, q_s + r0 * AF_LD, k_s, r0, ns, S, sb, p.scale);
      float o[8][4] = {};
      pv16(o, acc, pw, k_s + SK * AF_LD, ns, S4);
      float* dst = p.rows_e + (long long)(unit / H) * S * E + (unit % H) * 64 + (lane & 15) * 4;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = r0 + (lane >> 4) * 8 + r;
        if (row < S)
          *reinterpret_cast<float4*>(dst + (long long)row * E) =
              make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void attention(const Params<float>& p, int n_seq, unsigned char* smem) {
  attention_f32(p, n_seq, smem);
}

// bf16: NC, the 16-key chunks a tile's scores hold, from S
__device__ __forceinline__ void attention(const Params<bf16>& p, int n_seq, unsigned char* smem) {
  switch ((p.S + 15) >> 4) {
    case 1: attention_bf16<1>(p, n_seq, smem); break;
    case 2: attention_bf16<2>(p, n_seq, smem); break;
    case 3: attention_bf16<3>(p, n_seq, smem); break;
    case 4: attention_bf16<4>(p, n_seq, smem); break;
    default: attention_bf16<5>(p, n_seq, smem); break;
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BF_THREADS, Cfg<T>::MIN_BLOCKS)
    block_float_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params<T> p) {
  using R = typename Cfg<T>::R;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* tiles = smem_raw + (ring - raw);  // the attention's, in the ring's stages
  const uint32_t full0 = ring + R::STAGES * R::STAGE_BYTES, empty0 = full0 + R::STAGES * 8;
  volatile int* slots = reinterpret_cast<int*>(tiles + R::STAGES * R::STAGE_BYTES + 16 * R::STAGES);
  unsigned* ctr = p.bar + 1;
  const int S = p.S, E = 64 * p.H, F = p.F;
  RingPos rp;
  unsigned target = 0;
  ring_init<R>(full0, empty0);
  for (int seq0 = 0; seq0 < p.n_seq; seq0 += p.chunk) {
    const int n_seq = min(p.chunk, p.n_seq - seq0), M = n_seq * S;
    const long long r0 = (long long)seq0 * S;
    const T* x = p.x + r0 * E;
    T* out = p.out + r0 * E;
    ln_phase<T, T>(x, p.rows_e, p.ln1_s, p.ln1_b, M, E);
    grid_sync(p.bar, target);
    gemm_phase<T>(&maps.a_e, maps.b[0], M, 3 * E, E, ring, full0, empty0, slots, ctr, rp,
                  [qkv = p.rows_b, b = p.b_qkv, E](int m, int n, float v0, float v1) {
                    store2(qkv + (long long)m * 3 * E + n, __fadd_rn(v0, b[n]),
                           __fadd_rn(v1, b[n + 1]));
                  });
    grid_sync(p.bar, target);
    attention(p, n_seq, tiles);
    grid_sync(p.bar, target);
    gemm_phase<T>(&maps.a_e, maps.b[1], M, E, E, ring, full0, empty0, slots, ctr, rp,
                  [x, mid = p.mid, b = p.b_out, E](int m, int n, float v0, float v1) {
                    const long long i = (long long)m * E + n;
                    const float2 r = load2(x + i);
                    store2(mid + i, __fadd_rn(r.x, __fadd_rn(v0, b[n])),
                           __fadd_rn(r.y, __fadd_rn(v1, b[n + 1])));
                  });
    grid_sync(p.bar, target);
    ln_phase<T, float>(p.mid, p.rows_e, p.ln2_s, p.ln2_b, M, E);
    grid_sync(p.bar, target);
    gemm_phase<T>(&maps.a_e, maps.b[2], M, F, E, ring, full0, empty0, slots, ctr, rp,
                  [hid = p.rows_b, b = p.b_fc, F](int m, int n, float v0, float v1) {
                    const float g0 = __fadd_rn(v0, b[n]), g1 = __fadd_rn(v1, b[n + 1]);
                    const float s0 = __frcp_rn(__fadd_rn(1.0f, expf(-__fmul_rn(1.702f, g0))));
                    const float s1 = __frcp_rn(__fadd_rn(1.0f, expf(-__fmul_rn(1.702f, g1))));
                    store2(hid + (long long)m * F + n, __fmul_rn(g0, s0), __fmul_rn(g1, s1));
                  });
    grid_sync(p.bar, target);
    gemm_phase<T>(&maps.a_f, maps.b[3], M, E, F, ring, full0, empty0, slots, ctr, rp,
                  [out, mid = p.mid, b = p.b_proj, E](int m, int n, float v0, float v1) {
                    const long long i = (long long)m * E + n;
                    const float2 r = __ldcg(reinterpret_cast<const float2*>(mid + i));
                    store2(out + i, __fadd_rn(r.x, __fadd_rn(v0, b[n])),
                           __fadd_rn(r.y, __fadd_rn(v1, b[n + 1])));
                  });
    // the next chunk's LN1 writes rows_e, which c_fc read before the last
    // barrier; its qkv writes rows_b after the next barrier
  }
}

// the ring and its barriers, then a tile slot a stage
template <typename T>
size_t smem_bytes() {
  return (size_t)Cfg<T>::R::SMEM + 4 * Cfg<T>::R::STAGES;
}

template <typename T>
int launch(Params<T> p, const void* const* w, cudaStream_t stream) {
  const int E = 64 * p.H, C = p.chunk * p.S;
  const int t = (int)sizeof(T);
  Maps maps;
  int err = tensor_map(&maps.a_e, p.rows_e, C, (long long)E * t, GEMM_BM);
  if (!err) err = tensor_map(&maps.a_f, p.rows_b, C, (long long)p.F * t, GEMM_BM);
  const int n[4] = {3 * E, E, p.F, E}, k[4] = {E, E, E, p.F};
  for (int i = 0; i < 4 && !err; ++i) {
    if (std::is_same<T, float>::value) {  // the hi plane, then the lo plane
      const float* hi = static_cast<const float*>(w[i]);
      err = tensor_map(&maps.b[i][0], hi, n[i], 4LL * k[i], BF_BN);
      if (!err)
        err = tensor_map(&maps.b[i][1], hi + (long long)n[i] * k[i], n[i], 4LL * k[i], BF_BN);
    } else {
      err = tensor_map(&maps.b[i][0], w[i], n[i], 2LL * k[i], BF_BN);
      maps.b[i][1] = maps.b[i][0];
    }
  }
  if (err) return err;
  return launch_persistent(block_float_kernel<T>, BF_THREADS, smem_bytes<T>(), p.bar, 2, 0, stream,
                           maps, p);
}

template <typename T>
int run(const void* x, void* out, void* rows_e, void* rows_b, void* mid, void* bar,
        const void* const* ops, const float* bias, int n_seq, int S, int H, int F, int chunk,
        float scale, cudaStream_t stream) {
  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  p.rows_e = static_cast<T*>(rows_e);
  p.rows_b = static_cast<T*>(rows_b);
  p.mid = static_cast<float*>(mid);
  p.ln1_s = static_cast<const T*>(ops[0]);
  p.ln1_b = static_cast<const T*>(ops[1]);
  p.b_qkv = static_cast<const float*>(ops[3]);
  p.b_out = static_cast<const float*>(ops[5]);
  p.ln2_s = static_cast<const T*>(ops[6]);
  p.ln2_b = static_cast<const T*>(ops[7]);
  p.b_fc = static_cast<const float*>(ops[9]);
  p.b_proj = static_cast<const float*>(ops[11]);
  const void* const w[4] = {ops[2], ops[4], ops[8], ops[10]};
  p.bias = bias;
  p.bar = static_cast<unsigned*>(bar);
  p.n_seq = n_seq, p.S = S, p.H = H, p.F = F, p.chunk = chunk;
  p.scale = scale;
  return launch<T>(p, w, stream);
}

}  // namespace

// K9b (_block_kernel) in bf16 (f32 = 0) or f32 (f32 = 1): x [n_seq * S, E]
// -> out (same shape and type), S <= 80, head dim 64, E <= 1024; chunk:
// sequences a chunk (C = chunk * S rows); rows_e [C, E] and rows_b [C,
// max(3E, F)] of the rows' type, mid [C, E] f32; bar two unsigned (the
// grid barrier, the tile counter); ln1_s, ln1_b, ln2_s, ln2_b [E] of the
// rows' type; w_qkv [3E, E], w_out [E, E], w_fc [F, E], w_proj [E, F]
// ([out, in]) in bf16, or in f32 their TF32 hi and lo planes [2, N, K]; the
// four biases f32; bias [S, S] f32 additive; scale = 1/sqrt(64). Every
// pointer 16-byte aligned; F a multiple of 8.
extern "C" int jcf_block_float(int f32, const void* x, void* out, void* rows_e, void* rows_b,
                               void* mid, void* bar, const void* ln1_s,
                               const void* ln1_b, const void* w_qkv, const void* b_qkv,
                               const void* w_out, const void* b_out, const void* ln2_s,
                               const void* ln2_b, const void* w_fc, const void* b_fc,
                               const void* w_proj, const void* b_proj, const void* bias, int n_seq,
                               int S, int H, int F, int chunk, float scale, void* stream) {
  const int E = 64 * H;
  const void* const ops[12] = {ln1_s, ln1_b, w_qkv, b_qkv, w_out, b_out,
                               ln2_s, ln2_b, w_fc,  b_fc,  w_proj, b_proj};
  bool ok = n_seq >= 1 && S >= 1 && S <= BF_MAX_SEQ && H >= 1 && E <= 1024 && F >= 8 &&
            F % 8 == 0 && chunk >= 1 && bias != nullptr && bar != nullptr && x && out &&
            rows_e && rows_b && mid;
  for (const void* q : {x, (const void*)out, (const void*)rows_e, (const void*)rows_b,
                        (const void*)mid})
    ok = ok && ((uintptr_t)q & 15) == 0;
  for (const void* q : ops) ok = ok && q != nullptr && ((uintptr_t)q & 15) == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = static_cast<const float*>(bias);
  return f32 ? run<float>(x, out, rows_e, rows_b, mid, bar, ops, b, n_seq, S, H, F, chunk, scale, s)
             : run<bf16>(x, out, rows_e, rows_b, mid, bar, ops, b, n_seq, S, H, F, chunk, scale, s);
}
