// K3/K4 row and attention kernels of the int8 tower halves, and the K5
// CLS-query attention of the last layer, for every quantization the
// folded tree carries: static or dynamic per-row activation scales, a
// static or dynamic context scale, an optional calibrated softmax shift.
//
// The TPU runs each half of a layer as one Pallas kernel
// (jcf_tpu/ops/block_kernel.py::_attn_half_int8_kernel and
// ::_mlp_half_int8_kernel) because VMEM holds a whole crop tile plus the
// layer's weights. On the H100 a half is a few launches instead: this
// file's LayerNorm+quant row kernel, attention kernel and row-quant
// kernel, and the int8 tensor-core GEMM with fused epilogues in
// int8_gemm.cu. With static scales every intermediate between them is
// int8 or bf16, so the round trips through device memory stay at 1-2
// bytes per activation; a dynamic context or hidden scale adds one f32
// round trip of that activation (its row amax spans blocks).
#include "common.cuh"
#include "pair_attention.cuh"
#include "pair_mma.cuh"
#include "row_quant.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm + static or dynamic int8 quantization of bf16 or f32 rows
// ---------------------------------------------------------------------------
//
// Replaces the head of both halves and of K5. On the folded tree:
// _ln_norm (the LN affine is folded into the next projection's weights)
// then _quant_rows_static:
//   q = clip(round(((x - mean) * rsqrt(var + 1e-5)) * ln_inv), -127, 127)
// or, without a calibrated ln_inv, _quant_rows (DYN below). On the
// unfolded tree (AFFINE, dynamic only): _ln_rows then _quant_rows, the
// affine after the z-norm, a product and a sum each rounded to f32:
//   y = ((x - mean) * rsqrt(var + 1e-5)) * g + b
// with g and b in f32 (the caller rounds them to the rows' dtype where
// _halves_block casts them, block_kernel.py:1178, :1201, and keeps the
// layer params' f32 affine on the CLS rows, :1918-1921). Rows in bf16
// (the vision tower, a bf16 text tower) or f32 (the f32 text tower,
// whose residual stream stays f32 through the halves).
// Bound on the H100: bytes (2 or 4 B in, 1 B out per element).
//
// Rows of width 512 or 768 on 16-byte aligned tensors (every tower of the
// port) take ln_quant_vec_kernel, the row design of text_block.cu's
// ln_affine_vec_kernel: a grid sized to the card, each warp looping over
// rows; a lane holds the row's 16-byte chunks c = lane + 32k (8 bf16 or 4
// f32 contiguous elements each), the f32 affine's matching values in
// registers across all its rows, and issues the next row's loads before
// the current row's two reductions; the row's int8 values leave packed,
// 8 bytes a bf16 chunk and 4 an f32 chunk, and lane 0 writes the dynamic
// scale. Other rows take ln_quant_kernel, one warp a row in 2-byte (or
// 4-byte) slots j = lane + 32k, the wrapper's "/scalar" route.

constexpr int LNQ_WARPS = 8;
constexpr int LNQ_PER = 32;  // E <= 1024

// DYN: no calibrated scale; the row's own (_quant_rows):
//   amax = max(max |y|, 1e-8), q = clip(round(y * (127 / amax))),
//   scale = amax * f32(1/127)
// (a reciprocal multiply, as the reference; ops.quant.quantize_rows of
// the composable tower divides, which rounds differently).
template <typename T, bool DYN, bool AFFINE>
__global__ void __launch_bounds__(LNQ_WARPS * 32) ln_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    const float* __restrict__ inv_p, int8_t* __restrict__ out, float* __restrict__ scale, int M,
    int E) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LNQ_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + row * E;
  float v[LNQ_PER];
#pragma unroll
  for (int k = 0; k < LNQ_PER; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < E ? to_f(xr[j]) : 0.0f;
  }
  const float2 st = warp_row_stats<LNQ_PER>(v, lane, E);
#pragma unroll
  for (int k = 0; k < LNQ_PER; ++k) {
    const int j = lane + 32 * k;
    if (j < E) {
      float y = __fmul_rn(__fsub_rn(v[k], st.x), st.y);
      if (AFFINE) y = __fadd_rn(__fmul_rn(y, g[j]), b[j]);
      v[k] = y;
    }
  }
  float inv;
  if (DYN) {
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < LNQ_PER; ++k)
      if (lane + 32 * k < E) amax = fmaxf(amax, fabsf(v[k]));
    amax = fmaxf(warp_max(amax), 1e-8f);
    inv = __fdiv_rn(127.0f, amax);
    if (lane == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
  } else {
    inv = *inv_p;
  }
  int8_t* o = out + row * E;
#pragma unroll
  for (int k = 0; k < LNQ_PER; ++k) {
    const int j = lane + 32 * k;
    if (j < E) o[j] = round_clip_int8(__fmul_rn(v[k], inv));
  }
}

// CPL chunks a lane, E = 32 * CPL * V: every lane holds CPL chunks; the
// row body is row_quant.cuh's ln_quant_vec_row, shared with K9a / K9c
template <typename T, int CPL, bool DYN, bool AFFINE>
__global__ void __launch_bounds__(LNQ_WARPS * 32) ln_quant_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    const float* __restrict__ inv_p, int8_t* __restrict__ out, float* __restrict__ scale,
    int M) {
  constexpr int V = 16 / sizeof(T);
  constexpr int E = 32 * CPL * V;
  const int lane = threadIdx.x & 31;
  bool live[CPL];
  float ga[AFFINE ? CPL : 1][V], ba[AFFINE ? CPL : 1][V];
  uint4 cur[CPL], nxt[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    live[k] = true;
    cur[k] = nxt[k] = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (AFFINE) {
      const int c = lane + 32 * k;
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        lnv_unpack(reinterpret_cast<const uint4*>(g)[c * (V / 4) + i],
                   *reinterpret_cast<float(*)[4]>(&ga[k][4 * i]));
        lnv_unpack(reinterpret_cast<const uint4*>(b)[c * (V / 4) + i],
                   *reinterpret_cast<float(*)[4]>(&ba[k][4 * i]));
      }
    }
  }
  const float inv_static = DYN ? 0.0f : *inv_p;
  const long long stride = (long long)gridDim.x * LNQ_WARPS;
  long long row = (long long)blockIdx.x * LNQ_WARPS + (threadIdx.x >> 5);
  auto load = [&](uint4 (&r)[CPL], long long at) {
    const uint4* src = reinterpret_cast<const uint4*>(x + at * E);
#pragma unroll
    for (int k = 0; k < CPL; ++k) r[k] = src[lane + 32 * k];
  };
  if (row < M) load(cur, row);
  for (; row < M; row += stride) {
    if (row + stride < M) load(nxt, row + stride);
    ln_quant_vec_row<T, CPL, DYN, AFFINE>(cur, live, E, ga, ba, inv_static, out + row * E,
                                          DYN ? scale + row : nullptr);
#pragma unroll
    for (int k = 0; k < CPL; ++k) cur[k] = nxt[k];
  }
}

// ---------------------------------------------------------------------------
// dynamic per-row int8 quantization of f32 rows (_quant_rows), optionally
// after QuickGELU in its tanh form (_quick_gelu32)
// ---------------------------------------------------------------------------
//
// Replaces the reference's in-kernel quantizations that have no
// calibrated scale: the attention context over a whole E-wide row (all
// head pairs, which block.cu's attention spreads over E / 128 blocks, so
// the context comes here as f32), and the MLP hidden over all 3072
// columns (_MLP_NSPLIT = 1) after the c_fc GEMM's f32 epilogue:
//   g = GELU ? h * (0.5 + 0.5 tanh(0.851 h)) : h
//   amax = max(max |g|, 1e-8), q = clip(round(g * (127 / amax))),
//   scale = amax * f32(1/127)
// Bound on the H100: bytes (4 B in, 1 B out per element); with GELU the
// tanhf of every element sits close under it, so the loads must stay in
// flight while it runs.
//
// Rows of a width that is a multiple of 4 on 16-byte aligned tensors take
// quant_rows_vec_kernel, the row design of ln_quant_vec_kernel: a grid
// sized to the card, each row group looping over rows; a thread holds the
// row's float4 chunks c = t + 32 G k (t its index in the group of G warps)
// and issues the next row's loads before the current row's tanhf and max;
// the int8 values leave packed, 4 bytes a chunk, and thread 0 of the group
// writes the scale. Up to 1024 wide a warp owns a row (G = 1, 8 rows a
// block); wider rows would hold up to 128 values a lane, twice that with
// the next row in flight, so a group of 4 warps owns a row (G = 4, one row
// a block, the warps' maxima exchanged through shared memory, one barrier
// a row). Widths 512, 768, 2048 and 3072 have instances of their own,
// other widths a general instance of each group size. amax is an exact
// max and every element's arithmetic is the scalar kernel's, so both
// routes write the same bits. Other rows take quant_rows_kernel, one block
// a row in 4-byte slots, the wrapper's "/scalar" route.

constexpr int QR_THREADS = 256;
constexpr int QR_PER = 16;  // N <= 4096

template <bool GELU>
__global__ void __launch_bounds__(QR_THREADS) quant_rows_kernel(
    const float* __restrict__ x, int8_t* __restrict__ out, float* __restrict__ scale, int N) {
  __shared__ float red[QR_THREADS / 32];
  const long long row = blockIdx.x;
  const float* xr = x + row * N;
  float v[QR_PER];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < QR_PER; ++k) {
    const int j = threadIdx.x + QR_THREADS * k;
    float g = 0.0f;
    if (j < N) g = quick_gelu_tanh<GELU>(xr[j]);
    v[k] = g;
    amax = fmaxf(amax, fabsf(g));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QR_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  amax = fmaxf(amax, 1e-8f);
  const float inv = __fdiv_rn(127.0f, amax);
  if (threadIdx.x == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
  int8_t* o = out + row * N;
#pragma unroll
  for (int k = 0; k < QR_PER; ++k) {
    const int j = threadIdx.x + QR_THREADS * k;
    if (j < N) o[j] = round_clip_int8(__fmul_rn(v[k], inv));
  }
}

// the vector kernel's rows a block: 8 warps of one row each (G = 1), or
// one group of G warps
constexpr int QRV_WARPS = 8;
__host__ __device__ constexpr int qrv_threads(int G) {
  return G == 1 ? QRV_WARPS * 32 : G * 32;
}

// G warps a row, CPL chunks a thread; FIXED_N > 0: N = FIXED_N = 128 G
// CPL (every thread holds CPL chunks), 0: N at run time, N / 4 <= 32 G
// CPL chunks, a thread's chunk past the row neither loaded nor stored
template <bool GELU, int G, int CPL, int FIXED_N>
__global__ void __launch_bounds__(qrv_threads(G)) quant_rows_vec_kernel(
    const float* __restrict__ x, int8_t* __restrict__ out, float* __restrict__ scale, int M,
    int N_rt) {
  static_assert(FIXED_N == 0 || FIXED_N == 128 * G * CPL, "a fixed width fills every thread");
  constexpr int ROWS = qrv_threads(G) / (32 * G);
  const int N = FIXED_N > 0 ? FIXED_N : N_rt;
  const int chunks = N / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = G == 1 ? lane : (int)threadIdx.x;  // the thread's index in its row group
  __shared__ float red[2][G];
  bool live[CPL];
  uint4 cur[CPL], nxt[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    live[k] = FIXED_N > 0 || t + 32 * G * k < chunks;
    cur[k] = nxt[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  const long long stride = (long long)gridDim.x * ROWS;
  long long row = (long long)blockIdx.x * ROWS + (G == 1 ? warp : 0);
  auto load = [&](uint4 (&r)[CPL], long long at) {
    const uint4* src = reinterpret_cast<const uint4*>(x + at * N);
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (live[k]) r[k] = src[t + 32 * G * k];
  };
  if (row < M) load(cur, row);
  for (int it = 0; row < M; row += stride, ++it) {
    if (row + stride < M) load(nxt, row + stride);
    quant_rows_vec_row<GELU, G, CPL>(cur, live, t, reinterpret_cast<unsigned*>(out + row * N),
                                     scale + row, [&](float amax) {
      amax = warp_max(amax);
      if constexpr (G > 1) {
        // the block is one row group; the maxima alternate between two
        // slots, so a row's writes never meet the previous row's reads
        if (lane == 0) red[it & 1][warp] = amax;
        __syncthreads();
        amax = red[it & 1][0];
#pragma unroll
        for (int w = 1; w < G; ++w) amax = fmaxf(amax, red[it & 1][w]);
      }
      return amax;
    });
#pragma unroll
    for (int k = 0; k < CPL; ++k) cur[k] = nxt[k];
  }
}

// ---------------------------------------------------------------------------
// per-crop attention
// ---------------------------------------------------------------------------
//
// Replaces the attention section of _attn_half_int8_kernel
// (_batched_attention -> _paired_attention_nomask). The reference takes
// one softmax shift per head pair, max(floor, pair max), or the layer's
// calibrated shift; that is why a unit is a pair of heads. The floor is 0
// on the dense route (the reference's zeroed pad keys score 0: S is never
// a multiple of 16 there) and -inf on its non-dense route (S a multiple
// of 16: s_pad = S, no pad keys). SCALED multiplies the f32 sums by
// 1/sqrt(d) (the unfolded tree; the folded tree's q carries it). With a
// static context scale the kernel writes the int8 context; without one it
// writes the f32 context, and quant_rows_kernel quantizes each E-wide
// row after it: a row's amax spans every pair, and a block owning a
// whole crop would need E / 128 times the shared memory (over the card's
// 227 KB from S = 50 on).
//
// Bound on the H100: bytes (qkv read once, the context written once;
// about 25 flop a byte at S = 50, D = 64). Two routes, picked by the
// caller (ops.attention.attention_route):
// - "mma", bf16 qkv at D = 64 with 16-byte aligned qkv and out:
//   pair_mma.cuh's pair_attention_mma_kernel on the tensor cores, its
//   int8 and f32 instances with SCALED and the calibrated shift as
//   template parameters; NC = 4 key chunks up to 64 keys, 6 up to 96
//   (S = 82: 288² crops), 8 up to 127.
// - "rowloop", any other head dim or alignment: attention_kernel below,
//   one block per (crop, pair) with the pair's q, k (transposed) and v in
//   shared memory and the row loop of pair_attention.cuh on the CUDA
//   cores. KB = 4 blocks of 32 keys a lane, 105,664 B of shared memory at
//   S = 127; up to 64 keys the KB = 2 instance.

constexpr int ATT_WARPS = 8;

template <int KB, bool F32_OUT, bool SCALED>
__global__ void __launch_bounds__(ATT_WARPS * 32) attention_kernel(
    const bf16* __restrict__ qkv,       // [n_crops * S, 3E]
    const float* __restrict__ ctx_inv,  // scalar (static ctx)
    const float* __restrict__ shift,    // scalar, or null for the pair max
    void* __restrict__ out,             // [n_crops * S, E] int8, or f32
    int S, int H, int D, float scale, float m_floor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = H * D, D2 = 2 * D, n_pairs = H / 2;
  const int pair = blockIdx.x % n_pairs;
  const long long crop = blockIdx.x / n_pairs;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [S, D2]
  bf16* kt_s = q_s + S * D2;                       // [D2, S] (transposed)
  bf16* v_s = kt_s + D2 * S;                       // [S, D2]
  float* p_s = reinterpret_cast<float*>(v_s + S * D2);  // [warps, 2, S]

  const bf16* base = qkv + crop * S * 3 * E + pair * D2;
  for (int idx = threadIdx.x; idx < S * D2; idx += blockDim.x) {
    const int j = idx / D2, d = idx - j * D2;
    const bf16* r = base + (long long)j * 3 * E + d;
    q_s[idx] = r[0];
    kt_s[d * S + j] = r[E];
    v_s[idx] = r[2 * E];
  }
  __syncthreads();
  typedef typename std::conditional<F32_OUT, float, int8_t>::type O;
  pair_attention_rows_t<KB, bf16, O, SCALED>(q_s, D2, nullptr, kt_s, v_s, p_s, S, D, scale, shift,
                                             m_floor, F32_OUT ? 0.0f : *ctx_inv,
                                             static_cast<O*>(out) + crop * S * E + pair * D2, E,
                                             ATT_WARPS);
}

// ---------------------------------------------------------------------------
// CLS-query attention of the last layer (K5)
// ---------------------------------------------------------------------------
//
// Replaces the attention section of _attn_cls_int8_kernel: only each
// crop's CLS row queries, against the K/V of all S rows. For one crop and
// one head pair (lo, hi):
//   s      = q . k [* scale]                     (bf16 inputs, f32 sums; the
//                                                 unfolded tree's 1/sqrt(d)
//                                                 after the sum, SCALED)
//   m      = max over both heads' keys of s, and 0 when S < 64 (the
//            reference's zero-padded 64-key halves score exactly 0); or
//            the layer's calibrated score_shift where the tree has one
//   p_     = exp(s - m)                          (f32)
//   ctx_u  = sum_j bf16(p_j) v_j                 (f32)
//   l      = sum_j p_j                           (f32 p_, not bf16: the
//                                                 normalizer of K5, unlike K3)
//   out    = int8(round(ctx_u * (ctx_inv / max(l, 1e-30))))   (static ctx)
//          = ctx_u * (1 / max(l, 1e-30)), f32 (dynamic ctx: quant_rows
//            quantizes each CLS row over all pairs afterwards)
//
// Bound on the H100: bytes. A crop's K/V (2 x 50 x 768 bf16) is read
// once and its work is 2 x 50 x 64 MACs per head twice, so one warp owns
// a (crop, pair) and reads K/V straight from device memory with 8-byte
// coalesced loads: lanes 0-15 hold the lo head's 64 dims, lanes 16-31 the
// hi head's, four each; a score is a 16-lane shuffle reduction; PV keeps
// the same dims per lane. Only the scores and p pass through shared
// memory.

constexpr int CLS_WARPS = 4;
constexpr int CLS_MAX_S = 64;

template <bool F32_OUT, bool SCALED>
__global__ void __launch_bounds__(CLS_WARPS * 32) cls_attention_kernel(
    const bf16* __restrict__ q,         // [n_crops, E] (CLS rows)
    const bf16* __restrict__ kv,        // [n_crops * S, 2E]: [k | v]
    const float* __restrict__ ctx_inv,  // scalar (static ctx)
    const float* __restrict__ shift,    // scalar, or null for the pair max
    void* __restrict__ out,             // [n_crops, E] int8, or f32
    int n_crops, int S, int H, float scale) {
  __shared__ float sc[CLS_WARPS][2][CLS_MAX_S];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int E = H * 64, n_pairs = H / 2;
  const long long item = (long long)blockIdx.x * CLS_WARPS + warp;
  if (item >= (long long)n_crops * n_pairs) return;
  const long long crop = item / n_pairs;
  const int pair = (int)(item - crop * n_pairs);
  const int h = lane >> 4;        // 0: lo head, 1: hi head
  const int col = pair * 128 + lane * 4;  // this lane's four dims of the pair

  float qv[4];
  {
    const uint2 u = *reinterpret_cast<const uint2*>(q + crop * E + col);
    const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) qv[t] = bf2f(b[t]);
  }
  const bf16* kvc = kv + crop * S * 2 * E;
  float (*s)[CLS_MAX_S] = sc[warp];
  for (int j = 0; j < S; ++j) {
    const uint2 u = *reinterpret_cast<const uint2*>(kvc + (long long)j * 2 * E + col);
    const bf16* b = reinterpret_cast<const bf16*>(&u);
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) acc = fmaf(qv[t], bf2f(b[t]), acc);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (SCALED) acc = __fmul_rn(acc, scale);
    if ((lane & 15) == 0) s[h][j] = acc;
  }
  __syncwarp();
  // the pair shift over both heads' scores (and the pad keys' 0)
  float m;
  if (shift != nullptr) {
    m = *shift;
  } else {
    m = S < CLS_MAX_S ? 0.0f : -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, fmaxf(s[0][j], s[1][j]));
    m = warp_max(m);
  }
  float l0 = 0.0f, l1 = 0.0f;
  for (int j = lane; j < S; j += 32) {
    const float p0 = expf(__fsub_rn(s[0][j], m)), p1 = expf(__fsub_rn(s[1][j], m));
    l0 += p0;
    l1 += p1;
    s[0][j] = round_bf16(p0);
    s[1][j] = round_bf16(p1);
  }
  l0 = warp_sum(l0);
  l1 = warp_sum(l1);
  const float l = h ? l1 : l0;
  __syncwarp();
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < S; ++j) {
    const uint2 u = *reinterpret_cast<const uint2*>(kvc + (long long)j * 2 * E + E + col);
    const bf16* b = reinterpret_cast<const bf16*>(&u);
    const float p = s[h][j];
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = fmaf(p, bf2f(b[t]), acc[t]);
  }
  const float r = __fdiv_rn(F32_OUT ? 1.0f : *ctx_inv, fmaxf(l, 1e-30f));
  if (F32_OUT) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + crop * E + col) =
        make_float4(__fmul_rn(acc[0], r), __fmul_rn(acc[1], r), __fmul_rn(acc[2], r),
                    __fmul_rn(acc[3], r));
  } else {
    char4 o;
    o.x = round_clip_int8(__fmul_rn(acc[0], r));
    o.y = round_clip_int8(__fmul_rn(acc[1], r));
    o.z = round_clip_int8(__fmul_rn(acc[2], r));
    o.w = round_clip_int8(__fmul_rn(acc[3], r));
    *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + crop * E + col) = o;
  }
}

}  // namespace

template <bool F32_OUT, bool SCALED>
static int launch_cls(const bf16* q, const bf16* kv, const float* ctx_inv, const float* shift,
                      void* out, int n_crops, int S, int H, float scale, cudaStream_t stream) {
  const long long items = (long long)n_crops * (H / 2);
  const unsigned blocks = (unsigned)((items + CLS_WARPS - 1) / CLS_WARPS);
  cls_attention_kernel<F32_OUT, SCALED><<<blocks, CLS_WARPS * 32, 0, stream>>>(
      q, kv, ctx_inv, shift, out, n_crops, S, H, scale);
  return (int)cudaGetLastError();
}

// f32_out: write the f32 context (no ctx_inv); shift: null for the pair
// max; scaled: multiply the scores by scale (the unfolded tree)
extern "C" int jcf_cls_attention(const void* q, const void* kv, const void* ctx_inv,
                                 const void* shift, void* out, int n_crops, int S, int H,
                                 float scale, int scaled, int f32_out, void* stream) {
  if (S < 1 || S > CLS_MAX_S || H < 2 || H % 2) return (int)cudaErrorInvalidValue;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* kv_ = static_cast<const bf16*>(kv);
  const float* ci = static_cast<const float*>(ctx_inv);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t st = (cudaStream_t)stream;
  if (scaled)
    return f32_out ? launch_cls<true, true>(q_, kv_, ci, sh, out, n_crops, S, H, scale, st)
                   : launch_cls<false, true>(q_, kv_, ci, sh, out, n_crops, S, H, scale, st);
  return f32_out ? launch_cls<true, false>(q_, kv_, ci, sh, out, n_crops, S, H, scale, st)
                 : launch_cls<false, false>(q_, kv_, ci, sh, out, n_crops, S, H, scale, st);
}

// the vector kernel's grid: as many blocks as fit on the card at once (the
// occupancy of this instance, cached), fewer where M needs fewer
template <typename T, int CPL, bool DYN, bool AFFINE>
static int launch_ln_quant_vec(const void* x, const void* g, const void* b, const void* inv,
                               void* out, void* scale, int M, cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_quant_vec_kernel<T, CPL, DYN, AFFINE>, LNQ_WARPS * 32, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)M + LNQ_WARPS - 1) / LNQ_WARPS;
  const unsigned blocks = (unsigned)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
  ln_quant_vec_kernel<T, CPL, DYN, AFFINE><<<blocks, LNQ_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const float*>(inv), static_cast<int8_t*>(out), static_cast<float*>(scale), M);
  return (int)cudaGetLastError();
}

// vec: the vector kernel at E = 512 or 768 (x, out, g and b 16-byte
// aligned), else the scalar one
template <typename T, bool DYN, bool AFFINE>
static int launch_ln_quant(const void* x, const void* g, const void* b, const void* inv,
                           void* out, void* scale, int M, int E, int vec, cudaStream_t stream) {
  if (vec) {
    constexpr int LANE_ROW = 32 * 16 / (int)sizeof(T);  // elements of one chunk on every lane
    if (M < 1 || ((uintptr_t)x | (uintptr_t)out | (uintptr_t)g | (uintptr_t)b) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (E == 512)
      return launch_ln_quant_vec<T, 512 / LANE_ROW, DYN, AFFINE>(x, g, b, inv, out, scale, M,
                                                                 stream);
    if (E == 768)
      return launch_ln_quant_vec<T, 768 / LANE_ROW, DYN, AFFINE>(x, g, b, inv, out, scale, M,
                                                                 stream);
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((M + LNQ_WARPS - 1) / LNQ_WARPS);
  ln_quant_kernel<T, DYN, AFFINE><<<blocks, LNQ_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const float*>(inv), static_cast<int8_t*>(out), static_cast<float*>(scale), M, E);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_ln_quant(const void* x, const void* g, const void* b, const void* inv,
                             void* out, void* scale, int M, int E, int vec, cudaStream_t st) {
  if (g != nullptr)
    return launch_ln_quant<T, true, true>(x, g, b, nullptr, out, scale, M, E, vec, st);
  if (inv == nullptr)
    return launch_ln_quant<T, true, false>(x, g, b, nullptr, out, scale, M, E, vec, st);
  return launch_ln_quant<T, false, false>(x, g, b, inv, out, nullptr, M, E, vec, st);
}

// g, b null: the z-norm alone (the folded tree); else the f32 LN affine,
// dynamic only. inv null: the dynamic variant, writing each row's scale
// to scale[M]. f32: f32 rows, else bf16. vec: the vector kernel (E 512 or
// 768, 16-byte aligned tensors), else the scalar one
extern "C" int jcf_ln_quant(const void* x, const void* g, const void* b, const void* inv,
                            void* out, void* scale, int M, int E, int f32, int vec,
                            void* stream) {
  if (E < 1 || E > 32 * LNQ_PER || (g != nullptr && inv != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f32 ? dispatch_ln_quant<float>(x, g, b, inv, out, scale, M, E, vec, st)
             : dispatch_ln_quant<bf16>(x, g, b, inv, out, scale, M, E, vec, st);
}

// the vector kernel's grid: as many blocks as fit on the card at once (the
// occupancy of this instance, cached), fewer where M needs fewer
template <bool GELU, int G, int CPL, int FIXED_N>
static int launch_quant_rows_vec(const float* x, int8_t* out, float* scale, int M, int N,
                                 cudaStream_t stream) {
  constexpr int threads = qrv_threads(G), rows = threads / (32 * G);
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quant_rows_vec_kernel<GELU, G, CPL, FIXED_N>, threads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)M + rows - 1) / rows;
  const unsigned blocks = (unsigned)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
  quant_rows_vec_kernel<GELU, G, CPL, FIXED_N><<<blocks, threads, 0, stream>>>(x, out, scale, M, N);
  return (int)cudaGetLastError();
}

// vec: the vector kernel (N a multiple of 4, x and out 16-byte aligned),
// else the scalar one
template <bool GELU>
static int launch_quant_rows(const float* x, int8_t* out, float* scale, int M, int N, int vec,
                             cudaStream_t st) {
  if (!vec) {
    quant_rows_kernel<GELU><<<(unsigned)M, QR_THREADS, 0, st>>>(x, out, scale, N);
    return (int)cudaGetLastError();
  }
  if (M < 1 || N % 4 != 0 || ((uintptr_t)x | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 512) return launch_quant_rows_vec<GELU, 1, 4, 512>(x, out, scale, M, N, st);
  if (N == 768) return launch_quant_rows_vec<GELU, 1, 6, 768>(x, out, scale, M, N, st);
  if (N == 2048) return launch_quant_rows_vec<GELU, 4, 4, 2048>(x, out, scale, M, N, st);
  if (N == 3072) return launch_quant_rows_vec<GELU, 4, 6, 3072>(x, out, scale, M, N, st);
  if (N <= 1024) return launch_quant_rows_vec<GELU, 1, 8, 0>(x, out, scale, M, N, st);
  return launch_quant_rows_vec<GELU, 4, 8, 0>(x, out, scale, M, N, st);
}

// f32 rows [M, N <= 4096] -> int8 [M, N] and f32 scales [M]; gelu:
// QuickGELU first; vec: the vector kernel, else the scalar one
extern "C" int jcf_quant_rows(const void* x, void* out, void* scale, int M, int N, int gelu,
                              int vec, void* stream) {
  if (N < 1 || N > QR_THREADS * QR_PER) return (int)cudaErrorInvalidValue;
  const float* x_ = static_cast<const float*>(x);
  int8_t* o = static_cast<int8_t*>(out);
  float* sc = static_cast<float*>(scale);
  cudaStream_t st = (cudaStream_t)stream;
  return gelu ? launch_quant_rows<true>(x_, o, sc, M, N, vec, st)
              : launch_quant_rows<false>(x_, o, sc, M, N, vec, st);
}

template <int KB, bool F32_OUT, bool SCALED>
static int launch_attention(const bf16* qkv, const float* ctx_inv, const float* shift, void* out,
                            int n_crops, int S, int H, int D, float scale, float m_floor,
                            cudaStream_t stream) {
  const size_t smem =
      (size_t)3 * S * 2 * D * sizeof(bf16) + (size_t)ATT_WARPS * 2 * S * sizeof(float);
  const int err = set_smem(attention_kernel<KB, F32_OUT, SCALED>, smem);
  if (err) return err;
  const long long blocks = (long long)n_crops * (H / 2);
  attention_kernel<KB, F32_OUT, SCALED><<<(unsigned)blocks, ATT_WARPS * 32, smem, stream>>>(
      qkv, ctx_inv, shift, out, S, H, D, scale, m_floor);
  return (int)cudaGetLastError();
}

template <int KB>
static int dispatch_attention(const bf16* qkv, const float* ctx_inv, const float* shift, void* out,
                              int n_crops, int S, int H, int D, float scale, int scaled,
                              float m_floor, int f32_out, cudaStream_t st) {
  if (scaled)
    return f32_out ? launch_attention<KB, true, true>(qkv, ctx_inv, shift, out, n_crops, S, H, D,
                                                      scale, m_floor, st)
                   : launch_attention<KB, false, true>(qkv, ctx_inv, shift, out, n_crops, S, H, D,
                                                       scale, m_floor, st);
  return f32_out ? launch_attention<KB, true, false>(qkv, ctx_inv, shift, out, n_crops, S, H, D,
                                                     scale, m_floor, st)
                 : launch_attention<KB, false, false>(qkv, ctx_inv, shift, out, n_crops, S, H, D,
                                                      scale, m_floor, st);
}

// the tensor-core route's instances: the output form, SCALED and the
// calibrated shift at compile time
template <int NC, typename O>
static int dispatch_attention_mma_o(const bf16* qkv, const float* ctx_inv, const float* shift,
                                    void* out, int n_crops, int S, int H, float scale, int scaled,
                                    float m_floor, cudaStream_t st) {
  if (scaled)
    return shift ? launch_pair_mma<NC, O, true, true>(qkv, ctx_inv, shift, out, n_crops, S, H,
                                                      scale, m_floor, st)
                 : launch_pair_mma<NC, O, true, false>(qkv, ctx_inv, shift, out, n_crops, S, H,
                                                       scale, m_floor, st);
  return shift ? launch_pair_mma<NC, O, false, true>(qkv, ctx_inv, shift, out, n_crops, S, H,
                                                     scale, m_floor, st)
               : launch_pair_mma<NC, O, false, false>(qkv, ctx_inv, shift, out, n_crops, S, H,
                                                      scale, m_floor, st);
}

template <int NC>
static int dispatch_attention_mma(const bf16* qkv, const float* ctx_inv, const float* shift,
                                  void* out, int n_crops, int S, int H, float scale, int scaled,
                                  float m_floor, int f32_out, cudaStream_t st) {
  return f32_out ? dispatch_attention_mma_o<NC, float>(qkv, ctx_inv, shift, out, n_crops, S, H,
                                                       scale, scaled, m_floor, st)
                 : dispatch_attention_mma_o<NC, int8_t>(qkv, ctx_inv, shift, out, n_crops, S, H,
                                                        scale, scaled, m_floor, st);
}

// f32_out: write the f32 context (no ctx_inv); shift: null for the pair
// max; scaled: multiply the scores by scale (the unfolded tree); m_floor:
// the pair shift's floor (0 on the dense route, -inf off it). mma: the
// tensor-core kernel (D = 64, qkv and out 16-byte aligned; the caller's
// route), else the CUDA-core row loop
extern "C" int jcf_attention(const void* qkv, const void* ctx_inv, const void* shift, void* out,
                             int n_crops, int S, int H, int D, float scale, int scaled,
                             float m_floor, int f32_out, int mma, void* stream) {
  if (S < 1 || S > 128 || H < 2 || H % 2) return (int)cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* ci = static_cast<const float*>(ctx_inv);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t st = (cudaStream_t)stream;
  if (mma) {
    if (D != ATT_D || ((uintptr_t)qkv & 15) || ((uintptr_t)out & 15))
      return (int)cudaErrorInvalidValue;
    if (S <= 64)
      return dispatch_attention_mma<4>(q, ci, sh, out, n_crops, S, H, scale, scaled, m_floor,
                                       f32_out, st);
    if (S <= 96)
      return dispatch_attention_mma<6>(q, ci, sh, out, n_crops, S, H, scale, scaled, m_floor,
                                       f32_out, st);
    return dispatch_attention_mma<8>(q, ci, sh, out, n_crops, S, H, scale, scaled, m_floor,
                                     f32_out, st);
  }
  if (S <= 64)
    return dispatch_attention<2>(q, ci, sh, out, n_crops, S, H, D, scale, scaled, m_floor, f32_out,
                                 st);
  return dispatch_attention<4>(q, ci, sh, out, n_crops, S, H, D, scale, scaled, m_floor, f32_out,
                               st);
}
