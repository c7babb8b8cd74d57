// The persistent int8 layer kernel of K9a, K9c and K9d (block_int8.cu says
// what it replaces and how it runs): one template over the rows' type (f32
// rows: K9a on the f32 text tower), the mid's type (f32 for K9a, bf16 for
// K9c and K9d), the masked attention (K9a's masked route) and the
// quantization mode, with the layer count and the attention's kind at run
// time. Its instances are built in block_int8_{bf16mid,mid32,masked,
// rows32}*.cu, which nvcc compiles in parallel.
#pragma once

#include "int8_epilogue.cuh"
#include "pair_mma.cuh"
#include "persistent.cuh"
#include "row_quant.cuh"

namespace jcf_k9 {

constexpr int K9_THREADS = GEMM_THREADS_WG;  // 8 consumer warps + the producer warp
constexpr int K9_WARPS = K9_THREADS / 32;
constexpr int K9_MAX_SEQ = 127;
constexpr int K9_BARS = 3;  // the grid barrier, the tile counter, the attention's round counter
using K9Ring = Ring<3, PHASE_BN, 1>;  // the int8 GEMM's BN = 128 ring (int8_gemm.cu)

// the attention's kinds (Params::attn), one for the whole launch: the
// mask-free pair attention with its shift floored at 0 (the dense route)
// or not floored (the non-dense route, S a multiple of 16); the masked
// per-head attention without a mask (an odd head count) or causal
enum { K9_ATT_PAIR = 0, K9_ATT_PAIR_NOFLOOR = 1, K9_ATT_HEADS = 2, K9_ATT_CAUSAL = 3 };

// the tensor maps: the int8 A rows (LN1 and LN2 out, the context) [M, E]
// and the int8 hidden [M, F]; the weights, each stacked over the layers
// ([L * 3E, E], [L * E, E], [L * F, E], [L * E, F]: a layer's rows start
// at l times its own rows). The hidden and c_proj's weights are 3-D maps
// [rows, nsp, F / nsp] over the nsp hidden chunks (a box never crosses a
// chunk: TMA zero-fills a chunk's last box past F / nsp)
struct Maps {
  CUtensorMap a_x, a_h, b_qkv, b_out, b_fc, b_proj;
};

struct Params {
  const void* x;  // [M, E] bf16, or f32 (f32 rows), M = n_crops * S
  void* out;      // [M, E] as x; K9c's and K9d's mid and every layer's output
  int8_t* xq;     // [M, E]: LN1's rows, the context, LN2's rows
  bf16* qkv;      // [M, 3E]
  float* hid32;   // [M, F]: the dynamic hidden (the memory of qkv)
  int8_t* hq;     // [M, F]
  float* f32s;    // [M, E]: the dynamic context, then c_proj's chunk partials
  float* mid32;   // [M, E]: K9a's mid
  float* rsc;     // [M]: the dynamic row scales of LN1, the context, LN2
  float* hsc;     // [M, nsp]: the dynamic hidden's, per row and chunk
  unsigned* bar;  // K9_BARS counters, 0 at the launch
  // [L, N] each: the dequant scales and biases (h_inv folded into c_fc's
  // where the hidden's scale is static)
  const float *qkv_sc, *qkv_b, *out_sc, *out_b, *fc_sc, *fc_b, *proj_sc, *proj_b;
  // [L] each, read where the mode makes them static
  const float *ln1_inv, *ctx_inv, *ln2_inv, *gelu_c, *shift;
  // the unfolded tree's LN affines [L, E] in f32 (null when folded)
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b;
  int n_crops, S, H, F, n_layers, nsp, attn;
};

__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)K9Ring::SMEM + 4 * K9Ring::STAGES;  // the ring, then a tile slot a stage
}

// ---------------------------------------------------------------------------
// the GEMM phases
// ---------------------------------------------------------------------------

// the consumer warpgroups: per tile and stage four k32 s8 wgmma into the
// tile's int32 sums, one group in flight, a stage released once the group
// that read it is done (int8_gemm.cu's loop). The depth goes in chunks of
// chunk_steps stages (c_proj's hidden chunks; one chunk elsewhere): after
// each, the sums go through epi(acc, m0, n0, chunk) and restart from 0,
// outside the products' pipeline (an accumulator written between two
// wgmma of one pipeline would serialize them all)
template <class Epi>
__device__ __forceinline__ void consume_s8(int k_steps, int tiles_n, int chunk_steps,
                                           uint32_t ring, uint32_t full0, uint32_t empty0,
                                           const volatile int* slots, RingPos& rp, Epi& epi) {
  using R = K9Ring;
  const int cw = threadIdx.x >> 7, lane = threadIdx.x & 31;
  for (int t; (t = next_tile<R>(full0, empty0, slots, rp)) >= 0;) {
    const int m0 = (t / tiles_n) * GEMM_BM, n0 = (t % tiles_n) * PHASE_BN;
    for (int chunk = 0, k0 = 0; k0 < k_steps; ++chunk, k0 += chunk_steps) {
      int acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      int held = -1;
      for (int ks = k0; ks < k0 + chunk_steps && ks < k_steps; ++ks) {
        ring_wait(full0 + 8 * rp.stage, rp.phase);
        __syncwarp();
        const uint32_t a = ring + rp.stage * R::STAGE_BYTES + cw * 64 * GEMM_BK_BYTES;
        const uint32_t b = ring + rp.stage * R::STAGE_BYTES + R::A_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GEMM_BK_BYTES / 32; ++kk)
          wgmma_s8_n128(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
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
      epi(acc, m0, n0, chunk);
    }
  }
}

// a tile epilogue that stores pair by pair: f(m, n, v0, v1, chunk) for
// each of store_tile's pairs
template <class F>
__device__ __forceinline__ auto by_pair(int M, int N, F f) {
  return [=](const int (&acc)[64], int m0, int n0, int chunk) {
    auto pair = [&](int m, int n, int v0, int v1) { f(m, n, v0, v1, chunk); };
    store_tile(acc, m0, n0, M, N, pair);
  };
}

// c_proj's tile epilogue at chunk ch of nsp > 1 (store_tile's pairs): y =
// f32(acc) * scale[n] [* the chunk's row scale], + the earlier chunks'
// partial (ch > 0, in part), to part (ch < nsp - 1) or, at the last chunk,
// + bias[n], + mid(m, n) -> out in ROW. A column group's loads (both rows'
// partials and mids) go ahead of its stores: the compiler keeps a load
// behind a store that may alias it. Loading two, four, eight or all
// sixteen groups ahead spilled their registers and took longer (PERF.md).
template <typename ROW, bool HS, class Mid>
__device__ __forceinline__ void chunk_tile(const int (&acc)[64], int m0, int n0, int ch, int M,
                                           int E, int nsp, const Epilogue& ep, float* part,
                                           Mid mid) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int m = m0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
  const bool last = ch + 1 == nsp;
  float hs[2] = {1.0f, 1.0f};
  if constexpr (!HS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (m + 8 * r < M) hs[r] = __ldcg(ep.row_scale + (long long)(m + 8 * r) * nsp + ch);
  }
#pragma unroll
  for (int j = 0; j < PHASE_BN / 8; ++j) {
    const int n = n0 + j * 8 + tig * 2;
    if (n >= E) continue;
    float2 q[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mr = m + 8 * r;
      const bool ok = mr < M;
      const long long idx = (long long)mr * E + n;
      q[r] = ok && ch > 0 ? __ldcg(reinterpret_cast<const float2*>(part + idx))
                          : make_float2(0.0f, 0.0f);
      rs[r] = ok && last ? mid(mr, n) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mr = m + 8 * r;
      if (mr >= M) continue;
      const long long idx = (long long)mr * E + n;
      float y0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * r]), ep.scale[n]);
      float y1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * r + 1]), ep.scale[n + 1]);
      if constexpr (!HS) {
        y0 = __fmul_rn(y0, hs[r]);
        y1 = __fmul_rn(y1, hs[r]);
      }
      if (ch > 0) {
        y0 = __fadd_rn(q[r].x, y0);
        y1 = __fadd_rn(q[r].y, y1);
      }
      if (!last) {
        *reinterpret_cast<float2*>(part + idx) = make_float2(y0, y1);
        continue;
      }
      y0 = __fadd_rn(y0, ep.bias[n]);
      y1 = __fadd_rn(y1, ep.bias[n + 1]);
      if constexpr (std::is_same<ROW, float>::value)
        *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + idx) =
            make_float2(__fadd_rn(rs[r].x, y0), __fadd_rn(rs[r].y, y1));
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + idx) =
            __floats2bfloat162_rn(__fadd_rn(rs[r].x, y0), __fadd_rn(rs[r].y, y1));
    }
  }
}

// one GEMM phase: C[m, n] = sum_k A[m, k] W[b_row0 + n, k] over M rows and
// N columns, depth K bytes, through the tile epilogue epi (chunk_steps:
// stages a chunk of the depth; 0 for one chunk; CHUNKED: A and W are 3-D
// chunk maps, K = chunks x chunk_steps stages); the producer warp's lane 0
// loads, warps 0-7 consume
template <bool CHUNKED = false, class Epi>
__device__ __forceinline__ void gemm_phase(const CUtensorMap* ma, const CUtensorMap* mb, int b_row0,
                                           int M, int N, int K, int chunk_steps, uint32_t ring,
                                           uint32_t full0, uint32_t empty0, volatile int* slots,
                                           unsigned* ctr, RingPos& rp, Epi epi) {
  using R = K9Ring;
  const int tiles_n = (N + PHASE_BN - 1) / PHASE_BN;
  const int tiles = ((M + GEMM_BM - 1) / GEMM_BM) * tiles_n;
  const int k_steps = (K + GEMM_BK_BYTES - 1) / GEMM_BK_BYTES;
  if (threadIdx.x >= 32 * GEMM_CONSUMER_WARPS) {
    if (threadIdx.x == 32 * GEMM_CONSUMER_WARPS)
      produce<R, true, CHUNKED>(ma, mb, nullptr, tiles, tiles_n, k_steps, ring, full0, empty0,
                                slots, ctr, rp, b_row0, chunk_steps);
    __syncwarp();
  } else {
    consume_s8(k_steps, tiles_n, chunk_steps > 0 ? chunk_steps : k_steps, ring, full0, empty0,
               slots, rp, epi);
  }
}

// ---------------------------------------------------------------------------
// the row phases
// ---------------------------------------------------------------------------

// LayerNorm + int8 quantization of M rows (row_quant.cuh's body), a warp a
// row over the grid's warps, the next row's chunks in flight, through L2;
// CPL chunks a lane (live where in the row); g, b the f32 affine (AFFINE)
template <typename T, int CPL, bool DYN, bool AFFINE>
__device__ __forceinline__ void ln_rows_cpl(const T* in, int8_t* out, float* rsc, int M, int E,
                                            float inv, const float* g, const float* b) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, chunks = E / V;
  bool live[CPL];
  float ga[AFFINE ? CPL : 1][V], ba[AFFINE ? CPL : 1][V];
  uint4 cur[CPL], nxt[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    live[k] = c < chunks;
    cur[k] = nxt[k] = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (AFFINE) {
#pragma unroll
      for (int i = 0; i < V; ++i) ga[k][i] = ba[k][i] = 0.0f;
      if (live[k]) {
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          lnv_unpack(__ldg(reinterpret_cast<const uint4*>(g) + c * (V / 4) + i),
                     *reinterpret_cast<float(*)[4]>(&ga[k][4 * i]));
          lnv_unpack(__ldg(reinterpret_cast<const uint4*>(b) + c * (V / 4) + i),
                     *reinterpret_cast<float(*)[4]>(&ba[k][4 * i]));
        }
      }
    }
  }
  const long long stride = (long long)gridDim.x * K9_WARPS;
  long long row = (long long)blockIdx.x * K9_WARPS + (threadIdx.x >> 5);
  auto load = [&](uint4 (&r)[CPL], long long at) {
    const uint4* src = reinterpret_cast<const uint4*>(in + at * E);
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (live[k]) r[k] = __ldcg(src + lane + 32 * k);
  };
  if (row < M) load(cur, row);
  for (; row < M; row += stride) {
    if (row + stride < M) load(nxt, row + stride);
    ln_quant_vec_row<T, CPL, DYN, AFFINE>(cur, live, E, ga, ba, inv, out + row * E,
                                          DYN ? rsc + row : nullptr);
#pragma unroll
    for (int k = 0; k < CPL; ++k) cur[k] = nxt[k];
  }
}

// E = 768 its own chunk count (every lane full), other widths up to 1024
// the widest
template <typename T, bool DYN, bool AFFINE>
__device__ __forceinline__ void ln_rows(const T* in, int8_t* out, float* rsc, int M, int E,
                                        float inv, const float* g, const float* b) {
  constexpr int LANE_ROW = 32 * 16 / (int)sizeof(T);  // elements of one chunk on every lane
  if (E == 768)
    ln_rows_cpl<T, 768 / LANE_ROW, DYN, AFFINE>(in, out, rsc, M, E, inv, g, b);
  else
    ln_rows_cpl<T, 1024 / LANE_ROW, DYN, AFFINE>(in, out, rsc, M, E, inv, g, b);
}

// the dynamic row quantization (row_quant.cuh's body) of M f32 rows of N:
// a warp a row over the grid's warps (G = 1), or a row a block on its 8
// consumer warps (G = 8, their maxima through red, a named barrier a row);
// the next row in flight, through L2
template <bool GELU, int G, int CPL>
__device__ __forceinline__ void quant_rows_cpl(const float* in, int8_t* out, float* sc, long long M,
                                               int N, float (*red)[8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (G > 1 && warp >= G) return;
  const int t = G == 1 ? lane : (int)threadIdx.x;  // the thread's index in its row group
  constexpr int ROWS = G == 1 ? K9_WARPS : 1;
  const int chunks = N / 4;
  bool live[CPL];
  uint4 cur[CPL], nxt[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    live[k] = t + 32 * G * k < chunks;
    cur[k] = nxt[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  const long long stride = (long long)gridDim.x * ROWS;
  long long row = (long long)blockIdx.x * ROWS + (G == 1 ? warp : 0);
  auto load = [&](uint4 (&r)[CPL], long long at) {
    const uint4* src = reinterpret_cast<const uint4*>(in + at * N);
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (live[k]) r[k] = __ldcg(src + t + 32 * G * k);
  };
  if (row < M) load(cur, row);
  for (int it = 0; row < M; row += stride, ++it) {
    if (row + stride < M) load(nxt, row + stride);
    quant_rows_vec_row<GELU, G, CPL>(cur, live, t, reinterpret_cast<unsigned*>(out + row * N),
                                     sc + row, [&](float amax) {
      amax = warp_max(amax);
      if constexpr (G > 1) {
        // the maxima alternate between two slots, so a row's writes never
        // meet the previous row's reads
        if (lane == 0) red[it & 1][warp] = amax;
        asm volatile("bar.sync 1, %0;\n" ::"r"(32 * G) : "memory");
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

// WIDE: rows past 1024 columns may come (the hidden at one or two chunks):
// those take a row a block
template <bool GELU, bool WIDE>
__device__ __forceinline__ void quant_rows(const float* in, int8_t* out, float* sc, long long M,
                                           int N, float (*red)[8]) {
  if (WIDE && N > 1024) {
    if (N == 3072) quant_rows_cpl<GELU, 8, 3>(in, out, sc, M, N, red);
    else quant_rows_cpl<GELU, 8, 4>(in, out, sc, M, N, red);
  } else if (N == 768) {
    quant_rows_cpl<GELU, 1, 6>(in, out, sc, M, N, red);
  } else {
    quant_rows_cpl<GELU, 1, 8>(in, out, sc, M, N, red);
  }
}

// ---------------------------------------------------------------------------
// the attention
// ---------------------------------------------------------------------------

// K3's pair attention (pair_mma.cuh) on every (crop, head pair) unit:
// rounds of U units drawn from the counter actr (base abase: each phase
// takes rounds + gridDim.x of it); a round's K and V staged in the ring's
// shared memory, then each of the 8 consumer warps takes its unit's 16-row
// query tiles. The shift floored at m_floor (0 on the dense route, -inf
// off it); SCALED: the scores x 1/sqrt(64) (the unfolded tree)
template <int NC, typename O, bool SCALED, bool SHIFT>
__device__ __forceinline__ void attention_nc(const bf16* qkv, O* out, int n_crops, int S, int H,
                                             float cinv, const float* shift, float m_floor,
                                             unsigned char* smem, unsigned* actr, unsigned& abase,
                                             int& slot) {
  constexpr int U = NC <= 4 ? 2 : 1, KP = 16 * NC, WPU = GEMM_CONSUMER_WARPS / U;
  const int units = n_crops * (H >> 1), rounds = (units + U - 1) / U;
  const int warp = threadIdx.x >> 5;
  bf16* const st = reinterpret_cast<bf16*>(smem);
  // thread 0 draws the next round as soon as this one is known, so that
  // the counter's round trip overlaps the round's work
  unsigned drawn = 0;
  if (threadIdx.x == 0) slot = (int)(atomicAdd(actr, 1u) - abase);
  for (;;) {
    __syncthreads();
    const int r = slot;
    if (r >= rounds) break;
    if (threadIdx.x == 0) drawn = atomicAdd(actr, 1u);
    pair_stage<NC, U>(st, qkv, r * U, units, S, H);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp < GEMM_CONSUMER_WARPS) {
      const int ub = warp / WPU, unit = r * U + ub;
      if (unit < units) {
        const bf16* ks = st + ub * 2 * KP * PM_LD;
        pair_rows<NC, O, SCALED, SHIFT, true>(qkv, out, unit, ks, ks + KP * PM_LD, cinv, shift, S,
                                              H, 0.125f, m_floor, (warp % WPU) * 16, WPU * 16);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) slot = (int)(drawn - abase);
  }
  abase += rounds + gridDim.x;
}

// 4 key chunks up to 64 keys (two units a round), else 8 (one unit)
template <typename O, bool SCALED, bool SHIFT>
__device__ __forceinline__ void attention(const bf16* qkv, O* out, int n_crops, int S, int H,
                                          float cinv, const float* shift, float m_floor,
                                          unsigned char* smem, unsigned* actr, unsigned& abase,
                                          int& slot) {
  if (S <= 64)
    attention_nc<4, O, SCALED, SHIFT>(qkv, out, n_crops, S, H, cinv, shift, m_floor, smem, actr,
                                      abase, slot);
  else
    attention_nc<8, O, SCALED, SHIFT>(qkv, out, n_crops, S, H, cinv, shift, m_floor, smem, actr,
                                      abase, slot);
}

static_assert(2 * 2 * 64 * PM_LD * 2 <= K9Ring::STAGES * K9Ring::STAGE_BYTES &&
                  2 * 128 * PM_LD * 2 <= K9Ring::STAGES * K9Ring::STAGE_BYTES,
              "a round's K and V fit in the ring's stages");

// the masked attention (attn_mma.cuh's body of text_block.cu's
// masked_attention_mma_kernel) on every (sequence, head) unit, in rounds
// drawn from actr as the pair attention's: U = 8 / NC units a round, their
// K and V staged in the ring's shared memory, then the warps' scratch;
// consumer warp w < U NC takes query tile w % NC of unit w / NC (none
// past S). The scores x scale (1: exact), causal or not; the context as O
// (f32, or int8 x *ctx_inv)
template <int NC, typename O>
__device__ __forceinline__ void heads_nc(const bf16* qkv, O* out, int n_seq, int S, int H,
                                         bool causal, float scale, const float* ctx_inv,
                                         unsigned char* smem, unsigned* actr, unsigned& abase,
                                         int& slot) {
  constexpr int U = GEMM_CONSUMER_WARPS / NC, KP = 16 * NC, KV = 2 * KP * MA_LD;
  const int units = n_seq * H, rounds = (units + U - 1) / U;
  const int warp = threadIdx.x >> 5, E = H * ATT_D;
  bf16* const st = reinterpret_cast<bf16*>(smem);
  unsigned char* const wb = smem + U * KV * sizeof(bf16) + (warp % GEMM_CONSUMER_WARPS) *
                                                                ma_warp_bytes(KP);
  unsigned drawn = 0;
  if (threadIdx.x == 0) slot = (int)(atomicAdd(actr, 1u) - abase);
  for (;;) {
    __syncthreads();
    const int r = slot;
    if (r >= rounds) break;
    if (threadIdx.x == 0) drawn = atomicAdd(actr, 1u);
#pragma unroll
    for (int ub = 0; ub < U; ++ub) {
      const int unit = r * U + ub;
      if (unit < units) {
        const long long seq = unit / H;
        masked_stage_kv<NC>(st + ub * KV, qkv + seq * S * (3 * E) + (unit - seq * H) * ATT_D, qkv,
                            S, E, threadIdx.x, blockDim.x);
      }
    }
    cp_async_commit();
    const int ub = warp / NC, m0 = (warp % NC) * 16, unit = r * U + ub;
    const bool mine = ub < U && unit < units && m0 < S;  // warps past U NC (and the producer) idle
    const long long seq = unit / H;
    const int head = unit - (int)(seq * H);
    if (mine) masked_stage_q<true>(wb, qkv + seq * S * (3 * E) + head * ATT_D, E, m0, S);
    cp_async_wait<0>();
    __syncthreads();
    if (mine)
      masked_tile<NC>(st + ub * KV, wb, m0, S, causal, scale,
                      std::is_same<O, int8_t>::value ? 2 : 1, ctx_inv, out,
                      (seq * S + m0) * E + head * ATT_D, E);
    __syncthreads();
    if (threadIdx.x == 0) slot = (int)(drawn - abase);
  }
  abase += rounds + gridDim.x;
}

// 4, 5 or 8 key chunks (two, one or one unit a round; 5: the text
// tower's 77 tokens, whose attention phase took 2.4x as long at 8,
// PERF.md)
template <typename O>
__device__ __forceinline__ void heads(const bf16* qkv, O* out, int n_seq, int S, int H,
                                      bool causal, float scale, const float* ctx_inv,
                                      unsigned char* smem, unsigned* actr, unsigned& abase,
                                      int& slot) {
  if (S <= 64)
    heads_nc<4, O>(qkv, out, n_seq, S, H, causal, scale, ctx_inv, smem, actr, abase, slot);
  else if (S <= 80)
    heads_nc<5, O>(qkv, out, n_seq, S, H, causal, scale, ctx_inv, smem, actr, abase, slot);
  else
    heads_nc<8, O>(qkv, out, n_seq, S, H, causal, scale, ctx_inv, smem, actr, abase, slot);
}

template <int NC>
constexpr bool heads_fit() {
  return (GEMM_CONSUMER_WARPS / NC) * 2 * 16 * NC * MA_LD * 2 +
             GEMM_CONSUMER_WARPS * ma_warp_bytes(16 * NC) <=
         K9Ring::STAGES * K9Ring::STAGE_BYTES;
}
static_assert(heads_fit<4>() && heads_fit<5>() && heads_fit<8>(),
              "a round's K, V and warp scratch fit in the ring's stages");

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// ROW: the rows' type (bf16; float: K9a's f32 text rows, one layer). MID:
// the mid's type (float: K9a, in mid32; bf16: K9c and K9d, in out, as the
// halves round it). MASKED: the masked attention's code (K9a's masked
// route; compiled into the dense route's instances, its registers cost
// K9a's dynamic-context modes 3-6%, PERF.md). ACT, CTX, HS: a static scale
// for the LN rows, the context, the hidden (each else dynamic, per row;
// the hidden per row and chunk); SHIFT: the calibrated softmax shift (else
// the pair max, floored at 0 on the dense route); FOLDED: the folded tree
// (else the LN affines and the scores x 1/sqrt(64)). The attention's kind
// (p.attn) is read once a phase. Each phase ends on the grid barrier.
template <typename ROW, typename MID, bool MASKED, bool ACT, bool CTX, bool HS, bool SHIFT,
          bool FOLDED>
__global__ void __launch_bounds__(K9_THREADS, 2)
    block_int8_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  constexpr bool MID_F32 = std::is_same<MID, float>::value;
  constexpr bool ROW_F32 = std::is_same<ROW, float>::value;
  static_assert(!ROW_F32 || MID_F32, "f32 rows keep an f32 mid");
  static_assert(!MASKED || MID_F32, "the masked route is K9a's");
  using R = K9Ring;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[2][8];
  __shared__ int round_slot;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* tiles = smem_raw + (ring - raw);  // the attention's, in the ring's stages
  const uint32_t full0 = ring + R::STAGES * R::STAGE_BYTES, empty0 = full0 + R::STAGES * 8;
  volatile int* slots = reinterpret_cast<int*>(tiles + R::STAGES * R::STAGE_BYTES + 16 * R::STAGES);
  unsigned* const ctr = p.bar + 1;
  unsigned* const actr = p.bar + 2;
  const int S = p.S, H = p.H, E = 64 * H, E3 = 3 * E, F = p.F, nsp = p.nsp;
  const int M = p.n_crops * S;
  RingPos rp;
  unsigned target = 0, abase = 0;
  ring_init<R>(full0, empty0);
  for (int l = 0; l < p.n_layers; ++l) {
    // the residual stream
    const ROW* src = static_cast<const ROW*>(l == 0 ? p.x : static_cast<const void*>(p.out));
    const float* ln_g[2] = {FOLDED ? nullptr : p.ln1_s + l * E, FOLDED ? nullptr : p.ln2_s + l * E};
    const float* ln_b[2] = {FOLDED ? nullptr : p.ln1_b + l * E, FOLDED ? nullptr : p.ln2_b + l * E};

    // LN1 + quant
    ln_rows<ROW, !ACT, !FOLDED>(src, p.xq, p.rsc, M, E, ACT ? __ldg(p.ln1_inv + l) : 0.0f,
                                ln_g[0], ln_b[0]);
    grid_sync(p.bar, target);

    // qkv: bf16((acc * scale) [* row scale] + bias)
    gemm_phase(&maps.a_x, &maps.b_qkv, l * E3, M, E3, E, 0, ring, full0, empty0, slots, ctr, rp,
               by_pair(M, E3, [ep = Epilogue{p.qkv, p.qkv_sc + l * E3, p.qkv_b + l * E3, nullptr,
                                             nullptr, p.rsc},
                               E3](int m, int n, int v0, int v1, int) {
                 store_pair<ACT ? EPI_BF16 : EPI_BF16_ROWS, true>(ep, m, n, E3, v0, v1);
               }));
    grid_sync(p.bar, target);

    // the attention: the int8 context (static) or the f32 one, then its
    // row quantization. The masked kinds take no shift; their scores x
    // 1/sqrt(64) where the tree is unfolded (x 1 is exact)
    {
      using O = typename std::conditional<CTX, int8_t, float>::type;
      O* const ctx = CTX ? reinterpret_cast<O*>(p.xq) : reinterpret_cast<O*>(p.f32s);
      bool masked = false;
      if constexpr (MASKED) {
        masked = p.attn >= K9_ATT_HEADS;
        if (masked)
          heads<O>(p.qkv, ctx, p.n_crops, S, H, p.attn == K9_ATT_CAUSAL, FOLDED ? 1.0f : 0.125f,
                   CTX ? p.ctx_inv + l : nullptr, tiles, actr, abase, round_slot);
      }
      if (!masked)
        attention<O, !FOLDED, SHIFT>(p.qkv, ctx, p.n_crops, S, H,
                                     CTX ? __ldg(p.ctx_inv + l) : 0.0f,
                                     SHIFT ? p.shift + l : nullptr,
                                     p.attn == K9_ATT_PAIR ? 0.0f : -INFINITY, tiles, actr, abase,
                                     round_slot);
    }
    grid_sync(p.bar, target);
    if constexpr (!CTX) {
      quant_rows<false, false>(p.f32s, p.xq, p.rsc, M, E, red);
      grid_sync(p.bar, target);
    }

    // out-proj + residual -> mid: f32 (K9a; from f32 rows the halves' f32
    // residual epilogue) or bf16 in out (K9c, K9d: the halves' residual
    // epilogue)
    {
      const Epilogue ep{MID_F32 ? static_cast<void*>(p.mid32) : p.out, p.out_sc + l * E,
                        p.out_b + l * E, src, nullptr, p.rsc};
      constexpr int EPI = CTX ? EPI_RESID : EPI_RESID_ROWS;
      gemm_phase(&maps.a_x, &maps.b_out, l * E, M, E, E, 0, ring, full0, empty0, slots, ctr, rp,
                 by_pair(M, E, [ep, E](int m, int n, int v0, int v1, int) {
                   if constexpr (ROW_F32) {
                     store_pair<CTX ? EPI_RESID_F32 : EPI_RESID_ROWS_F32, true>(ep, m, n, E, v0,
                                                                                 v1);
                   } else if constexpr (MID_F32) {
                     const long long idx = (long long)m * E + n;
                     const float2 y = dequant_pair<EPI, true>(ep, m, n, v0, v1);
                     const float2 r = ep_ld_bf16x2<true>(static_cast<const bf16*>(ep.resid) + idx);
                     *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + idx) =
                         make_float2(__fadd_rn(r.x, y.x), __fadd_rn(r.y, y.y));
                   } else {
                     store_pair<EPI, true>(ep, m, n, E, v0, v1);
                   }
                 }));
    }
    grid_sync(p.bar, target);

    // LN2 + quant of mid
    if constexpr (MID_F32)
      ln_rows<float, !ACT, !FOLDED>(p.mid32, p.xq, p.rsc, M, E,
                                    ACT ? __ldg(p.ln2_inv + l) : 0.0f, ln_g[1], ln_b[1]);
    else
      ln_rows<bf16, !ACT, !FOLDED>(static_cast<const bf16*>(p.out), p.xq, p.rsc, M, E,
                                   ACT ? __ldg(p.ln2_inv + l) : 0.0f, ln_g[1], ln_b[1]);
    grid_sync(p.bar, target);

    // c_fc: GELU-quant into the int8 hidden (static), or the f32 hidden,
    // then QuickGELU and its row quantization per row and chunk (a row of
    // the [M nsp, F / nsp] view)
    if constexpr (HS) {
      gemm_phase(&maps.a_x, &maps.b_fc, l * F, M, F, E, 0, ring, full0, empty0, slots, ctr, rp,
                 by_pair(M, F, [ep = Epilogue{p.hq, p.fc_sc + l * F, p.fc_b + l * F, nullptr,
                                              p.gelu_c + l, nullptr},
                                F](int m, int n, int v0, int v1, int) {
                   store_pair<EPI_GELU_Q, true>(ep, m, n, F, v0, v1);
                 }));
      grid_sync(p.bar, target);
    } else {
      gemm_phase(&maps.a_x, &maps.b_fc, l * F, M, F, E, 0, ring, full0, empty0, slots, ctr, rp,
                 by_pair(M, F, [ep = Epilogue{p.hid32, p.fc_sc + l * F, p.fc_b + l * F, nullptr,
                                              nullptr, p.rsc},
                                F](int m, int n, int v0, int v1, int) {
                   store_pair<ACT ? EPI_F32 : EPI_F32_ROWS, true>(ep, m, n, F, v0, v1);
                 }));
      grid_sync(p.bar, target);
      quant_rows<true, true>(p.hid32, p.hq, p.hsc, (long long)M * nsp, F / nsp, red);
      grid_sync(p.bar, target);
    }

    // c_proj + residual. One chunk: the halves' residual epilogue on mid
    // (K9c, K9d), or its twin on the f32 mid (K9a; to f32 rows the halves'
    // f32 residual epilogue). nsp chunks: one int32 sum a hidden chunk, its
    // f32 partial (acc * scale) [* the chunk's row scale] added to the
    // earlier chunks' in chunk order (in f32s), then the bias and mid. Each
    // its own phase body: one body for both held more registers through
    // every tile and ran slower.
    {
      const Epilogue ep{p.out, p.proj_sc + l * E, p.proj_b + l * E,
                        MID_F32 ? static_cast<const void*>(p.mid32) : static_cast<const void*>(p.out),
                        nullptr, p.hsc};
      constexpr int EPI = HS ? EPI_RESID : EPI_RESID_ROWS;
      auto mid = [ep, E](int m, int n) {
        const long long idx = (long long)m * E + n;
        if constexpr (MID_F32)
          return __ldcg(reinterpret_cast<const float2*>(static_cast<const float*>(ep.resid) + idx));
        else
          return ep_ld_bf16x2<true>(static_cast<const bf16*>(ep.resid) + idx);
      };
      // the hidden and c_proj's weights through the chunk maps, each
      // chunk's depth in whole stages (zero-filled past F / nsp)
      const int steps = (F / nsp + GEMM_BK_BYTES - 1) / GEMM_BK_BYTES;
      if (nsp == 1) {
        gemm_phase<true>(&maps.a_h, &maps.b_proj, l * E, M, E, F, steps, ring, full0, empty0,
                         slots, ctr, rp, by_pair(M, E, [ep, E, mid](int m, int n, int v0, int v1, int) {
                     if constexpr (ROW_F32) {
                       store_pair<HS ? EPI_RESID_F32 : EPI_RESID_ROWS_F32, true>(ep, m, n, E, v0,
                                                                                 v1);
                     } else if constexpr (MID_F32) {
                       const float2 y = dequant_pair<EPI, true>(ep, m, n, v0, v1);
                       const float2 r = mid(m, n);
                       *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) +
                                                          (long long)m * E + n) =
                           __floats2bfloat162_rn(__fadd_rn(r.x, y.x), __fadd_rn(r.y, y.y));
                     } else {
                       store_pair<EPI, true>(ep, m, n, E, v0, v1);
                     }
                   }));
      } else {
        gemm_phase<true>(&maps.a_h, &maps.b_proj, l * E, M, E, nsp * steps * GEMM_BK_BYTES, steps,
                         ring, full0, empty0, slots, ctr, rp,
                         [ep, E, M, nsp, mid, part = p.f32s](const int (&acc)[64], int m0, int n0,
                                                             int ch) {
                           chunk_tile<ROW, HS>(acc, m0, n0, ch, M, E, nsp, ep, part, mid);
                         });
      }
    }
    if (l + 1 < p.n_layers) grid_sync(p.bar, target);
  }
}

template <typename ROW, typename MID, bool MASKED, bool ACT, bool CTX, bool HS, bool SHIFT,
          bool FOLDED>
int launch(const Maps& maps, const Params& p, int grid, cudaStream_t stream) {
  return launch_persistent(block_int8_kernel<ROW, MID, MASKED, ACT, CTX, HS, SHIFT, FOLDED>,
                           K9_THREADS, smem_bytes(), p.bar, K9_BARS, grid, stream, maps, p);
}

// the modes an instance file builds on bf16 rows: the folded tree's (ACT,
// CTX, HS) as its modes set them (dynamic, "ln": DYN, a dynamic hidden;
// "hidden", "full": STATIC) at one SHIFT, and the unfolded tree (every
// scale dynamic, no shift), each with the masked attention's code (MK) or
// without; on f32 rows (K9a's f32 text tower, masked) the folded tree's
// dynamic mode and the unfolded tree
#define JCF_K9_FOLDED_DYN(X, MID, MK, SHIFT)           \
  X(bf16, MID, MK, false, false, false, SHIFT, true)   \
  X(bf16, MID, MK, true, false, false, SHIFT, true)
#define JCF_K9_FOLDED_STATIC(X, MID, MK, SHIFT)        \
  X(bf16, MID, MK, true, false, true, SHIFT, true)     \
  X(bf16, MID, MK, true, true, true, SHIFT, true)
#define JCF_K9_FOLDED_MODES(X, MID, MK, SHIFT) \
  JCF_K9_FOLDED_DYN(X, MID, MK, SHIFT) JCF_K9_FOLDED_STATIC(X, MID, MK, SHIFT)
#define JCF_K9_UNFOLDED(X, MID, MK) X(bf16, MID, MK, false, false, false, false, false)
#define JCF_K9_ROWS32(X)                                  \
  X(float, float, true, false, false, false, false, true) \
  X(float, float, true, false, false, false, false, false)

#define JCF_K9_INSTANCE(ROW, MID, MK, A, C, H, SH, FO) \
  template int launch<ROW, MID, MK, A, C, H, SH, FO>(const Maps&, const Params&, int, cudaStream_t);
#define JCF_K9_EXTERN(ROW, MID, MK, A, C, H, SH, FO)                                       \
  extern template int launch<ROW, MID, MK, A, C, H, SH, FO>(const Maps&, const Params&, int, \
                                                            cudaStream_t);

}  // namespace jcf_k9
