// The tile machinery of the whole-layer kernels (fused_layer.cu) and the
// int8 layer kernel K9a / K9c / K9d as a template over its quantization
// mode; see fused_layer.cu for what they replace and how they are laid
// out. The 32 instances of the int8 kernel are built in four sources,
// fused_int8_{mid32,bf16mid}_{dyn,static}.cu, one per (mid, LN scale) pair.
#pragma once

#include "common.cuh"
#include "pair_attention.cuh"

// Built with -DJCF_FUSED_PROFILE (profile_fused.py), the int8 layer kernel
// closes each phase with a barrier and adds thread 0's clock64() cycles
// per phase of every block into fused_profile_cycles (LN1, qkv,
// attention, out-proj, LN2, c_fc + GELU, c_proj), one array in each
// translation unit that holds kernel instances; its
// JCF_FUSED_PROFILE_ENTRY copies them out and clears them, and
// fused_layer.cu's jcf_fused_profile sums those. Without the flag the
// marks compile to nothing.
#ifdef JCF_FUSED_PROFILE
static __device__ unsigned long long fused_profile_cycles[7];
#define PHASE_START long long phase_t0 = clock64();
#define PHASE_MARK(i)                                                          \
  __syncthreads();                                                             \
  if (threadIdx.x == 0) {                                                      \
    const long long t_ = clock64();                                            \
    atomicAdd(&fused_profile_cycles[i], (unsigned long long)(t_ - phase_t0)); \
    phase_t0 = t_;                                                             \
  }
#define JCF_FUSED_PROFILE_ENTRY(name)                                          \
  extern "C" int name(void* host) {                                            \
    const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};                  \
    int err = (int)cudaMemcpyFromSymbol(host, fused_profile_cycles, sizeof(zero)); \
    if (!err) err = (int)cudaMemcpyToSymbol(fused_profile_cycles, zero, sizeof(zero)); \
    return err;                                                                \
  }
#else
#define PHASE_START
#define PHASE_MARK(i)
#define JCF_FUSED_PROFILE_ENTRY(name)
#endif

namespace jcf_fused {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RING_LDS = 80;                // padded shared row of a weight tile, bytes
constexpr int RING_STAGE = 128 * RING_LDS;  // up to 128 rows x 64 bytes of depth
constexpr int INT8_STAGES = 4, BF16_STAGES = 3;  // weight ring depths (shared memory allows)

__device__ __forceinline__ void mma_any(int (&c)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  mma_s8(c, a, b);
}
__device__ __forceinline__ void mma_any(float (&c)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  mma_bf16(c, a, b);
}

template <int MT, int NT, typename T>
__device__ __forceinline__ void zero(T (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;
}

// acc += A x B^T over kbytes bytes of depth, for this warp's tile of MT x
// 16 rows and NT x 8 columns. The block's 8 warps are (8 / WN) x WN over
// rows and columns; the output tile is WN * NT * 8 columns wide.
// A: the activation tile in shared memory (or, for K9b at E = 768, in its
//    global scratch, read through the same generic loads), row stride lda
//    bytes.
// B: weights in global memory ([out, in] row-major), row stride ldb bytes,
//    offset to the output tile's first row and the depth's first byte,
//    streamed through a ring of NSTAGE 64-byte-deep stages (NSTAGE - 1
//    loads in flight while one stage is multiplied).
// kbytes % 64 == 0; every thread of the block calls it. The operand layout
// in bytes is the same for s8 (k32) and bf16 (k16) fragments.
template <int NSTAGE, int MT, int NT, int WN, typename T>
__device__ __forceinline__ void block_mma(T (&acc)[MT][NT][4], const unsigned char* A, int lda,
                                          const unsigned char* B, long long ldb, int kbytes,
                                          unsigned char* ring) {
  constexpr int BN = WN * NT * 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int a_row0 = (warp / WN) * MT * 16, b_col0 = (warp % WN) * NT * 8;
  const int k_tiles = kbytes / 64;
  // stage kt % NSTAGE <- depth tile kt; past the end an empty group keeps
  // the count of committed groups one per tile
  auto load = [&](int kt) {
    if (kt < k_tiles) {
      unsigned char* stage = ring + (kt % NSTAGE) * RING_STAGE;
      for (int c = tid; c < BN * 4; c += THREADS) {
        const int row = c >> 2, col = (c & 3) * 16;
        cp_async16(stage + row * RING_LDS + col, B + row * ldb + kt * 64 + col, 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) load(st);
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<NSTAGE - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and stage (kt - 1) % NSTAGE is free
    load(kt + NSTAGE - 1);
    const unsigned char* bs = ring + (kt % NSTAGE) * RING_STAGE;
    const unsigned char* as = A + kt * 64;
#pragma unroll
    for (int kk = 0; kk < 64; kk += 32) {
      unsigned af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const unsigned char* r = as + (a_row0 + mi * 16 + g) * lda + kk + tig * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(r);
        af[mi][1] = *reinterpret_cast<const unsigned*>(r + 8 * lda);
        af[mi][2] = *reinterpret_cast<const unsigned*>(r + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(r + 8 * lda + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const unsigned char* r = bs + (b_col0 + ni * 8 + g) * RING_LDS + kk + tig * 4;
        bfr[ni][0] = *reinterpret_cast<const unsigned*>(r);
        bfr[ni][1] = *reinterpret_cast<const unsigned*>(r + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_any(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring and A before the caller reuses them
}

// One product of the block over n_tiles output tiles: for each tile t,
// acc = A(t) x B(t)^T (block_mma, the ring filled anew per tile), then
// epi(t, acc). a_of(t) and b_of(t) give block_mma's A and B for tile t.
// The tiles are visited from tile `first` on, wrapping around: callers
// start each block at its own tile (blockIdx.x % n_tiles), so that blocks
// at the same point of a layer read different weights from L2. Tiles are
// independent, so the order changes no result. Ends on a barrier.
template <int NSTAGE, int MT, int NT, int WN, typename T, typename AF, typename BF, typename EF>
__device__ __forceinline__ void block_gemm(int n_tiles, int first, AF a_of, int lda, BF b_of,
                                           long long ldb, int kbytes, unsigned char* ring, EF epi) {
  for (int i = 0; i < n_tiles; ++i) {
    const int t = first + i < n_tiles ? first + i : first + i - n_tiles;
    T acc[MT][NT][4];
    zero(acc);
    block_mma<NSTAGE, MT, NT, WN>(acc, a_of(t), lda, b_of(t), ldb, kbytes, ring);
    epi(t, acc);
  }
  __syncthreads();  // the epilogues' writes are visible to the whole block
}

// f(row, col, v0, v1) for this warp's accumulator pairs: row and col of
// the tile (col even; v0 at col, v1 at col + 1)
template <int MT, int NT, int WN, typename T, typename F>
__device__ __forceinline__ void for_each_pair(const T (&acc)[MT][NT][4], F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int a_row0 = (warp / WN) * MT * 16, b_col0 = (warp % WN) * NT * 8;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int r = a_row0 + mi * 16 + g, c = b_col0 + ni * 8 + tig * 2;
      f(r, c, acc[mi][ni][0], acc[mi][ni][1]);
      f(r + 8, c, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// this lane's column of accumulator element e of n-tile ni
template <int NT, int WN>
__device__ __forceinline__ int acc_col(int ni, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp % WN) * NT * 8 + ni * 8 + (lane & 3) * 2 + (e & 1);
}

// this lane's row of accumulator element e of m-tile mi
template <int MT, int WN>
__device__ __forceinline__ int acc_row(int mi, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp / WN) * MT * 16 + mi * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}

template <typename T>
__device__ __forceinline__ void zero_row(T* o, int n) {
  for (int j = threadIdx.x & 31; j < n; j += 32) o[j] = from_f<T>(0.0f);
}
template <>
__device__ __forceinline__ void zero_row<int8_t>(int8_t* o, int n) {
  for (int j = threadIdx.x & 31; j < n; j += 32) o[j] = 0;
}

// LayerNorm with its affine (scale and bias bf16, math in f32) of one
// warp-held row -> bf16, as text_block.cu's ln_affine_kernel
template <typename T>
__device__ __forceinline__ void ln_affine_row(const T* xr, int E, const bf16* scale,
                                              const bf16* bias, bf16* o) {
  const int lane = threadIdx.x & 31;
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < E ? to_f(xr[j]) : 0.0f;
  }
  const float2 st = warp_row_stats<32>(v, lane, E);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = lane + 32 * k;
    if (j < E) {
      const float z = __fmul_rn(__fsub_rn(v[k], st.x), st.y);
      o[j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(z, bf2f(scale[j])), bf2f(bias[j])));
    }
  }
}

// ---------------------------------------------------------------------------
// K9a / K9c / K9d: the int8 layer, every quantization mode of the folded tree
// ---------------------------------------------------------------------------

constexpr int CROP_ROWS = 64;  // a crop's rows, padded: S <= 64
constexpr int MLP_ROWS = 32;   // rows per pass of the MLP

// one layer's operands, stacked on a leading layer axis; a scalar the
// mode keeps dynamic is not read (and may be null)
struct LayerInt8 {
  const int8_t *w_qkv, *w_out, *w_fc, *w_proj;   // [L, 3E, E] [L, E, E] [L, F, E] [L, E, F]
  const float *qkv_sc, *qkv_b, *out_sc, *out_b;  // [L, 3E] [L, 3E] [L, E] [L, E]
  // [L, F] [L, F] (h_inv folded where static) [L, E] [L, E]
  const float *fc_sc, *fc_b, *proj_sc, *proj_b;
  const float *ln1_inv, *ctx_inv, *ln2_inv, *gelu_c, *shift;  // [L]
};

// the per-row scales of the dynamic quantizations, after the tiles:
// LN1, then LN2 rows [64]; the context rows [64]; the hidden's per row and
// chunk, first its amax (then 127 / amax) and its scale, [32, nsp] each
inline size_t int8_scales_floats(int nsp) { return 2 * CROP_ROWS + 2 * MLP_ROWS * nsp; }

inline size_t int8_smem(int S, int E, int F, int nsp) {
  const size_t lda = E + 16, ldh = F + 16;
  const size_t attn = CROP_ROWS * lda + (size_t)3 * S * 128 * 2 + (size_t)WARPS * 2 * S * 4;
  const size_t mlp = MLP_ROWS * ldh;
  return INT8_STAGES * RING_STAGE + CROP_ROWS * lda + (attn > mlp ? attn : mlp) +
         int8_scales_floats(nsp) * 4;
}

// QuickGELU in its tanh form on an f32 value, c = 0.851 (or 0.851 / h_inv
// on values already scaled by a static h_inv)
__device__ __forceinline__ float gelu_tanh(float h, float c) {
  return __fmul_rn(h, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(c, h)))));
}

// the dynamic per-row quantization (_quant_rows) of a warp-held row of f32
// values v[32] (element j = lane + 32 k, valid while j < n): amax = max(max
// |v|, 1e-8), o = round(v * (127 / amax)), returns the scale amax / 127
__device__ __forceinline__ float quant_row_regs(const float (&v)[32], int n, int8_t* o) {
  const int lane = threadIdx.x & 31;
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (lane + 32 * k < n) amax = fmaxf(amax, fabsf(v[k]));
  amax = fmaxf(warp_max(amax), 1e-8f);
  const float inv = __fdiv_rn(127.0f, amax);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = lane + 32 * k;
    if (j < n) o[j] = round_clip_int8(__fmul_rn(v[k], inv));
  }
  return __fmul_rn(amax, 1.0f / 127.0f);
}

// LayerNorm z-norm of one warp-held row (E <= 1024) -> int8: with the
// static inv (DYN false, returns 0) or per row (returns the row's scale),
// as block.cu's ln_quant_kernel
template <bool DYN, typename T>
__device__ __forceinline__ float ln_quant_row(const T* xr, int E, float inv, int8_t* o) {
  const int lane = threadIdx.x & 31;
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < E ? to_f(xr[j]) : 0.0f;
  }
  const float2 st = warp_row_stats<32>(v, lane, E);
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = __fmul_rn(__fsub_rn(v[k], st.x), st.y);
  if (DYN) return quant_row_regs(v, E, o);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = lane + 32 * k;
    if (j < E) o[j] = round_clip_int8(__fmul_rn(v[k], inv));
  }
  return 0.0f;
}

// One block per crop of S rows. The mode is the template: MID_F32 (K9a:
// mid = x + attention(x) stays f32, in scratch32; otherwise, K9c and K9d,
// it is rounded to bf16, as the halves round it, and kept in out), and a
// static scale for the LN quantizations (ACT), the context (CTX) and the
// hidden (HS), and a static softmax shift (SHIFT); each quantization
// without its static scale is dynamic per row. Layers 1.. (K9c) read the
// residual stream from out. scratch32 [rows, E] f32 holds K9a's mid and the
// dynamic context before its row quantization (dead before mid is
// written); it is not read where neither is used.
template <bool MID_F32, bool ACT, bool CTX, bool HS, bool SHIFT>
__global__ void __launch_bounds__(THREADS, 1) fused_layer_int8_kernel(
    const bf16* x, bf16* out, float* scratch32, LayerInt8 w, int S, int H, int F, int n_layers,
    int nsp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = H * 64, lda = E + 16, ldh = F + 16, hs = F / nsp;
  unsigned char* ring = smem;
  int8_t* xq = reinterpret_cast<int8_t*>(smem + INT8_STAGES * RING_STAGE);  // [64, lda]
  unsigned char* un = smem + INT8_STAGES * RING_STAGE + CROP_ROWS * lda;
  int8_t* ctxq = reinterpret_cast<int8_t*>(un);                 // [64, lda]
  bf16* q_s = reinterpret_cast<bf16*>(un + CROP_ROWS * lda);    // [S, 128]
  bf16* kt_s = q_s + S * 128;                                   // [128, S]
  bf16* v_s = kt_s + 128 * S;                                   // [S, 128]
  float* p_s = reinterpret_cast<float*>(v_s + S * 128);         // [8, 2, S]
  int8_t* hq = reinterpret_cast<int8_t*>(un);                   // [32, ldh]
  const size_t attn_b = CROP_ROWS * lda + (size_t)3 * S * 128 * 2 + (size_t)WARPS * 2 * S * 4;
  const size_t mlp_b = (size_t)MLP_ROWS * ldh;
  float* x_sc = reinterpret_cast<float*>(un + (attn_b > mlp_b ? attn_b : mlp_b));  // [64]
  float* c_sc = x_sc + CROP_ROWS;                               // [64]
  float* h_inv_s = c_sc + CROP_ROWS;                            // [32, nsp]: amax, then 127 / amax
  float* h_sc = h_inv_s + MLP_ROWS * nsp;                       // [32, nsp]
  const int warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * S;
  const unsigned char* xq_b = reinterpret_cast<const unsigned char*>(xq);
  PHASE_START

  for (int l = 0; l < n_layers; ++l) {
    const bf16* src = l == 0 ? x : out;  // the residual stream
    const unsigned char* w_qkv =
        reinterpret_cast<const unsigned char*>(w.w_qkv + (long long)l * 3 * E * E);
    const unsigned char* w_out =
        reinterpret_cast<const unsigned char*>(w.w_out + (long long)l * E * E);
    const unsigned char* w_fc =
        reinterpret_cast<const unsigned char*>(w.w_fc + (long long)l * F * E);
    const unsigned char* w_proj =
        reinterpret_cast<const unsigned char*>(w.w_proj + (long long)l * E * F);
    const float* qkv_sc = w.qkv_sc + l * 3 * E;
    const float* qkv_b = w.qkv_b + l * 3 * E;
    const float* out_sc = w.out_sc + l * E;
    const float* out_b = w.out_b + l * E;
    const float* fc_sc = w.fc_sc + l * F;
    const float* fc_b = w.fc_b + l * F;
    const float* proj_sc = w.proj_sc + l * E;
    const float* proj_b = w.proj_b + l * E;

    // LN1 + quant: static, or per row (the scales into x_sc)
    for (int r = warp; r < CROP_ROWS; r += WARPS) {
      if (r < S) {
        const float sc = ln_quant_row<!ACT>(src + (row0 + r) * E, E, ACT ? w.ln1_inv[l] : 0.0f,
                                            xq + r * lda);
        if (!ACT && (threadIdx.x & 31) == 0) x_sc[r] = sc;
      } else {
        zero_row(xq + r * lda, E);
        if (!ACT && (threadIdx.x & 31) == 0) x_sc[r] = 0.0f;
      }
    }

    PHASE_MARK(0)
    // per head pair: its q, k, v columns (bf16; the dequant (acc * scale)
    // [* row scale] + bias, _int8_gemm's order), then its attention
    for (int pi = 0; pi < H / 2; ++pi) {
      const int p = (pi + blockIdx.x % (H / 2)) % (H / 2);
      block_gemm<INT8_STAGES, 2, 4, 4, int>(
          3, (int)(blockIdx.x % 3), [&](int) { return xq_b; }, lda,
          [&](int t) { return w_qkv + (long long)(t * E + p * 128) * E; }, E, E, ring,
          [&](int t, const int (&acc)[2][4][4]) {
        for_each_pair<2, 4, 4>(acc, [&](int r, int c, int v0, int v1) {
          if (r >= S) return;
          const int n = t * E + p * 128 + c;
          float a0 = __fmul_rn(__int2float_rn(v0), qkv_sc[n]);
          float a1 = __fmul_rn(__int2float_rn(v1), qkv_sc[n + 1]);
          if (!ACT) {
            a0 = __fmul_rn(a0, x_sc[r]);
            a1 = __fmul_rn(a1, x_sc[r]);
          }
          const __nv_bfloat162 y =
              __floats2bfloat162_rn(__fadd_rn(a0, qkv_b[n]), __fadd_rn(a1, qkv_b[n + 1]));
          if (t == 0) {
            *reinterpret_cast<__nv_bfloat162*>(q_s + r * 128 + c) = y;
          } else if (t == 1) {
            kt_s[c * S + r] = y.x;
            kt_s[(c + 1) * S + r] = y.y;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(v_s + r * 128 + c) = y;
          }
        });
      });
      PHASE_MARK(1)
      // the pair shift max(0, pair max) (the dense route's zeroed pad keys),
      // or the calibrated one; the static ctx_inv folded into the normalizer
      // (int8 out), or the f32 context for its row quantization
      const float* shift = SHIFT ? w.shift + l : nullptr;
      if (CTX)
        pair_attention_rows_t<2, bf16, int8_t, false>(q_s, 128, nullptr, kt_s, v_s, p_s, S, 64,
                                                      1.0f, shift, 0.0f, w.ctx_inv[l],
                                                      ctxq + p * 128, lda, WARPS);
      else
        pair_attention_rows_t<2, bf16, float, false>(q_s, 128, nullptr, kt_s, v_s, p_s, S, 64,
                                                     1.0f, shift, 0.0f, 0.0f,
                                                     scratch32 + row0 * E + p * 128, E, WARPS);
      __syncthreads();
      PHASE_MARK(2)
    }
    if (!CTX) {
      // the dynamic context: each E-wide row quantized over all pairs
      for (int r = warp; r < S; r += WARPS) {
        const float* cr = scratch32 + (row0 + r) * E;
        float v[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int j = (threadIdx.x & 31) + 32 * k;
          v[k] = j < E ? cr[j] : 0.0f;
        }
        const float sc = quant_row_regs(v, E, ctxq + r * lda);
        if ((threadIdx.x & 31) == 0) c_sc[r] = sc;
      }
      __syncthreads();
    }

    // out-proj + residual -> mid
    block_gemm<INT8_STAGES, 2, 4, 4, int>(
        E / 128, (int)(blockIdx.x % (E / 128)),
        [&](int) { return reinterpret_cast<const unsigned char*>(ctxq); }, lda,
        [&](int t) { return w_out + (long long)t * 128 * E; }, E, E, ring,
        [&](int t, const int (&acc)[2][4][4]) {
      for_each_pair<2, 4, 4>(acc, [&](int r, int c, int v0, int v1) {
        if (r >= S) return;
        const int n = t * 128 + c;
        const long long idx = (row0 + r) * E + n;
        float a0 = __fmul_rn(__int2float_rn(v0), out_sc[n]);
        float a1 = __fmul_rn(__int2float_rn(v1), out_sc[n + 1]);
        if (!CTX) {
          a0 = __fmul_rn(a0, c_sc[r]);
          a1 = __fmul_rn(a1, c_sc[r]);
        }
        const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(src + idx);
        const float m0 = __fadd_rn(__low2float(res), __fadd_rn(a0, out_b[n]));
        const float m1 = __fadd_rn(__high2float(res), __fadd_rn(a1, out_b[n + 1]));
        if (MID_F32) {
          *reinterpret_cast<float2*>(scratch32 + idx) = make_float2(m0, m1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(m0, m1);
        }
      });
    });  // ends on a barrier: mid, in global memory, is visible to the whole block
    PHASE_MARK(3)

    // LN2 + quant of mid: static, or per row (the scales into x_sc)
    for (int r = warp; r < CROP_ROWS; r += WARPS) {
      float sc = 0.0f;
      if (r >= S) zero_row(xq + r * lda, E);
      else if (MID_F32)
        sc = ln_quant_row<!ACT>(scratch32 + (row0 + r) * E, E, ACT ? w.ln2_inv[l] : 0.0f,
                                xq + r * lda);
      else
        sc = ln_quant_row<!ACT>(out + (row0 + r) * E, E, ACT ? w.ln2_inv[l] : 0.0f, xq + r * lda);
      if (!ACT && (threadIdx.x & 31) == 0) x_sc[r] = sc;
    }
    __syncthreads();

    // the MLP, 32 rows at a time: c_fc + GELU-quant into h_q, then c_proj
    // over nsp hidden chunks, each an exact int32 sum, their f32 partials
    // added in chunk order
    PHASE_MARK(4)
    const float gelu_c = w.gelu_c[l];
    for (int rt = 0; rt * MLP_ROWS < S; ++rt) {
      const unsigned char* a = xq_b + rt * MLP_ROWS * lda;
      // c_fc's f32 output, (acc * scale) [* row scale] + bias (h_inv folded
      // into scale and bias where the hidden's scale is static), then
      // QuickGELU
      auto gelu_of = [&](int r, int n, int v) {
        float h = __fmul_rn(__int2float_rn(v), fc_sc[n]);
        if (!ACT) h = __fmul_rn(h, x_sc[rt * MLP_ROWS + r]);
        return gelu_tanh(__fadd_rn(h, fc_b[n]), gelu_c);
      };
      if (!HS) {
        // the dynamic hidden: each row's amax over each hidden chunk
        // (_quant_rows per chunk), from a first pass of c_fc; the second
        // pass recomputes the same values and quantizes them
        for (int i = threadIdx.x; i < MLP_ROWS * nsp; i += THREADS) h_inv_s[i] = 0.0f;
        __syncthreads();
        block_gemm<INT8_STAGES, 1, 4, 4, int>(
            F / 128, (int)(blockIdx.x % (F / 128)), [&](int) { return a; }, lda,
            [&](int t) { return w_fc + (long long)t * 128 * E; }, E, E, ring,
            [&](int t, const int (&acc)[1][4][4]) {
          for_each_pair<1, 4, 4>(acc, [&](int r, int c, int v0, int v1) {
            const int n = t * 128 + c;
            const float m = fmaxf(fabsf(gelu_of(r, n, v0)), fabsf(gelu_of(r, n + 1, v1)));
            atomicMax(reinterpret_cast<int*>(h_inv_s + r * nsp + n / hs), __float_as_int(m));
          });
        });
        for (int i = threadIdx.x; i < MLP_ROWS * nsp; i += THREADS) {
          const float amax = fmaxf(h_inv_s[i], 1e-8f);
          h_inv_s[i] = __fdiv_rn(127.0f, amax);
          h_sc[i] = __fmul_rn(amax, 1.0f / 127.0f);
        }
        __syncthreads();
      }
      block_gemm<INT8_STAGES, 1, 4, 4, int>(
          F / 128, (int)(blockIdx.x % (F / 128)), [&](int) { return a; }, lda,
          [&](int t) { return w_fc + (long long)t * 128 * E; }, E, E, ring,
          [&](int t, const int (&acc)[1][4][4]) {
        for_each_pair<1, 4, 4>(acc, [&](int r, int c, int v0, int v1) {
          const int n = t * 128 + c;
          float g0 = gelu_of(r, n, v0), g1 = gelu_of(r, n + 1, v1);
          if (!HS) {
            const float inv = h_inv_s[r * nsp + n / hs];
            g0 = __fmul_rn(g0, inv);
            g1 = __fmul_rn(g1, inv);
          }
          char2 q;
          q.x = round_clip_int8(g0);
          q.y = round_clip_int8(g1);
          *reinterpret_cast<char2*>(hq + r * ldh + n) = q;
        });
      });
      PHASE_MARK(5)
      // c_proj: tile t is output columns (t / nsp) * 128.. over hidden chunk
      // t % nsp; a partial is (acc * scale) [* the chunk's row scale]
      float part[1][4][4];
      block_gemm<INT8_STAGES, 1, 4, 4, int>(
          E / 128 * nsp, (int)(blockIdx.x % (E / 128)) * nsp,
          [&](int t) { return reinterpret_cast<const unsigned char*>(hq) + t % nsp * hs; }, ldh,
          [&](int t) { return w_proj + (long long)(t / nsp) * 128 * F + t % nsp * hs; }, F, hs,
          ring, [&](int t, const int (&acc)[1][4][4]) {
        const int n0 = t / nsp * 128, ch = t % nsp;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = __fmul_rn(__int2float_rn(acc[0][ni][e]), proj_sc[n0 + acc_col<4, 4>(ni, e)]);
            if (!HS) v = __fmul_rn(v, h_sc[acc_row<1, 4>(0, e) * nsp + ch]);
            part[0][ni][e] = ch == 0 ? v : __fadd_rn(part[0][ni][e], v);
          }
        if (ch < nsp - 1) return;
        for_each_pair<1, 4, 4>(part, [&](int r, int c, float a0, float a1) {
          const int row = rt * MLP_ROWS + r;
          if (row >= S) return;
          const int n = n0 + c;
          const long long idx = (row0 + row) * E + n;
          float m0, m1;
          if (MID_F32) {
            const float2 m = *reinterpret_cast<const float2*>(scratch32 + idx);
            m0 = m.x;
            m1 = m.y;
          } else {
            const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(out + idx);
            m0 = __low2float(m);
            m1 = __high2float(m);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(
              __fadd_rn(m0, __fadd_rn(a0, proj_b[n])), __fadd_rn(m1, __fadd_rn(a1, proj_b[n + 1])));
        });
      });  // ends on a barrier: the layer's rows are complete before the next layer reads them
      PHASE_MARK(6)
    }
  }
}

// the flags of the int8 layer (a bit per option of the reference kernels,
// as ops/block_kernel.py numbers them): the kernels take the folded tree on
// the dense route, with any of the static options
constexpr int FLAG_FOLDED = 1, FLAG_STATIC_ACT = 2, FLAG_STATIC_CTX = 4, FLAG_STATIC_H = 8,
              FLAG_STATIC_SHIFT = 16, FLAG_DENSE = 32, FLAG_USE_MASK = 64;

struct Int8Launch {
  const bf16* x;
  bf16* out;
  float* scratch32;
  LayerInt8 w;
  int n_crops, S, H, F, n_layers, nsp;
  size_t smem;
  cudaStream_t stream;
};

template <bool MID_F32, bool ACT, bool CTX, bool HS, bool SHIFT>
int launch_int8_mode(const Int8Launch& a) {
  const auto kernel = fused_layer_int8_kernel<MID_F32, ACT, CTX, HS, SHIFT>;
  const int err = set_smem(kernel, a.smem);
  if (err) return err;
  kernel<<<a.n_crops, THREADS, a.smem, a.stream>>>(a.x, a.out, a.scratch32, a.w, a.S, a.H, a.F,
                                                   a.n_layers, a.nsp);
  return (int)cudaGetLastError();
}

// picks the instance of the run-time options, one bit at a time
template <bool... Bs>
int dispatch_int8(const Int8Launch& a, const bool (&bits)[5], int i) {
  if constexpr (sizeof...(Bs) == 5) {
    return launch_int8_mode<Bs...>(a);
  } else {
    return bits[i] ? dispatch_int8<Bs..., true>(a, bits, i + 1)
                   : dispatch_int8<Bs..., false>(a, bits, i + 1);
  }
}

// the 8 instances of one (MID_F32, ACT) pair over the context, hidden and
// shift options; each pair is instantiated in its own source
// (fused_int8_*.cu), so that nvcc builds the 32 instances four at a time
template <bool MID_F32, bool ACT>
int launch_int8_part(const Int8Launch& a, bool ctx, bool hs, bool shift) {
  const bool bits[5] = {MID_F32, ACT, ctx, hs, shift};
  return dispatch_int8<MID_F32, ACT>(a, bits, 2);
}

extern template int launch_int8_part<true, false>(const Int8Launch&, bool, bool, bool);
extern template int launch_int8_part<true, true>(const Int8Launch&, bool, bool, bool);
extern template int launch_int8_part<false, false>(const Int8Launch&, bool, bool, bool);
extern template int launch_int8_part<false, true>(const Int8Launch&, bool, bool, bool);

}  // namespace jcf_fused
