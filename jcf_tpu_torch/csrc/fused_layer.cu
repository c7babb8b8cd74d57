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
// for the serving flags only (folded tree, static scales in mode "full",
// dense rows, mask-free attention); the C entries refuse any other flag set.
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
// = 189,952 B, one block per SM. The qkv of all heads (230 KB in bf16)
// would not fit, so qkv is produced one head pair at a time and feeds the
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
// What bounds it on the H100: the int8 operations (5.8e12 per ViT-B/32
// layer at 8192 crops, 2.93 ms at the int8 peak). This first version is
// far from it (profile_fused.py splits its time by phase): one block of 8
// warps per SM, all the shared memory a crop needs, hides little latency;
// the attention runs on CUDA cores with two shared-memory loads per
// multiply-add; every block re-reads its layer's weights from L2 (7.08
// MB, the MLP's twice: about 97 GB per layer at 8192 crops).
#include "common.cuh"
#include "pair_attention.cuh"

// Built with -DJCF_FUSED_PROFILE (profile_fused.py), the int8 layer kernel
// closes each phase with a barrier and adds thread 0's clock64() cycles
// per phase of every block into fused_profile_cycles (LN1, qkv,
// attention, out-proj, LN2, c_fc + GELU, c_proj); jcf_fused_profile
// copies them out and clears them. Without the flag the marks compile to
// nothing.
#ifdef JCF_FUSED_PROFILE
__device__ unsigned long long fused_profile_cycles[7];
#define PHASE_START long long phase_t0 = clock64();
#define PHASE_MARK(i)                                                          \
  __syncthreads();                                                             \
  if (threadIdx.x == 0) {                                                      \
    const long long t_ = clock64();                                            \
    atomicAdd(&fused_profile_cycles[i], (unsigned long long)(t_ - phase_t0)); \
    phase_t0 = t_;                                                             \
  }
extern "C" int jcf_fused_profile(void* host) {
  const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  int err = (int)cudaMemcpyFromSymbol(host, fused_profile_cycles, sizeof(zero));
  if (!err) err = (int)cudaMemcpyToSymbol(fused_profile_cycles, zero, sizeof(zero));
  return err;
}
#else
#define PHASE_START
#define PHASE_MARK(i)
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RING_LDS = 80;                // padded shared row of a weight tile, bytes
constexpr int RING_STAGE = 128 * RING_LDS;  // up to 128 rows x 64 bytes of depth
constexpr int INT8_STAGES = 4, BF16_STAGES = 3;  // weight ring depths (shared memory allows)

// the flags of the int8 layer (bit per option of the reference kernels);
// the kernels take exactly the serving set
constexpr int FLAG_FOLDED = 1, FLAG_STATIC_ACT = 2, FLAG_STATIC_CTX = 4, FLAG_STATIC_H = 8,
              FLAG_STATIC_SHIFT = 16, FLAG_DENSE = 32, FLAG_USE_MASK = 64;
constexpr int SERVING_FLAGS =
    FLAG_FOLDED | FLAG_STATIC_ACT | FLAG_STATIC_CTX | FLAG_STATIC_H | FLAG_DENSE;

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

template <typename T>
__device__ __forceinline__ void zero_row(T* o, int n) {
  for (int j = threadIdx.x & 31; j < n; j += 32) o[j] = from_f<T>(0.0f);
}
template <>
__device__ __forceinline__ void zero_row<int8_t>(int8_t* o, int n) {
  for (int j = threadIdx.x & 31; j < n; j += 32) o[j] = 0;
}

// LayerNorm z-norm of one warp-held row (E <= 1024) -> static int8 quant,
// as block.cu's ln_quant_kernel
template <typename T>
__device__ __forceinline__ void ln_quant_row(const T* xr, int E, float inv, int8_t* o) {
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
    if (j < E) o[j] = round_clip_int8(__fmul_rn(__fmul_rn(__fsub_rn(v[k], st.x), st.y), inv));
  }
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
// K9a / K9c / K9d: the int8 serving layer
// ---------------------------------------------------------------------------

constexpr int CROP_ROWS = 64;  // a crop's rows, padded: S <= 64
constexpr int MLP_ROWS = 32;   // rows per pass of the MLP

// one layer's operands, stacked on a leading layer axis
struct LayerInt8 {
  const int8_t *w_qkv, *w_out, *w_fc, *w_proj;   // [L, 3E, E] [L, E, E] [L, F, E] [L, E, F]
  const float *qkv_sc, *qkv_b, *out_sc, *out_b;  // [L, 3E] [L, 3E] [L, E] [L, E]
  const float *fc_sc, *fc_b, *proj_sc, *proj_b;  // [L, F] [L, F] (h_inv folded) [L, E] [L, E]
  const float *ln1_inv, *ctx_inv, *ln2_inv, *gelu_c;  // [L]
};

size_t int8_smem(int S, int E, int F) {
  const size_t lda = E + 16, ldh = F + 16;
  const size_t attn = CROP_ROWS * lda + (size_t)3 * S * 128 * 2 + (size_t)WARPS * 2 * S * 4;
  const size_t mlp = MLP_ROWS * ldh;
  return INT8_STAGES * RING_STAGE + CROP_ROWS * lda + (attn > mlp ? attn : mlp);
}

// One block per crop of S rows. MID_F32 (K9a): mid = x + attention(x)
// stays f32 (in mid32); otherwise (K9c, K9d) it is rounded to bf16, as the
// halves round it, and kept in out. Layers 1.. (K9c) read the residual
// stream from out.
template <bool MID_F32>
__global__ void __launch_bounds__(THREADS, 1) fused_layer_int8_kernel(
    const bf16* x, bf16* out, float* mid32, LayerInt8 w, int S, int H, int F, int n_layers,
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

    // LN1 + static quant
    for (int r = warp; r < CROP_ROWS; r += WARPS) {
      if (r < S) ln_quant_row(src + (row0 + r) * E, E, w.ln1_inv[l], xq + r * lda);
      else zero_row(xq + r * lda, E);
    }

    PHASE_MARK(0)
    // per head pair: its q, k, v columns (bf16), then its attention
    for (int pi = 0; pi < H / 2; ++pi) {
      const int p = (pi + blockIdx.x % (H / 2)) % (H / 2);
      block_gemm<INT8_STAGES, 2, 4, 4, int>(
          3, (int)(blockIdx.x % 3), [&](int) { return xq_b; }, lda,
          [&](int t) { return w_qkv + (long long)(t * E + p * 128) * E; }, E, E, ring,
          [&](int t, const int (&acc)[2][4][4]) {
        for_each_pair<2, 4, 4>(acc, [&](int r, int c, int v0, int v1) {
          if (r >= S) return;
          const int n = t * E + p * 128 + c;
          const __nv_bfloat162 y = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn(__int2float_rn(v0), qkv_sc[n]), qkv_b[n]),
              __fadd_rn(__fmul_rn(__int2float_rn(v1), qkv_sc[n + 1]), qkv_b[n + 1]));
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
      pair_attention_rows(q_s, kt_s, v_s, p_s, S, 64, w.ctx_inv[l], ctxq + p * 128, lda, WARPS);
      __syncthreads();
      PHASE_MARK(2)
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
        const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(src + idx);
        const float m0 = __fadd_rn(__low2float(res),
                                   __fadd_rn(__fmul_rn(__int2float_rn(v0), out_sc[n]), out_b[n]));
        const float m1 = __fadd_rn(__high2float(res), __fadd_rn(__fmul_rn(__int2float_rn(v1),
                                                                          out_sc[n + 1]),
                                                                out_b[n + 1]));
        if (MID_F32) {
          *reinterpret_cast<float2*>(mid32 + idx) = make_float2(m0, m1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(m0, m1);
        }
      });
    });  // ends on a barrier: mid, in global memory, is visible to the whole block
    PHASE_MARK(3)

    // LN2 + static quant of mid
    for (int r = warp; r < CROP_ROWS; r += WARPS) {
      if (r >= S) zero_row(xq + r * lda, E);
      else if (MID_F32) ln_quant_row(mid32 + (row0 + r) * E, E, w.ln2_inv[l], xq + r * lda);
      else ln_quant_row(out + (row0 + r) * E, E, w.ln2_inv[l], xq + r * lda);
    }

    // the MLP, 32 rows at a time: c_fc + GELU-quant into h_q, then c_proj
    // over nsp hidden chunks, each an exact int32 sum, their f32 partials
    // added in chunk order
    PHASE_MARK(4)
    const float gelu_c = w.gelu_c[l];
    for (int rt = 0; rt * MLP_ROWS < S; ++rt) {
      const unsigned char* a = xq_b + rt * MLP_ROWS * lda;
      block_gemm<INT8_STAGES, 1, 4, 4, int>(
          F / 128, (int)(blockIdx.x % (F / 128)), [&](int) { return a; }, lda,
          [&](int t) { return w_fc + (long long)t * 128 * E; }, E, E, ring,
          [&](int t, const int (&acc)[1][4][4]) {
        for_each_pair<1, 4, 4>(acc, [&](int r, int c, int v0, int v1) {
          const int n = t * 128 + c;
          const float h0 = __fadd_rn(__fmul_rn(__int2float_rn(v0), fc_sc[n]), fc_b[n]);
          const float h1 = __fadd_rn(__fmul_rn(__int2float_rn(v1), fc_sc[n + 1]), fc_b[n + 1]);
          char2 q;
          q.x = round_clip_int8(
              __fmul_rn(h0, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(gelu_c, h0))))));
          q.y = round_clip_int8(
              __fmul_rn(h1, __fadd_rn(0.5f, __fmul_rn(0.5f, tanhf(__fmul_rn(gelu_c, h1))))));
          *reinterpret_cast<char2*>(hq + r * ldh + n) = q;
        });
      });
      PHASE_MARK(5)
      // c_proj: tile t is output columns (t / nsp) * 128.. over hidden chunk t % nsp
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
            const float v =
                __fmul_rn(__int2float_rn(acc[0][ni][e]), proj_sc[n0 + acc_col<4, 4>(ni, e)]);
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
            const float2 m = *reinterpret_cast<const float2*>(mid32 + idx);
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

int launch_int8(bool mid_f32, const void* x, void* out, void* mid32, const LayerInt8& w,
                int n_crops, int S, int H, int F, int n_layers, int nsp, int flags,
                cudaStream_t stream) {
  const int E = H * 64;
  if (flags != SERVING_FLAGS || n_crops < 1 || S < 1 || S > CROP_ROWS || H < 2 || H % 2 ||
      E > 1024 || E % 128 || F < 128 || F % 128 || nsp < 1 || F % nsp || (F / nsp) % 64 ||
      n_layers < 1 || (mid_f32 && mid32 == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = int8_smem(S, E, F);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  float* m = static_cast<float*>(mid32);
  if (mid_f32) {
    const int err = set_smem(fused_layer_int8_kernel<true>, smem);
    if (err) return err;
    fused_layer_int8_kernel<true><<<n_crops, THREADS, smem, stream>>>(xb, ob, m, w, S, H, F,
                                                                      n_layers, nsp);
  } else {
    const int err = set_smem(fused_layer_int8_kernel<false>, smem);
    if (err) return err;
    fused_layer_int8_kernel<false><<<n_crops, THREADS, smem, stream>>>(xb, ob, m, w, S, H, F,
                                                                       n_layers, nsp);
  }
  return (int)cudaGetLastError();
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

// K9a (_block_int8_kernel): one int8 layer, f32 mid in mid32 [rows, E].
// K9d (_layer_fused_int8_kernel): one int8 layer, bf16 mid (mid32 unused).
// K9c (_stream_tower_int8_kernel): n_layers int8 layers, bf16 mid.
// The same argument list for the three: x [n_crops * S, E] bf16 and out
// (same shape); the stacked weights, scales and biases of LayerInt8 (fc
// scale and bias with h_inv folded; gelu_c = 0.851 / h_inv per layer);
// nsp MLP hidden chunks; flags must be the serving set.
#define INT8_LAYER_ARGS                                                                        \
  const void *x, void *out, void *mid32, const void *w_qkv, const void *qkv_sc,               \
      const void *qkv_b, const void *w_out, const void *out_sc, const void *out_b,             \
      const void *w_fc, const void *fc_sc, const void *fc_b, const void *w_proj,               \
      const void *proj_sc, const void *proj_b, const void *ln1_inv, const void *ctx_inv,       \
      const void *ln2_inv, const void *gelu_c, int n_crops, int S, int H, int F, int n_layers, \
      int nsp, int flags, void *stream
#define INT8_LAYER_STRUCT                                                                     \
  LayerInt8 {                                                                                 \
    static_cast<const int8_t*>(w_qkv), static_cast<const int8_t*>(w_out),                     \
        static_cast<const int8_t*>(w_fc), static_cast<const int8_t*>(w_proj),                 \
        static_cast<const float*>(qkv_sc), static_cast<const float*>(qkv_b),                  \
        static_cast<const float*>(out_sc), static_cast<const float*>(out_b),                  \
        static_cast<const float*>(fc_sc), static_cast<const float*>(fc_b),                    \
        static_cast<const float*>(proj_sc), static_cast<const float*>(proj_b),                \
        static_cast<const float*>(ln1_inv), static_cast<const float*>(ctx_inv),               \
        static_cast<const float*>(ln2_inv), static_cast<const float*>(gelu_c)                 \
  }

extern "C" int jcf_block_int8(INT8_LAYER_ARGS) {
  if (n_layers != 1) return (int)cudaErrorInvalidValue;
  return launch_int8(true, x, out, mid32, INT8_LAYER_STRUCT, n_crops, S, H, F, 1, nsp, flags,
                     (cudaStream_t)stream);
}

extern "C" int jcf_layer_fused_int8(INT8_LAYER_ARGS) {
  if (n_layers != 1) return (int)cudaErrorInvalidValue;
  return launch_int8(false, x, out, mid32, INT8_LAYER_STRUCT, n_crops, S, H, F, 1, nsp, flags,
                     (cudaStream_t)stream);
}

extern "C" int jcf_stream_tower_int8(INT8_LAYER_ARGS) {
  return launch_int8(false, x, out, mid32, INT8_LAYER_STRUCT, n_crops, S, H, F, n_layers, nsp,
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
