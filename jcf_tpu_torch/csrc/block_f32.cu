// K9b in f32: one whole pre-LN transformer layer per sequence, every
// product an f32 FMA on the CUDA cores.
//
// Replaces jcf_tpu/ops/block_kernel.py::_block_kernel (:948, pallas_call
// at :1475) on f32 rows, where the TPU runs its dot_generals at
// Precision.HIGHEST. Per sequence of S rows (S <= 80), E = 64 H:
//   h    = LN1(x)                                   (f32 statistics, affine)
//   qkv  = h W_qkv^T + b_qkv
//   ctx  = per head: p = exp(s - max s) / sum, s = (q . k) / sqrt(64) + bias
//          (the additive [S, S] f32 bias: the causal mask, or all zero)
//   mid  = x + (ctx W_out^T + b_out)
//   h2   = LN2(mid)
//   hid  = g * sigmoid(1.702 g), g = h2 W_fc^T + b_fc   (QuickGELU, sigmoid form)
//   out  = mid + (hid W_proj^T + b_proj)
// No TF32 anywhere: the f32 reference preset exists to be exact. The
// epilogues use the _rn intrinsics, so nvcc fuses no rounding that the
// reference does separately.
//
// The TPU holds a group of sequences and a whole layer's weights in VMEM.
// On the H100 an f32 row tile of one sequence, [80, E + 4] floats, is 166
// KB at E = 512 and 250 KB at E = 768: nothing of a layer's activations
// fits beside the weight tiles in the 227 KB of shared memory. So a block
// owns one sequence and keeps every intermediate (the LN rows, then the
// context, then the LN2 rows in one [S, E] buffer; qkv, then the hidden,
// in one [S, max(3E, F)] buffer) in a global scratch that the wrapper
// allocates, S x (E + max(3E, F)) floats per sequence; the f32 mid goes to
// the output rows, which the last epilogue overwrites element by element.
// Every intermediate lives there at both widths, so each pointer's address
// space is fixed at compile time (a run-time choice between
// shared and global pointers measured +7.6% on one H100). The block's freshly written
// scratch mostly stays in the 50 MB L2.
//
// Each product streams its A operand (the sequence's rows, padded to ROWS
// = 64 or 80 with zeros) and the weights through shared memory in 16-deep
// K steps, double-buffered through registers with one barrier per step,
// one 128-column output tile at a time; 256 threads of ROWS / 16 x 8
// outputs (rows 4 ty .. 4 ty + 3 of a 64-row tile, one 16-byte read, or
// rows ty + 16 i of an 80-row tile; two 4-wide column groups 64 apart,
// so the 16-byte shared reads of a warp are conflict-free). The attention
// stages one head's q, k^T and v (f32) in shared memory, a warp per query
// row, K9b's bf16 head loop in f32.
//
// What bounds it on the H100: f32 operations (67 TFLOP/s outside the
// tensor cores): 6.45 MFLOP a row at E = 512 (the text tower, 3.8 ms at
// 512 x 77) and 14.31 MFLOP at E = 768 (the crop tower, 43.8 ms at 4104 x
// 50). This first version does not reach it: a 64-row tile holds 50 real
// rows, each block re-reads the layer's weights from L2 (28 MB at E =
// 768), and the 5 x 8 or 4 x 8 register tiles read shared memory once per
// 5 FMAs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SEQ = 80;
constexpr int NT = 128;       // output columns per tile
constexpr int KC = 16;        // depth per shared stage
constexpr int LDB = NT + 4;   // padded row of the transposed weight tile, floats

struct LayerF32 {
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b;   // [E]
  const float *w_qkv, *w_out, *w_fc, *w_proj;   // [3E, E] [E, E] [F, E] [E, F]
  const float *b_qkv, *b_out, *b_fc, *b_proj;   // [3E] [E] [F] [E]
};

__device__ __forceinline__ int big_width(int E, int F) { return 3 * E > F ? 3 * E : F; }

// the scratch of one sequence, floats
long long scratch_per_seq(int S, int E, int F) {
  return (long long)S * (E + (3 * E > F ? 3 * E : F));
}

template <int ROWS>
size_t smem_bytes(int S) {
  const size_t gemm = (size_t)2 * KC * (ROWS + 4) + (size_t)2 * KC * LDB;
  const size_t attn = (size_t)3 * S * 64 + (size_t)WARPS * S;
  return (gemm > attn ? gemm : attn) * sizeof(float);
}

// o = LN(xr) with its affine, one row of E <= 1024 floats, by one warp
__device__ __forceinline__ void ln_row(const float* xr, int E, const float* scale,
                                       const float* bias, float* o) {
  const int lane = threadIdx.x & 31;
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < E ? xr[j] : 0.0f;
  }
  const float2 st = warp_row_stats<32>(v, lane, E);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = lane + 32 * k;
    if (j < E) {
      const float z = __fmul_rn(__fsub_rn(v[k], st.x), st.y);
      o[j] = __fadd_rn(__fmul_rn(z, scale[j]), bias[j]);
    }
  }
}

// C[r, n] = sum_k A[r, k] W[n, k] for the sequence's rows r < S (A [S,
// K] with row stride lda, rows S..ROWS read as zero) and n < N (W [N, K]
// row-major), K a multiple of KC; epi(r, n, acc) for each r < S, n < N.
// Ends on a barrier after the epilogue, so its writes are visible to the
// whole block.
template <int ROWS, typename Epi>
__device__ void seq_gemm(const float* A, int lda, int S, const float* __restrict__ W, int N,
                         int K, float* smem, Epi epi) {
  constexpr int TM = ROWS / 16;
  constexpr int LDA = ROWS + 4;
  constexpr int A_VEC = ROWS * KC / 4, A_PER = (A_VEC + THREADS - 1) / THREADS;
  constexpr int B_VEC = NT * KC / 4, B_PER = B_VEC / THREADS;
  float* As = smem;                 // [2][KC][LDA]
  float* Bs = smem + 2 * KC * LDA;  // [2][KC][LDB]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int k_tiles = K / KC;
  for (int n0 = 0; n0 < N; n0 += NT) {
    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    float4 ra[A_PER], rb[B_PER];
    // vector idx: 4 consecutive threads read one row's 64 bytes of depth
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int idx = tid + i * THREADS, r = idx >> 2, kq = idx & 3;
        ra[i] = (idx < A_VEC && r < S)
                    ? *reinterpret_cast<const float4*>(A + (long long)r * lda + k0 + kq * 4)
                    : zero4;
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = tid + i * THREADS, c = idx >> 2, kq = idx & 3;
        rb[i] = n0 + c < N
                    ? __ldg(reinterpret_cast<const float4*>(W + (long long)(n0 + c) * K + k0 +
                                                            kq * 4))
                    : zero4;
      }
    };
    auto stash = [&](int buf) {
      float* as = As + buf * KC * LDA;
      float* bs = Bs + buf * KC * LDB;
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int idx = tid + i * THREADS, r = idx >> 2, kq = idx & 3;
        if (idx < A_VEC) {
          as[(kq * 4 + 0) * LDA + r] = ra[i].x;
          as[(kq * 4 + 1) * LDA + r] = ra[i].y;
          as[(kq * 4 + 2) * LDA + r] = ra[i].z;
          as[(kq * 4 + 3) * LDA + r] = ra[i].w;
        }
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = tid + i * THREADS, c = idx >> 2, kq = idx & 3;
        bs[(kq * 4 + 0) * LDB + c] = rb[i].x;
        bs[(kq * 4 + 1) * LDB + c] = rb[i].y;
        bs[(kq * 4 + 2) * LDB + c] = rb[i].z;
        bs[(kq * 4 + 3) * LDB + c] = rb[i].w;
      }
    };
    fetch(0);
    stash(0);
    __syncthreads();
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < k_tiles;
      if (more) fetch((kt + 1) * KC);
      const float* as = As + cur * KC * LDA;
      const float* bs = Bs + cur * KC * LDB;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float a[TM];
        if constexpr (TM == 4) {
          // 64-row tile: a thread's 4 rows are adjacent, one 16-byte read
          const float4 a4 = *reinterpret_cast<const float4*>(as + k * LDA + ty * 4);
          a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = as[k * LDA + ty + 16 * i];
        }
        const float4 b0 = *reinterpret_cast<const float4*>(bs + k * LDB + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + k * LDB + 64 + tx * 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) stash(cur ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = TM == 4 ? ty * 4 + i : ty + 16 * i;
      if (r >= S) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (n < N) epi(r, n, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// One head's attention rows with an additive [S, S] f32 bias, in f32:
// s = (q . k) * scale + bias[i, j], the row max m, p = exp(s - m) / sum,
// ctx = sum_j p_j v_j. q_s [S, 64], kt_s [64, S], v_s [S, 64]; p_s [8,
// S]; row i's 64 outputs go to out + i * out_stride. S <= 96.
__device__ __forceinline__ void head_rows(const float* q_s, const float* kt_s, const float* v_s,
                                          float* p_s, const float* bias, int S, float scale,
                                          float* out, int out_stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pw = p_s + warp * S;
  for (int i = warp; i < S; i += WARPS) {
    const float* qi = q_s + i * 64;
    float s[3];
    float m = -INFINITY;
#pragma unroll
    for (int kb = 0; kb < 3; ++kb) {
      const int j = lane + 32 * kb;
      float acc = -INFINITY;
      if (j < S) {
        acc = 0.0f;
#pragma unroll 16
        for (int d = 0; d < 64; ++d) acc = fmaf(qi[d], kt_s[d * S + j], acc);
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
      if (j < S) pw[j] = __fdiv_rn(s[kb], sum);
    }
    __syncwarp();
    for (int d = lane; d < 64; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < S; ++j) acc = fmaf(pw[j], v_s[j * 64 + d], acc);
      out[i * out_stride + d] = acc;
    }
    __syncwarp();
  }
}

// One block per sequence of S rows: x [n_seq * S, E] -> out (same shape).
// The scratch and the output rows are plain (coherent) pointers: the
// block writes them and reads them back between barriers.
template <int ROWS>
__global__ void __launch_bounds__(THREADS, 2) block_f32_kernel(
    const float* __restrict__ x, float* out, float* scratch, LayerF32 w,
    const float* __restrict__ bias, int S, int H, int F, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int E = H * 64, ldb = big_width(E, F);
  const int warp = threadIdx.x >> 5;
  float* hb = scratch + (long long)blockIdx.x * S * (E + ldb);  // [S, E]: LN1, ctx, LN2
  float* big = hb + (long long)S * E;                           // [S, ldb]: qkv, hidden
  const float* xs = x + (long long)blockIdx.x * S * E;
  float* os = out + (long long)blockIdx.x * S * E;              // the mid, then the output

  for (int r = warp; r < S; r += WARPS)
    ln_row(xs + (long long)r * E, E, w.ln1_s, w.ln1_b, hb + (long long)r * E);
  __syncthreads();
  seq_gemm<ROWS>(hb, E, S, w.w_qkv, 3 * E, E, smem, [&](int r, int n, float acc) {
    big[(long long)r * ldb + n] = __fadd_rn(acc, w.b_qkv[n]);
  });

  float* q_s = smem;           // [S, 64]
  float* kt_s = q_s + S * 64;  // [64, S]
  float* v_s = kt_s + 64 * S;  // [S, 64]
  float* p_s = v_s + S * 64;   // [8, S]
  for (int h = 0; h < H; ++h) {
    for (int idx = threadIdx.x; idx < S * 64; idx += THREADS) {
      const int r = idx >> 6, d = idx & 63;
      const float* row = big + (long long)r * ldb + h * 64 + d;
      q_s[idx] = row[0];
      kt_s[d * S + r] = row[E];
      v_s[idx] = row[2 * E];
    }
    __syncthreads();
    head_rows(q_s, kt_s, v_s, p_s, bias, S, scale, hb + h * 64, E);
    __syncthreads();
  }

  seq_gemm<ROWS>(hb, E, S, w.w_out, E, E, smem, [&](int r, int n, float acc) {
    const long long idx = (long long)r * E + n;
    os[idx] = __fadd_rn(xs[idx], __fadd_rn(acc, w.b_out[n]));
  });
  for (int r = warp; r < S; r += WARPS)
    ln_row(os + (long long)r * E, E, w.ln2_s, w.ln2_b, hb + (long long)r * E);
  __syncthreads();
  seq_gemm<ROWS>(hb, E, S, w.w_fc, F, E, smem, [&](int r, int n, float acc) {
    const float g = __fadd_rn(acc, w.b_fc[n]);
    const float sg = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn(1.702f, g))));
    big[(long long)r * ldb + n] = __fmul_rn(g, sg);
  });
  seq_gemm<ROWS>(big, ldb, S, w.w_proj, E, F, smem, [&](int r, int n, float acc) {
    const long long idx = (long long)r * E + n;
    os[idx] = __fadd_rn(os[idx], __fadd_rn(acc, w.b_proj[n]));
  });
}

template <int ROWS>
int launch(const float* x, float* out, float* scratch, const LayerF32& w, const float* bias,
           int n_seq, int S, int H, int F, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<ROWS>(S);
  const int err = set_smem(block_f32_kernel<ROWS>, smem);
  if (err) return err;
  block_f32_kernel<ROWS><<<n_seq, THREADS, smem, stream>>>(x, out, scratch, w, bias, S, H, F,
                                                           scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch one sequence needs, floats: S x (E + max(3E, F)).
extern "C" long long jcf_block_f32_scratch(int S, int E, int F) {
  return scratch_per_seq(S, E, F);
}

// K9b (_block_kernel) in f32: x [n_seq * S, E] f32 -> out (same shape);
// scratch n_seq x jcf_block_f32_scratch(S, E, F) floats; LN params [E],
// weights [out, in] and biases f32; bias [S, S] f32 additive; scale =
// 1/sqrt(64). S <= 80, head dim 64, E <= 1024, E and F multiples of 16.
extern "C" int jcf_block_f32(const void* x, void* out, void* scratch, const void* ln1_s,
                             const void* ln1_b, const void* w_qkv, const void* b_qkv,
                             const void* w_out, const void* b_out, const void* ln2_s,
                             const void* ln2_b, const void* w_fc, const void* b_fc,
                             const void* w_proj, const void* b_proj, const void* bias, int n_seq,
                             int S, int H, int F, float scale, void* stream) {
  const int E = H * 64;
  if (n_seq < 1 || S < 1 || S > MAX_SEQ || H < 1 || E > 1024 ||
      E % KC || F < KC || F % KC || scratch == nullptr || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const LayerF32 w{static_cast<const float*>(ln1_s),  static_cast<const float*>(ln1_b),
                   static_cast<const float*>(ln2_s),  static_cast<const float*>(ln2_b),
                   static_cast<const float*>(w_qkv),  static_cast<const float*>(w_out),
                   static_cast<const float*>(w_fc),   static_cast<const float*>(w_proj),
                   static_cast<const float*>(b_qkv),  static_cast<const float*>(b_out),
                   static_cast<const float*>(b_fc),   static_cast<const float*>(b_proj)};
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(scratch);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = (cudaStream_t)stream;
  if (S <= 64) return launch<64>(xf, of, sf, w, bf, n_seq, S, H, F, scale, s);
  return launch<80>(xf, of, sf, w, bf, n_seq, S, H, F, scale, s);
}
