// K3/K4 row and attention kernels of the int8 tower halves.
//
// The TPU runs each half of a layer as one Pallas kernel
// (jcf_tpu/ops/block_kernel.py::_attn_half_int8_kernel and
// ::_mlp_half_int8_kernel) because VMEM holds a whole crop tile plus the
// layer's weights. On the H100 a half is a few launches instead: this
// file's LayerNorm+quant row kernel and attention kernel, and the int8
// tensor-core GEMM with fused epilogues in int8_gemm.cu. Every
// intermediate between them is int8 or bf16, so the round trips through
// device memory stay at 1-2 bytes per activation.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm z-norm + static int8 quantization of bf16 rows
// ---------------------------------------------------------------------------
//
// Replaces the head of both halves: _ln_norm (the LN affine is folded into
// the next projection's weights) then _quant_rows_static:
//   q = clip(round(((x - mean) * rsqrt(var + 1e-5)) * ln_inv), -127, 127)
// Bound on the H100: bytes (2 B in, 1 B out per element). One warp per
// row, the row held in registers across both reductions.

constexpr int LNQ_WARPS = 8;
constexpr int LNQ_PER = 32;  // E <= 1024

__global__ void __launch_bounds__(LNQ_WARPS * 32) ln_quant_kernel(
    const bf16* __restrict__ x, const float* __restrict__ inv_p,
    int8_t* __restrict__ out, int M, int E) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LNQ_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* xr = x + row * E;
  float v[LNQ_PER];
#pragma unroll
  for (int k = 0; k < LNQ_PER; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < E ? bf2f(xr[j]) : 0.0f;
  }
  const float2 st = warp_row_stats<LNQ_PER>(v, lane, E);
  const float inv = *inv_p;
  int8_t* o = out + row * E;
#pragma unroll
  for (int k = 0; k < LNQ_PER; ++k) {
    const int j = lane + 32 * k;
    if (j < E) o[j] = round_clip_int8(__fmul_rn(__fmul_rn(__fsub_rn(v[k], st.x), st.y), inv));
  }
}

// ---------------------------------------------------------------------------
// per-crop attention with the static context quantization folded in
// ---------------------------------------------------------------------------
//
// Replaces the attention section of _attn_half_int8_kernel
// (_batched_attention -> _paired_attention_nomask), folded tree (1/sqrt(d)
// already in q), static ctx scale. For one crop of S rows and one head
// pair (lo, hi):
//   s      = q . k                          (bf16 inputs, f32 sums)
//   m      = max(0, max over both heads' keys of s)
//   p      = bf16(exp(s - m))
//   ctx_u  = sum_j p_j v_j,  l = sum_j p_j   (per head, f32)
//   out    = int8(round(ctx_u * (ctx_inv / max(l, 1e-30))))
// The TPU takes one softmax shift per head PAIR, over both heads' scores
// and the zeroed pad keys' 0 (its paired MXU layout); the shift cancels
// in real arithmetic but moves the bf16 rounding of p, so the kernel
// keeps exactly that shift, max(0, pair max), to stay within rounding of
// the reference. That is why a block owns a pair of heads.
//
// Bound on the H100: at S = 50, D = 64 the block's work (2 heads x 50 x
// 50 x 64 x 2 MACs) is small next to launching a tensor-core pipeline,
// so it runs on the CUDA cores from shared memory: one warp per query
// row, lanes over keys for the scores (K stored transposed so the lanes
// read consecutive addresses) and lanes over head dims for PV. qkv is
// read once and the int8 context written once.

constexpr int ATT_WARPS = 8;

__global__ void __launch_bounds__(ATT_WARPS * 32) attention_kernel(
    const bf16* __restrict__ qkv,       // [n_crops * S, 3E]
    const float* __restrict__ ctx_inv,  // scalar
    int8_t* __restrict__ out,           // [n_crops * S, E]
    int S, int H, int D) {
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

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float cinv = *ctx_inv;
  float* pw = p_s + warp * 2 * S;
  for (int i = warp; i < S; i += ATT_WARPS) {
    const bf16* qi = q_s + i * D2;
    float s[2][2];  // [head][key block]: key j = lane + 32 * kb
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const int j = lane + 32 * kb;
        float acc = -INFINITY;
        if (j < S) {
          acc = 0.0f;
          for (int d = 0; d < D; ++d)
            acc = fmaf(bf2f(qi[h * D + d]), bf2f(kt_s[(h * D + d) * S + j]), acc);
        }
        s[h][kb] = acc;
      }
    // the reference's pair shift: max over both heads and the pad keys' 0
    float m = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    m = fmaxf(warp_max(m), 0.0f);
    float l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.0f;
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const int j = lane + 32 * kb;
        if (j < S) {
          const float p = round_bf16(expf(__fsub_rn(s[h][kb], m)));
          pw[h * S + j] = p;
          sum += p;
        }
      }
      l[h] = warp_sum(sum);
    }
    __syncwarp();
    for (int d2 = lane; d2 < D2; d2 += 32) {
      const int h = d2 >= D;
      const float* ph = pw + h * S;
      float acc = 0.0f;
      for (int j = 0; j < S; ++j) acc = fmaf(ph[j], bf2f(v_s[j * D2 + d2]), acc);
      const float r = __fdiv_rn(cinv, fmaxf(l[h], 1e-30f));
      out[(crop * S + i) * E + pair * D2 + d2] = round_clip_int8(__fmul_rn(acc, r));
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int jcf_ln_quant(const void* x, const void* inv, void* out, int M, int E,
                            void* stream) {
  const unsigned blocks = (unsigned)((M + LNQ_WARPS - 1) / LNQ_WARPS);
  ln_quant_kernel<<<blocks, LNQ_WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(inv),
      static_cast<int8_t*>(out), M, E);
  return (int)cudaGetLastError();
}

extern "C" int jcf_attention(const void* qkv, const void* ctx_inv, void* out, int n_crops,
                             int S, int H, int D, void* stream) {
  const size_t smem = (size_t)3 * S * 2 * D * sizeof(bf16) + (size_t)ATT_WARPS * 2 * S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const long long blocks = (long long)n_crops * (H / 2);
  attention_kernel<<<(unsigned)blocks, ATT_WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(ctx_inv),
      static_cast<int8_t*>(out), S, H, D);
  return (int)cudaGetLastError();
}
