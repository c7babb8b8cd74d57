// K6a row and attention kernels of the bf16 tower halves (the text tower).
//
// The TPU runs each half of a text layer as one Pallas kernel
// (jcf_tpu/ops/block_kernel.py::_attn_half_kernel and ::_mlp_half_kernel)
// with the tile's rows resident in VMEM. On the H100 a half is a few
// launches: this file's LayerNorm row kernel and causal attention kernel,
// and the bf16 tensor-core GEMM with fused epilogues in bf16_gemm.cu. Every
// intermediate between them is bf16.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm with its affine on bf16 rows
// ---------------------------------------------------------------------------
//
// Replaces the head of both halves: _ln_rows with the LN scale and bias
// cast to bf16 by the caller (block_kernel.py:1229, :1249), statistics
// and the affine in f32, the output cast to bf16:
//   y = bf16(((x - mean) * rsqrt(var + 1e-5)) * scale + bias)
// Bound on the H100: bytes (2 B in, 2 B out per element). One warp per
// row, the row held in registers across both reductions.

constexpr int LNA_WARPS = 8;
constexpr int LNA_PER = 32;  // E <= 1024

__global__ void __launch_bounds__(LNA_WARPS * 32) ln_affine_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ scale, const bf16* __restrict__ bias,
    bf16* __restrict__ out, int M, int E) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LNA_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* xr = x + row * E;
  float v[LNA_PER];
#pragma unroll
  for (int k = 0; k < LNA_PER; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < E ? bf2f(xr[j]) : 0.0f;
  }
  const float2 st = warp_row_stats<LNA_PER>(v, lane, E);
  bf16* o = out + row * E;
#pragma unroll
  for (int k = 0; k < LNA_PER; ++k) {
    const int j = lane + 32 * k;
    if (j < E) {
      const float z = __fmul_rn(__fsub_rn(v[k], st.x), st.y);
      o[j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(z, bf2f(scale[j])), bf2f(bias[j])));
    }
  }
}

// ---------------------------------------------------------------------------
// causal self-attention over one prompt and one head
// ---------------------------------------------------------------------------
//
// Replaces the attention section of _attn_half_kernel (_batched_attention
// -> _paired_attention with the additive causal mask). Per head, for query
// row i and keys j <= i (the mask's -inf above the diagonal; the TPU's pad
// keys carry -1e30 and never reach real rows, so the port does not pad):
//   s   = (q . k) * scale              (bf16 inputs, f32 sums; 1/sqrt(d) not folded)
//   m   = max_j s                      (per head: no pair shift here)
//   p   = exp(s - m),  l = sum_j p     (f32)
//   ctx = bf16(sum_j bf16(p / l) v_j)  (normalized p cast to bf16 for PV)
// The TPU pairs two heads per 128-lane MXU pass with per-half masked
// reductions; that is exact per head, so a block owns one head.
//
// Bound on the H100: at S = 77, D = 64 a (prompt, head) block's work is
// small next to a tensor-core pipeline, so it runs on the CUDA cores from
// shared memory (one warp per query row, lanes over keys for the scores
// with K stored transposed, lanes over head dims for PV). qkv is read once
// (16-byte loads) and the context written once.

constexpr int CA_WARPS = 8;
constexpr int CA_KEYS = 4;  // keys per lane: S <= 128

__global__ void __launch_bounds__(CA_WARPS * 32) causal_attention_kernel(
    const bf16* __restrict__ qkv,  // [n_seq * S, 3E]
    bf16* __restrict__ out,        // [n_seq * S, E]
    int S, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = H * D;
  const int head = blockIdx.x % H;
  const long long seq = blockIdx.x / H;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);        // [S, D]
  bf16* kt_s = q_s + S * D;                              // [D, S] (transposed)
  bf16* v_s = kt_s + D * S;                              // [S, D]
  float* p_s = reinterpret_cast<float*>(v_s + S * D);    // [warps, S]

  const bf16* base = qkv + seq * S * 3 * E + head * D;
  const int chunks = D / 8;
  for (int idx = threadIdx.x; idx < S * chunks; idx += blockDim.x) {
    const int j = idx / chunks, d0 = (idx - j * chunks) * 8;
    const bf16* r = base + (long long)j * 3 * E + d0;
    *reinterpret_cast<uint4*>(q_s + j * D + d0) = *reinterpret_cast<const uint4*>(r);
    *reinterpret_cast<uint4*>(v_s + j * D + d0) = *reinterpret_cast<const uint4*>(r + 2 * E);
    const uint4 kv = *reinterpret_cast<const uint4*>(r + E);
    const bf16* k8 = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int t = 0; t < 8; ++t) kt_s[(d0 + t) * S + j] = k8[t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pw = p_s + warp * S;
  for (int i = warp; i < S; i += CA_WARPS) {
    const bf16* qi = q_s + i * D;
    float s[CA_KEYS];
    float m = -INFINITY;
#pragma unroll
    for (int kb = 0; kb < CA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      float acc = -INFINITY;
      if (j <= i) {
        acc = 0.0f;
        for (int d = 0; d < D; ++d) acc = fmaf(bf2f(qi[d]), bf2f(kt_s[d * S + j]), acc);
        acc = __fmul_rn(acc, scale);
      }
      s[kb] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int kb = 0; kb < CA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      s[kb] = j <= i ? expf(__fsub_rn(s[kb], m)) : 0.0f;
      sum += s[kb];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int kb = 0; kb < CA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      if (j <= i) pw[j] = round_bf16(__fdiv_rn(s[kb], sum));
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j) acc = fmaf(pw[j], bf2f(v_s[j * D + d]), acc);
      out[(seq * S + i) * E + head * D + d] = __float2bfloat16_rn(acc);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int jcf_ln_affine(const void* x, const void* scale, const void* bias, void* out, int M,
                             int E, void* stream) {
  const unsigned blocks = (unsigned)((M + LNA_WARPS - 1) / LNA_WARPS);
  ln_affine_kernel<<<blocks, LNA_WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, E);
  return (int)cudaGetLastError();
}

extern "C" int jcf_causal_attention(const void* qkv, void* out, int n_seq, int S, int H, int D,
                                    float scale, void* stream) {
  const size_t smem = (size_t)3 * S * D * sizeof(bf16) + (size_t)CA_WARPS * S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(causal_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const long long blocks = (long long)n_seq * H;
  causal_attention_kernel<<<(unsigned)blocks, CA_WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), S, H, D, scale);
  return (int)cudaGetLastError();
}
