// K2: token assembly, patch-embed accumulators -> flat dense tower rows.
//
// Replaces jcf_tpu/ops/assemble_kernel.py::_assemble_kernel
// (assemble_dense_rows). Per crop g and token t of S = n_tok + 1 rows:
//   row g*S      = cls_row (ln_pre(cls + pos[0]), precomputed once)
//   row g*S + t  = bf16(ln_pre(bf16(acc[g, t-1] * col_scale + col_bias) + pos[t]))
// with the reference's cast points: the epilogue in f32, a bf16 cast, the
// positional add in bf16, LayerNorm statistics in f32, a bf16 output.
//
// What bounds it on the H100: bytes (read 4 B/element of int32
// accumulators, write 2 B/element of bf16 rows; a few flops each). It is
// a row-wise epilogue plus a normalization with no matrix work, so one
// warp owns one token row: the row (E <= 1024) stays in registers between
// the epilogue, the two warp-shuffle reductions of the LayerNorm and the
// store, and every load and store is a coalesced sweep across the lanes.
#include "common.cuh"

namespace {

constexpr int ASM_WARPS = 8;
constexpr int ASM_PER = 32;  // values per lane: E <= 32 * 32

__global__ void __launch_bounds__(ASM_WARPS * 32) assemble_kernel(
    const int32_t* __restrict__ acc,    // [n_crops * n_tok, E]
    const float* __restrict__ scale,    // [E]
    const float* __restrict__ bias,     // [E]
    const bf16* __restrict__ pos,       // [n_tok, E] positional rows 1..S-1
    const bf16* __restrict__ cls,       // [E]
    const float* __restrict__ ln_s,     // [E]
    const float* __restrict__ ln_b,     // [E]
    bf16* __restrict__ out,             // [n_crops * S, E]
    int n_crops, int n_tok, int E) {
  const int lane = threadIdx.x & 31;
  const int s_len = n_tok + 1;
  const long long row = (long long)blockIdx.x * ASM_WARPS + (threadIdx.x >> 5);
  if (row >= (long long)n_crops * s_len) return;
  const int t = (int)(row % s_len);
  bf16* o = out + row * E;
  if (t == 0) {
    for (int j = lane; j < E; j += 32) o[j] = cls[j];
    return;
  }
  const long long g = row / s_len;
  const int32_t* a = acc + (g * n_tok + (t - 1)) * E;
  const bf16* p = pos + (long long)(t - 1) * E;
  float v[ASM_PER];
#pragma unroll
  for (int k = 0; k < ASM_PER; ++k) {
    const int j = lane + 32 * k;
    v[k] = 0.0f;
    if (j < E) {
      const float e = __fadd_rn(__fmul_rn(__int2float_rn(a[j]), scale[j]), bias[j]);
      v[k] = round_bf16(__fadd_rn(round_bf16(e), bf2f(p[j])));
    }
  }
  const float2 st = warp_row_stats<ASM_PER>(v, lane, E);
#pragma unroll
  for (int k = 0; k < ASM_PER; ++k) {
    const int j = lane + 32 * k;
    if (j < E) {
      const float z = __fmul_rn(__fsub_rn(v[k], st.x), st.y);
      o[j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(z, ln_s[j]), ln_b[j]));
    }
  }
}

}  // namespace

extern "C" int jcf_assemble(const void* acc, const void* scale, const void* bias,
                            const void* pos, const void* cls, const void* ln_s,
                            const void* ln_b, void* out, int n_crops, int n_tok, int E,
                            void* stream) {
  const long long rows = (long long)n_crops * (n_tok + 1);
  const unsigned blocks = (unsigned)((rows + ASM_WARPS - 1) / ASM_WARPS);
  assemble_kernel<<<blocks, ASM_WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(pos),
      static_cast<const bf16*>(cls), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), n_crops, n_tok, E);
  return (int)cudaGetLastError();
}
