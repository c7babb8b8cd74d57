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
//
// Rows of a width that is a multiple of 8 on 16-byte aligned tensors take
// assemble_vec_kernel, the row design of text_block.cu's
// ln_affine_vec_kernel: a grid sized to the card, each warp looping over
// rows; a lane owns chunks of 8 contiguous elements c = lane + 32k (two
// 16-byte loads of int32, one of bf16 pos, one 16-byte bf16 store) and
// issues the next row's loads before the current row's two reductions; a
// CLS row is a chunk copy, and a warp's crop and token advance by its
// stride without a division a row. The column scale and bias and the
// ln_pre scale and bias are loaded once a block into shared memory (16
// KB at E = 1024) and read there as 16-byte words: held in registers they
// took 194 a thread, one block of 8 warps an SM, and 0.742 ms at 8192
// crops against 0.643 from shared memory (an H100 80GB HBM3 at 700 W). E = 768 has an
// instance of its own, other widths up to 1024 a general one. Other rows
// take assemble_kernel, one warp a row in 4- and 2-byte slots, the
// wrapper's "/scalar" route.
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

constexpr int ASV_WARPS = 8;

// the 8 int32 of a chunk's two 16-byte words as f32
__device__ __forceinline__ void asm_unpack_s32(const uint4 (&r)[2], float (&f)[8]) {
  const int w[8] = {(int)r[0].x, (int)r[0].y, (int)r[0].z, (int)r[0].w,
                    (int)r[1].x, (int)r[1].y, (int)r[1].z, (int)r[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __int2float_rn(w[i]);
}

// the f32 vectors a block holds in shared memory: the column scale and
// bias, the ln_pre scale and bias
enum { AFF_SCALE, AFF_BIAS, AFF_LN_S, AFF_LN_B, AFF_N };

// the 8 values of chunk c of an [AFF_N][2][chunks] float4 table: each
// chunk's two halves in planes of their own, so a warp's 16-byte reads of
// one half are consecutive
template <int N>
__device__ __forceinline__ void asm_aff8(const float4 (&plane)[2][N], int c, float (&f)[8]) {
  const float4 lo = plane[0][c], hi = plane[1][c];
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = v[i];
}

// CPL chunks of 8 a lane; FIXED_E > 0: E = FIXED_E = 256 CPL (every lane
// holds CPL chunks), 0: E at run time, E / 8 <= 32 CPL chunks, a lane's
// chunk past the row neither loaded nor stored
template <int CPL, int FIXED_E>
__global__ void __launch_bounds__(ASV_WARPS * 32) assemble_vec_kernel(
    const int32_t* __restrict__ acc, const float* __restrict__ scale,
    const float* __restrict__ bias, const bf16* __restrict__ pos, const bf16* __restrict__ cls,
    const float* __restrict__ ln_s, const float* __restrict__ ln_b, bf16* __restrict__ out,
    int n_crops, int n_tok, int E_rt) {
  static_assert(FIXED_E == 0 || FIXED_E == 256 * CPL, "a fixed width fills every lane");
  const int E = FIXED_E > 0 ? FIXED_E : E_rt;
  const int lane = threadIdx.x & 31;
  const int chunks = E / 8, s_len = n_tok + 1;
  __shared__ float4 aff[AFF_N][2][32 * CPL];
  {
    const float* vecs[AFF_N] = {scale, bias, ln_s, ln_b};
    for (int i = threadIdx.x; i < 2 * chunks; i += blockDim.x)
#pragma unroll
      for (int a = 0; a < AFF_N; ++a)
        aff[a][i & 1][i >> 1] = reinterpret_cast<const float4*>(vecs[a])[i];
  }
  __syncthreads();
  bool live[CPL];
  uint4 a_cur[CPL][2], a_nxt[CPL][2], p_cur[CPL], p_nxt[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    live[k] = FIXED_E > 0 || lane + 32 * k < chunks;
    a_cur[k][0] = a_cur[k][1] = a_nxt[k][0] = a_nxt[k][1] = make_uint4(0u, 0u, 0u, 0u);
    p_cur[k] = p_nxt[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  const long long rows = (long long)n_crops * s_len;
  const long long stride = (long long)gridDim.x * ASV_WARPS;
  // the crop g and token t of a warp's row, advanced by the stride
  const long long stride_g = stride / s_len;
  const int stride_t = (int)(stride - stride_g * s_len);
  long long row = (long long)blockIdx.x * ASV_WARPS + (threadIdx.x >> 5);
  long long g = row / s_len;
  int t = (int)(row - g * s_len);
  // a token row's accumulators are row g * n_tok + t - 1 = row - g - 1; a
  // CLS row loads nothing here (its copy reads cls)
  auto load = [&](uint4 (&a)[CPL][2], uint4 (&p)[CPL], long long at, long long g_at, int t_at) {
    if (t_at == 0) return;
    const uint4* src = reinterpret_cast<const uint4*>(acc + (at - g_at - 1) * E);
    const uint4* ps = reinterpret_cast<const uint4*>(pos + (long long)(t_at - 1) * E);
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (live[k]) {
        const int c = lane + 32 * k;
        a[k][0] = src[2 * c];
        a[k][1] = src[2 * c + 1];
        p[k] = ps[c];
      }
  };
  if (row < rows) load(a_cur, p_cur, row, g, t);
  while (row < rows) {
    const long long row_n = row + stride;
    long long g_n = g + stride_g;
    int t_n = t + stride_t;
    if (t_n >= s_len) {
      t_n -= s_len;
      ++g_n;
    }
    if (row_n < rows) load(a_nxt, p_nxt, row_n, g_n, t_n);
    uint4* dst = reinterpret_cast<uint4*>(out + row * E);
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (live[k]) dst[lane + 32 * k] = reinterpret_cast<const uint4*>(cls)[lane + 32 * k];
    } else {
      float v[CPL][8];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        float a[8], p[8], sc[8], bi[8];
        asm_unpack_s32(a_cur[k], a);
        lnv_unpack(p_cur[k], p);
        asm_aff8(aff[AFF_SCALE], lane + 32 * k, sc);
        asm_aff8(aff[AFF_BIAS], lane + 32 * k, bi);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float e = __fadd_rn(__fmul_rn(a[i], sc[i]), bi[i]);
          v[k][i] = round_bf16(__fadd_rn(round_bf16(e), p[i]));
        }
      }
      const float2 st = ln_vec_stats<CPL, 8>(v, live, E);
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        if (!live[k]) continue;
        float y[8], gs[8], gb[8];
        asm_aff8(aff[AFF_LN_S], lane + 32 * k, gs);
        asm_aff8(aff[AFF_LN_B], lane + 32 * k, gb);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float z = __fmul_rn(__fsub_rn(v[k][i], st.x), st.y);
          y[i] = __fadd_rn(__fmul_rn(z, gs[i]), gb[i]);
        }
        dst[lane + 32 * k] = lnv_pack(y);
      }
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      a_cur[k][0] = a_nxt[k][0];
      a_cur[k][1] = a_nxt[k][1];
      p_cur[k] = p_nxt[k];
    }
    row = row_n;
    g = g_n;
    t = t_n;
  }
}

// the vector kernel's grid: as many blocks as fit on the card at once (the
// occupancy of this instance, cached), fewer where the rows need fewer
template <int CPL, int FIXED_E>
int launch_assemble_vec(const void* acc, const void* scale, const void* bias, const void* pos,
                        const void* cls, const void* ln_s, const void* ln_b, void* out,
                        int n_crops, int n_tok, int E, cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, assemble_vec_kernel<CPL, FIXED_E>, ASV_WARPS * 32, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)n_crops * (n_tok + 1);
  const long long need = (rows + ASV_WARPS - 1) / ASV_WARPS;
  const unsigned blocks = (unsigned)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
  assemble_vec_kernel<CPL, FIXED_E><<<blocks, ASV_WARPS * 32, 0, stream>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(pos),
      static_cast<const bf16*>(cls), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), n_crops, n_tok, E);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: the vector kernel (E a multiple of 8, every pointer 16-byte
// aligned; E = 768 an instance of its own), else the scalar one
extern "C" int jcf_assemble(const void* acc, const void* scale, const void* bias,
                            const void* pos, const void* cls, const void* ln_s,
                            const void* ln_b, void* out, int n_crops, int n_tok, int E, int vec,
                            void* stream) {
  if (E < 1 || E > 32 * ASM_PER) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)n_crops * (n_tok + 1);
  if (vec) {
    const uintptr_t any = (uintptr_t)acc | (uintptr_t)scale | (uintptr_t)bias | (uintptr_t)pos |
                          (uintptr_t)cls | (uintptr_t)ln_s | (uintptr_t)ln_b | (uintptr_t)out;
    if (rows < 1 || E % 8 != 0 || any % 16 != 0) return (int)cudaErrorInvalidValue;
    if (E == 768)
      return launch_assemble_vec<3, 768>(acc, scale, bias, pos, cls, ln_s, ln_b, out, n_crops,
                                         n_tok, E, st);
    return launch_assemble_vec<4, 0>(acc, scale, bias, pos, cls, ln_s, ln_b, out, n_crops, n_tok,
                                     E, st);
  }
  const unsigned blocks = (unsigned)((rows + ASM_WARPS - 1) / ASM_WARPS);
  assemble_kernel<<<blocks, ASM_WARPS * 32, 0, st>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(pos),
      static_cast<const bf16*>(cls), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), n_crops, n_tok, E);
  return (int)cudaGetLastError();
}
