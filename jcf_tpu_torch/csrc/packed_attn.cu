// K7: multi-head attention over the packed qkv projection, forward and
// backward (f32 or bf16 in and out).
//
// Replaces jcf_tpu/ops/attention.py::_packed_attn_kernel (the forward; on
// a TPU every LoRA training step takes it, attention.py:351-354) and the
// XLA VJP of _packed_attention_ref (attention.py:239-258), its backward.
// One block per (sequence, head); every q/k/v/dO tile of the head and, in
// the backward, the S x S probabilities and score gradients stay in shared
// memory, so qkv, dO and the bias are read once and the outputs written
// once. Per head, with scale = 1/sqrt(d) and the additive f32 bias:
//   s   = (q . k) * scale + bias      (f32 sums of exact products: no TF32)
//   p   = exp(s - max_j s) / sum_j    (f32)
//   out = T(sum_j T(p) v_j)           (p cast to the value type for PV)
// backward, for the cotangent dO:
//   dP  = T(dO . v_j)                 (the cast's cotangent is rounded too)
//   dS  = p * (dP - sum_j p dP) * scale
//   dQ  = T(dS K),  dK = T(dS^T Q),  dV = T(T(p)^T dO)
// T() is a no-op in f32 and a bf16 rounding in bf16; the bias gets no
// gradient.
//
// Bound on the H100: at the training shapes (S = 77 or 50, D = 64) a
// (sequence, head) block holds a few hundred KFLOP on a tile of a few
// tens of KB, so the kernels run on the CUDA cores from shared memory:
// one warp per query row with lanes over keys for the row work (K and V
// stored transposed with an odd row stride, so column reads by lanes over
// the head dim are conflict-free too), one thread per output element for
// the column sums of the backward. Tiles are f32 in shared memory for both
// input types (bf16 widens exactly).
#include "common.cuh"

namespace {

constexpr int PA_WARPS = 8;   // forward: warps per block
constexpr int PB_WARPS = 16;  // backward: warps per block
constexpr int PA_KEYS = 4;    // keys per lane: S <= 128

__host__ __device__ __forceinline__ int odd_stride(int s) { return s | 1; }

// loads the head's q, k, v tiles: q (and v when v_rows) as [S, D], k (and
// v when !v_rows) transposed as [D, SP]
template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ base, int S, int D, int E, int SP,
                                           float* q_s, float* kt_s, float* v_s, bool v_rows) {
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - j * D;
    const T* r = base + (long long)j * 3 * E + d;
    q_s[idx] = to_f(r[0]);
    kt_s[d * SP + j] = to_f(r[E]);
    if (v_rows)
      v_s[idx] = to_f(r[2 * E]);
    else
      v_s[d * SP + j] = to_f(r[2 * E]);
  }
}

// scores of query row i against every key, one warp: s[kb] holds key
// lane + 32 kb (-inf past S); returns p = exp(s - m) / sum in s
__device__ __forceinline__ void softmax_row(const float* qi, const float* kt_s,
                                            const float* __restrict__ bi, int S, int D, int SP,
                                            float scale, int lane, float (&s)[PA_KEYS]) {
  float m = -INFINITY;
#pragma unroll
  for (int kb = 0; kb < PA_KEYS; ++kb) {
    const int j = lane + 32 * kb;
    float acc = -INFINITY;
    if (j < S) {
      acc = 0.0f;
      for (int d = 0; d < D; ++d) acc = fmaf(qi[d], kt_s[d * SP + j], acc);
      acc = __fadd_rn(__fmul_rn(acc, scale), bi[j]);
    }
    s[kb] = acc;
    m = fmaxf(m, acc);
  }
  m = warp_max(m);
  float sum = 0.0f;
#pragma unroll
  for (int kb = 0; kb < PA_KEYS; ++kb) {
    s[kb] = lane + 32 * kb < S ? expf(__fsub_rn(s[kb], m)) : 0.0f;
    sum += s[kb];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int kb = 0; kb < PA_KEYS; ++kb) s[kb] = __fdiv_rn(s[kb], sum);
}

template <typename T>
__global__ void __launch_bounds__(PA_WARPS * 32) packed_attn_fwd_kernel(
    const T* __restrict__ qkv,     // [B * S, 3E]
    const float* __restrict__ bias,  // [S, S]
    T* __restrict__ out,             // [B * S, E]
    int S, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = H * D, SP = odd_stride(S);
  const int head = blockIdx.x % H;
  const long long seq = blockIdx.x / H;
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [S, D]
  float* kt_s = q_s + S * D;                         // [D, SP]
  float* v_s = kt_s + D * SP;                        // [S, D]
  float* p_s = v_s + S * D;                          // [warps, S]
  load_tiles<T>(qkv + seq * S * 3 * E + head * D, S, D, E, SP, q_s, kt_s, v_s, true);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pw = p_s + warp * S;
  for (int i = warp; i < S; i += PA_WARPS) {
    float s[PA_KEYS];
    softmax_row(q_s + i * D, kt_s, bias + (long long)i * S, S, D, SP, scale, lane, s);
#pragma unroll
    for (int kb = 0; kb < PA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      if (j < S) pw[j] = round_to<T>(s[kb]);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < S; ++j) acc = fmaf(pw[j], v_s[j * D + d], acc);
      out[(seq * S + i) * E + head * D + d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(PB_WARPS * 32) packed_attn_bwd_kernel(
    const T* __restrict__ qkv,       // [B * S, 3E]
    const float* __restrict__ bias,  // [S, S]
    const T* __restrict__ dout,      // [B * S, E]
    T* __restrict__ dqkv,            // [B * S, 3E]
    int S, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = H * D, SP = odd_stride(S);
  const int head = blockIdx.x % H;
  const long long seq = blockIdx.x / H;
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [S, D]
  float* kt_s = q_s + S * D;                         // [D, SP]
  float* vt_s = kt_s + D * SP;                       // [D, SP]
  float* do_s = vt_s + D * SP;                       // [S, D]
  float* p_s = do_s + S * D;                         // [S, SP] p in f32
  float* ds_s = p_s + S * SP;                        // [S, SP] dS * scale
  load_tiles<T>(qkv + seq * S * 3 * E + head * D, S, D, E, SP, q_s, kt_s, vt_s, false);
  const T* dbase = dout + seq * S * E + head * D;
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - j * D;
    do_s[idx] = to_f(dbase[(long long)j * E + d]);
  }
  __syncthreads();

  // rows: p, dP, the row's sum of p dP, dS
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < S; i += PB_WARPS) {
    float p[PA_KEYS];
    softmax_row(q_s + i * D, kt_s, bias + (long long)i * S, S, D, SP, scale, lane, p);
    const float* doi = do_s + i * D;
    float dp[PA_KEYS];
    float pdp = 0.0f;
#pragma unroll
    for (int kb = 0; kb < PA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      float acc = 0.0f;
      if (j < S) {
        for (int d = 0; d < D; ++d) acc = fmaf(doi[d], vt_s[d * SP + j], acc);
        acc = round_to<T>(acc);
      }
      dp[kb] = acc;
      pdp = fmaf(p[kb], acc, pdp);
    }
    pdp = warp_sum(pdp);
#pragma unroll
    for (int kb = 0; kb < PA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      if (j < S) {
        p_s[i * SP + j] = p[kb];
        ds_s[i * SP + j] = __fmul_rn(__fmul_rn(p[kb], __fsub_rn(dp[kb], pdp)), scale);
      }
    }
  }
  __syncthreads();

  // columns: one thread per (row, dim) of dQ, dK and dV
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    float dq = 0.0f, dk = 0.0f, dv = 0.0f;
    for (int i = 0; i < S; ++i) {
      dk = fmaf(ds_s[i * SP + r], q_s[i * D + d], dk);
      dv = fmaf(round_to<T>(p_s[i * SP + r]), do_s[i * D + d], dv);
    }
    for (int j = 0; j < S; ++j) dq = fmaf(ds_s[r * SP + j], kt_s[d * SP + j], dq);
    T* o = dqkv + (seq * S + r) * 3 * E + head * D + d;
    o[0] = from_f<T>(dq);
    o[E] = from_f<T>(dk);
    o[2 * E] = from_f<T>(dv);
  }
}

size_t fwd_smem(int S, int D) {
  return ((size_t)2 * S * D + (size_t)D * odd_stride(S) + (size_t)PA_WARPS * S) * sizeof(float);
}

size_t bwd_smem(int S, int D) {
  const size_t sp = odd_stride(S);
  return ((size_t)2 * S * D + 2 * D * sp + 2 * S * sp) * sizeof(float);
}

// a lane holds PA_KEYS keys of a row: S <= 128
bool shape_ok(int B, int S, int H, int D) {
  return B > 0 && S > 0 && S <= 32 * PA_KEYS && H > 0 && D > 0;
}

template <typename T>
int launch_fwd(const void* qkv, const void* bias, void* out, int B, int S, int H, int D,
               float scale, cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(S, D);
  const int err = set_smem(packed_attn_fwd_kernel<T>, smem);
  if (err) return err;
  packed_attn_fwd_kernel<T><<<(unsigned)((long long)B * H), PA_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<T*>(out), S, H, D,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const void* bias, const void* dout, void* dqkv, int B, int S,
               int H, int D, float scale, cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(S, D);
  const int err = set_smem(packed_attn_bwd_kernel<T>, smem);
  if (err) return err;
  packed_attn_bwd_kernel<T><<<(unsigned)((long long)B * H), PB_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// both entries return cudaErrorInvalidValue, and launch nothing, for
// S > 128 or a block over the card's shared memory
extern "C" int jcf_packed_attention(const void* qkv, const void* bias, void* out, int B, int S,
                                    int H, int D, float scale, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd<bf16>(qkv, bias, out, B, S, H, D, scale, st)
                 : launch_fwd<float>(qkv, bias, out, B, S, H, D, scale, st);
}

extern "C" int jcf_packed_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                        void* dqkv, int B, int S, int H, int D, float scale,
                                        int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd<bf16>(qkv, bias, dout, dqkv, B, S, H, D, scale, st)
                 : launch_bwd<float>(qkv, bias, dout, dqkv, B, S, H, D, scale, st);
}
