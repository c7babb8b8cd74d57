// K6a row and attention kernels of the unquantized tower halves (the text
// tower in bf16 and f32, the float vision towers in bf16 and f32), and
// the masked attention of the int8 halves (K3 with use_mask=True: the
// int8 text tower, odd head counts).
//
// The TPU runs each half of a layer as one Pallas kernel
// (jcf_tpu/ops/block_kernel.py::_attn_half_kernel and ::_mlp_half_kernel)
// with the tile's rows resident in VMEM. On the H100 a half is a few
// launches: this file's LayerNorm row kernel and attention kernels, and
// the GEMMs with fused epilogues (bf16_gemm.cu on the tensor cores for
// bf16, f32_gemm.cu on the CUDA cores for f32). Every intermediate
// between them is in the compute dtype T (bf16 or f32).
#include "attn_f32.cuh"
#include "attn_mma.cuh"
#include "common.cuh"
#include "pair_attention.cuh"
#include "pair_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm with its affine on T rows
// ---------------------------------------------------------------------------
//
// Replaces the head of both halves: _ln_rows with the LN scale and bias
// cast to the row dtype by the caller (block_kernel.py:1229, :1249),
// statistics and the affine in f32, the output cast to T:
//   y = T(((x - mean) * rsqrt(var + 1e-5)) * scale + bias)
// Bound on the H100: bytes (sizeof(T) in, sizeof(T) out per element).
//
// Rows whose width is a multiple of the 16-byte vector (and 16-byte
// aligned tensors) take ln_affine_vec_kernel: a grid sized to the card,
// each warp looping over rows; a lane holds 16-byte chunks c = lane + 32k
// (8 bf16 or 4 f32 contiguous elements each) of the row, its chunks of the
// scale and bias in registers across all its rows, and issues the next
// row's loads before the current row's two reductions. Other rows take
// ln_affine_kernel, one warp a row in 2-byte (or 4-byte) slots
// j = lane + 32k, the wrapper's "/scalar" route.

constexpr int LNA_WARPS = 8;
constexpr int LNA_PER = 32;  // E <= 1024

template <typename T>
__global__ void __launch_bounds__(LNA_WARPS * 32) ln_affine_kernel(
    const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
    T* __restrict__ out, int M, int E) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LNA_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + row * E;
  float v[LNA_PER];
#pragma unroll
  for (int k = 0; k < LNA_PER; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < E ? to_f(xr[j]) : 0.0f;
  }
  const float2 st = warp_row_stats<LNA_PER>(v, lane, E);
  T* o = out + row * E;
#pragma unroll
  for (int k = 0; k < LNA_PER; ++k) {
    const int j = lane + 32 * k;
    if (j < E) {
      const float z = __fmul_rn(__fsub_rn(v[k], st.x), st.y);
      o[j] = from_f<T>(__fadd_rn(__fmul_rn(z, to_f(scale[j])), to_f(bias[j])));
    }
  }
}

// CPL chunks a lane; FIXED_E > 0: E = FIXED_E = 32 * CPL * V (every lane
// holds CPL chunks), 0: E at run time, E / V <= 32 * CPL chunks, a lane's
// chunk past the row neither loaded nor stored
template <typename T, int CPL, int FIXED_E>
__global__ void __launch_bounds__(LNA_WARPS * 32) ln_affine_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
    T* __restrict__ out, int M, int E_rt) {
  constexpr int V = 16 / sizeof(T);
  static_assert(FIXED_E == 0 || FIXED_E == 32 * CPL * V, "a fixed width fills every lane");
  const int E = FIXED_E > 0 ? FIXED_E : E_rt;
  const int lane = threadIdx.x & 31;
  const int chunks = E / V;
  bool live[CPL];
  uint4 sc[CPL], bi[CPL], cur[CPL], nxt[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    live[k] = FIXED_E > 0 || c < chunks;
    sc[k] = bi[k] = cur[k] = nxt[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live[k]) {
      sc[k] = reinterpret_cast<const uint4*>(scale)[c];
      bi[k] = reinterpret_cast<const uint4*>(bias)[c];
    }
  }
  const long long stride = (long long)gridDim.x * LNA_WARPS;
  long long row = (long long)blockIdx.x * LNA_WARPS + (threadIdx.x >> 5);
  auto load = [&](uint4 (&r)[CPL], long long at) {
    const uint4* src = reinterpret_cast<const uint4*>(x + at * E);
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (live[k]) r[k] = src[lane + 32 * k];
  };
  if (row < M) load(cur, row);
  for (; row < M; row += stride) {
    if (row + stride < M) load(nxt, row + stride);
    float v[CPL][V];
#pragma unroll
    for (int k = 0; k < CPL; ++k) lnv_unpack(cur[k], v[k]);
    const float2 st = ln_vec_stats<CPL, V>(v, live, E);
    uint4* dst = reinterpret_cast<uint4*>(out + row * E);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (!live[k]) continue;
      float s[V], b[V], y[V];
      lnv_unpack(sc[k], s);
      lnv_unpack(bi[k], b);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float z = __fmul_rn(__fsub_rn(v[k][i], st.x), st.y);
        y[i] = __fadd_rn(__fmul_rn(z, s[i]), b[i]);
      }
      dst[lane + 32 * k] = lnv_pack(y);
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) cur[k] = nxt[k];
  }
}

// ---------------------------------------------------------------------------
// per-head attention under a mask (causal, or none) over one sequence
// ---------------------------------------------------------------------------
//
// Replaces the masked attention of the halves, _batched_attention with
// use_mask=True: _paired_attention (an even head count) or the per-head
// loop (block_kernel.py:203-225, an odd head count) with the additive
// bias. For query row i and head h, over keys j <= i (CAUSAL: the mask's
// -inf above the diagonal) or all S keys (no mask: an odd head count
// without one, where the bias is 0 on real keys; the TPU's pad keys
// carry -1e30, score exactly 0 after exp and never reach real rows, so
// the port does not pad):
//   s   = (q . k) [* scale]            (T inputs, f32 sums; SCALED: the
//                                       unfolded 1/sqrt(d) after the sum,
//                                       none where the folded q carries it)
//   m   = max_j s                      (per head: no pair shift here)
//   p   = exp(s - m),  l = sum_j p     (f32)
//   ctx = sum_j T(p / l) v_j           (normalized p cast to T for PV)
// stored as O: T (the float halves, K6a), f32 (the int8 halves'
// dynamic context, quantized per row after), or int8(round(ctx *
// ctx_inv)) (a static context scale, post-multiplied as the masked path
// does, block_kernel.py:186-189). The TPU pairs two heads per 128-lane
// MXU pass with per-half masked reductions; that is exact per head, so a
// block owns one head. With the int8 halves T is bf16, the qkv of the
// int8 GEMM.
//
// Bound on the H100: bytes. At the int8 text tower's 512 prompts x 77
// tokens x 8 heads a (sequence, head) reads q, k, v (3 x 77 x 64 x 2 B)
// and writes the context, against 4 x 77 x 78 / 2 x 64 flop of products
// under the causal mask: under 20 flop a byte.
//
// bf16 qkv at D = 64 (every tower of the port): masked_attention_mma_kernel,
// PV on the tensor cores (attn_mma.cuh). One block per (sequence, head)
// with NC = ceil(S / 16) warps, one 16-row query tile each, so S = 77's
// five tiles take five warps and one round. The block stages the head's K
// and V, 16 NC rows (zero-filled past S), with 16-byte cp.async while each
// warp stages its q rows in f32. A warp takes its tile's scores on the
// CUDA cores in the reference's order (scores_seq: lanes over keys, an
// fmaf a dim in turn; the causal tiles skip the 32-key slots past their
// diagonal), x scale after the sum, the causal mask and keys past S at
// -inf, then the row loop's softmax (softmax_rows: p comes out bit for
// bit as the CUDA-core kernel's, so a p near a bf16 tie rounds to the
// reference's side), writes bf16 p to its scratch and runs PV on the
// tensor cores (NC a template parameter, every loop over it unrolled
// without a guard: p through ldmatrix, V through ldmatrix.trans). The
// context leaves as bf16 or int8 in 16-byte stores or as f32 in 8-byte
// ones (32 contiguous bytes a row a quad). The scale multiplies every
// score (1 where the caller gives none: x 1 is exact), and the output
// kind is a run-time switch after PV. Scores on the tensor cores
// (qk_chunk) took 0.08 ms at 512 x 77 x 8 but moved the bf16 context past
// 1 ulp + 1e-3 on 3-45 elements of each batch measured, and a
// warp-uniform dispatch to t + 1 key chunks for causal tile t was 4-13%
// slower than all NC (the block waits for its last tile), on an H100
// 80GB HBM3 at 700 W (jcf_tpu_torch/scripts/ab_attention.py,
// score_order.py).
//
// f32 qkv at D = 64 (every f32 tower; 16-byte aligned rows): attn_f32.cuh's
// register-tiled kernel on the CUDA cores, K8's f32 kernel with the causal
// mask or none and the optional scale (the port refuses TF32 for f32
// products): one block a (sequence, head), each warp's 8 query rows x
// 32-key slots in registers, the causal slots past a unit's last row
// skipped, the softmax by shuffles over the head's keys, p / l before PV.
//
// bf16 at another head dim: masked_attention_kernel, on the CUDA cores
// from shared memory (one warp per query row, lanes over keys for the
// scores with K stored transposed, lanes over head dims for PV). qkv is
// read once (16-byte loads) and the context written once. Shared memory:
// 3 S D sizeof(T) + 8 S 4 B.

constexpr int CA_WARPS = 8;
constexpr int CA_KEYS = 4;  // keys per lane: S <= 128

__device__ __forceinline__ void store_head_ctx(float* o, float acc, float) { *o = acc; }
__device__ __forceinline__ void store_head_ctx(bf16* o, float acc, float) {
  *o = __float2bfloat16_rn(acc);
}
__device__ __forceinline__ void store_head_ctx(int8_t* o, float acc, float cinv) {
  *o = round_clip_int8(__fmul_rn(acc, cinv));
}

template <typename T, typename O, bool CAUSAL, bool SCALED>
__global__ void __launch_bounds__(CA_WARPS * 32) masked_attention_kernel(
    const T* __restrict__ qkv,          // [n_seq * S, 3E]
    const float* __restrict__ ctx_inv,  // scalar (int8 context)
    O* __restrict__ out,                // [n_seq * S, E]
    int S, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  const int E = H * D;
  const int head = blockIdx.x % H;
  const long long seq = blockIdx.x / H;
  T* q_s = reinterpret_cast<T*>(smem_raw);             // [S, D]
  T* kt_s = q_s + S * D;                                 // [D, S] (transposed)
  T* v_s = kt_s + D * S;                                 // [S, D]
  float* p_s = reinterpret_cast<float*>(v_s + S * D);    // [warps, S]

  const T* base = qkv + seq * S * 3 * E + head * D;
  const int chunks = D / VEC;
  for (int idx = threadIdx.x; idx < S * chunks; idx += blockDim.x) {
    const int j = idx / chunks, d0 = (idx - j * chunks) * VEC;
    const T* r = base + (long long)j * 3 * E + d0;
    *reinterpret_cast<uint4*>(q_s + j * D + d0) = *reinterpret_cast<const uint4*>(r);
    *reinterpret_cast<uint4*>(v_s + j * D + d0) = *reinterpret_cast<const uint4*>(r + 2 * E);
    const uint4 kv = *reinterpret_cast<const uint4*>(r + E);
    const T* kk = reinterpret_cast<const T*>(&kv);
#pragma unroll
    for (int t = 0; t < VEC; ++t) kt_s[(d0 + t) * S + j] = kk[t];
  }
  __syncthreads();

  const float cinv = std::is_same<O, int8_t>::value ? *ctx_inv : 0.0f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pw = p_s + warp * S;
  for (int i = warp; i < S; i += CA_WARPS) {
    const T* qi = q_s + i * D;
    const int n_keys = CAUSAL ? i + 1 : S;  // keys j < n_keys
    float s[CA_KEYS];
    float m = -INFINITY;
#pragma unroll
    for (int kb = 0; kb < CA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      float acc = -INFINITY;
      if (j < n_keys) {
        acc = 0.0f;
        for (int d = 0; d < D; ++d) acc = fmaf(to_f(qi[d]), to_f(kt_s[d * S + j]), acc);
        if (SCALED) acc = __fmul_rn(acc, scale);
      }
      s[kb] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int kb = 0; kb < CA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      s[kb] = j < n_keys ? expf(__fsub_rn(s[kb], m)) : 0.0f;
      sum += s[kb];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int kb = 0; kb < CA_KEYS; ++kb) {
      const int j = lane + 32 * kb;
      if (j < n_keys) pw[j] = round_to<T>(__fdiv_rn(s[kb], sum));
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < n_keys; ++j) acc = fmaf(pw[j], to_f(v_s[j * D + d]), acc);
      store_head_ctx(out + (seq * S + i) * E + head * D + d, acc, cinv);
    }
    __syncwarp();
  }
}

// NC: 16-key chunks, ceil(S / 16); as many warps, one query tile each;
// the register budget leaves each thread at least 128. out_kind: 0 bf16,
// 1 f32, 2 int8 x ctx_inv. The body is attn_mma.cuh's (masked_stage_kv,
// masked_stage_q, masked_tile), which the persistent int8 layer kernel
// shares.
template <int NC, bool CAUSAL>
__global__ void __launch_bounds__(NC * 32, 16 / NC > 1 ? 16 / NC : 1)
    masked_attention_mma_kernel(const bf16* __restrict__ qkv,       // [n_seq * S, 3E]
                                const float* __restrict__ ctx_inv,  // scalar (int8 context)
                                void* __restrict__ out,             // [n_seq * S, E]
                                int S, int H, float scale, int out_kind) {
  constexpr int KP = 16 * NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [KP][MA_LD] K, then [KP][MA_LD] V
  const int E = H * ATT_D;
  const int head = blockIdx.x % H;
  const long long seq = blockIdx.x / H;
  const bf16* base = qkv + seq * S * (3 * E) + head * ATT_D;
  masked_stage_kv<NC>(ks, base, qkv, S, E, threadIdx.x, blockDim.x);
  cp_async_commit();
  const int m0 = (threadIdx.x >> 5) * 16;
  unsigned char* wb =
      smem_raw + 2 * KP * MA_LD * sizeof(bf16) + (threadIdx.x >> 5) * ma_warp_bytes(KP);
  masked_stage_q<false>(wb, base, E, m0, S);
  cp_async_wait<0>();
  __syncthreads();
  masked_tile<NC>(ks, wb, m0, S, CAUSAL, scale, out_kind, ctx_inv, out,
                  (seq * S + m0) * E + head * ATT_D, E);
}

// ---------------------------------------------------------------------------
// mask-free paired attention over one crop and one head pair
// ---------------------------------------------------------------------------
//
// Replaces the attention section of _attn_half_kernel on the float vision
// towers (_batched_attention -> _paired_attention_nomask, no post_scale,
// no score shift, the tree unfolded), per crop and head pair (lo, hi):
//   s   = (q . k) * 1/sqrt(d)           (f32 sums, then the scale)
//   m   = max(floor, max over both heads' real keys of s)
//   p   = T(exp(s - m)),  l = sum_j p   (per head, f32 sums of the rounded p)
//   ctx = T(sum_j p_j v_j * (1 / max(l, 1e-30)))
// The pair shift is floored at 0 where the TPU pads the keys (S not a
// multiple of 8: zeroed pad keys score 0); at a multiple of 8 there are
// no pad keys and no floor.
//
// Bound on the H100: bytes. At the bf16 parity engine's 8192 crops x 50
// tokens a pair reads q, k, v and writes the context, 4 x 50 x 128 x 2 B,
// against 4 x 50 x 50 x 128 flop of products: 25 flop a byte, far under
// the bf16 ridge point (295).
//
// bf16 (D = 64): pair_mma.cuh's pair_attention_mma_kernel on the tensor
// cores, its bf16 instance with the scale (2 x 8 n8 tiles of scores a
// head up to 64 keys, 2 x 16 up to 127), the template K3's attention
// shares.
//
// f32 (D = 64, 16-byte aligned rows: every float vision tower):
// pair_attention_tiled_kernel below, register tiles on the CUDA cores (the
// port refuses TF32 for f32 products; the f32 FMAs, 62.9 GFLOP at 8192 x
// 50 x 12, take 0.94 ms at 67 TFLOP/s, under the 1.50 ms of its bytes).

constexpr int PA_WARPS = 8;

// The tiled f32 kernel, one block of 8 warps per (crop, head pair) item
// (pair_attention_tiled_kernel). The item's K and V (and, up to
// 64 keys, Q) are staged in shared memory with 16-byte cp.async loads; K
// and Q rows are 132 floats, head 1 at float 68, so that the 8 keys (rows)
// a quarter warp reads at one d, and the 4 (row, head) pairs of a warp's q
// loads, fall in distinct 16-byte bank groups. A warp takes 8 query rows
// (a unit) at a time, units warp, warp + warps, ...:
// - scores: lane = (head h, row half rh, key kk); the thread holds rows
//   4 rh + i (i < 4) x keys kk + 8 t (t < ceil(S / 8)) of head h and walks d
//   in float4 steps: 4 + ceil(S / 8) 16-byte shared loads feed 16 ceil(S /
//   8) FMAs (pair_attention.cuh's row loop: two 4-byte loads an FMA).
//   Each sum runs over d in order, as the row loop's; then x scale, keys
//   past S at -inf;
// - the pair shift: the row's max over both heads' keys by shuffles (lane
//   bits kk and h), then the floor; p = exp(s - m), l by shuffles over kk;
// - p goes to shared memory ([2][8][S8] a unit, head 1 4 floats on, so
//   the two heads' broadcast loads miss each other's banks): up to 64 keys
//   over the unit's own q rows, which the scores no longer need; past 64
//   to a buffer of each warp's, and Q is then read from device memory
//   (staged, K, Q, V and p would take 266 KB at S = 127);
// - PV: lane = 4 columns of the pair's 128 (head lane / 16), the thread
//   holds the unit's 8 rows x 4 columns and walks the keys in order, 4 at
//   a time: 4 loads of v and 8 of p (float4) feed 128 FMAs; the context
//   leaves as whole 16-byte runs, times 1 / max(l, 1e-30) as store_ctx.
// Shared memory: 86,272 B at S = 50 (two blocks an SM), 199,424 B at S =
// 127. The FMA chains' latency bounds it, with 14 of an SM's 16 warps busy
// at S = 50 (7 units): one persistent block an SM that loaded the next
// item while computing this one (7 warps an SM) was slower, and so was
// reading Q through L1 to fit three blocks an SM (80 registers: spills).
constexpr int PT_D = 64, PT_LD = 132, PT_H1 = 68;

// floats of one item's staging: K [S8][PT_LD], V [S4][128], with q_smem
// Q [S8][PT_LD]
__host__ __device__ __forceinline__ int pair_stage_floats(int S, bool q_smem) {
  const int S8 = (S + 7) & ~7, S4 = (S + 3) & ~3;
  return S8 * PT_LD * (q_smem ? 2 : 1) + S4 * 2 * PT_D;
}

// stages item (crop, pair) into k_s, v_s (and q_s): cp.async, zeros past S
template <bool Q_SMEM>
__device__ __forceinline__ void pair_stage(const float* base, int S, int E, float* k_s, float* v_s,
                                           float* q_s) {
  const int S8 = (S + 7) & ~7, S4 = (S + 3) & ~3, E3 = 3 * E;
  for (int c = threadIdx.x; c < S8 * 32; c += blockDim.x) {
    const int j = c >> 5, h = (c >> 4) & 1, d = (c & 15) * 4;
    float* kd = k_s + j * PT_LD + h * PT_H1 + d;
    float* qd = q_s + j * PT_LD + h * PT_H1 + d;
    float* vd = v_s + j * 2 * PT_D + h * PT_D + d;
    if (j < S) {
      const float* r = base + (long long)j * E3 + h * PT_D + d;
      cp_async16(kd, r + E, 16);
      if (Q_SMEM) cp_async16(qd, r, 16);
      cp_async16(vd, r + 2 * E, 16);
    } else {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(kd) = z;
      if (Q_SMEM) *reinterpret_cast<float4*>(qd) = z;
      if (j < S4) *reinterpret_cast<float4*>(vd) = z;
    }
  }
}

// the attention of one staged item by n_warps warps: base its qkv rows
// (Q read from there without Q_SMEM), dst its context rows (row stride E);
// l_s [warps][16]. p of a unit goes over its q rows (Q_SMEM), else to each
// warp's buffer p_w [2][8 S8 + 4]
template <int KT, bool Q_SMEM>
__device__ __forceinline__ void pair_compute(const float* base, float* dst, int S, int E,
                                             float scale, float m_floor, const float* k_s,
                                             const float* v_s, float* q_s, float* p_w,
                                             float* l_s, int n_warps) {
  const int E3 = 3 * E;
  const int units = (S + 7) >> 3, S8 = units * 8, S4 = (S + 3) & ~3;
  const int PH = 8 * S8 + 4;  // a head's p rows of one unit
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kk = lane & 7, rh = (lane >> 3) & 1, h = lane >> 4;
  const float* kh = k_s + h * PT_H1 + kk * PT_LD;
  for (int u = warp; u < units; u += n_warps) {
    const int r0 = u * 8 + rh * 4;
    float acc[4][KT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < KT; ++t) acc[i][t] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < PT_D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (Q_SMEM) {
          qv[i] = *reinterpret_cast<const float4*>(q_s + (r0 + i) * PT_LD + h * PT_H1 + d);
        } else {
          qv[i] = r0 + i < S ? __ldg(reinterpret_cast<const float4*>(
                                   base + (long long)(r0 + i) * E3 + h * PT_D + d))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (t < units) {
          const float4 kv = *reinterpret_cast<const float4*>(kh + 8 * t * PT_LD + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = acc[i][t];
            a = fmaf(qv[i].x, kv.x, a);
            a = fmaf(qv[i].y, kv.y, a);
            a = fmaf(qv[i].z, kv.z, a);
            a = fmaf(qv[i].w, kv.w, a);
            acc[i][t] = a;
          }
        }
      }
    }
    // the pair shift and p, in place of the sums
    float l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const float sc = t < units && kk + 8 * t < S ? __fmul_rn(acc[i][t], scale) : -INFINITY;
        acc[i][t] = sc;
        mx = fmaxf(mx, sc);
      }
#pragma unroll
      for (int o = 1; o <= 16; o <<= 1)
        if (o != 8) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m = fmaxf(mx, m_floor);
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < KT; ++t)
        if (t < units) {
          const float pv = expf(__fsub_rn(acc[i][t], m));
          acc[i][t] = pv;
          sum += pv;
        }
#pragma unroll
      for (int o = 1; o <= 4; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = sum;
    }
    float* pw = Q_SMEM ? q_s + u * 8 * PT_LD : p_w + warp * 2 * PH;
    if (Q_SMEM) __syncwarp();  // the unit's q rows are read: p takes their place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < KT; ++t)
        if (t < units) pw[h * PH + (rh * 4 + i) * S8 + kk + 8 * t] = acc[i][t];
    if (kk == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) l_s[warp * 16 + h * 8 + rh * 4 + i] = l[i];
    }
    __syncwarp();

    const int c = lane * 4;  // the pair's columns c .. c + 3, head lane / 16
    const float* ph = pw + h * PH;
    float o4[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x) o4[i][x] = 0.0f;
    for (int j = 0; j < S4; j += 4) {
      float4 v4[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v4[jj] = *reinterpret_cast<const float4*>(v_s + (j + jj) * 2 * PT_D + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(ph + i * S8 + j);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          o4[i][0] = fmaf(pj[jj], v4[jj].x, o4[i][0]);
          o4[i][1] = fmaf(pj[jj], v4[jj].y, o4[i][1]);
          o4[i][2] = fmaf(pj[jj], v4[jj].z, o4[i][2]);
          o4[i][3] = fmaf(pj[jj], v4[jj].w, o4[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = u * 8 + i;
      if (row < S) {
        const float inv = __fdiv_rn(1.0f, fmaxf(l_s[warp * 16 + h * 8 + i], 1e-30f));
        *reinterpret_cast<float4*>(dst + (long long)row * E + c) =
            make_float4(__fmul_rn(o4[i][0], inv), __fmul_rn(o4[i][1], inv),
                        __fmul_rn(o4[i][2], inv), __fmul_rn(o4[i][3], inv));
      }
    }
    __syncwarp();  // p and l of this unit are read before the next unit's
  }
}

// KT: key slots of a lane, keys kk + 8 t, t < KT (S <= 8 KT): up to 64 keys
// Q staged, past 64 read through L1 with each warp's own p buffer
template <int KT>
__global__ void __launch_bounds__(PA_WARPS * 32, 2) pair_attention_tiled_kernel(
    const float* __restrict__ qkv,  // [n_crops * S, 3E]
    float* __restrict__ out,        // [n_crops * S, E]
    int S, int H, float scale, float m_floor) {
  constexpr bool Q_SMEM = KT <= 8;
  extern __shared__ __align__(16) float smem_f[];
  const int E = H * PT_D, n_pairs = H / 2;
  const int pair = blockIdx.x % n_pairs;
  const long long crop = blockIdx.x / n_pairs;
  const int kq = ((S + 7) & ~7) * PT_LD;  // the stage: K, (Q,) V
  float* k_s = smem_f;
  float* q_s = k_s + kq;                           // Q_SMEM
  float* v_s = k_s + (Q_SMEM ? 2 : 1) * kq;
  float* p_w = smem_f + pair_stage_floats(S, Q_SMEM);  // each warp's p past 64 keys
  float* l_s = p_w + (Q_SMEM ? 0 : PA_WARPS * 2 * (8 * ((S + 7) & ~7) + 4));
  const float* base = qkv + crop * S * 3 * E + pair * 2 * PT_D;
  pair_stage<Q_SMEM>(base, S, E, k_s, v_s, q_s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  pair_compute<KT, Q_SMEM>(base, out + crop * S * E + pair * 2 * PT_D, S, E, scale, m_floor, k_s,
                           v_s, q_s, p_w, l_s, PA_WARPS);
}

// the vector kernel's grid: as many blocks as fit on the card at once (the
// occupancy of this instance, cached), fewer where M needs fewer
template <typename T, int CPL, int FIXED_E>
int launch_ln_affine_vec(const T* x, const T* scale, const T* bias, T* out, int M, int E,
                         cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_affine_vec_kernel<T, CPL, FIXED_E>, LNA_WARPS * 32, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)M + LNA_WARPS - 1) / LNA_WARPS;
  const unsigned blocks = (unsigned)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
  ln_affine_vec_kernel<T, CPL, FIXED_E><<<blocks, LNA_WARPS * 32, 0, stream>>>(x, scale, bias, out,
                                                                              M, E);
  return (int)cudaGetLastError();
}

// vec: the vector kernel (E a multiple of 16 / sizeof(T), every pointer
// 16-byte aligned; the 512 and 768 widths have instances of their own),
// else the scalar one
template <typename T>
int launch_ln_affine(const void* xv, const void* scv, const void* biv, void* outv, int M, int E,
                     int vec, cudaStream_t stream) {
  if (E < 1 || E > 32 * LNA_PER) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  const T* scale = static_cast<const T*>(scv);
  const T* bias = static_cast<const T*>(biv);
  T* out = static_cast<T*>(outv);
  if (!vec) {
    const unsigned blocks = (unsigned)((M + LNA_WARPS - 1) / LNA_WARPS);
    ln_affine_kernel<T><<<blocks, LNA_WARPS * 32, 0, stream>>>(x, scale, bias, out, M, E);
    return (int)cudaGetLastError();
  }
  constexpr int V = 16 / sizeof(T), LANE_ROW = 32 * V;  // elements of one chunk on every lane
  if (M < 1 || E % V != 0 ||
      ((uintptr_t)xv | (uintptr_t)scv | (uintptr_t)biv | (uintptr_t)outv) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (E == 512) return launch_ln_affine_vec<T, 512 / LANE_ROW, 512>(x, scale, bias, out, M, E, stream);
  if (E == 768) return launch_ln_affine_vec<T, 768 / LANE_ROW, 768>(x, scale, bias, out, M, E, stream);
  return launch_ln_affine_vec<T, 32 * LNA_PER / LANE_ROW, 0>(x, scale, bias, out, M, E, stream);
}

template <typename T, typename O, bool CAUSAL, bool SCALED>
int launch_masked(const void* qkv, const void* ctx_inv, void* out, int n_seq, int S, int H, int D,
                  float scale, cudaStream_t stream) {
  const size_t smem = (size_t)3 * S * D * sizeof(T) + (size_t)CA_WARPS * S * sizeof(float);
  const int err = set_smem(masked_attention_kernel<T, O, CAUSAL, SCALED>, smem);
  if (err) return err;
  const long long blocks = (long long)n_seq * H;
  masked_attention_kernel<T, O, CAUSAL, SCALED><<<(unsigned)blocks, CA_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(ctx_inv), static_cast<O*>(out), S, H,
      D, scale);
  return (int)cudaGetLastError();
}

template <int NC, bool CAUSAL>
int launch_masked_mma(const void* qkv, const void* ctx_inv, void* out, int n_seq, int H,
                      int S, float scale, int out_kind, cudaStream_t stream) {
  const size_t smem =
      (size_t)2 * 16 * NC * MA_LD * sizeof(bf16) + (size_t)NC * ma_warp_bytes(16 * NC);
  const int err = set_smem(masked_attention_mma_kernel<NC, CAUSAL>, smem);
  if (err) return err;
  masked_attention_mma_kernel<NC, CAUSAL><<<(unsigned)((long long)n_seq * H), NC * 32, smem,
                                            stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(ctx_inv), out, S, H, scale,
      out_kind);
  return (int)cudaGetLastError();
}

// the chunk count the shape needs: ceil(S / 16), S <= 128
template <bool CAUSAL>
int dispatch_masked_mma(const void* qkv, const void* ctx_inv, void* out, int n_seq, int S, int H,
                        float scale, int kind, cudaStream_t st) {
  switch ((S + 15) / 16) {
    case 1: return launch_masked_mma<1, CAUSAL>(qkv, ctx_inv, out, n_seq, H, S, scale, kind, st);
    case 2: return launch_masked_mma<2, CAUSAL>(qkv, ctx_inv, out, n_seq, H, S, scale, kind, st);
    case 3: return launch_masked_mma<3, CAUSAL>(qkv, ctx_inv, out, n_seq, H, S, scale, kind, st);
    case 4: return launch_masked_mma<4, CAUSAL>(qkv, ctx_inv, out, n_seq, H, S, scale, kind, st);
    case 5: return launch_masked_mma<5, CAUSAL>(qkv, ctx_inv, out, n_seq, H, S, scale, kind, st);
    case 6: return launch_masked_mma<6, CAUSAL>(qkv, ctx_inv, out, n_seq, H, S, scale, kind, st);
    case 7: return launch_masked_mma<7, CAUSAL>(qkv, ctx_inv, out, n_seq, H, S, scale, kind, st);
    default: return launch_masked_mma<8, CAUSAL>(qkv, ctx_inv, out, n_seq, H, S, scale, kind, st);
  }
}

template <typename T, typename O>
int dispatch_masked(const void* qkv, const void* ctx_inv, void* out, int n_seq, int S, int H,
                    int D, float scale, int causal, int scaled, cudaStream_t st) {
  if (causal)
    return scaled ? launch_masked<T, O, true, true>(qkv, ctx_inv, out, n_seq, S, H, D, scale, st)
                  : launch_masked<T, O, true, false>(qkv, ctx_inv, out, n_seq, S, H, D, scale, st);
  return scaled ? launch_masked<T, O, false, true>(qkv, ctx_inv, out, n_seq, S, H, D, scale, st)
                : launch_masked<T, O, false, false>(qkv, ctx_inv, out, n_seq, S, H, D, scale, st);
}

template <int KT>
int launch_pair_tiled(const void* qkv, void* out, int n_crops, int S, int H, float scale,
                      float m_floor, cudaStream_t stream) {
  constexpr bool Q_SMEM = KT <= 8;
  const int S8 = (S + 7) & ~7;
  const size_t p_w = Q_SMEM ? 0 : (size_t)PA_WARPS * 2 * (8 * S8 + 4);
  const size_t smem = ((size_t)pair_stage_floats(S, Q_SMEM) + p_w + PA_WARPS * 16) * sizeof(float);
  const int err = set_smem(pair_attention_tiled_kernel<KT>, smem);
  if (err) return err;
  const long long blocks = (long long)n_crops * (H / 2);
  pair_attention_tiled_kernel<KT><<<(unsigned)blocks, PA_WARPS * 32, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), S, H, scale, m_floor);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: 1 for f32 rows, scale and bias, 0 for bf16; vec: 1 for the vector
// kernel (E a multiple of 16 / sizeof(T), 16-byte aligned pointers), 0
// for the scalar one
extern "C" int jcf_ln_affine(const void* x, const void* scale, const void* bias, void* out, int M,
                             int E, int f32, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return f32 ? launch_ln_affine<float>(x, scale, bias, out, M, E, vec, st)
             : launch_ln_affine<bf16>(x, scale, bias, out, M, E, vec, st);
}

// f32: f32 rows (the context in f32; D = 64, qkv and out 16-byte aligned:
// the register-tiled kernel), else bf16 rows with the context stored as
// out_kind: 0 bf16, 1 f32, 2 int8 x ctx_inv. causal: the causal mask, else
// none; scaled: the scores x scale. mma: the tensor-core kernel (bf16
// rows, D = 64, qkv and out 16-byte aligned; the caller's route), else the
// CUDA-core row loop (bf16 rows)
extern "C" int jcf_masked_attention(const void* qkv, const void* ctx_inv, void* out, int n_seq,
                                    int S, int H, int D, float scale, int causal, int scaled,
                                    int f32, int out_kind, int mma, void* stream) {
  if (S < 1 || S > 32 * CA_KEYS || D % 8 || (f32 && out_kind != 0) || out_kind < 0 ||
      out_kind > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32) {
    if (D != ATT_D || mma) return (int)cudaErrorInvalidValue;
    const float* q = static_cast<const float*>(qkv);
    const long long E = (long long)H * ATT_D;
    const Strides in{S * 3 * E, ATT_D, 3 * E}, os{S * E, ATT_D, E};
    const float sc = scaled ? scale : 1.0f;  // x 1 is exact
    float* o = static_cast<float*>(out);
    constexpr int MAX_S = 32 * CA_KEYS;
    return causal ? launch_attn_f32<true, MAX_S>(q, q + E, q + 2 * E, nullptr, o, n_seq, S, H, in,
                                                 os, sc, st)
                  : launch_attn_f32<false, MAX_S>(q, q + E, q + 2 * E, nullptr, o, n_seq, S, H, in,
                                                  os, sc, st);
  }
  if (mma) {
    if (D != ATT_D || (long long)n_seq * H > 0x7fffffffLL || ((uintptr_t)qkv & 15) ||
        ((uintptr_t)out & 15))
      return (int)cudaErrorInvalidValue;
    const float sc = scaled ? scale : 1.0f;  // x 1 is exact
    return causal ? dispatch_masked_mma<true>(qkv, ctx_inv, out, n_seq, S, H, sc, out_kind, st)
                  : dispatch_masked_mma<false>(qkv, ctx_inv, out, n_seq, S, H, sc, out_kind, st);
  }
  if (out_kind == 0)
    return dispatch_masked<bf16, bf16>(qkv, ctx_inv, out, n_seq, S, H, D, scale, causal, scaled,
                                       st);
  if (out_kind == 1)
    return dispatch_masked<bf16, float>(qkv, ctx_inv, out, n_seq, S, H, D, scale, causal, scaled,
                                        st);
  return dispatch_masked<bf16, int8_t>(qkv, ctx_inv, out, n_seq, S, H, D, scale, causal, scaled,
                                       st);
}

// floor: 0 where the reference pads the keys, -inf where it does not;
// D = 64 and 16-byte aligned qkv and out only: bf16 on the tensor cores,
// f32 register-tiled on the CUDA cores
extern "C" int jcf_pair_attention(const void* qkv, void* out, int n_crops, int S, int H, int D,
                                  float scale, float m_floor, int f32, void* stream) {
  if (S < 1 || S > 128 || H < 2 || H % 2 || D != ATT_D || ((uintptr_t)qkv & 15) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return S <= 64 ? launch_pair_tiled<8>(qkv, out, n_crops, S, H, scale, m_floor, st)
                   : launch_pair_tiled<16>(qkv, out, n_crops, S, H, scale, m_floor, st);
  return S <= 64 ? launch_pair_mma<4, bf16, true, false>(qkv, nullptr, nullptr, out, n_crops, S, H,
                                                          scale, m_floor, st)
                 : launch_pair_mma<8, bf16, true, false>(qkv, nullptr, nullptr, out, n_crops, S, H,
                                                          scale, m_floor, st);
}
