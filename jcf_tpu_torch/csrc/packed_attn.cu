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
// Bound on the H100: bytes. At the training shapes (S = 77 or 50, D = 64)
// a (sequence, head) block holds a few hundred KFLOP on a tile of a few
// tens of KB. The f32 forward and backward, and the bf16 ones at another
// head dim (or off 16-byte alignment), run on the CUDA cores from shared
// memory: one warp per query row with lanes over keys for the row
// work (K and V stored transposed with an odd row stride, so column reads
// by lanes over the head dim are conflict-free too), one thread per
// output element for the column sums of the backward. Tiles are f32 in
// shared memory for both input types (bf16 widens exactly).
//
// The bf16 forward at D = 64: packed_attn_fwd_mma_kernel (attn_mma.cuh).
// One block per (sequence, head), NC = ceil(S / 16) warps. The block
// stages Q, K and V as bf16 rows (16 NC of them, zero-filled past S) with
// 16-byte cp.async; a warp per 16-row query tile takes the backward's row
// pass up to p (scores on the CUDA cores in the reference's order, x
// scale, + bias, keys past S at -inf, the row loop's softmax: p bit for
// bit as the CUDA-core kernel's, so the bf16 context keeps its bar of 1
// bf16 ulp + 1e-3 with no slack for p's rounding), writes bf16(p) to its
// own rows of shared memory, and takes PV on the tensor cores (p through
// ldmatrix, V through ldmatrix.trans) into 16-byte stores. Shared memory
// 2 (3 x 16 NC x 72 + 16 NC x (16 NC + 8)) B: 48,640 at S = 77 (four
// blocks an SM).
//
// The bf16 backward at D = 64: packed_attn_bwd_mma_kernel (attn_mma.cuh).
// One block per (sequence, head), NC = ceil(S / 16) warps. The block
// stages Q, K, V and dO as bf16 rows (16 NC of them, zero-filled past S)
// with 16-byte cp.async. Row pass, a warp per 16-row query tile: S = Q K^T
// on the CUDA cores in the reference's order, x scale then + bias (keys
// past S at -inf), p = exp(s - m) / sum as the CUDA-core kernel takes them
// (scores_seq, softmax_rows: a p near a bf16 tie rounds to the
// reference's side); then on the tensor cores dP = dO V^T rounded to bf16,
// the row sum of p dP by quad shuffles, dS = p (dP - sum) x scale, dQ =
// dS K in 16-byte stores; bf16(p), hi = bf16(dS) and lo = bf16(dS - hi)
// go to shared memory. Column pass after one barrier, a warp per 16-key
// tile: dV = bf16(p)^T dO and dK = dS^T Q with the transposed A fragments
// through ldmatrix.trans. dS enters dQ and dK as hi + lo, two products
// into the same f32 sums: about 16 bits of dS where bf16 alone keeps 8
// (the CUDA-core kernel sums f32 dS). Shared memory 2 (4 x 16 NC x 72 + 3
// x 16 NC x (16 NC + 8)) B: 88,320 at S = 77 (two blocks an SM).
#include "attn_mma.cuh"

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

constexpr int PK_LD = ATT_D + 8;  // padded row of Q, K, V, dO (bf16): conflict-free ldmatrix

// one warp's tile of f32 values to shared memory split into bf16 pairs
// hi (at hi) and lo (at lo) (split_bf16), row 0 at each, LDP a row
template <int NC, int LDP>
__device__ __forceinline__ void store_split(const float (&sc)[2 * NC][4], bf16* hi, bf16* lo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < 2 * NC; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (g + 8 * h) * LDP + 8 * t + 2 * tig;
      split_bf16(sc[t][2 * h], sc[t][2 * h + 1], *reinterpret_cast<unsigned*>(hi + off),
                 *reinterpret_cast<unsigned*>(lo + off));
    }
}

size_t bwd_mma_smem(int nc) {
  const size_t kp = 16 * nc;
  return (4 * kp * PK_LD + 3 * kp * (kp + 8)) * sizeof(bf16);
}

size_t fwd_mma_smem(int nc) {
  const size_t kp = 16 * nc;
  return (3 * kp * PK_LD + kp * (kp + 8)) * sizeof(bf16);
}

// NC: 16-row chunks, ceil(S / 16); as many warps
template <int NC>
__global__ void __launch_bounds__(NC * 32) packed_attn_fwd_mma_kernel(
    const bf16* __restrict__ qkv,    // [B * S, 3E]
    const float* __restrict__ bias,  // [S, S]
    bf16* __restrict__ out,          // [B * S, E]
    int S, int H, float scale) {
  constexpr int KP = 16 * NC, LDP = KP + 8, KS = (KP + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [KP][PK_LD] each: Q, K, V
  const bf16* k_s = q_s + KP * PK_LD;
  const bf16* v_s = k_s + KP * PK_LD;
  bf16* p_s = q_s + 3 * KP * PK_LD;  // [KP][LDP] bf16(p)
  const int E = H * ATT_D, E3 = 3 * E;
  const int head = blockIdx.x % H;
  const long long seq = blockIdx.x / H;
  const bf16* base = qkv + seq * S * E3 + head * ATT_D;
  for (int c = threadIdx.x; c < 3 * KP * 8; c += blockDim.x) {
    const int r = c >> 3, t = r / KP, row = r - t * KP, col = (c & 7) * 8;
    const bool ok = row < S;
    cp_async16(q_s + r * PK_LD + col, ok ? base + (long long)row * E3 + t * E + col : qkv,
               ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // query rows m0 .. m0 + 15: the scores and p in the reference's order
  // (lanes over keys), x scale, then + bias; rows past S (zero q) take
  // bias 0 and are not stored
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  {
    float sp[16][KS];
    scores_seq<KS, PK_LD>(sp, q_s + m0 * PK_LD, k_s, S, KP);
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int sl = 0; sl < KS; ++sl) {
        const int i = m0 + r, j = 32 * sl + lane;
        const float b = i < S && j < S ? __ldg(bias + (long long)i * S + j) : 0.0f;
        sp[r][sl] = j < S ? __fadd_rn(__fmul_rn(sp[r][sl], scale), b) : -INFINITY;
      }
    softmax_rows<KS>(sp);
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int sl = 0; sl < KS; ++sl)
        if (32 * sl + lane < KP)
          p_s[(m0 + r) * LDP + 32 * sl + lane] = __float2bfloat16_rn(sp[r][sl]);
  }
  __syncwarp();

  // out = bf16(bf16(p) V) on the tensor cores
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  smem_tile<NC, LDP, PK_LD, false, false>(acc, p_s + m0 * LDP, nullptr, v_s);
  store_tile_bf16(acc, out + (seq * S + m0) * E + head * ATT_D, E, S - m0);
}

// NC: 16-row chunks, ceil(S / 16); as many warps
template <int NC>
__global__ void __launch_bounds__(NC * 32) packed_attn_bwd_mma_kernel(
    const bf16* __restrict__ qkv,    // [B * S, 3E]
    const float* __restrict__ bias,  // [S, S]
    const bf16* __restrict__ dout,   // [B * S, E]
    bf16* __restrict__ dqkv,         // [B * S, 3E]
    int S, int H, float scale) {
  constexpr int KP = 16 * NC, LDP = KP + 8, KS = (KP + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [KP][PK_LD] each: Q, K, V, dO
  const bf16* k_s = q_s + KP * PK_LD;
  const bf16* v_s = k_s + KP * PK_LD;
  const bf16* do_s = v_s + KP * PK_LD;
  bf16* p_s = q_s + 4 * KP * PK_LD;  // [KP][LDP] each: bf16(p), then hi and lo of dS
  bf16* hi_s = p_s + KP * LDP;
  bf16* lo_s = hi_s + KP * LDP;
  const int E = H * ATT_D, E3 = 3 * E;
  const int head = blockIdx.x % H;
  const long long seq = blockIdx.x / H;
  const bf16* base = qkv + seq * S * E3 + head * ATT_D;
  const bf16* dbase = dout + seq * S * E + head * ATT_D;
  for (int c = threadIdx.x; c < 4 * KP * 8; c += blockDim.x) {
    const int r = c >> 3, t = r / KP, row = r - t * KP, col = (c & 7) * 8;
    const bool ok = row < S;
    const bf16* src =
        t < 3 ? base + (long long)row * E3 + t * E + col : dbase + (long long)row * E + col;
    cp_async16(q_s + r * PK_LD + col, ok ? src : qkv, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // row pass: query rows m0 .. m0 + 15. The scores and p in the
  // reference's order (lanes over keys), x scale, then + bias; rows past S
  // (zero q and dO) take bias 0: finite p, and dS = 0
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
  {
    float sp[16][KS];
    scores_seq<KS, PK_LD>(sp, q_s + m0 * PK_LD, k_s, S, KP);
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int sl = 0; sl < KS; ++sl) {
        const int i = m0 + r, j = 32 * sl + lane;
        const float b = i < S && j < S ? __ldg(bias + (long long)i * S + j) : 0.0f;
        sp[r][sl] = j < S ? __fadd_rn(__fmul_rn(sp[r][sl], scale), b) : -INFINITY;
      }
    softmax_rows<KS>(sp);
    // bf16(p) for dV, and f32 p through this warp's rows of hi and lo (8
    // rows of LDP floats each) into the accumulator layout
    float* pf0 = reinterpret_cast<float*>(hi_s + m0 * LDP);
    float* pf1 = reinterpret_cast<float*>(lo_s + m0 * LDP);
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int sl = 0; sl < KS; ++sl) {
        const int j = 32 * sl + lane;
        if (j < KP) {
          p_s[(m0 + r) * LDP + j] = __float2bfloat16_rn(sp[r][sl]);
          (r < 8 ? pf0 : pf1)[(r & 7) * LDP + j] = sp[r][sl];
        }
      }
  }
  __syncwarp();
  float sc[2 * NC][4];
  {
    const float* pf0 = reinterpret_cast<const float*>(hi_s + m0 * LDP);
    const float* pf1 = reinterpret_cast<const float*>(lo_s + m0 * LDP);
#pragma unroll
    for (int t = 0; t < 2 * NC; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[t][e] = ((e >> 1) ? pf1 : pf0)[g * LDP + 8 * t + 2 * tig + (e & 1)];
  }
  __syncwarp();  // p read: hi and lo take dS

  // dP = T(dO V^T) (the cast's cotangent is rounded), the row sums of p dP
  unsigned a[4][4];
  load_a_tile<PK_LD>(a, do_s + m0 * PK_LD);
  float dp[2 * NC][4], pdp[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < NC; ++c) qk_chunk<PK_LD>(dp[2 * c], dp[2 * c + 1], a, v_s + 16 * c * PK_LD);
#pragma unroll
  for (int t = 0; t < 2 * NC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dp[t][e] = round_bf16(dp[t][e]);
      pdp[e >> 1] = fmaf(sc[t][e], dp[t][e], pdp[e >> 1]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) pdp[r] = quad_sum(pdp[r]);
  // dS = p (dP - sum) x scale, in place of p
#pragma unroll
  for (int t = 0; t < 2 * NC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[t][e] = __fmul_rn(__fmul_rn(sc[t][e], __fsub_rn(dp[t][e], pdp[e >> 1])), scale);
  store_split<NC, LDP>(sc, hi_s + m0 * LDP, lo_s + m0 * LDP);
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  pv_tile_split<NC, PK_LD>(acc, sc, k_s);  // dQ = dS K
  bf16* ob = dqkv + seq * S * E3 + head * ATT_D;
  store_tile_bf16(acc, ob + (long long)m0 * E3, E3, S - m0);
  __syncthreads();

  // column pass: key rows j0 .. j0 + 15; dV = T(p)^T dO, dK = dS^T Q
  const int j0 = m0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  smem_tile<NC, LDP, PK_LD, true, false>(acc, p_s + j0, nullptr, do_s);
  store_tile_bf16(acc, ob + (long long)j0 * E3 + 2 * E, E3, S - j0);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  smem_tile<NC, LDP, PK_LD, true, true>(acc, hi_s + j0, lo_s + j0, q_s);
  store_tile_bf16(acc, ob + (long long)j0 * E3 + E, E3, S - j0);
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

template <int NC>
int launch_fwd_mma(const void* qkv, const void* bias, void* out, int B, int S, int H, float scale,
                   cudaStream_t stream) {
  const size_t smem = fwd_mma_smem(NC);
  const int err = set_smem(packed_attn_fwd_mma_kernel<NC>, smem);
  if (err) return err;
  packed_attn_fwd_mma_kernel<NC><<<(unsigned)((long long)B * H), NC * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias), static_cast<bf16*>(out), S,
      H, scale);
  return (int)cudaGetLastError();
}

// the chunk count the shape needs: ceil(S / 16), S <= 128
int dispatch_fwd_mma(const void* qkv, const void* bias, void* out, int B, int S, int H, float scale,
                     cudaStream_t st) {
  switch ((S + 15) / 16) {
    case 1: return launch_fwd_mma<1>(qkv, bias, out, B, S, H, scale, st);
    case 2: return launch_fwd_mma<2>(qkv, bias, out, B, S, H, scale, st);
    case 3: return launch_fwd_mma<3>(qkv, bias, out, B, S, H, scale, st);
    case 4: return launch_fwd_mma<4>(qkv, bias, out, B, S, H, scale, st);
    case 5: return launch_fwd_mma<5>(qkv, bias, out, B, S, H, scale, st);
    case 6: return launch_fwd_mma<6>(qkv, bias, out, B, S, H, scale, st);
    case 7: return launch_fwd_mma<7>(qkv, bias, out, B, S, H, scale, st);
    default: return launch_fwd_mma<8>(qkv, bias, out, B, S, H, scale, st);
  }
}

template <int NC>
int launch_bwd_mma(const void* qkv, const void* bias, const void* dout, void* dqkv, int B, int S,
                   int H, float scale, cudaStream_t stream) {
  const size_t smem = bwd_mma_smem(NC);
  const int err = set_smem(packed_attn_bwd_mma_kernel<NC>, smem);
  if (err) return err;
  packed_attn_bwd_mma_kernel<NC><<<(unsigned)((long long)B * H), NC * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), S, H, scale);
  return (int)cudaGetLastError();
}

// the chunk count the shape needs: ceil(S / 16), S <= 128
int dispatch_bwd_mma(const void* qkv, const void* bias, const void* dout, void* dqkv, int B, int S,
                     int H, float scale, cudaStream_t st) {
  switch ((S + 15) / 16) {
    case 1: return launch_bwd_mma<1>(qkv, bias, dout, dqkv, B, S, H, scale, st);
    case 2: return launch_bwd_mma<2>(qkv, bias, dout, dqkv, B, S, H, scale, st);
    case 3: return launch_bwd_mma<3>(qkv, bias, dout, dqkv, B, S, H, scale, st);
    case 4: return launch_bwd_mma<4>(qkv, bias, dout, dqkv, B, S, H, scale, st);
    case 5: return launch_bwd_mma<5>(qkv, bias, dout, dqkv, B, S, H, scale, st);
    case 6: return launch_bwd_mma<6>(qkv, bias, dout, dqkv, B, S, H, scale, st);
    case 7: return launch_bwd_mma<7>(qkv, bias, dout, dqkv, B, S, H, scale, st);
    default: return launch_bwd_mma<8>(qkv, bias, dout, dqkv, B, S, H, scale, st);
  }
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
// S > 128 or a block over the card's shared memory. mma: the tensor-core
// kernel (bf16, D = 64, every pointer but the bias 16-byte aligned; the
// caller's route), else the CUDA-core kernel
extern "C" int jcf_packed_attention(const void* qkv, const void* bias, void* out, int B, int S,
                                    int H, int D, float scale, int is_bf16, int mma,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mma) {
    if (!shape_ok(B, S, H, D) || !is_bf16 || D != ATT_D || (long long)B * H > 0x7fffffffLL ||
        ((uintptr_t)qkv & 15) || ((uintptr_t)out & 15))
      return (int)cudaErrorInvalidValue;
    return dispatch_fwd_mma(qkv, bias, out, B, S, H, scale, st);
  }
  return is_bf16 ? launch_fwd<bf16>(qkv, bias, out, B, S, H, D, scale, st)
                 : launch_fwd<float>(qkv, bias, out, B, S, H, D, scale, st);
}

// mma: the tensor-core kernel (bf16, D = 64, qkv, dout and dqkv 16-byte
// aligned; the caller's route), else the CUDA-core kernel
extern "C" int jcf_packed_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                        void* dqkv, int B, int S, int H, int D, float scale,
                                        int is_bf16, int mma, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mma) {
    if (!shape_ok(B, S, H, D) || !is_bf16 || D != ATT_D || (long long)B * H > 0x7fffffffLL ||
        ((uintptr_t)qkv & 15) || ((uintptr_t)dout & 15) || ((uintptr_t)dqkv & 15))
      return (int)cudaErrorInvalidValue;
    return dispatch_bwd_mma(qkv, bias, dout, dqkv, B, S, H, scale, st);
  }
  return is_bf16 ? launch_bwd<bf16>(qkv, bias, dout, dqkv, B, S, H, D, scale, st)
                 : launch_bwd<float>(qkv, bias, dout, dqkv, B, S, H, D, scale, st);
}
