// The f32 attention of one head on the CUDA cores, register-tiled: K8 in
// f32 (blocked_attn.cu: jcf_tpu/ops/attention.py::_attn_kernel_blocked at
// precision HIGHEST, any additive [S, S] bias, S <= 768) and the masked
// attention on f32 qkv (text_block.cu: causal_attention_f32, the causal
// text tower's _paired_attention in f32, and head_attention_f32, the
// per-head route of an odd head count without a mask; S <= 128). Per
// (sequence, head), D = 64, f32 in and out, no TF32 (the port refuses it
// for f32 products):
//   s   = (q . k) * scale [+ bias]     (each score a sum over d in order,
//                                       one FMA a step, then __fmul_rn and
//                                       __fadd_rn; scale 1 where the caller
//                                       gives none: x 1 is exact)
//   the causal mask (keys j > i) or the bias' -inf, keys past S at -inf
//   m   = max_j s                      (the plain row max)
//   p   = exp(s - m) / l,  l = sum_j exp(s - m)   (f32; divided before PV)
//   out = sum_j p_j v_j                (f32 FMAs over the keys in order)
// q, k and v are read through element strides (Strides: crop, head, row;
// the head dim contiguous, every stride and pointer on 16 bytes), so K8
// takes head views of the packed [B, S, 3E] qkv and the masked attention
// its packed [n_seq * S, 3E] rows; the context is written through the
// output's strides in 16-byte stores.
//
// Bound on the H100: at ViT-B/16 (2048 crops x 12 heads x 197) the two
// products are 244 GFLOP of f32 FMAs over 1.2 GB of operands and context,
// 3.64 ms at 67 TFLOP/s against 0.37 ms of bytes: operations. At the text
// tower's 512 x 77 x 8 (causal) the bytes bound it (0.096 ms).
//
// Design. A unit is 8 query rows of one head, taken by one warp:
// - scores: lane l holds the unit's 8 rows x keys l + 32 t (t < nt, the
//   slot count of the unit's keys, dispatched at run time to a loop with
//   no guard, so that a step's loads are in flight together) and walks d in
//   float4 steps: each step reads the 8 q rows (the whole warp one
//   address, a broadcast) and nt k rows (32 distinct rows, the rows padded
//   to 68 floats so that a quarter warp's 8 rows fall in distinct 16-byte
//   bank groups) from shared memory for 32 nt FMAs. Keys are padded to the
//   32-key slot only; under the causal mask the slots past the unit's last
//   row are skipped, and the rest of the diagonal scores -inf;
// - softmax in registers: the row max and sum by shuffles over the 32
//   lanes (lane l's keys summed in t order, then the xor 1, 2, 4, 8, 16
//   butterfly), p = e / l by div_rcp (attn_mma.cuh: the IEEE quotient of
//   __fdiv_rn from one reciprocal a row, on this range);
// - PV: lane (rh, c) holds rows 4 rh .. 4 rh + 3 x columns 4 c .. 4 c + 3.
//   Each 32-key slot's p goes to the warp's [8][36] buffer in shared
//   memory; the warp walks those keys in order, 4 at a time: 4 float4
//   loads of p and 4 of v feed 64 FMAs. The context leaves in 16-byte
//   stores.
// Up to 256 keys (attn_f32_kernel) a block holds one (crop, head): its Q,
// K and V are staged once with 16-byte cp.async (Q and K first: each warp
// takes its first unit's scores while V lands) and its W warps take the
// units warp, warp + W, ...: W = 12 up to 96 keys (82,176 B at the text
// tower's 77, two blocks an SM), 8 up to 128 (two blocks), 16 past it
// (184,960 B at S = 197, one block an SM). On an H100 the kernel waits on
// latency more than on its FMAs: at 2048 x 12 x 197 each of these was
// faster than the one before it: a run-time guard around each slot's
// load and FMAs (the loads then wait one by one), the loop without it,
// 12 and then 16 warps in place of 8, 7 slots in place of 8 and the
// early scores. Past 256 keys (attn_f32_stream_kernel) a block holds 64
// query rows, one unit a warp, and streams K and V in 128-key groups
// through 94,208 B of shared memory, twice: pass one keeps each row's
// running max and sum (the sum rescaled by exp(m_old - m_new) as the max
// grows), pass two recomputes the same scores, divides by the final sum
// and accumulates PV.
#pragma once

#include "attn_mma.cuh"

namespace {

constexpr int AF_D = 64;        // head dim
constexpr int AF_WARPS = 8;     // warps of a streaming block
constexpr int AF_LD = 68;       // padded shared row of Q and K, floats
constexpr int AF_LDP = 36;      // padded row of a warp's p buffer, floats
constexpr int AF_ONE_PASS = 256;  // keys a block stages at once (T = 8)
constexpr int AF_GROUP = 128;   // keys a streamed group holds (T = 4)
constexpr int AF_QB = AF_WARPS * 8;  // query rows a streaming block holds

struct Strides {
  long long b, h, s;  // elements; the head dim is contiguous
};

// rows [0, rows) of a [*, 64] f32 operand (row stride rs elements) into
// shared rows of ld floats, 16-byte cp.async, rows >= n zero-filled
__device__ __forceinline__ void af_stage(float* dst, int ld, const float* src, long long rs,
                                         int rows, int n) {
  for (int c = threadIdx.x; c < rows * 16; c += blockDim.x) {
    const int r = c >> 4, col = (c & 15) * 4;
    const bool ok = r < n;
    cp_async16(dst + r * ld + col, ok ? src + r * rs + col : src, ok ? 16 : 0);
  }
}

// the unit's raw sums of the first NT slots, every one taken (no guard,
// so that a step's k loads are in flight together): acc[i][t] += q_{row i} .
// k_{key lane + 32 t} (q_s the unit's row 0, kl the lane's staged key 0,
// both AF_LD a row; each sum over d in order, one FMA a step)
template <int T, int NT>
__device__ __forceinline__ void af_scores_n(float (&acc)[8][T], const float* q_s,
                                            const float* kl) {
#pragma unroll 2
  for (int d = 0; d < AF_D; d += 4) {
    float4 qv[8], kv[NT];
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = *reinterpret_cast<const float4*>(q_s + i * AF_LD + d);
#pragma unroll
    for (int t = 0; t < NT; ++t) kv[t] = *reinterpret_cast<const float4*>(kl + 32 * t * AF_LD + d);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = acc[i][t];
        a = fmaf(qv[i].x, kv[t].x, a);
        a = fmaf(qv[i].y, kv[t].y, a);
        a = fmaf(qv[i].z, kv[t].z, a);
        a = fmaf(qv[i].w, kv[t].w, a);
        acc[i][t] = a;
      }
  }
}

// af_scores_n for the slot count nt <= NT, chosen at run time (warp-uniform)
template <int T, int NT>
__device__ __forceinline__ void af_scores_upto(float (&acc)[8][T], const float* q_s,
                                               const float* kl, int nt) {
  if constexpr (NT > 1) {
    if (nt < NT) {
      af_scores_upto<T, NT - 1>(acc, q_s, kl, nt);
      return;
    }
  }
  af_scores_n<T, NT>(acc, q_s, kl);
}

// the unit's raw sums: acc[i][t] = q_{row i} . k_{key lane + 32 t} for the
// slots t < nt, 0 past them (k_s the staged key 0)
template <int T>
__device__ __forceinline__ void af_scores(float (&acc)[8][T], const float* q_s, const float* k_s,
                                          int nt) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < T; ++t) acc[i][t] = 0.0f;
  af_scores_upto<T, T>(acc, q_s, k_s + (threadIdx.x & 31) * AF_LD, nt);
}

// scores in place of the sums: x scale, + bias, and -inf for the slots
// past nt, keys >= S and (CAUSAL) keys past the row; row0 the unit's
// first row, key0 the slot 0 key of lane 0
template <int T, bool CAUSAL>
__device__ __forceinline__ void af_mask(float (&acc)[8][T], int row0, int key0, int nt, int S,
                                        const float* bias, float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int row = row0 + i, j = key0 + lane + 32 * t;
      float s = -INFINITY;
      if (t < nt && j < S && (!CAUSAL || j <= row)) {
        s = __fmul_rn(acc[i][t], scale);
        if (bias != nullptr && row < S) s = __fadd_rn(s, __ldg(bias + (long long)row * S + j));
      }
      acc[i][t] = s;
    }
}

// a row's sum over the warp, the same bits in every lane: xor 1, 2, 4, 8, 16
__device__ __forceinline__ float af_lane_sum(float v) {
#pragma unroll
  for (int o = 1; o <= 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// PV over the unit's keys [key0, key0 + 32 nt) clipped to n_keys (a
// multiple of 4): p (the slots of acc) through the warp's buffer pw [8]
// [AF_LDP], v_s the staged value key0 (64 floats a row). Lane (rh, c)
// holds o[i] = columns 4 c .. 4 c + 3 of row 4 rh + i, accumulated over
// the keys in order: 4 keys take 4 float4 loads of v and 4 of p for 64
// FMAs
template <int T>
__device__ __forceinline__ void af_pv(float (&o)[4][4], const float (&p)[8][T], float* pw,
                                      const float* v_s, int nt, int n_keys) {
  const int lane = threadIdx.x & 31;
  const float* pr = pw + (lane >> 4) * 4 * AF_LDP;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (t < nt) {
      __syncwarp();  // the last slot's p is read
#pragma unroll
      for (int i = 0; i < 8; ++i) pw[i * AF_LDP + lane] = p[i][t];
      __syncwarp();
      const int jn = min(32, n_keys - 32 * t);
      const float* vt = v_s + 32 * t * AF_D + (lane & 15) * 4;
#pragma unroll 2
      for (int jj = 0; jj < jn; jj += 4) {
        float4 vv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) vv[x] = *reinterpret_cast<const float4*>(vt + (jj + x) * AF_D);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + i * AF_LDP + jj);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            o[i][0] = fmaf(pj[x], vv[x].x, o[i][0]);
            o[i][1] = fmaf(pj[x], vv[x].y, o[i][1]);
            o[i][2] = fmaf(pj[x], vv[x].z, o[i][2]);
            o[i][3] = fmaf(pj[x], vv[x].w, o[i][3]);
          }
        }
      }
    }
  }
}

// rows row0 .. row0 + 7 (< S) of the context at dst (row stride ld), in
// 16-byte stores: lane (rh, c) its 4 columns of 4 rows
__device__ __forceinline__ void af_store(const float (&o)[4][4], float* dst, long long ld,
                                         int row0, int S) {
  const int lane = threadIdx.x & 31, col = (lane & 15) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + (lane >> 4) * 4 + i;
    if (row < S)
      *reinterpret_cast<float4*>(dst + row * ld + col) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
  }
}

// floats of the one-pass block's shared memory: Q [S8][AF_LD], K [32 nt]
// [AF_LD], V [S4][64], the W warps' p buffers
__host__ __device__ __forceinline__ int af_smem_floats(int S, int W) {
  const int S8 = (S + 7) & ~7, SK = (S + 31) & ~31, S4 = (S + 3) & ~3;
  return (S8 + SK) * AF_LD + S4 * AF_D + W * 8 * AF_LDP;
}

// p = exp(s - m) / l in place of the unit's scores, the row max m and the
// sum l over the warp, for the slots t < nt (0 past them)
template <int T>
__device__ __forceinline__ void af_softmax(float (&acc)[8][T], int nt) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < T; ++t) mx = fmaxf(mx, acc[i][t]);
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float e = t < nt ? expf(__fsub_rn(acc[i][t], mx)) : 0.0f;
      acc[i][t] = e;
      sum += e;
    }
    sum = af_lane_sum(sum);
    const float y = __frcp_rn(sum);
#pragma unroll
    for (int t = 0; t < T; ++t) acc[i][t] = div_rcp(acc[i][t], sum, y);
  }
}

// one block of W warps a (crop, head), S <= 32 T, MB blocks an SM. Q and K
// land first: each warp takes its first unit's scores while V lands
template <int T, int W, int MB, bool CAUSAL>
__global__ void __launch_bounds__(W * 32, MB) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias,  // [S, S] or null
    float* __restrict__ out, int S, int H, Strides in, Strides os, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int S8 = (S + 7) & ~7, SK = (S + 31) & ~31, S4 = (S + 3) & ~3;
  float* q_s = smem_f;
  float* k_s = q_s + S8 * AF_LD;
  float* v_s = k_s + SK * AF_LD;
  float* p_s = v_s + S4 * AF_D;
  const int head = (int)(blockIdx.x % H);
  const long long b = blockIdx.x / H;
  const long long ib = b * in.b + head * in.h;
  af_stage(q_s, AF_LD, q + ib, in.s, S8, S);
  af_stage(k_s, AF_LD, k + ib, in.s, SK, S);
  cp_async_commit();
  af_stage(v_s, AF_D, v + ib, in.s, S4, S);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int units = (S + 7) >> 3, n_slots = (S + 31) >> 5;
  float* pw = p_s + warp * 8 * AF_LDP;
  float* dst = out + b * os.b + head * os.h;
  for (int u = warp;; u += W) {
    const bool live = u < units;
    const int r0 = u * 8;
    // CAUSAL: no key past the unit's last row
    const int nt = CAUSAL ? min(n_slots, ((r0 + 7) >> 5) + 1) : n_slots;
    float acc[8][T];
    if (live) {
      af_scores<T>(acc, q_s + r0 * AF_LD, k_s, nt);
      af_mask<T, CAUSAL>(acc, r0, 0, nt, S, bias, scale);
      af_softmax<T>(acc, nt);
    }
    if (u == warp) {  // every thread once: V has landed
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!live) break;
    float o[4][4] = {};
    af_pv<T>(o, acc, pw, v_s, nt, CAUSAL ? min(S4, r0 + 8) : S4);
    af_store(o, dst, os.s, r0, S);
  }
}

// floats of the streaming block's shared memory: Q [64][AF_LD], K [128]
// [AF_LD], V [128][64], the warps' p buffers
constexpr int AF_STREAM_FLOATS =
    (AF_QB + AF_GROUP) * AF_LD + AF_GROUP * AF_D + AF_WARPS * 8 * AF_LDP;

// one block a (crop, head, 64 query rows), any S: K and V in groups of
// 32 T keys (T = AF_GROUP / 32), the scores taken twice (the same bits
// each time)
template <int T>
__global__ void __launch_bounds__(AF_WARPS * 32, 2) attn_f32_stream_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ out, int S, int H, int n_qb,
    Strides in, Strides os, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;
  float* k_s = q_s + AF_QB * AF_LD;
  float* v_s = k_s + AF_GROUP * AF_LD;
  float* p_s = v_s + AF_GROUP * AF_D;
  const int qb = (int)(blockIdx.x % n_qb);
  const long long bh = blockIdx.x / n_qb;
  const int head = (int)(bh % H);
  const long long b = bh / H;
  const long long ib = b * in.b + head * in.h;
  const int warp = threadIdx.x >> 5;
  const int q0 = qb * AF_QB, r0 = q0 + warp * 8;
  const bool live = r0 < S;  // the warp's unit holds a real row
  af_stage(q_s, AF_LD, q + ib + q0 * in.s, in.s, AF_QB, S - q0);
  float* pw = p_s + warp * 8 * AF_LDP;

  // pass one: each row's max and its lanes' sums of exp(s - max), rescaled
  // as the max grows
  float m[8], lp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = -INFINITY, lp[i] = 0.0f;
  float acc[8][T];
  for (int g0 = 0; g0 < S; g0 += AF_GROUP) {
    __syncthreads();  // the last group's K is read
    af_stage(k_s, AF_LD, k + ib + g0 * in.s, in.s, AF_GROUP, S - g0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!live) continue;
    const int nt = min(T, (S - g0 + 31) >> 5);
    af_scores<T>(acc, q_s + warp * 8 * AF_LD, k_s, nt);
    af_mask<T, false>(acc, r0, g0, nt, S, bias, scale);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mg = -INFINITY;
#pragma unroll
      for (int t = 0; t < T; ++t) mg = fmaxf(mg, acc[i][t]);
      const float mn = fmaxf(m[i], warp_max(mg));
      float sg = 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (t < nt) sg += expf(__fsub_rn(acc[i][t], mn));
      // a row with no finite score yet keeps 0
      lp[i] = mn == -INFINITY ? 0.0f : __fmaf_rn(lp[i], expf(__fsub_rn(m[i], mn)), sg);
      m[i] = mn;
    }
  }
  float l[8], y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] = af_lane_sum(lp[i]);
    y[i] = __frcp_rn(l[i]);
  }

  // pass two: the same scores, p = exp(s - m) / l, PV
  float o[4][4] = {};
  for (int g0 = 0; g0 < S; g0 += AF_GROUP) {
    __syncthreads();  // the last group's K and V are read
    af_stage(k_s, AF_LD, k + ib + g0 * in.s, in.s, AF_GROUP, S - g0);
    af_stage(v_s, AF_D, v + ib + g0 * in.s, in.s, AF_GROUP, S - g0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!live) continue;
    const int nt = min(T, (S - g0 + 31) >> 5);
    af_scores<T>(acc, q_s + warp * 8 * AF_LD, k_s, nt);
    af_mask<T, false>(acc, r0, g0, nt, S, bias, scale);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < T; ++t)
        acc[i][t] = t < nt ? div_rcp(expf(__fsub_rn(acc[i][t], m[i])), l[i], y[i]) : 0.0f;
    af_pv<T>(o, acc, pw, v_s, nt, min(AF_GROUP, ((S + 3) & ~3) - g0));
  }
  if (live) af_store(o, out + b * os.b + head * os.h, os.s, r0, S);
}

template <int T, int W, int MB, bool CAUSAL>
int launch_attn_f32_one(const float* q, const float* k, const float* v, const float* bias,
                        float* out, long long B, int S, int H, Strides in, Strides os,
                        float scale, cudaStream_t stream) {
  const size_t smem = (size_t)af_smem_floats(S, W) * sizeof(float);
  const int err = set_smem(attn_f32_kernel<T, W, MB, CAUSAL>, smem);
  if (err) return err;
  attn_f32_kernel<T, W, MB, CAUSAL><<<(unsigned)(B * H), W * 32, smem, stream>>>(
      q, k, v, bias, out, S, H, in, os, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the attention of B x H heads of S <= MAX_S keys (K8: 768, the masked
// attention: 128); cudaErrorInvalidValue, and nothing launched, for an
// empty shape, S over MAX_S, more blocks than the grid holds, or a pointer
// or stride off 16 bytes
template <bool CAUSAL, int MAX_S>
int launch_attn_f32(const float* q, const float* k, const float* v, const float* bias, float* out,
                    long long B, int S, int H, Strides in, Strides os, float scale,
                    cudaStream_t stream) {
  const bool strides16 = in.b % 4 == 0 && in.h % 4 == 0 && in.s % 4 == 0 && os.b % 4 == 0 &&
                         os.h % 4 == 0 && os.s % 4 == 0;
  const long long n_qb = S <= AF_ONE_PASS ? 1 : (S + AF_QB - 1) / AF_QB;
  if (B <= 0 || S <= 0 || H <= 0 || S > MAX_S || B * H * n_qb > 0x7fffffffLL || !strides16 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  // up to 128 keys (the text tower, the small towers) two blocks an SM;
  // past it one, 16 warps wide
  if (S <= 96)
    return launch_attn_f32_one<3, 12, 2, CAUSAL>(q, k, v, bias, out, B, S, H, in, os, scale,
                                                 stream);
  if (S <= 128)
    return launch_attn_f32_one<4, 8, 2, CAUSAL>(q, k, v, bias, out, B, S, H, in, os, scale,
                                                stream);
  if constexpr (MAX_S > 128) {
    if (S <= 224)
      return launch_attn_f32_one<7, 16, 1, CAUSAL>(q, k, v, bias, out, B, S, H, in, os, scale,
                                                   stream);
    if (S <= AF_ONE_PASS)
      return launch_attn_f32_one<8, 16, 1, CAUSAL>(q, k, v, bias, out, B, S, H, in, os, scale,
                                                   stream);
    if constexpr (!CAUSAL) {
      const size_t smem = (size_t)AF_STREAM_FLOATS * sizeof(float);
      constexpr int T = AF_GROUP / 32;
      const int err = set_smem(attn_f32_stream_kernel<T>, smem);
      if (err) return err;
      attn_f32_stream_kernel<T><<<(unsigned)(B * H * n_qb), AF_WARPS * 32, smem, stream>>>(
          q, k, v, bias, out, S, H, (int)n_qb, in, os, scale);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
