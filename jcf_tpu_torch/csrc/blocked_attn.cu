// K8: scaled dot-product attention over [B, H, S, D] heads of any length
// up to 768 (f32 or bf16 in and out, D = 64).
//
// Replaces jcf_tpu/ops/attention.py::_attn_kernel_blocked (_attention_pallas,
// which fused_attention picks on a TPU for every tower of 128 tokens or
// more: ViT-B/16's 197, ViT-L/14's 257, ViT-L/14@336px's 577). The TPU
// kernel pads S to a multiple of 128 and D to 128 and loops over a group of
// heads; that is its layout, not its function, and is not copied. Per
// (crop, head), with scale = 1/sqrt(D) and an optional additive f32 [S, S]
// bias:
//   s   = (q . k) * scale + bias     (f32 sums of exact products: no TF32)
//   p   = exp(s - max_j s) / sum_j   (f32, the plain row max; p is divided
//                                     by its f32 sum BEFORE the cast)
//   out = T(sum_j T(p) v_j)          (T() is a no-op in f32, a bf16
//                                     rounding in bf16)
// q, k and v are read through element strides, so the callers pass views
// of the packed [B, S, 3E] qkv projection and get the context back in the
// packed [B, S, E] layout: no head-split transposes.
//
// Bound on the H100: at ViT-B/16 serving (2048 crops x 12 heads x 197 x 64)
// the two products are 244 GFLOP over 2.5 GB of bf16 operands, about 100
// operations per byte, so on the tensor cores the bytes bound it (0.74 ms).
//
// bf16: blocked_attn_mma_kernel, on the tensor cores (attn_mma.cuh). One
// block per (crop, head) stages the head's K and V once in shared memory
// (16-byte cp.async, the keys past S zero-filled up to the kernel's chunks)
// and its four warps walk the 16-row query tiles. A warp loads its tile's
// q fragments from device memory, keeps the tile's scores against up to
// 208 keys in registers (13 16-key chunks, 104 f32 a thread), takes the row
// max and sum by quad shuffles, divides in f32 (one reciprocal a row,
// then a branch-free correctly rounded quotient an element) and packs
// bf16 p straight into PV's A fragments; V comes through ldmatrix.trans
// and the context leaves in 16-byte stores. Longer rows (S > 208) stream
// the keys in groups of 128 twice: pass one keeps the online row max and
// sum, pass two recomputes the same scores (the same bits), forms p and
// accumulates PV. Every loop over a warp's chunks is unrolled without a
// guard (the chunk count is a template parameter, the staged keys padded
// to it), so a warp runs its chunks as one block of independent work.
// Three blocks an SM (168 registers a thread; at 13 chunks 32 bytes
// spill, where 255 registers and two blocks took 2.35 ms against 2.01 ms
// at 2048 x 12 x 197 on an H100 80GB HBM3 at 700 W, ab_attention.py).
// Pad keys score -inf before the max. Flash attention's deferred
// normalization would round p elsewhere and is not used. The q, k, v rows
// and the output must be 16-byte aligned (the C entry refuses others).
//
// f32: attn_f32.cuh's register-tiled kernels on the CUDA cores (the port
// refuses TF32 for f32 products), q, k, v and the output on 16 bytes as in
// bf16: one block a (crop, head) up to 256 keys, Q, K and V staged once,
// each warp's 8 query rows x 32-key slots in registers walking d in
// float4 steps, the softmax by shuffles, PV from a warp's p buffer; past
// 256 keys 64 query rows a block with K and V streamed in 128-key groups,
// the scores taken twice.
#include "attn_f32.cuh"
#include "attn_mma.cuh"

namespace {

constexpr int K8_WARPS = 4;
constexpr int K8_LD = ATT_D + 8;  // padded shared row of K and V (bf16): conflict-free ldmatrix
constexpr int K8_MAX_SEQ = 768;   // K and V of the head: 221,184 B of shared memory
constexpr int K8_GROUP = 8;       // 16-key chunks a pass holds on the streamed branch

// the tile's (rows m0 .. m0 + 15) scores against keys [key0, key0 + 16 KC):
// x scale, + bias, keys >= S at -inf
template <int KC>
__device__ __forceinline__ void k8_scores(float (&sc)[2 * KC][4], const unsigned (&a)[4][4],
                                          const bf16* ks, int key0, int m0, int S,
                                          const float* bias, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int c = 0; c < KC; ++c)
    qk_chunk<K8_LD>(sc[2 * c], sc[2 * c + 1], a, ks + (key0 + 16 * c) * K8_LD);
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = __fmul_rn(sc[t][e], scale);
  if (bias != nullptr) {
#pragma unroll
    for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + (e >> 1) * 8, j = key0 + 8 * t + tig * 2 + (e & 1);
        if (i < S && j < S) sc[t][e] = __fadd_rn(sc[t][e], __ldg(bias + (long long)i * S + j));
      }
  }
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * t + tig * 2 + (e & 1) >= S) sc[t][e] = -INFINITY;
}

// p = sc / l in place, each an IEEE division (div_rcp); y = 1 / l
template <int KC>
__device__ __forceinline__ void k8_normalize(float (&sc)[2 * KC][4], const float (&l)[2],
                                             const float (&y)[2]) {
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = div_rcp(sc[t][e], l[e >> 1], y[e >> 1]);
}

// KC: 16-key chunks in registers. One pass (STREAM false) holds all keys,
// S <= 16 KC; STREAM takes them in groups of 16 KC, twice. kp: the staged
// keys, a multiple of 16 KC (rows >= S zero-filled)
template <int KC, bool STREAM>
__global__ void __launch_bounds__(K8_WARPS * 32, 3) blocked_attn_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias,  // [S, S] or null
    bf16* __restrict__ out, int S, int kp, int H, Strides in, Strides os, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kp][K8_LD] K, then [kp][K8_LD] V
  const bf16* vs = ks + kp * K8_LD;
  const int head = (int)(blockIdx.x % H);
  const long long b = blockIdx.x / H;
  const long long ib = b * in.b + head * in.h;
  for (int c = threadIdx.x; c < 2 * kp * 8; c += blockDim.x) {
    const int r = c >> 3, t = r >= kp, row = r - t * kp, col = (c & 7) * 8;
    const bf16* src = t ? v : k;
    const bool ok = row < S;
    cp_async16(ks + r * K8_LD + col, ok ? src + ib + row * in.s + col : src, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const long long ob = b * os.b + head * os.h;
  for (int m0 = (threadIdx.x >> 5) * 16; m0 < S; m0 += K8_WARPS * 16) {
    unsigned a[4][4];
    load_q_tile(a, q + ib + m0 * in.s, in.s, S - m0);
    float sc[2 * KC][4], acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, y[2];
    if (!STREAM) {
      k8_scores<KC>(sc, a, ks, 0, m0, S, bias, scale);
      tile_max<KC>(sc, m);
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
      exp_tile<KC, false>(sc, m, l);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        y[r] = __frcp_rn(l[r]);
      }
      k8_normalize<KC>(sc, l, y);
      pv_tile<KC, K8_LD>(acc, sc, vs);
    } else {
      // pass one: the online row max and sum, group by group
      for (int key0 = 0; key0 < kp; key0 += 16 * KC) {
        k8_scores<KC>(sc, a, ks, key0, m0, S, bias, scale);
        float mg[2] = {-INFINITY, -INFINITY}, sg[2] = {0.0f, 0.0f}, mn[2];
        tile_max<KC>(sc, mg);
#pragma unroll
        for (int r = 0; r < 2; ++r) mn[r] = fmaxf(m[r], quad_max(mg[r]));
        exp_tile<KC, false>(sc, mn, sg);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sg[r] = quad_sum(sg[r]);
          // a row with no finite score yet keeps l = 0
          l[r] = mn[r] == -INFINITY ? 0.0f : l[r] * expf(__fsub_rn(m[r], mn[r])) + sg[r];
          m[r] = mn[r];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) y[r] = __frcp_rn(l[r]);
      // pass two: the same scores, p = exp(s - m) / l, PV
      for (int key0 = 0; key0 < kp; key0 += 16 * KC) {
        k8_scores<KC>(sc, a, ks, key0, m0, S, bias, scale);
        float unused[2] = {0.0f, 0.0f};
        exp_tile<KC, false>(sc, m, unused);
        k8_normalize<KC>(sc, l, y);
        pv_tile<KC, K8_LD>(acc, sc, vs + key0 * K8_LD);
      }
    }
    store_tile_bf16(acc, out + ob + m0 * os.s, os.s, S - m0);
  }
}

template <int KC, bool STREAM>
int launch_mma(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
               int S, int H, Strides in, Strides os, float scale, cudaStream_t stream) {
  const int kp = STREAM ? (S + 16 * KC - 1) / (16 * KC) * (16 * KC) : 16 * KC;
  const size_t smem = (size_t)2 * kp * K8_LD * sizeof(bf16);
  const int err = set_smem(blocked_attn_mma_kernel<KC, STREAM>, smem);
  if (err) return err;
  blocked_attn_mma_kernel<KC, STREAM><<<(unsigned)((long long)B * H), K8_WARPS * 32, smem,
                                        stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), S, kp, H, in, os, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
                int S, int H, Strides in, Strides os, float scale, cudaStream_t stream) {
  // 16-byte rows: cp.async of K and V, the context's stores
  const bool strides16 = in.b % 8 == 0 && in.h % 8 == 0 && in.s % 8 == 0 && os.b % 8 == 0 &&
                         os.h % 8 == 0 && os.s % 8 == 0;
  if (S > K8_MAX_SEQ || (long long)B * H > 0x7fffffffLL || !strides16 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  // the keys in registers at once up to 208 (ViT-B/16's 197: 13 chunks)
  if (S <= 64) return launch_mma<4, false>(q, k, v, bias, out, B, S, H, in, os, scale, stream);
  if (S <= 128) return launch_mma<8, false>(q, k, v, bias, out, B, S, H, in, os, scale, stream);
  if (S <= 208) return launch_mma<13, false>(q, k, v, bias, out, B, S, H, in, os, scale, stream);
  return launch_mma<K8_GROUP, true>(q, k, v, bias, out, B, S, H, in, os, scale, stream);
}

}  // namespace

// returns cudaErrorInvalidValue, and launches nothing, for D != 64, an
// empty shape, more blocks than the grid holds, S > 768, or a pointer or
// stride that is not 16-byte aligned; bias may be null
extern "C" int jcf_blocked_attention(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, int B, int S, int H, int D,
                                     long long sb, long long sh, long long ss, long long ob,
                                     long long oh, long long os, float scale, int is_bf16,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D != ATT_D) return (int)cudaErrorInvalidValue;
  const Strides in{sb, sh, ss}, o{ob, oh, os};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) return launch_bf16(q, k, v, bias, out, B, S, H, in, o, scale, st);
  return launch_attn_f32<false, K8_MAX_SEQ>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), B, S, H, in, o, scale, st);
}
