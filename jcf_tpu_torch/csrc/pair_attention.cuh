// Mask-free paired attention over one crop and one head pair, from shared
// memory: the row loop of _paired_attention_nomask, shared by K3's
// attention (block.cu), the fused layer kernels (fused_layer.cu) and the
// unquantized K6a attention (text_block.cu).
//
// For each query row i and head h of the pair (lo, hi), with T the
// element type of q, k, v and p (bf16, or f32):
//   s      = (q . k) [* scale]              (T inputs, f32 sums; no scale on
//                                            the folded tree, whose q carries
//                                            1/sqrt(d), else 1/sqrt(d) after
//                                            the sum, JAX's order)
//   m      = max(floor, max over both heads' keys of s), or the layer's
//            calibrated score_shift where the tree has one
//   p      = T(exp(s - m))
//   ctx_u  = sum_j p_j v_j,  l = sum_j p_j   (per head, f32)
//   out    = int8(round(ctx_u * (ctx_inv / max(l, 1e-30))))  (static int8 ctx)
//          = O(ctx_u * (1 / max(l, 1e-30)))   (O = f32 or bf16 context)
// The TPU takes one softmax shift per head PAIR, over both heads' scores
// and the zeroed pad keys' 0 (its paired MXU layout); the shift cancels
// in real arithmetic but moves the rounding of p, so the loop keeps
// exactly that shift: floor = 0 where the reference pads the keys (the
// int8 dense route, S not a multiple of 16; the float towers where S is
// not a multiple of 8), -inf where it does not (the int8 non-dense route
// at S a multiple of 16, the float towers at a multiple of 8). With a calibrated shift the TPU takes no max at
// all (_paired_attention_nomask, score_shift).
//
// One warp per query row (rows warp, warp + n_warps, ...), lanes over keys
// for the scores (K stored transposed so the lanes read consecutive
// addresses; KB blocks of 32 keys, S <= 32 * KB) and lanes over head dims
// for PV.
#pragma once

#include "common.cuh"

// the context's store: int8 with the static scale folded into the
// normalizer, or f32 / bf16 normalized by 1 / l
__device__ __forceinline__ void store_ctx(int8_t* o, float acc, float l, float cinv) {
  *o = round_clip_int8(__fmul_rn(acc, __fdiv_rn(cinv, fmaxf(l, 1e-30f))));
}
__device__ __forceinline__ void store_ctx(float* o, float acc, float l, float) {
  *o = __fmul_rn(acc, __fdiv_rn(1.0f, fmaxf(l, 1e-30f)));
}
__device__ __forceinline__ void store_ctx(bf16* o, float acc, float l, float) {
  *o = __float2bfloat16_rn(__fmul_rn(acc, __fdiv_rn(1.0f, fmaxf(l, 1e-30f))));
}

// q rows at q + i * q_stride (shared or device memory; with q_w non-null
// each warp first copies its row's 2D values to q_w + warp * 2D in shared
// memory), kt_s [2D, S] and v_s [S, 2D] in shared memory, p_s [n_warps,
// 2, S] f32 scratch; shift null for the pair max, else the layer's scalar
// shift; row i's 2D outputs go to out + i * out_stride (cinv read for the
// int8 context only). SCALED multiplies the sums by scale (the unfolded
// tree); it is a template parameter because nvcc keeps a __fmul_rn by a
// literal 1 (K3 at S = 82 +4.8%) and a run-time test of scale cost the
// f32 pair attention 18% (H100 80GB HBM3, 700 W; profile_attention.py,
// chip_smoke.py).
template <int KB, typename T, typename O, bool SCALED>
__device__ __forceinline__ void pair_attention_rows_t(const T* q, long long q_stride, T* q_w,
                                                      const T* kt_s, const T* v_s, float* p_s,
                                                      int S, int D, float scale,
                                                      const float* shift, float m_floor,
                                                      float cinv, O* out, long long out_stride,
                                                      int n_warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D2 = 2 * D;
  float* pw = p_s + warp * 2 * S;
  for (int i = warp; i < S; i += n_warps) {
    const T* qi = q + i * q_stride;
    if (q_w != nullptr) {
      T* qw = q_w + warp * D2;
      for (int d = lane; d < D2; d += 32) qw[d] = qi[d];
      __syncwarp();
      qi = qw;
    }
    float s[2][KB];  // [head][key block]: key j = lane + 32 * kb
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int j = lane + 32 * kb;
        float acc = -INFINITY;
        if (j < S) {
          acc = 0.0f;
          for (int d = 0; d < D; ++d)
            acc = fmaf(to_f(qi[h * D + d]), to_f(kt_s[(h * D + d) * S + j]), acc);
          if (SCALED) acc = __fmul_rn(acc, scale);
        }
        s[h][kb] = acc;
      }
    float m;
    if (shift != nullptr) {
      m = *shift;
    } else {
      // the reference's pair shift: max over both heads (and the pad keys' 0)
      m = -INFINITY;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) m = fmaxf(m, fmaxf(s[0][kb], s[1][kb]));
      m = fmaxf(warp_max(m), m_floor);
    }
    float l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.0f;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int j = lane + 32 * kb;
        if (j < S) {
          const float p = round_to<T>(expf(__fsub_rn(s[h][kb], m)));
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
      for (int j = 0; j < S; ++j) acc = fmaf(ph[j], to_f(v_s[j * D2 + d2]), acc);
      store_ctx(out + i * out_stride + d2, acc, l[h], cinv);
    }
    __syncwarp();
  }
}
