// K3's attention over one crop and one head pair, from shared memory: the
// row loop of block.cu's attention kernel, shared with the fused layer
// kernels of fused_layer.cu.
//
// Folded tree (1/sqrt(d) already in q). For each query row i and head h
// of the pair (lo, hi):
//   s      = q . k                          (bf16 inputs, f32 sums)
//   m      = max(0, max over both heads' keys of s), or the layer's
//            calibrated score_shift where the tree has one
//   p      = bf16(exp(s - m))
//   ctx_u  = sum_j p_j v_j,  l = sum_j p_j   (per head, f32)
//   out    = int8(round(ctx_u * (ctx_inv / max(l, 1e-30))))  (static ctx)
//          = ctx_u * (1 / max(l, 1e-30)), f32                 (dynamic ctx,
//            quantized per row afterwards over all heads)
// The TPU takes one softmax shift per head PAIR, over both heads' scores
// and the zeroed pad keys' 0 (its paired MXU layout); the shift cancels
// in real arithmetic but moves the bf16 rounding of p, so the loop keeps
// exactly that shift, max(0, pair max). With a calibrated shift the TPU
// takes no max at all (_paired_attention_nomask, score_shift).
//
// One warp per query row (rows warp, warp + n_warps, ...), lanes over keys
// for the scores (K stored transposed so the lanes read consecutive
// addresses; KB blocks of 32 keys, S <= 32 * KB) and lanes over head dims
// for PV.
#pragma once

#include "common.cuh"

// q_s [S, 2D], kt_s [2D, S] and v_s [S, 2D] bf16; p_s [n_warps, 2, S] f32
// scratch; shift null for the pair max, else the layer's scalar shift;
// row i's 2D outputs go to out + i * out_stride (int8, or f32 with
// F32_OUT, where cinv is not read).
template <int KB, bool F32_OUT>
__device__ __forceinline__ void pair_attention_rows_t(const bf16* q_s, const bf16* kt_s,
                                                      const bf16* v_s, float* p_s, int S, int D,
                                                      const float* shift, float cinv, void* out,
                                                      long long out_stride, int n_warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D2 = 2 * D;
  float* pw = p_s + warp * 2 * S;
  for (int i = warp; i < S; i += n_warps) {
    const bf16* qi = q_s + i * D2;
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
            acc = fmaf(bf2f(qi[h * D + d]), bf2f(kt_s[(h * D + d) * S + j]), acc);
        }
        s[h][kb] = acc;
      }
    float m;
    if (shift != nullptr) {
      m = *shift;
    } else {
      // the reference's pair shift: max over both heads and the pad keys' 0
      m = -INFINITY;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) m = fmaxf(m, fmaxf(s[0][kb], s[1][kb]));
      m = fmaxf(warp_max(m), 0.0f);
    }
    float l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.0f;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
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
      const float r = __fdiv_rn(F32_OUT ? 1.0f : cinv, fmaxf(l[h], 1e-30f));
      if (F32_OUT)
        static_cast<float*>(out)[i * out_stride + d2] = __fmul_rn(acc, r);
      else
        static_cast<int8_t*>(out)[i * out_stride + d2] = round_clip_int8(__fmul_rn(acc, r));
    }
    __syncwarp();
  }
}

// the serving flags' loop (S <= 64, pair max, static ctx): fused_layer.cu
__device__ __forceinline__ void pair_attention_rows(const bf16* q_s, const bf16* kt_s,
                                                    const bf16* v_s, float* p_s, int S, int D,
                                                    float cinv, int8_t* out, long long out_stride,
                                                    int n_warps) {
  pair_attention_rows_t<2, false>(q_s, kt_s, v_s, p_s, S, D, nullptr, cinv, out, out_stride,
                                  n_warps);
}
