// Warp-level pieces of the tensor-core attention kernels: K8 in bf16
// (blocked_attn.cu) and the mask-free pair attention in bf16
// (text_block.cu). One warp holds one 16-row query tile of one head of
// 64 dims; the head's keys and values are rows of LD bf16 in shared
// memory. Products are mma.sync m16n8k16 bf16 with f32 sums.
//
// A score array sc[2 NC][4] holds NC k16 chunks of keys as 2 NC n8 tiles
// (NC is a template parameter and every loop over it is unrolled without
// a guard, so that a warp's chunks are one block of independent work; the
// callers stage 16 NC key rows, zero-filled past S, and mask those keys):
// thread (g = lane / 4, tig = lane % 4) holds, of tile t, rows g (e = 0,
// 1) and g + 8 (e = 2, 3), keys 8 t + 2 tig + (e & 1). That accumulator
// layout is the A layout of PV's k16 step over the same keys, so p goes
// from the scores to PV in registers; a row's four holders are one quad.
#pragma once

#include "common.cuh"

constexpr int ATT_D = 64;  // head dim

// the A fragments of a 16 x 64 query tile from device memory: q is the
// tile's row 0, ld its row stride in elements (even), rows >= n_rows read
// as 0; a[kk] is the k16 step over dims 16 kk ..
__device__ __forceinline__ void load_q_tile(unsigned (&a)[4][4], const bf16* q, long long ld,
                                            int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const bool ok0 = g < n_rows, ok1 = g + 8 < n_rows;
  const unsigned* r0 = reinterpret_cast<const unsigned*>(q + g * ld + tig * 2);
  const unsigned* r1 = reinterpret_cast<const unsigned*>(q + (g + 8) * ld + tig * 2);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = ok0 ? __ldg(r0 + kk * 8) : 0u;
    a[kk][1] = ok1 ? __ldg(r1 + kk * 8) : 0u;
    a[kk][2] = ok0 ? __ldg(r0 + kk * 8 + 4) : 0u;
    a[kk][3] = ok1 ? __ldg(r1 + kk * 8 + 4) : 0u;
  }
}

// the tile's raw scores (f32 sums of exact bf16 products) against the 16
// keys whose row 0 is ks: s0 keys 0-7, s1 keys 8-15
template <int LD>
__device__ __forceinline__ void qk_chunk(float (&s0)[4], float (&s1)[4], const unsigned (&a)[4][4],
                                         const bf16* ks) {
  const int lane = threadIdx.x & 31;
  // matrices: keys 0-7 of dims +0-7 and +8-15, then keys 8-15
  const bf16* row = ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int e = 0; e < 4; ++e) s0[e] = s1[e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned b[4];
    ldsm_x4(b, row + kk * 16);
    const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma_bf16(s0, a[kk], b0);
    mma_bf16(s1, a[kk], b1);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// this thread's part of the row max (no quad reduction)
template <int NC>
__device__ __forceinline__ void tile_max(const float (&sc)[2 * NC][4], float (&mx)[2]) {
#pragma unroll
  for (int t = 0; t < 2 * NC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
}

// sc = exp(sc - m) in place (ROUND: rounded to bf16, kept in f32), added
// to this thread's part of the row sums; -inf scores (keys past S) give 0
template <int NC, bool ROUND>
__device__ __forceinline__ void exp_tile(float (&sc)[2 * NC][4], const float (&m)[2],
                                         float (&sum)[2]) {
#pragma unroll
  for (int t = 0; t < 2 * NC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = expf(__fsub_rn(sc[t][e], m[e >> 1]));
      if (ROUND) p = round_bf16(p);
      sc[t][e] = p;
      sum[e >> 1] += p;
    }
}

// a / b rounded to nearest as __fdiv_rn gives it, from y = __frcp_rn(b),
// with no branch: q = RN(a y) is within an ulp of a / b, r = a - b q is
// exact, and RN(q + r y) = RN(a / b) (Markstein's theorem; it holds for
// quotients in the normal range, so below 2^-126 the two may differ by a
// subnormal ulp)
__device__ __forceinline__ float div_rcp(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// acc (dims 8 nt .. 8 nt + 7 in acc[nt]) += bf16(sc) . V, V's row 0 at vs,
// its fragments through ldmatrix.trans
template <int NC, int LD>
__device__ __forceinline__ void pv_tile(float (&acc)[8][4], const float (&sc)[2 * NC][4],
                                        const bf16* vs) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  // matrices: keys 0-7 and 8-15 of dims +0-7, then of dims +8-15
  const bf16* row = vs + ((mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float(&p0)[4] = sc[2 * c];
    const float(&p1)[4] = sc[2 * c + 1];
    const unsigned a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                           pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm_x4_trans(b, row + c * 16 * LD + np * 16);
      const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[2 * np], a, b0);
      mma_bf16(acc[2 * np + 1], a, b1);
    }
  }
}

__device__ __forceinline__ unsigned pick4(const unsigned (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// stores a 16 x 64 f32 tile as bf16 with one 16-byte store a thread per
// pair of n8 tiles: the quad trades fragments so that each thread holds 8
// adjacent values of one row. dst is row 0 (16-byte aligned), ld the row
// stride in elements (a multiple of 8); rows >= n_rows are not stored
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[8][4], bf16* dst, long long ld,
                                                int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int row = g + (tig & 1) * 8;
#pragma unroll
  for (int pr = 0; pr < 4; ++pr) {
    // chunk c (of 8 values): tile 2 pr + (c >> 1), row g + 8 (c & 1); u[c]
    // holds this thread's two values of it, which are word tig of its 4
    const unsigned u[4] = {pack_bf16(acc[2 * pr][0], acc[2 * pr][1]),
                           pack_bf16(acc[2 * pr][2], acc[2 * pr][3]),
                           pack_bf16(acc[2 * pr + 1][0], acc[2 * pr + 1][1]),
                           pack_bf16(acc[2 * pr + 1][2], acc[2 * pr + 1][3])};
    // round s: word (tig + s) & 3 of chunk tig, from quad thread (tig + s) & 3
    unsigned w[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      w[s] = __shfl_sync(0xffffffffu, pick4(u, (tig - s) & 3), (lane & ~3) | ((tig + s) & 3));
    const uint4 v = make_uint4(pick4(w, (0 - tig) & 3), pick4(w, (1 - tig) & 3),
                               pick4(w, (2 - tig) & 3), pick4(w, (3 - tig) & 3));
    if (row < n_rows)
      *reinterpret_cast<uint4*>(dst + row * ld + (2 * pr + (tig >> 1)) * 8) = v;
  }
}
