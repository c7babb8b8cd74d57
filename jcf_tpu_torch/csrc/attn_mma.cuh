// Warp-level pieces of the tensor-core attention kernels: K8 in bf16
// (blocked_attn.cu), the mask-free pair attention of K3 and K6a
// (pair_mma.cuh), the masked attention in bf16 (text_block.cu), and K7's
// forward and backward in bf16 (packed_attn.cu), and the CUDA-core scores
// in the reference's order that the last two take. One warp holds one
// 16-row query tile of one head of 64 dims; the head's keys and values
// are rows of LD bf16 in shared memory. Products are mma.sync m16n8k16
// bf16 with f32 sums.
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
template <bool CG = false>
__device__ __forceinline__ void load_q_tile(unsigned (&a)[4][4], const bf16* q, long long ld,
                                            int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const bool ok0 = g < n_rows, ok1 = g + 8 < n_rows;
  const unsigned* r0 = reinterpret_cast<const unsigned*>(q + g * ld + tig * 2);
  const unsigned* r1 = reinterpret_cast<const unsigned*>(q + (g + 8) * ld + tig * 2);
  // CG: q written earlier in the same launch, read through L2 (the
  // non-coherent path of __ldg may hold stale lines)
  auto ld32 = [](const unsigned* p) { return CG ? __ldcg(p) : __ldg(p); };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = ok0 ? ld32(r0 + kk * 8) : 0u;
    a[kk][1] = ok1 ? ld32(r1 + kk * 8) : 0u;
    a[kk][2] = ok0 ? ld32(r0 + kk * 8 + 4) : 0u;
    a[kk][3] = ok1 ? ld32(r1 + kk * 8 + 4) : 0u;
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

// the A fragments of a 16 x 64 bf16 tile in shared memory (row 0 at src,
// LD elements a row), through ldmatrix; a[kk] is the k16 step over dims
// 16 kk ..
template <int LD>
__device__ __forceinline__ void load_a_tile(unsigned (&a)[4][4], const bf16* src) {
  const int lane = threadIdx.x & 31;
  // matrices: rows 0-7 and 8-15 of dims +0-7, then of dims +8-15
  const bf16* row = src + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], row + kk * 16);
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

// two f32 values as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo
// keeps about 16 bits of x (x - hi is exact in f32)
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(__fsub_rn(x0, __low2float(h)), __fsub_rn(x1, __high2float(h)));
}

// acc (dims 8 nt ..) += sc . B over NC k16 chunks, sc split into bf16 hi
// and lo (split_bf16), two products into the same f32 sums; B's rows (the
// k dim) at bs, LD elements a row, through ldmatrix.trans
template <int NC, int LD>
__device__ __forceinline__ void pv_tile_split(float (&acc)[8][4], const float (&sc)[2 * NC][4],
                                              const bf16* bs) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  const bf16* row = bs + ((mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float(&p0)[4] = sc[2 * c];
    const float(&p1)[4] = sc[2 * c + 1];
    unsigned hi[4], lo[4];
    split_bf16(p0[0], p0[1], hi[0], lo[0]);
    split_bf16(p0[2], p0[3], hi[1], lo[1]);
    split_bf16(p1[0], p1[1], hi[2], lo[2]);
    split_bf16(p1[2], p1[3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm_x4_trans(b, row + c * 16 * LD + np * 16);
      const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[2 * np], hi, b0);
      mma_bf16(acc[2 * np + 1], hi, b1);
      mma_bf16(acc[2 * np], lo, b0);
      mma_bf16(acc[2 * np + 1], lo, b1);
    }
  }
}

// acc (16 rows m, dims 8 nt ..) += A . B over NC k16 chunks, with A's 16
// x 16 NC bf16 in shared memory: stored [m][k] (TRANS false: column k = 0
// at as, LDA elements a row, through ldmatrix) or [k][m] (TRANS: row k = 0
// and column m = 0 at as, its transposed fragments through
// ldmatrix.trans); with lo (SPLIT) a second A of the same layout adds its
// product into the same sums (the lo half of a split). B's rows (k) at
// bs, LDB elements a row, as in pv_tile
template <int NC, int LDA, int LDB, bool TRANS, bool SPLIT>
__device__ __forceinline__ void smem_tile(float (&acc)[8][4], const bf16* as, const bf16* lo,
                                          const bf16* bs) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  // A's matrices: m 0-7 and 8-15 of k 0-7, then of k 8-15 (in the transposed
  // layout: k 0-7 of m 0-7, k 0-7 of m 8-15, then k 8-15)
  const int aoff = TRANS ? ((lane & 7) + ((lane >> 4) << 3)) * LDA + ((lane >> 3) & 1) * 8
                         : (lane & 15) * LDA + (lane >> 4) * 8;
  const int astep = TRANS ? 16 * LDA : 16;  // one k16 chunk
  const bf16* brow = bs + ((mat & 1) * 8 + (lane & 7)) * LDB + (mat >> 1) * 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    unsigned a[4], al[4];
    if constexpr (TRANS) {
      ldsm_x4_trans(a, as + aoff + c * astep);
      if constexpr (SPLIT) ldsm_x4_trans(al, lo + aoff + c * astep);
    } else {
      ldsm_x4(a, as + aoff + c * astep);
      if constexpr (SPLIT) ldsm_x4(al, lo + aoff + c * astep);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm_x4_trans(b, brow + c * 16 * LDB + np * 16);
      const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[2 * np], a, b0);
      mma_bf16(acc[2 * np + 1], a, b1);
      if constexpr (SPLIT) {
        mma_bf16(acc[2 * np], al, b0);
        mma_bf16(acc[2 * np + 1], al, b1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// scores in the reference's order
// ---------------------------------------------------------------------------
//
// The plain versions' f32 products (torch.matmul without TF32) sum a dot
// product as one fmaf after another over the 64 dims: bit for bit on the
// H100. The tensor cores sum the same exact products in another order; a
// score that differs in its last bits puts a p near a bf16 tie on the
// other side, which moves PV's output by an ulp of p times |v|, past 1
// bf16 ulp + 1e-3 on some elements of every text batch of 512 x 77 (even
// with exactly rounded scores; the CUDA-core row loop, which sums in the
// reference's order, on none). The masked attention and K7's bf16
// forward and backward therefore take a tile's scores and softmax on the
// CUDA cores in that order, as the row loop does (lanes over keys: lane l
// holds keys l, l + 32, ... of all 16 rows, so p comes out bit for bit as
// the row loop's), and keep the products that follow on the tensor cores.
// k is read as bf16 rows from shared memory and widened exactly, q by
// broadcast (in f32 or bf16). The pair attention's contexts (pair_mma.cuh)
// have bars that allow p's other rounding and keep qk_chunk.

// 8 bf16 (one 16-byte word) widened to f32, exactly
__device__ __forceinline__ void unpack8(float (&f)[8], const uint4 w) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// a warp's 16 query rows (row 0 at q, ld elements a row, 16-byte aligned;
// rows >= n_rows as 0) to f32 at qf (64 a row); CG: q through L2 (written
// earlier in the same launch)
template <bool CG = false>
__device__ __forceinline__ void stage_q_f32(float* qf, const bf16* q, long long ld, int n_rows) {
  const int lane = threadIdx.x & 31;
  auto ld16 = [](const bf16* p) {
    if constexpr (CG) return __ldcg(reinterpret_cast<const uint4*>(p));
    else return *reinterpret_cast<const uint4*>(p);
  };
#pragma unroll
  for (int c = lane; c < 16 * 8; c += 32) {
    const int r = c >> 3, d0 = (c & 7) * 8;
    float f[8];
    unpack8(f, r < n_rows ? ld16(q + r * ld + d0) : make_uint4(0u, 0u, 0u, 0u));
    *reinterpret_cast<float4*>(qf + r * ATT_D + d0) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(qf + r * ATT_D + d0 + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// s[r][sl] = q_r . k_j, j = 32 sl + lane, for the 16 query rows at q_s
// (QT: f32 rows of 64, or bf16 rows of LD; read by broadcast) against the
// kp staged key rows at k_s (bf16 rows, LD a row), fmaf over the dims in
// turn (8 dims a step: each q load serves every slot); slots from n_keys
// on are skipped (left 0, warp-uniform), keys past kp read the last row
// (the caller masks both). f32 q spares the widening of 16 rows a step in
// every lane; bf16 q needs no f32 copy
template <int KS, int LD, typename QT>
__device__ __forceinline__ void scores_seq(float (&s)[16][KS], const QT* q_s, const bf16* k_s,
                                           int n_keys, int kp) {
  constexpr bool F32 = std::is_same<QT, float>::value;
  constexpr int LDQ = F32 ? ATT_D : LD;
  const int lane = threadIdx.x & 31;
  const bf16* kr[KS];
#pragma unroll
  for (int sl = 0; sl < KS; ++sl) {
    kr[sl] = k_s + min(32 * sl + lane, kp - 1) * LD;
#pragma unroll
    for (int r = 0; r < 16; ++r) s[r][sl] = 0.0f;
  }
#pragma unroll 1
  for (int d0 = 0; d0 < ATT_D; d0 += 8) {
    float k8[KS][8];
#pragma unroll
    for (int sl = 0; sl < KS; ++sl)
      if (32 * sl < n_keys) unpack8(k8[sl], *reinterpret_cast<const uint4*>(kr[sl] + d0));
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float q8[8];
      if constexpr (F32) {
        const float4 a = *reinterpret_cast<const float4*>(q_s + r * LDQ + d0);
        const float4 b = *reinterpret_cast<const float4*>(q_s + r * LDQ + d0 + 4);
        q8[0] = a.x, q8[1] = a.y, q8[2] = a.z, q8[3] = a.w;
        q8[4] = b.x, q8[5] = b.y, q8[6] = b.z, q8[7] = b.w;
      } else {
        unpack8(q8, *reinterpret_cast<const uint4*>(q_s + r * LDQ + d0));
      }
#pragma unroll
      for (int sl = 0; sl < KS; ++sl) {
        if (32 * sl >= n_keys) continue;
        float a = s[r][sl];
#pragma unroll
        for (int u = 0; u < 8; ++u) a = fmaf(q8[u], k8[sl][u], a);
        s[r][sl] = a;
      }
    }
  }
}

// p = exp(s - m) / sum per row of s (lanes over keys), as the row loop
// takes it: the row max and sum across the lanes (each lane's slots in
// turn, then the butterfly), the IEEE quotient (div_rcp); -inf gives 0
template <int KS>
__device__ __forceinline__ void softmax_rows(float (&s)[16][KS]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float m = -INFINITY, l = 0.0f;
#pragma unroll
    for (int sl = 0; sl < KS; ++sl) m = fmaxf(m, s[r][sl]);
    m = warp_max(m);
#pragma unroll
    for (int sl = 0; sl < KS; ++sl) {
      s[r][sl] = expf(__fsub_rn(s[r][sl], m));
      l += s[r][sl];
    }
    l = warp_sum(l);
    const float y = __frcp_rn(l);
#pragma unroll
    for (int sl = 0; sl < KS; ++sl) s[r][sl] = div_rcp(s[r][sl], l, y);
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

// stores a 16 x 64 f32 tile: per n8 tile and row half, the quad writes
// 32 contiguous bytes of each of 8 rows (float2 a thread). dst is row 0
// (8-byte aligned), ld the row stride in elements (even); rows >= n_rows
// are not stored
__device__ __forceinline__ void store_tile_f32(const float (&acc)[8][4], float* dst, long long ld,
                                               int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (g + 8 * h >= n_rows) continue;
    float* r = dst + (g + 8 * h) * ld + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(r + 8 * nt) = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  }
}

// stores int8(round(acc x cinv[h])) (round_clip_int8) of a 16 x 64 tile,
// cinv[h] the factor of this thread's row g + 8 h, with one 16-byte store
// a thread per row half: the quad trades words so that thread tig holds
// dims 16 tig .. 16 tig + 15 of its row. dst is row 0 (16-byte aligned),
// ld the row stride in elements (a multiple of 16); rows >= n_rows are
// not stored
__device__ __forceinline__ void store_tile_int8(const float (&acc)[8][4], const float (&cinv)[2],
                                                int8_t* dst, long long ld, int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // w[c]: this thread's bytes of dims 16 c .. 16 c + 15 (n8 tiles 2 c and
    // 2 c + 1), tile 2 c's pair in the low half
    unsigned w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned b0 = (uint8_t)round_clip_int8(__fmul_rn(acc[2 * c][2 * h], cinv[h]));
      const unsigned b1 = (uint8_t)round_clip_int8(__fmul_rn(acc[2 * c][2 * h + 1], cinv[h]));
      const unsigned b2 = (uint8_t)round_clip_int8(__fmul_rn(acc[2 * c + 1][2 * h], cinv[h]));
      const unsigned b3 = (uint8_t)round_clip_int8(__fmul_rn(acc[2 * c + 1][2 * h + 1], cinv[h]));
      w[c] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
    }
    // round s: word tig of quad thread (tig + s) & 3
    unsigned got[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      got[s] = __shfl_sync(0xffffffffu, pick4(w, (tig - s) & 3), (lane & ~3) | ((tig + s) & 3));
    // r[j] = the word from quad thread j: its pairs of dims 16 tig + 2 j
    // (low half) and 16 tig + 8 + 2 j (high half)
    unsigned r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = pick4(got, (j - tig) & 3);
    const uint4 v = make_uint4(__byte_perm(r[0], r[1], 0x5410), __byte_perm(r[2], r[3], 0x5410),
                               __byte_perm(r[0], r[1], 0x7632), __byte_perm(r[2], r[3], 0x7632));
    if (g + 8 * h < n_rows)
      *reinterpret_cast<uint4*>(dst + (g + 8 * h) * ld + 16 * tig) = v;
  }
}

// the same with one factor for every row
__device__ __forceinline__ void store_tile_int8(const float (&acc)[8][4], float cinv,
                                                int8_t* dst, long long ld, int n_rows) {
  const float c[2] = {cinv, cinv};
  store_tile_int8(acc, c, dst, ld, n_rows);
}

// ---------------------------------------------------------------------------
// the masked attention of one (sequence, head)
// ---------------------------------------------------------------------------
//
// The body of text_block.cu's masked_attention_mma_kernel (its header says
// what it computes), shared with the attention phase of the persistent
// int8 layer kernel (block_int8.cuh): the block stages the head's K and V
// (masked_stage_kv), each warp its 16-row query tile (masked_stage_q),
// then each warp computes its tile (masked_tile). NC: 16-key chunks, 16 NC
// >= S.

constexpr int MA_LD = ATT_D + 8;  // padded shared row of K and V (bf16): conflict-free ldmatrix

// bytes of a warp's scratch: its 16 query rows in f32 for the scores, then
// its 16 rows of bf16 p (KP + 8 a row) for PV
__host__ __device__ constexpr int ma_warp_bytes(int kp) {
  return 16 * ATT_D * 4 > 16 * (kp + 8) * 2 ? 16 * ATT_D * 4 : 16 * (kp + 8) * 2;
}

// K then V of one head ([16 NC][MA_LD] bf16 each at ks, rows past S
// zero-filled; any: a valid address for the zero-filled chunks) from its
// packed qkv rows (base: the head's q in the sequence's row 0, E = 64 H),
// 16-byte cp.async by threads t, t + nt, ..
template <int NC>
__device__ __forceinline__ void masked_stage_kv(bf16* ks, const bf16* base, const bf16* any, int S,
                                                int E, int t, int nt) {
  constexpr int KP = 16 * NC;
  const int E3 = 3 * E;
  for (int c = t; c < 2 * KP * 8; c += nt) {
    const int r = c >> 3, kv = r >= KP, row = r - kv * KP, col = (c & 7) * 8;
    const bool ok = row < S;
    cp_async16(ks + r * MA_LD + col, ok ? base + (long long)row * E3 + (1 + kv) * E + col : any,
               ok ? 16 : 0);
  }
}

// the warp's query rows m0 .. m0 + 15 of the head (base as above) in f32
// into its scratch wb
template <bool CG>
__device__ __forceinline__ void masked_stage_q(unsigned char* wb, const bf16* base, int E, int m0,
                                               int S) {
  const int E3 = 3 * E;
  stage_q_f32<CG>(reinterpret_cast<float*>(wb), base + (long long)m0 * E3, E3, S - m0);
}

// the warp's tile m0 once K, V (ks) and its q (wb) are staged: scores and
// softmax in the reference's order, PV on the tensor cores, the context
// rows to out + o (E a row) as out_kind: 0 bf16, 1 f32, 2 int8 x *ctx_inv
template <int NC>
__device__ __forceinline__ void masked_tile(const bf16* ks, unsigned char* wb, int m0, int S,
                                            bool causal, float scale, int out_kind,
                                            const float* ctx_inv, void* out, long long o, int E) {
  constexpr int KP = 16 * NC, KS = (KP + 31) / 32, LDP = KP + 8;
  const bf16* vs = ks + KP * MA_LD;
  const int lane = threadIdx.x & 31;
  const float* qf = reinterpret_cast<const float*>(wb);  // [16][64] q in f32, then [16][LDP] bf16 p
  bf16* ps = reinterpret_cast<bf16*>(wb);

  // scores and softmax in the reference's order (lanes over keys)
  float sc[16][KS];
  scores_seq<KS, MA_LD>(sc, qf, ks, causal ? min(S, m0 + 16) : S, KP);
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int sl = 0; sl < KS; ++sl) {
      const int j = 32 * sl + lane;
      sc[r][sl] = j < S && (!causal || j <= m0 + r) ? __fmul_rn(sc[r][sl], scale) : -INFINITY;
    }
  softmax_rows<KS>(sc);
  __syncwarp();  // q read: its scratch takes p
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int sl = 0; sl < KS; ++sl)
      if (32 * sl + lane < KP) ps[r * LDP + 32 * sl + lane] = __float2bfloat16_rn(sc[r][sl]);
  __syncwarp();

  // PV on the tensor cores: bf16 p through ldmatrix, V through ldmatrix.trans
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  smem_tile<NC, LDP, MA_LD, false, false>(acc, ps, nullptr, vs);

  if (out_kind == 0)
    store_tile_bf16(acc, static_cast<bf16*>(out) + o, E, S - m0);
  else if (out_kind == 1)
    store_tile_f32(acc, static_cast<float*>(out) + o, E, S - m0);
  else
    store_tile_int8(acc, *ctx_inv, static_cast<int8_t*>(out) + o, E, S - m0);
}
