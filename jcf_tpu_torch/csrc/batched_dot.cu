// Probe P3's kernels: softmax attention per head at tower scale (S <= 64
// tokens, head dim 64, bf16), no 1/sqrt(d):
//   s = q . k^T              (bf16 products, f32 sums)
//   p = exp(s - max_j s)     (f32)
//   p = p / sum_j p          (f32, an IEEE division per element)
//   o = bf16( bf16(p) . v )  (f32 sums)
// (jcf_tpu_torch/scripts/exp_batched_dot.py), two ways:
//
// batched_dot_mma replaces kernel_batched (scripts/exp_batched_dot.py:35,
// its pallas_call at :90), which takes all heads of a grid step in one
// batched dot_general on the MXU. Here the products run on the tensor
// cores: mma.sync m16n8k16 bf16 with f32 sums. A block holds MMA_HEADS
// heads, q, k and v each padded from S to 64 rows in shared memory only
// (16-byte cp.async, the pad rows zero-filled) and two warps a head, each
// warp two 16-row query tiles. A warp keeps a tile's 16 x 64 scores in
// registers, masks the pad keys out of the max and the sum, normalizes p
// in f32 before PV (the TPU kernel's order, not flash attention's deferred
// normalization) and feeds the rounded p to PV straight from the score
// fragments (the accumulator layout of m16n8k16 is its A layout); V's
// fragments come from shared memory with ldmatrix.trans. The output tile
// goes back through the head's q rows in shared memory and leaves in
// 16-byte stores.
//
// batched_dot_loop replaces kernel_loop (:52), which walks the heads in a
// fori_loop. Here the heads of a block run in sequence on the CUDA cores,
// with the row loop of pair_attention.cuh (the design of K3's, K6a's and
// K9's attention) for one head and this normalization: a warp per query
// row, lanes over keys for the scores (K transposed in shared memory),
// then lanes over head dims for PV.
//
// What bounds both on the H100: bytes. q, k, v and o are 4 x 56 x 64 x 2
// bytes (28.7 KB) a head against 2 x 2 x 56 x 56 x 64 flop (803 k) of
// products: 28 flop a byte, far below the bf16 ridge point (295). The mma
// kernel moves each byte once; its bound is the copy of q, k, v in and o
// out. The loop kernel runs the products as scalar f32 FMAs on the CUDA
// cores (2 x 56 x 56 x 64 a head), each beside a shared-memory load: the
// gap P3 measures.
#include "common.cuh"

namespace {

constexpr int BD_D = 64;         // head dim
constexpr int BD_SP = 64;        // rows a head in shared memory (S padded)
constexpr int BD_LD = BD_D + 8;  // padded shared row (bf16): conflict-free fragment loads
constexpr int MMA_HEADS = 4;     // heads a block
constexpr int MMA_THREADS = 64 * MMA_HEADS;  // two warps a head
constexpr int HEAD_SMEM = 3 * BD_SP * BD_LD;  // q, k, v of one head (bf16 elements)
constexpr int LOOP_HEADS = 8;    // heads a block, in sequence
constexpr int LOOP_THREADS = 256;

__global__ void __launch_bounds__(MMA_THREADS) batched_dot_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int B, int S) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* smem = reinterpret_cast<bf16*>(mma_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int head0 = blockIdx.x * MMA_HEADS;
  const long long head_elems = (long long)S * BD_D;

  // q, k, v of the block's heads: 64 rows x 8 chunks of 16 bytes each;
  // rows >= S and heads >= B zero-filled
  for (int c = tid; c < MMA_HEADS * 3 * BD_SP * 8; c += MMA_THREADS) {
    const int chunk = c & 7, row = (c >> 3) & (BD_SP - 1), t = (c >> 9) % 3, hb = c / (3 * 512);
    const int head = head0 + hb;
    const bf16* src = t == 0 ? q : t == 1 ? k : v;
    const bool ok = head < B && row < S;
    cp_async16(smem + hb * HEAD_SMEM + t * BD_SP * BD_LD + row * BD_LD + chunk * 8,
               ok ? src + head * head_elems + row * BD_D + chunk * 8 : src, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int hb = warp >> 1;
  bf16* qs = smem + hb * HEAD_SMEM;
  const bf16* ks = qs + BD_SP * BD_LD;
  const bf16* vs = ks + BD_SP * BD_LD;
  if (head0 + hb < B) {
#pragma unroll 1
    for (int mi = 0; mi < 2; ++mi) {
      const int m0 = ((warp & 1) * 2 + mi) * 16;
      if (m0 >= S) break;
      // scores of query rows m0 + g and m0 + g + 8 against the 64 keys
      float sc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < BD_D; kk += 16) {
        unsigned a[4];
        a[0] = ld_u32(qs + (m0 + g) * BD_LD + kk + tig * 2);
        a[1] = ld_u32(qs + (m0 + g + 8) * BD_LD + kk + tig * 2);
        a[2] = ld_u32(qs + (m0 + g) * BD_LD + kk + 8 + tig * 2);
        a[3] = ld_u32(qs + (m0 + g + 8) * BD_LD + kk + 8 + tig * 2);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          unsigned b[2];
          b[0] = ld_u32(ks + (nt * 8 + g) * BD_LD + kk + tig * 2);
          b[1] = ld_u32(ks + (nt * 8 + g) * BD_LD + kk + 8 + tig * 2);
          mma_bf16(sc[nt], a, b);
        }
      }
      // softmax over the S real keys of each row; a quad holds a row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (nt * 8 + tig * 2 + (e & 1) >= S) sc[nt][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = expf(__fsub_rn(sc[nt][e], mx[e >> 1]));
          sum[e >> 1] += sc[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      }
      // o = bf16(p / sum) . v: the score fragments of keys kk..kk+15 are
      // the A fragment of that k-step
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int ks16 = 0; ks16 < 4; ++ks16) {
        const float(&p0)[4] = sc[2 * ks16];
        const float(&p1)[4] = sc[2 * ks16 + 1];
        unsigned a[4];
        a[0] = pack_bf16(__fdiv_rn(p0[0], sum[0]), __fdiv_rn(p0[1], sum[0]));
        a[1] = pack_bf16(__fdiv_rn(p0[2], sum[1]), __fdiv_rn(p0[3], sum[1]));
        a[2] = pack_bf16(__fdiv_rn(p1[0], sum[0]), __fdiv_rn(p1[1], sum[0]));
        a[3] = pack_bf16(__fdiv_rn(p1[2], sum[1]), __fdiv_rn(p1[3], sum[1]));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          // matrices: keys +0..7 / +8..15 of dims np*16 + 0..7, then + 8..15
          const int mat = lane >> 3;
          unsigned b[4];
          ldsm_x4_trans(b, vs + (ks16 * 16 + (mat & 1) * 8 + (lane & 7)) * BD_LD + np * 16 +
                               (mat >> 1) * 8);
          const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          mma_bf16(acc[2 * np], a, b0);
          mma_bf16(acc[2 * np + 1], a, b1);
        }
      }
      // the tile's output over its own q rows (read by this warp only)
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + tig * 2;
        *reinterpret_cast<__nv_bfloat162*>(qs + (m0 + g) * BD_LD + col) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(qs + (m0 + g + 8) * BD_LD + col) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < MMA_HEADS * BD_SP * 8; c += MMA_THREADS) {
    const int chunk = c & 7, row = (c >> 3) & (BD_SP - 1), h = c >> 9;
    if (head0 + h < B && row < S)
      *reinterpret_cast<uint4*>(o + (head0 + h) * head_elems + row * BD_D + chunk * 8) =
          *reinterpret_cast<const uint4*>(smem + h * HEAD_SMEM + row * BD_LD + chunk * 8);
  }
}

__global__ void __launch_bounds__(LOOP_THREADS) batched_dot_loop_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int B, int S) {
  // kt [D][S], v [S][D], q [S][D] bf16, then p [warps][S] f32
  extern __shared__ __align__(16) unsigned char loop_smem[];
  bf16* kt_s = reinterpret_cast<bf16*>(loop_smem);
  bf16* v_s = kt_s + BD_D * S;
  bf16* q_s = v_s + S * BD_D;
  float* p_s = reinterpret_cast<float*>(q_s + S * BD_D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int n_warps = LOOP_THREADS / 32;
  float* pw = p_s + warp * S;
  const long long head_elems = (long long)S * BD_D;
#pragma unroll 1
  for (int hb = 0; hb < LOOP_HEADS; ++hb) {
    const long long head = (long long)blockIdx.x * LOOP_HEADS + hb;
    if (head >= B) break;
    const bf16* qh = q + head * head_elems;
    const bf16* kh = k + head * head_elems;
    const bf16* vh = v + head * head_elems;
    __syncthreads();  // the previous head's readers are done
    for (int c = tid; c < S * 8; c += LOOP_THREADS) {
      const int row = c >> 3, d0 = (c & 7) * 8;
      const uint4 kv = *reinterpret_cast<const uint4*>(kh + row * BD_D + d0);
      const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
      for (int e = 0; e < 8; ++e) kt_s[(d0 + e) * S + row] = ke[e];
      *reinterpret_cast<uint4*>(v_s + row * BD_D + d0) =
          *reinterpret_cast<const uint4*>(vh + row * BD_D + d0);
      *reinterpret_cast<uint4*>(q_s + row * BD_D + d0) =
          *reinterpret_cast<const uint4*>(qh + row * BD_D + d0);
    }
    __syncthreads();
    for (int i = warp; i < S; i += n_warps) {
      const bf16* qi = q_s + i * BD_D;
      float s[2];  // keys lane and lane + 32
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const int j = lane + 32 * kb;
        float acc = -INFINITY;
        if (j < S) {
          acc = 0.0f;
          for (int d = 0; d < BD_D; ++d) acc = fmaf(bf2f(qi[d]), bf2f(kt_s[d * S + j]), acc);
        }
        s[kb] = acc;
      }
      const float m = warp_max(fmaxf(s[0], s[1]));
      float p[2], sum = 0.0f;
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        p[kb] = lane + 32 * kb < S ? expf(__fsub_rn(s[kb], m)) : 0.0f;
        sum += p[kb];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
        if (lane + 32 * kb < S) pw[lane + 32 * kb] = round_bf16(__fdiv_rn(p[kb], sum));
      __syncwarp();
#pragma unroll
      for (int db = 0; db < 2; ++db) {
        const int d = lane + 32 * db;
        float acc = 0.0f;
        for (int j = 0; j < S; ++j) acc = fmaf(pw[j], bf2f(v_s[j * BD_D + d]), acc);
        o[head * head_elems + i * BD_D + d] = __float2bfloat16_rn(acc);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// q, k, v, o: bf16 [B, S, 64], contiguous and 16-byte aligned, S <= 64.
// Returns a cudaError_t.
int jcf_batched_dot_mma(const void* q, const void* k, const void* v, void* o, int B, int S,
                        void* stream) {
  if (B <= 0 || S <= 0 || S > BD_SP) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)MMA_HEADS * HEAD_SMEM * sizeof(bf16);
  const int err = set_smem(batched_dot_mma_kernel, smem);
  if (err) return err;
  batched_dot_mma_kernel<<<(B + MMA_HEADS - 1) / MMA_HEADS, MMA_THREADS, smem,
                           (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), B, S);
  return (int)cudaGetLastError();
}

int jcf_batched_dot_loop(const void* q, const void* k, const void* v, void* o, int B, int S,
                         void* stream) {
  if (B <= 0 || S <= 0 || S > BD_SP) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * S * BD_D * sizeof(bf16) + (size_t)(LOOP_THREADS / 32) * S * 4;
  const int err = set_smem(batched_dot_loop_kernel, smem);
  if (err) return err;
  batched_dot_loop_kernel<<<(B + LOOP_HEADS - 1) / LOOP_HEADS, LOOP_THREADS, smem,
                            (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), B, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
