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
// operations per byte, so on tensor cores the bytes would bound it; this
// first version runs the products on the CUDA cores in f32 (the f32 route
// needs that anyway), where the 67 TFLOP/s f32 rate bounds it. Design: one
// block per (crop, head, 64-query tile). The tile's scores against every
// key stay in shared memory ([S, 64] f32, 197 KB at S = 768), so each key
// tile of K and then of V is read once per query tile and nothing of the
// S x S scores reaches device memory. Both products use 4 x 4 register
// tiles per thread over f32 shared tiles (q and k stored transposed, rows
// padded to 68 floats); the softmax runs with four threads per query row
// over the key-major score tile, conflict-free.
#include "common.cuh"

namespace {

constexpr int BA_THREADS = 256;
constexpr int QT = 64;  // queries per block
constexpr int KT = 64;  // keys per tile
constexpr int HD = 64;  // head dim
constexpr int LD = 68;  // padded shared row of the q / k / v tiles, floats

struct Strides {
  long long b, h, s;  // elements; the head dim is contiguous
};

size_t smem_bytes(int S) {
  const size_t n_kt = (S + KT - 1) / KT;
  return ((size_t)(HD + KT) * LD + n_kt * KT * QT + 4 * QT) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(BA_THREADS) blocked_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias,  // [S, S] or null
    T* __restrict__ out, int S, int H, int n_qt, Strides in, Strides os, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_kt = (S + KT - 1) / KT;
  float* qt_s = reinterpret_cast<float*>(smem_raw);  // [HD][LD] q^T of the query tile
  float* kv_s = qt_s + HD * LD;                       // [HD][LD] k^T, then [KT][LD] v
  float* sc_s = kv_s + KT * LD;                       // [n_kt * KT][QT] scores, then p
  float* red_s = sc_s + (size_t)n_kt * KT * QT;       // [4][QT] partial row max / sum

  const int tid = threadIdx.x;
  const int qt = blockIdx.x % n_qt;
  const long long bh = blockIdx.x / n_qt;
  const int head = (int)(bh % H);
  const long long b = bh / H;
  const int q0 = qt * QT;
  const long long ib = b * in.b + head * in.h;

  for (int idx = tid; idx < QT * HD; idx += BA_THREADS) {
    const int r = idx / HD, d = idx % HD, i = q0 + r;
    qt_s[d * LD + r] = i < S ? to_f(q[ib + i * in.s + d]) : 0.0f;
  }

  // scores: thread (tx, ty) holds queries tx*4 + i of keys ty*4 + jj
  const int tx = tid & 15, ty = tid >> 4;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * KT;
    __syncthreads();
    for (int idx = tid; idx < KT * HD; idx += BA_THREADS) {
      const int r = idx / HD, d = idx % HD, j = j0 + r;
      kv_s[d * LD + r] = j < S ? to_f(k[ib + j * in.s + d]) : 0.0f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt_s + d * LD + tx * 4);
      const float4 c = *reinterpret_cast<const float4*>(kv_s + d * LD + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], cv[jj], acc[i][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + ty * 4 + jj;
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + tx * 4 + i;
        float s = __fmul_rn(acc[i][jj], scale);
        if (bias != nullptr && qi < S && j < S) s = __fadd_rn(s, bias[(long long)qi * S + j]);
        sv[i] = j < S ? s : -INFINITY;
      }
      *reinterpret_cast<float4*>(sc_s + (size_t)j * QT + tx * 4) = make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
  }
  __syncthreads();

  // softmax: four threads per query row r, keys g, g + 4, ...
  {
    const int r = tid & (QT - 1), g = tid / QT;
    float m = -INFINITY;
    for (int j = g; j < S; j += 4) m = fmaxf(m, sc_s[j * QT + r]);
    red_s[g * QT + r] = m;
    __syncthreads();
    m = fmaxf(fmaxf(red_s[r], red_s[QT + r]), fmaxf(red_s[2 * QT + r], red_s[3 * QT + r]));
    float sum = 0.0f;
    for (int j = g; j < S; j += 4) {
      const float e = expf(__fsub_rn(sc_s[j * QT + r], m));
      sc_s[j * QT + r] = e;
      sum = __fadd_rn(sum, e);
    }
    __syncthreads();
    red_s[g * QT + r] = sum;
    __syncthreads();
    sum = __fadd_rn(__fadd_rn(red_s[r], red_s[QT + r]), __fadd_rn(red_s[2 * QT + r], red_s[3 * QT + r]));
    for (int j = g; j < S; j += 4) sc_s[j * QT + r] = round_to<T>(__fdiv_rn(sc_s[j * QT + r], sum));
  }

  // PV: thread (tx, ty) holds queries ty*4 + i of dims tx*4 + c
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.0f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * KT;
    __syncthreads();
    for (int idx = tid; idx < KT * HD; idx += BA_THREADS) {
      const int r = idx / HD, d = idx % HD, j = j0 + r;
      kv_s[r * LD + d] = j < S ? to_f(v[ib + j * in.s + d]) : 0.0f;
    }
    __syncthreads();
    const int nk = min(KT, S - j0);
#pragma unroll 4
    for (int jj = 0; jj < nk; ++jj) {
      const float4 p = *reinterpret_cast<const float4*>(sc_s + (size_t)(j0 + jj) * QT + ty * 4);
      const float4 w = *reinterpret_cast<const float4*>(kv_s + jj * LD + tx * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][c] = fmaf(pv[i], wv[c], o[i][c]);
    }
  }
  const long long ob = b * os.b + head * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < S) {
      T* dst = out + ob + qi * os.s + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c] = from_f<T>(o[i][c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B, int S,
           int H, Strides in, Strides os, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
  const int err = set_smem(blocked_attn_kernel<T>, smem);
  if (err) return err;
  const int n_qt = (S + QT - 1) / QT;
  blocked_attn_kernel<T><<<(unsigned)((long long)B * H * n_qt), BA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), S, H, n_qt, in, os, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// returns cudaErrorInvalidValue, and launches nothing, for D != 64, an
// empty shape, more blocks than the grid holds, or S whose score tile is
// over the card's shared memory (S > 768 on an H100); bias may be null
extern "C" int jcf_blocked_attention(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, int B, int S, int H, int D,
                                     long long sb, long long sh, long long ss, long long ob,
                                     long long oh, long long os, float scale, int is_bf16,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D != HD ||
      (long long)B * H * ((S + QT - 1) / QT) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides in{sb, sh, ss}, o{ob, oh, os};
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<bf16>(q, k, v, bias, out, B, S, H, in, o, scale, st)
                 : launch<float>(q, k, v, bias, out, B, S, H, in, o, scale, st);
}
