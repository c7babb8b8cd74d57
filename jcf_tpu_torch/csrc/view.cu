// K1: fused TTA view resampling.
//
// Replaces jcf_tpu/ops/view_kernel.py::_view_kernel (fused_views_nchw).
// Per image, view and channel: triangle (antialiased bilinear) weights
// wy [out, H] and wx [W, out] built in-kernel from per-pixel centers (the
// horizontal flip is already folded into mirrored column centers), a row
// resample t = wy @ X_c with f32 accumulation cast to bf16, a column
// resample view = t @ wx in f32, and the int8 pixel quantization
// round(view * 254 - 127).
//
// What bounds it on the H100: bytes. Each source row is read once per
// output row tile and each output pixel written once (1 byte); the resample work is tiny because a triangle filter whose
// support is at most ~1.15 source pixels (crop scale >= 0.5 of a 256^2
// source into 224^2) touches only a handful of taps. So instead of the
// TPU's two dense GEMMs per channel (MXU work is free there) the kernel
// evaluates only the nonzero taps of each weight row: [i_lo, i_hi] around
// the center, with the same weight formula and cast points, so the zero
// taps the dense product adds change nothing.
//
// Layout: one block per (image, view, channel, tile of VIEW_ROWS output
// rows). Pass 1 writes the tile's rows of t (all W source columns) to
// shared memory as bf16; pass 2 gives each thread one output column and
// VIEW_ROWS accumulators, so each column weight is computed once per tile.
#include "common.cuh"

namespace {

constexpr int VIEW_ROWS = 32;
constexpr int VIEW_THREADS = 256;

// unnormalized triangle weight max(0, 1 - |c - i| * inv), rounded as the
// reference rounds it
__device__ __forceinline__ float tri(float c, int i, float inv) {
  return fmaxf(0.0f, __fsub_rn(1.0f, __fmul_rn(fabsf(__fsub_rn(c, (float)i)), inv)));
}

// taps [lo, hi] that can carry weight, clamped to [0, n)
__device__ __forceinline__ void tap_range(float c, float inv, int n, int& lo, int& hi) {
  const float r = 1.0f / inv;
  lo = max(0, (int)floorf(c - r));
  hi = min(n - 1, (int)ceilf(c + r));
}

// 1 / max(sum of weights, 1e-8): the reference normalizes by w * (1/denom)
__device__ __forceinline__ float tap_rnorm(float c, float inv, int lo, int hi) {
  float s = 0.0f;
  for (int i = lo; i <= hi; ++i) s = __fadd_rn(s, tri(c, i, inv));
  return 1.0f / fmaxf(s, 1e-8f);
}

__global__ void __launch_bounds__(VIEW_THREADS) view_kernel(
    const bf16* __restrict__ img,   // [B, C, H, W]
    const float* __restrict__ cy,   // [B, V, out]
    const float* __restrict__ cx,   // [B, V, out]
    const float* __restrict__ inv,  // [B, V, 2]
    int8_t* __restrict__ out,       // [B, V, C, out, out]
    int C, int H, int W, int V, int out_size) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* t_s = reinterpret_cast<bf16*>(smem_raw);  // [VIEW_ROWS, W]

  const int n_tiles = (out_size + VIEW_ROWS - 1) / VIEW_ROWS;
  long long id = blockIdx.x;
  const int tile = (int)(id % n_tiles);
  id /= n_tiles;
  const int c = (int)(id % C);
  id /= C;
  const int v = (int)(id % V);
  const int b = (int)(id / V);

  const int o0 = tile * VIEW_ROWS;
  const long long bv = (long long)b * V + v;
  const float inv_y = inv[bv * 2 + 0];
  const float inv_x = inv[bv * 2 + 1];
  const float* cy_v = cy + bv * out_size;
  const float* cx_v = cx + bv * out_size;
  const bf16* x_c = img + ((long long)b * C + c) * H * W;

  // pass 1: t[r, w] = bf16(sum_i bf16(wy[o0 + r, i]) * x[i, w])
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    for (int r = 0; r < VIEW_ROWS; ++r) {
      const int o = o0 + r;
      float acc = 0.0f;
      if (o < out_size) {
        const float cen = cy_v[o];
        int lo, hi;
        tap_range(cen, inv_y, H, lo, hi);
        const float rn = tap_rnorm(cen, inv_y, lo, hi);
        for (int i = lo; i <= hi; ++i) {
          const float wt = round_bf16(__fmul_rn(tri(cen, i, inv_y), rn));
          acc = fmaf(wt, bf2f(x_c[(long long)i * W + w]), acc);  // exact product
        }
      }
      t_s[r * W + w] = __float2bfloat16_rn(acc);
    }
  }
  __syncthreads();

  // pass 2: view[r, q] = sum_w t[r, w] * bf16(wx[w, q])
  const long long plane = (long long)out_size * out_size;
  const long long out_base = (bv * C + c) * plane;
  for (int q = threadIdx.x; q < out_size; q += blockDim.x) {
    const float cen = cx_v[q];
    int lo, hi;
    tap_range(cen, inv_x, W, lo, hi);
    const float rn = tap_rnorm(cen, inv_x, lo, hi);
    float acc[VIEW_ROWS];
#pragma unroll
    for (int r = 0; r < VIEW_ROWS; ++r) acc[r] = 0.0f;
    for (int w = lo; w <= hi; ++w) {
      const float wt = round_bf16(__fmul_rn(tri(cen, w, inv_x), rn));
#pragma unroll
      for (int r = 0; r < VIEW_ROWS; ++r) acc[r] = fmaf(bf2f(t_s[r * W + w]), wt, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < VIEW_ROWS; ++r) {
      const int o = o0 + r;
      if (o >= out_size) break;
      out[out_base + (long long)o * out_size + q] =
          round_clip_int8(__fsub_rn(__fmul_rn(acc[r], 254.0f), 127.0f));
    }
  }
}

}  // namespace

extern "C" int jcf_view(const void* img, const void* cy, const void* cx, const void* inv,
                        void* out, int B, int C, int H, int W, int V, int out_size,
                        void* stream) {
  const int n_tiles = (out_size + VIEW_ROWS - 1) / VIEW_ROWS;
  const long long blocks = (long long)B * V * C * n_tiles;
  const size_t smem = (size_t)VIEW_ROWS * W * sizeof(bf16);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(view_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  view_kernel<<<(unsigned)blocks, VIEW_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(img), static_cast<const float*>(cy),
      static_cast<const float*>(cx), static_cast<const float*>(inv),
      static_cast<int8_t*>(out), C, H, W, V, out_size);
  return (int)cudaGetLastError();
}
