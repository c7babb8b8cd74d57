// K1: fused TTA view resampling.
//
// Replaces jcf_tpu/ops/view_kernel.py::_view_kernel (fused_views_nchw).
// Per image, view and channel: triangle (antialiased bilinear) weights
// wy [out, H] and wx [W, out] built in-kernel from per-pixel centers (the
// horizontal flip is already folded into mirrored column centers), a row
// resample t = wy @ X_c with f32 accumulation cast to the image type T, a
// column resample view = t @ wx in f32, then either the int8 pixel
// quantization round(view * 254 - 127) (quantize=True, bf16 images) or
// the view cast to T (quantize=False: bf16 or f32 views in the images'
// dtype, the float engines' path). The weights are cast to T as the
// reference casts them.
//
// What bounds it on the H100: bytes. Each source pixel is read once per
// view (the views of an image run close together, so its rows come from
// L2 after the first) and each output pixel written once (1 byte, or
// sizeof(T)); the resample work is tiny because a triangle filter whose
// support is at most ~1.15 source pixels (crop scale >= 0.5 of a 256^2
// source into 224^2) touches at most 3 taps. So instead of the TPU's two
// dense GEMMs per channel (MXU work is free there) the kernel evaluates
// only the nonzero taps of each weight row, with the same weight formula
// and cast points, so the zero taps the dense product adds change nothing.
//
// Layout: one block per (image, view, band of VIEW_ROWS output rows), all
// channels in turn. The block first builds the view's tap tables in
// shared memory, once for all channels: for each of the band's rows and
// each of the `out` columns its first nonzero tap, tap count, normalizer
// and weights rounded to T, each row (column) padded with zero weights to
// the band's (view's) largest tap count NT, its window kept inside the
// source. The passes are instances of NT (0..VIEW_TAPS, every tap loop
// unrolled with no guard; a zero weight leaves the f32 chain as it is:
// fmaf(0, x, acc) == acc); a view needing more taps takes the general
// instance, which loops over each row's own taps and recomputes their
// weights. Per channel:
//   pass 1: t[r, w] for the band's rows and the source columns the view
//           reads, as T in shared memory. A thread makes 16-byte chunks of
//           t (8 bf16 or 4 f32 columns), two at a time: one 16-byte
//           read-only load per tap along the source row, all issued before
//           the sums (one load a pixel, a chunk at a time, where a row is
//           not a multiple of 16 bytes or the images are not 16-byte
//           aligned), the row's taps broadcast from the table, one 16-byte
//           store a chunk.
//   pass 2: a warp takes 32 adjacent output columns and 4 rows of the
//           band, a lane one column with its window start and weights in
//           registers across the rows; t is read as T (adjacent lanes read
//           adjacent elements, no bank conflict), the 4 rows' reads issued
//           before their sums, and each store instruction writes one
//           contiguous run (32 int8 pixels, or 64 / 128 bytes) at offsets
//           the table holds.
// Every output's arithmetic is the parent kernel's: the same tri / rnorm
// formulas with _rn intrinsics, the weights rounded to T, the taps in
// ascending order as one fmaf chain from 0, t rounded to T between the
// passes and the same int8 store, so the output is the same bit for bit.
//
// Patch rows (PATCH, int8 only): the same pixels stored straight into the
// im2col rows [B*V*G*G, C*p*p] of the int8 patch embed, in the conv
// weight's (c, py, px) order (models/clip.py _patchify); each (output row,
// patch column) is one contiguous run of p bytes. The JAX kernel's
// py_split emission does the same on the TPU.
#include <limits.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int VIEW_ROWS = 32;
constexpr int VIEW_THREADS = 256;
constexpr int VIEW_TAPS = 8;  // taps of the largest unrolled instance
constexpr int VIEW_RG = 4;    // rows of the band a warp takes in pass 2
// blocks an SM must hold (the register cap that buys them: occupancy hides
// the table and shared-memory latencies the passes wait on)
constexpr int VIEW_BLOCKS_PER_SM = 6;

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

// the normalized weight of tap i, rounded to T
template <typename T>
__device__ __forceinline__ float tap_weight(float c, int i, float inv, float rn) {
  return round_to<T>(__fmul_rn(tri(c, i, inv), rn));
}

// the view's store: int8 pixels, or the view cast to the image type
__device__ __forceinline__ void store_view(int8_t* o, float v) {
  *o = round_clip_int8(__fsub_rn(__fmul_rn(v, 254.0f), 127.0f));
}
__device__ __forceinline__ void store_view(bf16* o, float v) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_view(float* o, float v) { *o = v; }

// One axis's tap table in shared memory, n entries (the band's rows or
// the view's columns). Entry e: its first nonzero tap lo[e], nonzero taps
// cnt[e], center cen[e] and normalizer rn[e]; for the unrolled instances
// the window start ws[e] of the padded taps and their weights w[k * n + e]
// (k-major, so lanes over adjacent entries read adjacent words); and its
// output offset off[e] (a row's from the channel's base, a column's from
// its row's), so that the store loop divides nothing.
struct TapTable {
  float* w;
  int* ws;
  int* lo;
  int* cnt;
  float* cen;
  float* rn;
  int* off;
  int n;

  __device__ TapTable(unsigned char*& p, int n_) : n(n_) {
    w = reinterpret_cast<float*>(p);
    ws = reinterpret_cast<int*>(w + VIEW_TAPS * n);
    lo = ws + n;
    cnt = lo + n;
    cen = reinterpret_cast<float*>(cnt + n);
    rn = cen + n;
    off = reinterpret_cast<int*>(rn + n);
    p = reinterpret_cast<unsigned char*>(off + n);
  }

  // first step: the entry's nonzero taps (their count reduced into *nt_max)
  template <typename T>
  __device__ void build(int e, float c, float inv, int n_src, int* nt_max) {
    int a, b;
    tap_range(c, inv, n_src, a, b);
    const float r = tap_rnorm(c, inv, a, b);
    int first = b + 1, last = a - 1;
    for (int i = a; i <= b; ++i)
      if (tap_weight<T>(c, i, inv, r) != 0.0f) {
        first = min(first, i);
        last = i;
      }
    const int n_taps = max(0, last - first + 1);
    lo[e] = n_taps ? first : 0;
    cnt[e] = n_taps;
    cen[e] = c;
    rn[e] = r;
    atomicMax(nt_max, n_taps);
  }

  // second step, unrolled instances (nt <= VIEW_TAPS): the window of nt
  // taps holding the nonzero ones, inside [0, n_src), and its weights
  template <typename T>
  __device__ void pad(int e, int nt, float inv, int n_src) {
    const int first = lo[e], n_taps = cnt[e];
    const int start = n_taps ? min(first, n_src - nt) : 0;
    ws[e] = start;
    for (int k = 0; k < nt; ++k) {
      const int i = start + k;
      w[k * n + e] = (i >= first && i < first + n_taps) ? tap_weight<T>(cen[e], i, inv, rn[e]) : 0.0f;
    }
  }
};

// elements of T in a 16-byte chunk
template <typename T>
__host__ __device__ constexpr int view_chunk() {
  return 16 / (int)sizeof(T);
}

// shared-memory layout: the two tap tables, four block scalars, then t
// (VIEW_ROWS rows of at most W + one chunk, from a chunk boundary)
__host__ __device__ inline size_t table_bytes(int n) {
  return (size_t)n * (VIEW_TAPS + 6) * 4;
}

__host__ __device__ inline size_t t_offset(int out_size) {
  return (table_bytes(VIEW_ROWS) + table_bytes(out_size) + 16 + 15) / 16 * 16;
}

template <typename T>
size_t view_smem(int W, int out_size) {
  constexpr int CH = view_chunk<T>();
  return t_offset(out_size) + (size_t)VIEW_ROWS * ((W + CH - 1) / CH + 1) * CH * sizeof(T);
}

// a 16-byte chunk of CH source pixels at x (f32); VEC: one 16-byte load,
// else one load a pixel, pixels past the row (avail of them) read as 0
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const T* x, int avail, float (&v)[view_chunk<T>()]) {
  constexpr int CH = view_chunk<T>();
  if constexpr (VEC) {
    lnv_unpack(__ldg(reinterpret_cast<const uint4*>(x)), v);
  } else {
#pragma unroll
    for (int e = 0; e < CH; ++e) v[e] = e < avail ? to_f(x[e]) : 0.0f;
  }
}

// CH f32 values rounded to T, one 16-byte store
__device__ __forceinline__ void store_chunk(float* t, const float (&v)[4]) {
  *reinterpret_cast<float4*>(t) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_chunk(bf16* t, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(t) = make_uint4(w[0], w[1], w[2], w[3]);
}

// calls f(std::integral_constant<int, n>) for n in [N, VIEW_TAPS], or
// f(std::integral_constant<int, -1>) (the general instance) past it
template <int N, typename F>
__device__ __forceinline__ void with_taps(int n, F&& f) {
  if constexpr (N > VIEW_TAPS) {
    f(std::integral_constant<int, -1>());
  } else {
    if (n == N)
      f(std::integral_constant<int, N>());
    else
      with_taps<N + 1>(n, f);
  }
}

// pass 1: t[r, x0 + CH * ch + e] = T(sum over the row's taps of w * x)
// for the band's rv rows and nch chunks; NT taps a row (-1: each row's own).
// A thread takes U items at a time, their loads issued before the sums.
template <typename T, bool VEC, int NT>
__device__ __forceinline__ void rows_pass(const T* __restrict__ x_c, int W, const TapTable& rt,
                                          float inv_y, int rv, int x0, int nch, int ts,
                                          T* __restrict__ t_s) {
  constexpr int CH = view_chunk<T>();
  constexpr int U = (VEC && NT >= 0) ? 2 : 1;
  const int items = rv * nch;
  for (int it0 = threadIdx.x; it0 < items; it0 += U * blockDim.x) {
    int r[U], col[U];
    bool live[U];
    float acc[U][CH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = min(it0 + u * (int)blockDim.x, items - 1);
      live[u] = it0 + u * (int)blockDim.x < items;
      r[u] = it / nch;
      col[u] = x0 + (it - r[u] * nch) * CH;
#pragma unroll
      for (int e = 0; e < CH; ++e) acc[u][e] = 0.0f;
    }
    if constexpr (NT >= 0) {
      float v[U][NT > 0 ? NT : 1][CH];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // a chunk past the row (never read by pass 2) loads the row's last
        // 16 bytes; the narrow loads skip its pixels past the row
        const T* src = x_c + (long long)rt.ws[r[u]] * W + (VEC ? min(col[u], W - CH) : col[u]);
#pragma unroll
        for (int k = 0; k < NT; ++k) load_chunk<T, VEC>(src + (long long)k * W, W - col[u], v[u][k]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          const float wt = rt.w[k * VIEW_ROWS + r[u]];
#pragma unroll
          for (int e = 0; e < CH; ++e) acc[u][e] = fmaf(wt, v[u][k][e], acc[u][e]);
        }
    } else {
      const int first = rt.lo[r[0]], n_taps = rt.cnt[r[0]];
      const float cen = rt.cen[r[0]], rn = rt.rn[r[0]];
      if (col[0] < W)
        for (int k = 0; k < n_taps; ++k) {
          const float wt = tap_weight<T>(cen, first + k, inv_y, rn);
          float v[CH];
          load_chunk<T, VEC>(x_c + (long long)(first + k) * W + col[0], W - col[0], v);
#pragma unroll
          for (int e = 0; e < CH; ++e) acc[0][e] = fmaf(wt, v[e], acc[0][e]);
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (live[u]) store_chunk(t_s + r[u] * ts + (col[u] - x0), acc[u]);
  }
}

// pass 2: view[r, q] = sum over the column's taps of t[r, w] * w, stored at
// out + rt.off[r] + ct.off[q]; NT taps a column (-1: each column's own).
// The rows' loads are issued before their sums (rows past rv reload the
// last row and store nothing).
template <typename T, typename O, int NT>
__device__ __forceinline__ void cols_pass(const T* __restrict__ t_s, int ts, int x0,
                                          const TapTable& rt, const TapTable& ct, float inv_x,
                                          int rv, int out_size, O* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int n_groups = (rv + VIEW_RG - 1) / VIEW_RG;
  const int items = (out_size + 31) / 32 * n_groups;
  for (int it = warp; it < items; it += n_warps) {
    const int q = it / n_groups * 32 + lane, r0 = it % n_groups * VIEW_RG;
    const bool live = q < out_size;
    const int qq = live ? q : out_size - 1;
    float acc[VIEW_RG];
    if constexpr (NT >= 0) {
      float wt[NT > 0 ? NT : 1];
#pragma unroll
      for (int k = 0; k < NT; ++k) wt[k] = ct.w[k * out_size + qq];
      const T* tq = t_s + (ct.ws[qq] - x0);
      float tv[VIEW_RG][NT > 0 ? NT : 1];
#pragma unroll
      for (int rr = 0; rr < VIEW_RG; ++rr)
#pragma unroll
        for (int k = 0; k < NT; ++k) tv[rr][k] = to_f(tq[min(r0 + rr, rv - 1) * ts + k]);
#pragma unroll
      for (int rr = 0; rr < VIEW_RG; ++rr) {
        acc[rr] = 0.0f;
#pragma unroll
        for (int k = 0; k < NT; ++k) acc[rr] = fmaf(tv[rr][k], wt[k], acc[rr]);
      }
    } else {
      const int first = ct.lo[qq], n_taps = ct.cnt[qq];
      const float cen = ct.cen[qq], rn = ct.rn[qq];
      const T* tq = t_s + (first - x0);
#pragma unroll
      for (int rr = 0; rr < VIEW_RG; ++rr) {
        const int r = min(r0 + rr, rv - 1);
        acc[rr] = 0.0f;
        for (int k = 0; k < n_taps; ++k)
          acc[rr] = fmaf(to_f(tq[r * ts + k]), tap_weight<T>(cen, first + k, inv_x, rn), acc[rr]);
      }
    }
    O* oq = out + ct.off[qq];
#pragma unroll
    for (int rr = 0; rr < VIEW_RG; ++rr)
      if (live && r0 + rr < rv) store_view(oq + rt.off[r0 + rr], acc[rr]);
  }
}

// PATCH: the patch-row layout, patches of p x p pixels
template <typename T, typename O, bool VEC, bool PATCH>
__global__ void __launch_bounds__(VIEW_THREADS, VIEW_BLOCKS_PER_SM) view_kernel(
    const T* __restrict__ img,      // [B, C, H, W]
    const float* __restrict__ cy,   // [B, V, out]
    const float* __restrict__ cx,   // [B, V, out]
    const float* __restrict__ inv,  // [B, V, 2]
    O* __restrict__ out,            // [B, V, C, out, out], or PATCH: [B*V*G*G, C*p*p]
    int C, int H, int W, int V, int out_size, int p) {
  constexpr int CH = view_chunk<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  TapTable rt(sp, VIEW_ROWS), ct(sp, out_size);
  int* scal = reinterpret_cast<int*>(sp);  // max row taps, max column taps, min / max column
  T* t_s = reinterpret_cast<T*>(smem_raw + t_offset(out_size));

  const int n_bands = (out_size + VIEW_ROWS - 1) / VIEW_ROWS;
  const int band = (int)(blockIdx.x % n_bands);
  const long long bv = blockIdx.x / n_bands;
  const int b = (int)(bv / V);
  const int o0 = band * VIEW_ROWS, rv = min(VIEW_ROWS, out_size - o0);
  const float inv_y = inv[bv * 2 + 0];
  const float inv_x = inv[bv * 2 + 1];
  const float* cy_v = cy + bv * out_size;
  const float* cx_v = cx + bv * out_size;
  // the channel's base: NCHW plane (bv, c), or the crop's patch rows at
  // channel c; the offsets of a row and a column from it
  const int G = PATCH ? out_size / p : 0;
  const long long cpp = PATCH ? (long long)C * p * p : 0;
  auto row_off = [&](int o) { return PATCH ? (int)((o / p) * G * cpp + (o % p) * p) : o * out_size; };
  auto col_off = [&](int q) { return PATCH ? (int)((q / p) * cpp + q % p) : q; };

  // the tap tables, once for all channels
  if (threadIdx.x == 0) {
    scal[0] = scal[1] = 0;
    scal[2] = INT_MAX;
    scal[3] = 0;
  }
  __syncthreads();
  if (threadIdx.x < rv) {
    rt.build<T>(threadIdx.x, cy_v[o0 + threadIdx.x], inv_y, H, &scal[0]);
    rt.off[threadIdx.x] = row_off(o0 + threadIdx.x);
  }
  for (int q = threadIdx.x; q < out_size; q += blockDim.x) {
    ct.build<T>(q, cx_v[q], inv_x, W, &scal[1]);
    ct.off[q] = col_off(q);
  }
  __syncthreads();
  const int nr = scal[0], nc = scal[1];
  if (nr <= VIEW_TAPS && threadIdx.x < rv) rt.pad<T>(threadIdx.x, nr, inv_y, H);
  for (int q = threadIdx.x; q < out_size; q += blockDim.x) {
    if (nc <= VIEW_TAPS) {
      ct.pad<T>(q, nc, inv_x, W);
      if (nc > 0) {
        atomicMin(&scal[2], ct.ws[q]);
        atomicMax(&scal[3], ct.ws[q] + nc);
      }
    } else if (ct.cnt[q] > 0) {
      atomicMin(&scal[2], ct.lo[q]);
      atomicMax(&scal[3], ct.lo[q] + ct.cnt[q]);
    }
  }
  __syncthreads();
  // the source columns the view reads, [x0, x0 + CH * nch)
  const int x_lo = scal[2] <= scal[3] ? scal[2] : 0;
  const int x0 = x_lo / CH * CH;
  const int nch = (max(scal[3], x_lo) - x0 + CH - 1) / CH;
  const int ts = CH * nch;

  for (int c = 0; c < C; ++c) {
    const T* x_c = img + ((long long)b * C + c) * H * W;
    O* base = PATCH ? out + bv * G * G * cpp + (long long)c * p * p
                    : out + (bv * C + c) * out_size * out_size;
    with_taps<0>(nr, [&](auto nt) {
      rows_pass<T, VEC, decltype(nt)::value>(x_c, W, rt, inv_y, rv, x0, nch, ts, t_s);
    });
    __syncthreads();
    with_taps<0>(nc, [&](auto nt) {
      cols_pass<T, O, decltype(nt)::value>(t_s, ts, x0, rt, ct, inv_x, rv, out_size, base);
    });
    __syncthreads();
  }
}

template <typename T, typename O, bool PATCH>
int launch_view(const void* img, const void* cy, const void* cx, const void* inv, void* out,
                int B, int C, int H, int W, int V, int out_size, int p, cudaStream_t stream) {
  const long long blocks = (long long)B * V * ((out_size + VIEW_ROWS - 1) / VIEW_ROWS);
  const size_t smem = view_smem<T>(W, out_size);
  const bool vec = (uintptr_t)img % 16 == 0 && W % view_chunk<T>() == 0;
  auto kernel = vec ? view_kernel<T, O, true, PATCH> : view_kernel<T, O, false, PATCH>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, VIEW_THREADS, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(cy), static_cast<const float*>(cx),
      static_cast<const float*>(inv), static_cast<O*>(out), C, H, W, V, out_size, p);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 bf16 images -> int8 pixels, 1 bf16 -> bf16 views, 2 f32 -> f32
// views; patch > 0 (mode 0 only, out_size a multiple of it): the int8
// pixels as patch rows [B*V*G*G, C*patch*patch], G = out_size / patch
extern "C" int jcf_view(const void* img, const void* cy, const void* cx, const void* inv,
                        void* out, int B, int C, int H, int W, int V, int out_size, int mode,
                        int patch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_size < 1 || H < 1 || W < 1 || patch < 0 || (patch > 0 && (mode != 0 || out_size % patch)))
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0:
      return patch ? launch_view<bf16, int8_t, true>(img, cy, cx, inv, out, B, C, H, W, V,
                                                     out_size, patch, st)
                   : launch_view<bf16, int8_t, false>(img, cy, cx, inv, out, B, C, H, W, V,
                                                      out_size, 0, st);
    case 1:
      return launch_view<bf16, bf16, false>(img, cy, cx, inv, out, B, C, H, W, V, out_size, 0, st);
    case 2:
      return launch_view<float, float, false>(img, cy, cx, inv, out, B, C, H, W, V, out_size, 0,
                                              st);
    default: return (int)cudaErrorInvalidValue;
  }
}
