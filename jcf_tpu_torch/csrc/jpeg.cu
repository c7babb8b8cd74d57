// JPEG decode on the card after the host's Huffman decoding
// (csrc/jpeg_entropy.cpp), then the short-side resize and center crop of
// the throughput path's host decoder.
//
// Replaces jcf_tpu/native/jcfnative.cpp (libjpeg-turbo + a std::thread
// pool, host code, not a TPU kernel) and PIL's decode in
// jcf_tpu/data/datasets.py. No TPU kernel decodes images: these kernels
// stand in for libjpeg-turbo's host code, integer for integer.
//
// Each kernel is one launch a decode call over every image of the call,
// from a descriptor table in device memory (an entry a component for the
// IDCT, an image for the others), sorted by each entry's first CTA: a CTA
// finds its entry by a binary search (find_entry).
//
// jpeg_idct: dequantization + the IDCT of every component, 8 lanes per
// 8 x 8 coefficient block, templated on the output block size (8: the
// islow IDCT of jidctint.c; 4, 2, 1: the reduced IDCTs of jidctred.c), as
// libjpeg-turbo's x86 SIMD code computes them (16-bit dequantization and
// sums where the SIMD code adds 16-bit lanes, 32-bit products, int16
// saturation between the passes, a clamp to 0..255 at the end; the 1 x 1
// size in C, through libjpeg's RANGE_MASK table). data/jpeg.py states the
// arithmetic; idct_plain there is its plain version, bit for bit.
//
// jpeg_upsample_color: each component's sample by its upsampling method
// (box replication, or jdsample.c's triangle "fancy" h2v1, h1v2, h2v2 with
// edge rows and columns replicated), then jdcolor.c's fixed-point YCbCr ->
// RGB (SCALEBITS 16); a grayscale image keeps its one channel. Its plain
// version is upsample_color_plain.
//
// Everything is integer arithmetic (unsigned where a sum may wrap), so the
// card's pixels equal the plain versions' and libjpeg-turbo's bit for bit.
//
// What bounds them: bytes. The IDCT reads 128 bytes of coefficients and
// writes S^2 samples a block (S its size); the upsampler reads each plane
// sample about once and writes 3 bytes a pixel; the resize reads its
// source and writes 3 bytes an output pixel. The IDCT's lanes: lane r of a
// block's 8 loads its row r as one 16-byte load (a warp reads 512
// contiguous bytes), the column pass runs after a transpose by shuffles
// within the 8 lanes, the block's AC-zero test is a vote of the 8, and
// lane r stores output row r as one 8-, 4- or 2-byte word. The upsampler:
// a CTA a band of one image's output rows (one row in column segments
// where a whole row does not fit its shared memory; the band short enough
// that one large image alone still makes a few CTAs a multiprocessor,
// data/jpeg.py: upsample_layout) stages the plane rows
// the band reads, the v2 methods' near and far rows and the h2 methods'
// side columns included, with 16-byte loads; each thread makes
// UP_PIXELS consecutive pixels of a row, a plane at a time (its rows'
// offsets once, then the columns, with no division a sample), into a
// shared copy of the band's output, which the CTA stores as 16-byte words
// (the ragged ends byte by byte).
// A single image's kernels are a few microseconds of bytes, under a
// launch's own cost, so a 128-image decode_batch is one launch each whose
// bound a kernel can approach.
//
// resize_crop: the short side to resize_to, then the centered out x out
// crop, with the C++ arithmetic (jcfnative.cpp:resize_rgb): window
// [floor(c - support), ceil(c + support)] clamped, weights max(0, 1 -
// |i - c| / support), each times 1 / sum, every tap added by fmaf in
// ascending order from 0, the horizontal pass first, then
// uint8(clamp(acc + 0.5, 0, 255)). A CTA a band of one image's crop rows
// (and a span of its columns): the band's column and row weights (weight *
// 1 / sum a tap) once into shared memory; then over the band's source rows
// in ascending chunks, the horizontal pass of a chunk into shared memory
// (f32) and the vertical pass's taps from there into accumulators held in
// registers, so the sums keep their order; uint8 straight into the
// batch's [N, out, out, 3]. A grayscale source has one channel, which the
// passes read for R, G and B.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the upsample's and the resize's shared memory (dynamic)
extern __shared__ __align__(16) uint8_t jpeg_smem[];

namespace {

// the triangle-filter window and weight of output coordinate o, as
// jcfnative.cpp:resize_rgb computes them
struct Window {
  float center, support;
  int lo, hi;
};

__device__ __forceinline__ Window window(int o, float scale, int in_size) {
  Window w;
  w.center = (o + 0.5f) * scale - 0.5f;
  w.support = fmaxf(scale, 1.0f);
  w.lo = max((int)floorf(w.center - w.support), 0);
  w.hi = min((int)ceilf(w.center + w.support), in_size - 1);
  return w;
}

__device__ __forceinline__ float weight(const Window& w, int i) {
  return fmaxf(0.0f, 1.0f - fabsf(i - w.center) / w.support);
}

__device__ __forceinline__ float inv_sum(const Window& w) {
  float sum = 0.0f;
  for (int i = w.lo; i <= w.hi; ++i) sum += weight(w, i);
  return sum > 0.0f ? 1.0f / sum : 0.0f;
}

// the last of n descriptors (fields int64 each, sorted by their first
// field, the first CTA) whose first CTA is at most b
__device__ __forceinline__ int find_entry(const long long* desc, int fields, int n, long long b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[(long long)mid * fields] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// jpeg_idct
// ---------------------------------------------------------------------------

typedef unsigned int u32;

__device__ __forceinline__ int w16(u32 x) { return (int)(int16_t)(uint16_t)(x & 0xFFFFu); }
__device__ __forceinline__ int s16(int x) { return min(max(x, -32768), 32767); }
// paddd of the rounding term, then psrad
__device__ __forceinline__ int descale(u32 x, int n) { return ((int)(x + (1u << (n - 1)))) >> n; }

constexpr int CONST_BITS = 13, PASS1_BITS = 2;

// one pass of the islow IDCT over x[0..7] (16-bit values)
__device__ __forceinline__ void islow_1d(const int* x, int shift, int* out) {
  const u32 z2 = (u32)x[2], z3 = (u32)x[6];
  const u32 tmp3 = z2 * (u32)(4433 + 6270) + z3 * 4433u;
  const u32 tmp2 = z2 * 4433u + z3 * (u32)(4433 - 15137);
  const u32 tmp0 = (u32)w16((u32)x[0] + (u32)x[4]) << CONST_BITS;
  const u32 tmp1 = (u32)w16((u32)x[0] - (u32)x[4]) << CONST_BITS;
  const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const u32 i7 = (u32)x[7], i5 = (u32)x[5], i3 = (u32)x[3], i1 = (u32)x[1];
  const u32 s73 = (u32)w16(i7 + i3), s51 = (u32)w16(i5 + i1);
  const u32 z3b = s73 * (u32)(9633 - 16069) + s51 * 9633u;
  const u32 z4b = s73 * 9633u + s51 * (u32)(9633 - 3196);
  const u32 t0 = i7 * (u32)(2446 - 7373) + i1 * (u32)(-7373) + z3b;
  const u32 t3 = i7 * (u32)(-7373) + i1 * (u32)(12299 - 7373) + z4b;
  const u32 t1 = i5 * (u32)(16819 - 20995) + i3 * (u32)(-20995) + z4b;
  const u32 t2 = i5 * (u32)(-20995) + i3 * (u32)(25172 - 20995) + z3b;
  out[0] = descale(tmp10 + t3, shift);
  out[1] = descale(tmp11 + t2, shift);
  out[2] = descale(tmp12 + t1, shift);
  out[3] = descale(tmp13 + t0, shift);
  out[4] = descale(tmp13 - t0, shift);
  out[5] = descale(tmp12 - t1, shift);
  out[6] = descale(tmp11 - t2, shift);
  out[7] = descale(tmp10 - t3, shift);
}

// one pass of the 4 x 4 IDCT (input 4 unused)
__device__ __forceinline__ void red4_1d(const int* x, int shift, int* out) {
  const u32 tmp0 = (u32)x[0] << (CONST_BITS + 1);
  const u32 tmp2 = (u32)x[2] * 15137u + (u32)x[6] * (u32)(-6270);
  const u32 tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
  const u32 z1 = (u32)x[7], z2 = (u32)x[5], z3 = (u32)x[3], z4 = (u32)x[1];
  const u32 t0 = z1 * (u32)(-1730) + z2 * 11893u + z3 * (u32)(-17799) + z4 * 8697u;
  const u32 t2 = z1 * (u32)(-4176) + z2 * (u32)(-4926) + z3 * 7373u + z4 * 20995u;
  out[0] = descale(tmp10 + t2, shift);
  out[1] = descale(tmp12 + t0, shift);
  out[2] = descale(tmp12 - t0, shift);
  out[3] = descale(tmp10 - t2, shift);
}

// one pass of the 2 x 2 IDCT: the (shifted) DC term and the odd inputs
__device__ __forceinline__ void red2_1d(u32 dc, const int* x, int shift, int* out) {
  const u32 t0 = (u32)x[7] * (u32)(-5906) + (u32)x[5] * 6967u + (u32)x[3] * (u32)(-10426) +
                 (u32)x[1] * 29692u;
  out[0] = descale(dc + t0, shift);
  out[1] = descale(dc - t0, shift);
}

__device__ __forceinline__ uint8_t clamp_sample(int v) {
  return (uint8_t)(min(max(v, -128), 127) + 128);
}

// the batched IDCT: a descriptor a component (int64 fields, device memory:
// a decode_batch of 128 images holds 384 of them), sorted by cta0; each
// component's blocks padded to whole CTAs, so a CTA serves one component
enum { D_CTA0, D_BLK0, D_BW, D_BH, D_SIZE, D_TABLE, D_OFFSET, D_STRIDE, D_FIELDS };
constexpr int IDCT_THREADS = 256;
constexpr int IDCT_BLOCKS = IDCT_THREADS / 8;  // 8 lanes an 8 x 8 block, 4 blocks a warp
constexpr unsigned FULL = 0xffffffffu;

// an 8 x 8 transpose across the 8 lanes of a group (lane r of the group
// holds row r in x[0..7] before, column r after): at each level b the
// entries (r, i) and (r ^ b, i ^ b) whose bit b differs trade places,
// one shuffle a pair of them; the three levels move (r, i) to (i, r)
__device__ __forceinline__ void transpose8(int (&x)[8], int r) {
#pragma unroll
  for (int b = 4; b >= 1; b >>= 1) {
    const bool up = r & b;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & b) continue;
      const int got = __shfl_xor_sync(FULL, up ? x[i] : x[i | b], b);
      if (up)
        x[i] = got;
      else
        x[i | b] = got;
    }
  }
}

// one block's S x S output by its group of 8 lanes (r: the lane's row):
// lane r loads coefficient row r (16 bytes), dequantizes it with the
// table in shared memory, the group transposes, lane c runs pass 1 on
// column c, the group transposes back, lane r < S runs pass 2 on row r
// and stores its S samples as one word. Dead lanes (past the component's
// last block) compute on zeros, so every shuffle and the vote see the
// whole warp, and store nothing.
template <int S>
__device__ __forceinline__ void idct_block(const int16_t* __restrict__ c, const int* q, bool live,
                                           int lane, uint8_t* o, long long stride) {
  const int r = lane & 7;
  int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(c) + r);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = (int)(int16_t)(words[k] & 0xFFFF);
      v[2 * k + 1] = words[k] >> 16;
    }
  }
  if (S == 1) {  // C: DESCALE(dc * q, 3) through the RANGE_MASK table
    if (live && r == 0) {
      const int i = descale((u32)(v[0] * (int)(int16_t)q[0]), 3) & 1023;
      o[0] = (uint8_t)min(max((i < 512 ? i : i - 1024) + 128, 0), 255);
    }
    return;
  }
  // the SIMD code's zero test: are the AC rows pass 1 reads all zero?
  bool nz = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) nz |= v[k] != 0;
  const unsigned votes = __ballot_sync(FULL, nz && r != 0 && !(S == 4 && r == 4));
  const bool ac_zero = ((votes >> (lane & 24)) & 0xFFu) == 0;
  int x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = w16((u32)v[k] * (u32)q[8 * r + k]);
  transpose8(x, r);  // x: column r
  int y[8];
  if (S == 8) {
    islow_1d(x, CONST_BITS - PASS1_BITS, y);
  } else if (S == 4) {
    red4_1d(x, CONST_BITS - PASS1_BITS + 1, y);
  } else {
    red2_1d((u32)x[0] << (CONST_BITS + 2), x, CONST_BITS - PASS1_BITS + 2, y);
  }
  // 2 x 2: column 0's pass-1 outputs, kept in 32 bits for pass 2's DC term
  const int dc0 = S == 2 ? __shfl_sync(FULL, y[0], lane & 24) : 0;
  const int dc1 = S == 2 ? __shfl_sync(FULL, y[1], lane & 24) : 0;
  int ws[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    ws[k] = k >= S ? 0 : (S != 2 && ac_zero) ? w16((u32)x[0] << PASS1_BITS) : s16(y[k]);
  transpose8(ws, r);  // ws: pass 1's row r
  if (!live || r >= S) return;
  if (S == 8) {
    islow_1d(ws, CONST_BITS + PASS1_BITS + 3, y);
  } else if (S == 4) {
    red4_1d(ws, CONST_BITS + PASS1_BITS + 3 + 1, y);
  } else {
    red2_1d((u32)(r == 0 ? dc0 : dc1) << (CONST_BITS + 2), ws, CONST_BITS + PASS1_BITS + 3 + 2, y);
  }
  u32 word[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < S; ++k) word[k >> 2] |= (u32)clamp_sample(y[k]) << (8 * (k & 3));
  uint8_t* row = o + r * stride;
  if (S == 8)
    *reinterpret_cast<uint2*>(row) = make_uint2(word[0], word[1]);
  else if (S == 4)
    *reinterpret_cast<u32*>(row) = word[0];
  else
    *reinterpret_cast<uint16_t*>(row) = (uint16_t)word[0];
}

// one launch for every component of every image of a decode call: CTA b
// finds its component (the last descriptor with cta0 <= b), stages that
// component's table in shared memory and dispatches on its IDCT size,
// uniform over the CTA
__global__ void __launch_bounds__(IDCT_THREADS)
    idct_batch_kernel(const int16_t* __restrict__ coefs, const int* __restrict__ quant,
                      const long long* __restrict__ desc, int n_desc, uint8_t* __restrict__ out) {
  __shared__ int q[64];
  __shared__ int comp;
  const long long b = blockIdx.x;
  if (threadIdx.x == 0) comp = find_entry(desc, D_FIELDS, n_desc, b);
  __syncthreads();
  const long long* d = desc + (long long)comp * D_FIELDS;
  const long long bw = d[D_BW], stride = d[D_STRIDE];
  const int size = (int)d[D_SIZE];
  if (threadIdx.x < 64) q[threadIdx.x] = quant[d[D_TABLE] * 64 + threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long j = (b - d[D_CTA0]) * IDCT_BLOCKS + (threadIdx.x >> 3);  // the component's block
  const bool live = j < bw * d[D_BH];
  const int16_t* c = coefs + (d[D_BLK0] + (live ? j : 0)) * 64;
  uint8_t* o = out + d[D_OFFSET] + (j / bw) * size * stride + (j % bw) * size;
  switch (size) {
    case 8: idct_block<8>(c, q, live, lane, o, stride); break;
    case 4: idct_block<4>(c, q, live, lane, o, stride); break;
    case 2: idct_block<2>(c, q, live, lane, o, stride); break;
    default: idct_block<1>(c, q, live, lane, o, stride); break;
  }
}

// ---------------------------------------------------------------------------
// jpeg_upsample_color
// ---------------------------------------------------------------------------

// a descriptor an image (int64 fields): its first CTA, its output's byte
// offset, width, height, components (1 or 3) and YCbCr flag, the tile a
// CTA takes (rows output rows; cols columns a step: out_w where whole rows
// fit, else rows is 1), then per plane its byte offset from the planes'
// base, row stride, width, height, factors and method (0 box, 1 h2v1, 2
// h1v2, 3 h2v2)
enum { U_CTA0, U_OUT, U_W, U_H, U_N, U_YCC, U_ROWS, U_COLS, U_PLANE, U_FIELDS = U_PLANE + 21 };
enum { P_OFF, P_STRIDE, P_W, P_H, P_FX, P_FY, P_METHOD, P_FIELDS };
constexpr int UP_THREADS = 256;
constexpr int UP_PIXELS = 8;        // consecutive pixels a thread makes
constexpr int UP_SMEM = 40 * 1024;  // a tile's staged output and planes (data/jpeg.py: UP_SMEM)

// the rows and the row pitch of a plane's staging for a tile of rows x
// cols output pixels, at most (data/jpeg.py: _tile_bytes): the rows y /
// fy of the tile's rows (and the v2 methods' rows either side), the
// columns x / fx (and the h2 methods' side columns), each row from the
// 16-byte word that holds its first column
__device__ __forceinline__ int staged_rows(int rows, int fy, int method) {
  return (rows - 1) / fy + 2 + (method >= 2 ? 2 : 0);
}

__device__ __forceinline__ int staged_pitch(int cols, int fx, int method) {
  return ((cols - 1) / fx + 2 + ((method & 1) ? 2 : 0) + 30) / 16 * 16;
}

// a plane and its rows r_lo.. (columns c_lo..) staged in shared memory:
// row r at (r - r_lo) * pitch, from the 16-byte word holding its column
// c_lo, so column c sits at row(r) + c with row(r) the row's offset less
// c_lo plus its address of c_lo mod 16
struct Staged {
  const uint8_t* g;  // the plane in device memory
  uint8_t* s;
  int stride, width, height, fx, fy, method, pitch, r_lo, c_lo;

  __device__ __forceinline__ int row(int r) const {
    const unsigned shift = ((unsigned)(uintptr_t)g + (unsigned)r * (unsigned)stride + c_lo) & 15u;
    return (r - r_lo) * pitch + (int)shift - c_lo;
  }
};

// plane p's samples for output pixels x .. x + count - 1 of row y into v,
// as jdsample.c computes them: the plane rows once, then each pixel's
// columns (box replication counts its column up every fx pixels)
__device__ __forceinline__ void plane_samples(const Staged& p, int x, int y, int count,
                                              int (&v)[UP_PIXELS]) {
  const uint8_t* s = p.s;
  const int w1 = p.width - 1;
  const int near = min(y / p.fy, p.height - 1), rn = p.row(near);
  if (p.method == 0) {
    int c = x / p.fx, rem = x - c * p.fx;
#pragma unroll
    for (int q = 0; q < UP_PIXELS; ++q) {
      if (q < count) v[q] = s[rn + min(c, w1)];
      if (++rem == p.fx) {
        rem = 0;
        ++c;
      }
    }
    return;
  }
  if (p.method == 1) {  // h2v1: (3 nearer + further + 1 or 2) >> 2
#pragma unroll
    for (int q = 0; q < UP_PIXELS; ++q) {
      const int xx = x + q, j = min(xx >> 1, w1);
      const int side = min(max((xx & 1) ? j + 1 : j - 1, 0), w1);
      if (q < count) v[q] = (s[rn + j] * 3 + s[rn + side] + ((xx & 1) ? 2 : 1)) >> 2;
    }
    return;
  }
  const int rf = p.row(min(max((y & 1) ? near + 1 : near - 1, 0), p.height - 1));
  if (p.method == 2) {  // h1v2
    const int bias = (y & 1) ? 2 : 1;
#pragma unroll
    for (int q = 0; q < UP_PIXELS; ++q) {
      const int xs = min(x + q, w1);
      if (q < count) v[q] = (s[rn + xs] * 3 + s[rf + xs] + bias) >> 2;
    }
    return;
  }
  // h2v2 on the column sums: (3 this + that + 8 or 7) >> 4
#pragma unroll
  for (int q = 0; q < UP_PIXELS; ++q) {
    if (q >= count) break;
    const int xx = x + q, j = min(xx >> 1, w1);
    const int side = min(max((xx & 1) ? j + 1 : j - 1, 0), w1);
    const int this_sum = s[rn + j] * 3 + s[rf + j], that_sum = s[rn + side] * 3 + s[rf + side];
    v[q] = (this_sum * 3 + that_sum + ((xx & 1) ? 7 : 8)) >> 4;
  }
}

__device__ __forceinline__ uint8_t clamp255(int v) { return (uint8_t)min(max(v, 0), 255); }

// bytes [dst, dst + len) from src, which sits at the same address mod 16
// in shared memory: whole 16-byte words by every thread, the ragged ends
// byte by byte
__device__ __forceinline__ void store_span(uint8_t* dst, const uint8_t* src, long long len,
                                           int threads) {
  const uintptr_t g0 = (uintptr_t)dst, g1 = g0 + (uintptr_t)len;
  const uintptr_t a0 = (g0 + 15) & ~(uintptr_t)15, a1 = g1 & ~(uintptr_t)15;
  for (uintptr_t a = a0 + 16 * (uintptr_t)threadIdx.x; a < a1; a += 16 * (uintptr_t)threads)
    *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(src + (a - g0));
  const uintptr_t head = a0 < g1 ? a0 : g1, tail = a1 > head ? a1 : head;
  const uintptr_t mine = g0 + threadIdx.x;
  if (threadIdx.x < 16 && mine < head) *reinterpret_cast<uint8_t*>(mine) = src[mine - g0];
  const uintptr_t last = tail + (threadIdx.x - 16);
  if (threadIdx.x >= 16 && threadIdx.x < 32 && last < g1)
    *reinterpret_cast<uint8_t*>(last) = src[last - g0];
}

// CTA b: rows [ya, yb) of its image (the image's CTAs in order), in
// column segments of cols; per segment each plane's rows and columns that
// the tile reads are staged, each thread makes UP_PIXELS pixels of a row
// into the staged output, and the tile (whole rows, or one row's segment:
// contiguous either way) is stored
__global__ void __launch_bounds__(UP_THREADS)
    upsample_batch_kernel(const uint8_t* __restrict__ planes, const long long* __restrict__ desc,
                          int n_desc, uint8_t* __restrict__ out) {
  __shared__ int image;
  if (threadIdx.x == 0) image = find_entry(desc, U_FIELDS, n_desc, blockIdx.x);
  __syncthreads();
  const long long* d = desc + (long long)image * U_FIELDS;
  const int out_w = (int)d[U_W], out_h = (int)d[U_H], n = (int)d[U_N], ycc = (int)d[U_YCC];
  const int rows = (int)d[U_ROWS], cols = (int)d[U_COLS];
  const int ya = (int)(blockIdx.x - d[U_CTA0]) * rows, yb = min(ya + rows, out_h);
  Staged st[3];
  int at = (rows * cols * n + 30) / 16 * 16;  // the staged output, then each plane's rows
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i >= n) break;
    const long long* q = d + U_PLANE + i * P_FIELDS;
    Staged& p = st[i];
    p.g = planes + q[P_OFF];
    p.stride = (int)q[P_STRIDE];
    p.width = (int)q[P_W];
    p.height = (int)q[P_H];
    p.fx = (int)q[P_FX];
    p.fy = (int)q[P_FY];
    p.method = (int)q[P_METHOD];
    p.pitch = staged_pitch(cols, p.fx, p.method);
    p.s = jpeg_smem + at;
    at += staged_rows(rows, p.fy, p.method) * p.pitch;
  }
  for (int xa = 0; xa < out_w; xa += cols) {
    const int xb = min(xa + cols, out_w), tw = xb - xa;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i >= n) break;
      Staged& p = st[i];
      const int v2 = p.method >= 2 ? 1 : 0, h2 = p.method & 1;
      p.r_lo = max(min(ya / p.fy, p.height - 1) - v2, 0);
      const int r_hi = min(min((yb - 1) / p.fy, p.height - 1) + v2, p.height - 1);
      p.c_lo = max(min(xa / p.fx, p.width - 1) - h2, 0);
      const int c_hi = min(min((xb - 1) / p.fx, p.width - 1) + h2, p.width - 1);
      const int words = p.pitch / 16, nr = r_hi - p.r_lo + 1;
      for (int k = threadIdx.x; k < nr * words; k += UP_THREADS) {
        const int r = p.r_lo + k / words, w = k % words;
        const uint8_t* row = p.g + (long long)r * p.stride;
        const uintptr_t a = ((uintptr_t)(row + p.c_lo) & ~(uintptr_t)15) + 16 * (uintptr_t)w;
        if (a <= (uintptr_t)(row + c_hi))
          *reinterpret_cast<uint4*>(p.s + (r - p.r_lo) * p.pitch + 16 * w) =
              __ldg(reinterpret_cast<const uint4*>(a));
      }
    }
    __syncthreads();
    uint8_t* dst = out + d[U_OUT] + ((long long)ya * out_w + xa) * n;
    uint8_t* o = jpeg_smem + ((uintptr_t)dst & 15);
    const int groups = (tw + UP_PIXELS - 1) / UP_PIXELS;
    for (int k = threadIdx.x; k < (yb - ya) * groups; k += UP_THREADS) {
      const int r = k / groups, xl = (k - r * groups) * UP_PIXELS;
      const int x = xa + xl, y = ya + r, count = min(UP_PIXELS, tw - xl);
      uint8_t* px = o + (r * tw + xl) * n;
      int c0[UP_PIXELS], c1[UP_PIXELS], c2[UP_PIXELS];
      plane_samples(st[0], x, y, count, c0);
      if (n == 1) {
#pragma unroll
        for (int q = 0; q < UP_PIXELS; ++q)
          if (q < count) px[q] = (uint8_t)c0[q];
        continue;
      }
      plane_samples(st[1], x, y, count, c1);
      plane_samples(st[2], x, y, count, c2);
#pragma unroll
      for (int q = 0; q < UP_PIXELS; ++q) {
        if (q >= count) break;
        uint8_t* o3 = px + 3 * q;
        if (!ycc) {
          o3[0] = (uint8_t)c0[q];
          o3[1] = (uint8_t)c1[q];
          o3[2] = (uint8_t)c2[q];
          continue;
        }
        const int cb = c1[q] - 128, cr = c2[q] - 128;
        o3[0] = clamp255(c0[q] + ((91881 * cr + 32768) >> 16));
        o3[1] = clamp255(c0[q] + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
        o3[2] = clamp255(c0[q] + ((116130 * cb + 32768) >> 16));
      }
    }
    __syncthreads();
    store_span(dst, o, (long long)(yb - ya) * tw * n, UP_THREADS);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// resize_crop
// ---------------------------------------------------------------------------

// a descriptor an image (int64 fields): its first CTA; the source's device
// address, width, height and channels (1 or 3); the crop's corner in the
// resized image; the scales sw / rw and sh / rh (f32 bits); the output's
// byte offset; the tile (rows crop rows a band, cols columns a span, spans
// spans a band); the taps a column's and a row's window hold at most
enum {
  R_CTA0, R_SRC, R_SW, R_SH, R_CH, R_LEFT, R_TOP, R_SX, R_SY, R_OUT, R_ROWS, R_COLS, R_SPANS,
  R_TX, R_TY, R_FIELDS
};
constexpr int RS_THREADS = 256;
constexpr int RS_VALS = 3;                          // (column, channel) values a thread sums a row
constexpr int RS_ROWS = 16;                         // crop rows a band at most
constexpr int RS_SPAN = RS_THREADS * RS_VALS / 3;   // crop columns a span at most
constexpr int RS_WX = 4096, RS_WY = 1024;           // floats of column and row weights
constexpr int RS_TMP = 12288;                       // floats of horizontal-pass rows
constexpr int RS_SMEM = 4 * (RS_WX + RS_WY + RS_TMP + 2 * RS_SPAN + 2 * RS_ROWS);
// (data/decode.py mirrors RS_ROWS, RS_SPAN, RS_WX and RS_WY)

__global__ void __launch_bounds__(RS_THREADS)
    resize_batch_kernel(const long long* __restrict__ desc, int n_desc, int out,
                        uint8_t* __restrict__ dst) {
  __shared__ int image;
  if (threadIdx.x == 0) image = find_entry(desc, R_FIELDS, n_desc, blockIdx.x);
  __syncthreads();
  const long long* d = desc + (long long)image * R_FIELDS;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(d[R_SRC]);
  const int sw = (int)d[R_SW], sh = (int)d[R_SH], ch = (int)d[R_CH];
  const int left = (int)d[R_LEFT], top = (int)d[R_TOP];
  const float sx = __int_as_float((int)d[R_SX]), sy = __int_as_float((int)d[R_SY]);
  const int rows = (int)d[R_ROWS], cols = (int)d[R_COLS], spans = (int)d[R_SPANS];
  const int ty = (int)d[R_TY];
  const int local = (int)(blockIdx.x - d[R_CTA0]);
  const int r0 = local / spans * rows, x0 = local % spans * cols;
  const int nr = min(rows, out - r0), nc = min(cols, out - x0), vals = nc * 3;
  float* wx = reinterpret_cast<float*>(jpeg_smem);  // [taps, nc]
  float* wy = wx + RS_WX;                            // [nr, ty]
  float* tmp = wy + RS_WY;                           // [chunk rows, nc, 3]
  int* lox = reinterpret_cast<int*>(tmp + RS_TMP);   // [nc]
  int* nx = lox + RS_SPAN;
  int* loy = nx + RS_SPAN;  // [nr]
  int* hiy = loy + RS_ROWS;
  for (int x = threadIdx.x; x < nc; x += RS_THREADS) {
    const Window w = window(left + x0 + x, sx, sw);
    const float inv = inv_sum(w);
    lox[x] = w.lo;
    nx[x] = w.hi - w.lo + 1;
    for (int i = w.lo; i <= w.hi; ++i) wx[(i - w.lo) * nc + x] = weight(w, i) * inv;
  }
  for (int r = threadIdx.x; r < nr; r += RS_THREADS) {
    const Window w = window(top + r0 + r, sy, sh);
    const float inv = inv_sum(w);
    loy[r] = w.lo;
    hiy[r] = w.hi;
    for (int i = w.lo; i <= w.hi; ++i) wy[r * ty + i - w.lo] = weight(w, i) * inv;
  }
  __syncthreads();
  int ylo = loy[0], yhi = hiy[0];
  for (int r = 1; r < nr; ++r) {
    ylo = min(ylo, loy[r]);
    yhi = max(yhi, hiy[r]);
  }
  const int chunk = RS_TMP / vals;
  float acc[RS_VALS][RS_ROWS];
#pragma unroll
  for (int j = 0; j < RS_VALS; ++j)
#pragma unroll
    for (int r = 0; r < RS_ROWS; ++r) acc[j][r] = 0.0f;
  for (int s0 = ylo; s0 <= yhi; s0 += chunk) {
    const int cnt = min(chunk, yhi - s0 + 1);
    // the horizontal pass of source rows s0 .. s0 + cnt - 1 for the span
    for (int k = threadIdx.x; k < cnt * nc; k += RS_THREADS) {
      const int x = k % nc;
      const uint8_t* row = src + (long long)(s0 + k / nc) * sw * ch;
      const int lo = lox[x], taps = nx[x];
      float cr = 0.0f, cg = 0.0f, cb = 0.0f;
      for (int t = 0; t < taps; ++t) {
        const float wt = wx[t * nc + x];
        const uint8_t* p = row + (long long)(lo + t) * ch;
        cr = fmaf(wt, (float)p[0], cr);
        cg = fmaf(wt, (float)p[ch == 3 ? 1 : 0], cg);
        cb = fmaf(wt, (float)p[ch == 3 ? 2 : 0], cb);
      }
      float* t3 = tmp + 3 * k;
      t3[0] = cr;
      t3[1] = cg;
      t3[2] = cb;
    }
    __syncthreads();
    // the vertical pass: each band row's taps that fall in the chunk
#pragma unroll
    for (int r = 0; r < RS_ROWS; ++r) {
      if (r >= nr) break;
      const int i0 = max(loy[r], s0), i1 = min(hiy[r], s0 + cnt - 1);
      for (int i = i0; i <= i1; ++i) {
        const float wt = wy[r * ty + i - loy[r]];
        const float* trow = tmp + (i - s0) * vals;
#pragma unroll
        for (int j = 0; j < RS_VALS; ++j) {
          const int v = threadIdx.x + j * RS_THREADS;
          if (v < vals) acc[j][r] = fmaf(wt, trow[v], acc[j][r]);
        }
      }
    }
    __syncthreads();
  }
  uint8_t* o = dst + d[R_OUT] + ((long long)r0 * out + x0) * 3;
#pragma unroll
  for (int r = 0; r < RS_ROWS; ++r) {
    if (r >= nr) break;
#pragma unroll
    for (int j = 0; j < RS_VALS; ++j) {
      const int v = threadIdx.x + j * RS_THREADS;
      if (v < vals)
        o[(long long)r * out * 3 + v] = (uint8_t)fminf(fmaxf(acc[j][r] + 0.5f, 0.0f), 255.0f);
    }
  }
}

}  // namespace

extern "C" {

// coefs int16 [blocks, 64] (natural order), quant int32 [tables, 64],
// desc int64 [n_desc, 8] (cta0, first block, bw, bh, IDCT size 8, 4, 2 or
// 1, table, the plane's byte offset in out and its row stride; sorted by
// cta0, the first at 0, each component's block range padded to whole
// CTAs), all in device memory -> every component's uint8 plane [bh * size,
// bw * size] in out, one launch of ctas CTAs. Offsets and strides must
// keep each stored row word-aligned (16-byte aligned offsets do). Returns
// a cudaError_t.
int jcf_jpeg_idct(const void* coefs, const void* quant, const void* desc, int n_desc,
                  long long ctas, void* out, void* stream) {
  if (n_desc < 1 || ctas < 1 || ctas > 0x7fffffffLL || ((uintptr_t)coefs & 15))
    return (int)cudaErrorInvalidValue;
  idct_batch_kernel<<<(unsigned)ctas, IDCT_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int16_t*>(coefs), static_cast<const int*>(quant),
      static_cast<const long long*>(desc), n_desc, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// planes: the base of the descriptors' plane offsets (the IDCT's packed
// output); desc int64 [n_desc, 29] in device memory (cta0, the output's
// byte offset, out_w, out_h, components, ycc, the tile's rows and cols,
// then per plane its offset, stride, width, height, fx, fy, method;
// sorted by cta0, the first at 0, each image's ceil(out_h / rows) CTAs
// after it; the tile's staging within UP_SMEM bytes) -> each image's uint8
// [out_h, out_w, components] at its offset in out, one launch of ctas
// CTAs. Returns a cudaError_t.
int jcf_jpeg_upsample_color(const void* planes, const void* desc, int n_desc, long long ctas,
                            void* out, void* stream) {
  if (n_desc < 1 || ctas < 1 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  upsample_batch_kernel<<<(unsigned)ctas, UP_THREADS, UP_SMEM, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(planes), static_cast<const long long*>(desc), n_desc,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// desc int64 [n_desc, 15] in device memory (cta0, the source's address,
// sw, sh, channels, left, top, sx and sy as f32 bits, the output's byte
// offset, the tile's rows, cols and spans, the taps a column and a row
// hold at most; sorted by cta0, the first at 0, each image's
// ceil(out / rows) x spans CTAs after it) -> each source uint8 [sh, sw,
// channels] resized (short side to resize_to, the long side to
// resize_to * long / short rounded down) and center-cropped to uint8
// [out, out, 3] at its offset in dst, one launch of ctas CTAs. Returns a
// cudaError_t.
int jcf_resize_crop(const void* desc, int n_desc, long long ctas, int out, void* dst,
                    void* stream) {
  if (n_desc < 1 || ctas < 1 || ctas > 0x7fffffffLL || out < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      resize_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RS_SMEM);
  if (e != cudaSuccess) return (int)e;
  resize_batch_kernel<<<(unsigned)ctas, RS_THREADS, RS_SMEM, (cudaStream_t)stream>>>(
      static_cast<const long long*>(desc), n_desc, out, static_cast<uint8_t*>(dst));
  return (int)cudaGetLastError();
}

}  // extern "C"
