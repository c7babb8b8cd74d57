// JPEG decode on the card after the host's Huffman decoding
// (csrc/jpeg_entropy.cpp), then the short-side resize and center crop of
// the throughput path's host decoder.
//
// Replaces jcf_tpu/native/jcfnative.cpp (libjpeg-turbo + a std::thread
// pool, host code, not a TPU kernel) and PIL's decode in
// jcf_tpu/data/datasets.py. No TPU kernel decodes images: these kernels
// stand in for libjpeg-turbo's host code, integer for integer.
//
// jpeg_idct: dequantization + the IDCT of every component of every image
// of a decode call in one launch (a descriptor table in device memory
// maps each CTA to its component), 8 lanes per 8 x 8 coefficient block,
// templated on the output block size (8: the islow IDCT of jidctint.c; 4,
// 2, 1: the reduced IDCTs of jidctred.c), as
// libjpeg-turbo's x86 SIMD code computes them (16-bit dequantization and
// sums where the SIMD code adds 16-bit lanes, 32-bit products, int16
// saturation between the passes, a clamp to 0..255 at the end; the 1 x 1
// size in C, through libjpeg's RANGE_MASK table). data/jpeg.py states the
// arithmetic; idct_plain there is its plain version, bit for bit.
//
// jpeg_upsample_color: one thread per output pixel: each component's
// sample by its upsampling method (box replication, or jdsample.c's
// triangle "fancy" h2v1, h1v2, h2v2 with edge rows and columns
// replicated), then jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS 16).
// Its plain version is upsample_color_plain.
//
// Everything is integer arithmetic (unsigned where a sum may wrap), so the
// card's pixels equal the plain versions' and libjpeg-turbo's bit for bit.
//
// What bounds them: bytes. The IDCT reads 128 bytes of coefficients and
// writes S^2 samples a block (S its size); the upsampler reads each plane
// sample about once and writes 3 bytes a pixel. The IDCT's lanes: lane r
// of a block's 8 loads its row r as one 16-byte load (a warp reads 512
// contiguous bytes), the column pass runs after a transpose by shuffles
// within the 8 lanes, the block's AC-zero test is a vote of the 8, and
// lane r stores output row r as one 8-, 4- or 2-byte word. One launch a
// decode call: a single image's IDCT is ~1.5 us of bytes, under a
// launch's own cost, and a 128-image decode_batch is one launch whose
// bound a kernel can approach. The upsampler: one thread a pixel; not
// tuned.
//
// The resize is two kernels, the horizontal pass over every source row
// for the crop's columns into an f32 [sh, out, 3] scratch, then the
// vertical pass for the crop's rows to uint8 [out, out, 3], with the C++
// arithmetic: window [floor(c - support), ceil(c + support)] clamped,
// weights max(0, 1 - |i - c| / support), the horizontal weights times
// 1 / sum, the vertical ones times 1 / sum term by term, uint8(clamp(acc
// + 0.5, 0, 255)). A grayscale JPEG decodes to one channel, which both
// passes read for R, G and B.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// tmp[y, ox - left, c] for every source row y and the crop's columns
__global__ void resize_h_kernel(const uint8_t* __restrict__ src, int sw, int sh, int ch,
                                float sx, int left, int out, float* __restrict__ tmp) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)sh * out) return;
  const int y = (int)(idx / out), ox = (int)(idx % out) + left;
  const Window w = window(ox, sx, sw);
  const float inv = inv_sum(w);
  const uint8_t* row = src + (long long)y * sw * ch;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  for (int i = w.lo; i <= w.hi; ++i) {
    const float wt = weight(w, i) * inv;
    const uint8_t* p = row + (long long)i * ch;
    r = fmaf(wt, (float)p[0], r);
    g = fmaf(wt, (float)p[ch == 3 ? 1 : 0], g);
    b = fmaf(wt, (float)p[ch == 3 ? 2 : 0], b);
  }
  float* t = tmp + idx * 3;
  t[0] = r;
  t[1] = g;
  t[2] = b;
}

// dst[oy - top, x, c] for the crop's rows
__global__ void resize_v_kernel(const float* __restrict__ tmp, int sh, int out, float sy, int top,
                                uint8_t* __restrict__ dst) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= out * out * 3) return;
  const int oy = idx / (out * 3) + top, xc = idx % (out * 3);
  const Window w = window(oy, sy, sh);
  const float inv = inv_sum(w);
  float acc = 0.0f;
  for (int i = w.lo; i <= w.hi; ++i)
    acc = fmaf(weight(w, i) * inv, tmp[(long long)i * out * 3 + xc], acc);
  dst[idx] = (uint8_t)fminf(fmaxf(acc + 0.5f, 0.0f), 255.0f);
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
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_desc - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (desc[(long long)mid * D_FIELDS + D_CTA0] <= b)
        lo = mid;
      else
        hi = mid - 1;
    }
    comp = lo;
  }
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

struct PlaneDesc {
  const uint8_t* data;
  int stride, width, height, fx, fy, method;  // method: 0 box, 1 h2v1, 2 h1v2, 3 h2v2
};

struct Planes {
  PlaneDesc p[3];
};

__device__ __forceinline__ int plane_sample(const PlaneDesc& p, int x, int y) {
  const uint8_t* d = p.data;
  if (p.method == 0)
    return d[(long long)min(y / p.fy, p.height - 1) * p.stride + min(x / p.fx, p.width - 1)];
  if (p.method == 1) {  // h2v1: (3 nearer + further + 1 or 2) >> 2
    const uint8_t* row = d + (long long)min(y, p.height - 1) * p.stride;
    const int j = min(x >> 1, p.width - 1);
    const int side = min(max((x & 1) ? j + 1 : j - 1, 0), p.width - 1);
    return (row[j] * 3 + row[side] + ((x & 1) ? 2 : 1)) >> 2;
  }
  const int near = min(y >> 1, p.height - 1);
  const int far = min(max((y & 1) ? near + 1 : near - 1, 0), p.height - 1);
  const uint8_t* r0 = d + (long long)near * p.stride;
  const uint8_t* r1 = d + (long long)far * p.stride;
  if (p.method == 2) {  // h1v2
    const int xs = min(x, p.width - 1);
    return (r0[xs] * 3 + r1[xs] + ((y & 1) ? 2 : 1)) >> 2;
  }
  // h2v2 on the column sums: (3 this + that + 8 or 7) >> 4
  const int j = min(x >> 1, p.width - 1);
  const int side = min(max((x & 1) ? j + 1 : j - 1, 0), p.width - 1);
  const int this_sum = r0[j] * 3 + r1[j], that_sum = r0[side] * 3 + r1[side];
  return (this_sum * 3 + that_sum + ((x & 1) ? 7 : 8)) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) { return (uint8_t)min(max(v, 0), 255); }

__global__ void upsample_color_kernel(Planes planes, int n, int ycc, int out_w, int out_h,
                                      uint8_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)out_w * out_h) return;
  const int x = (int)(idx % out_w), y = (int)(idx / out_w);
  uint8_t* o = out + idx * n;
  if (n == 1) {
    o[0] = (uint8_t)plane_sample(planes.p[0], x, y);
    return;
  }
  const int c0 = plane_sample(planes.p[0], x, y);
  const int c1 = plane_sample(planes.p[1], x, y);
  const int c2 = plane_sample(planes.p[2], x, y);
  if (!ycc) {
    o[0] = (uint8_t)c0;
    o[1] = (uint8_t)c1;
    o[2] = (uint8_t)c2;
    return;
  }
  const int cb = c1 - 128, cr = c2 - 128;
  o[0] = clamp255(c0 + ((91881 * cr + 32768) >> 16));
  o[1] = clamp255(c0 + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  o[2] = clamp255(c0 + ((116130 * cb + 32768) >> 16));
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

// planes p0..p2 (uint8, device; n of them) with desc (host) int32 [3, 6]:
// stride, width, height, fx, fy, method per plane -> out uint8 [out_h,
// out_w, n]. Returns a cudaError_t.
int jcf_jpeg_upsample_color(const void* p0, const void* p1, const void* p2, const int* desc, int n,
                            int ycc, int out_w, int out_h, void* out, void* stream) {
  if ((n != 1 && n != 3) || out_w < 1 || out_h < 1) return (int)cudaErrorInvalidValue;
  Planes planes = {};
  const void* ptrs[3] = {p0, p1, p2};
  for (int i = 0; i < n; ++i) {
    const int* d = desc + 6 * i;
    if (d[1] < 1 || d[2] < 1 || d[3] < 1 || d[4] < 1) return (int)cudaErrorInvalidValue;
    planes.p[i] = {static_cast<const uint8_t*>(ptrs[i]), d[0], d[1], d[2], d[3], d[4], d[5]};
  }
  const long long total = (long long)out_w * out_h;
  upsample_color_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      planes, n, ycc, out_w, out_h, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// src uint8 [sh, sw, channels] -> dst uint8 [out, out, 3]: the short side
// resized to resize_to (the long side to resize_to * long / short,
// rounded down), then the centered out x out crop; tmp f32 [sh, out, 3].
// Returns a cudaError_t.
int jcf_resize_crop(const void* src, int sw, int sh, int channels, int resize_to, int out,
                    void* tmp, void* dst, void* stream) {
  if (sw < 1 || sh < 1 || (channels != 1 && channels != 3) || out < 1 || resize_to < out)
    return (int)cudaErrorInvalidValue;
  int rw, rh;
  if (sw <= sh) {
    rw = resize_to;
    rh = (int)((long long)resize_to * sh / sw);
  } else {
    rh = resize_to;
    rw = (int)((long long)resize_to * sw / sh);
  }
  const int left = (rw - out) / 2, top = (rh - out) / 2;
  const float sx = (float)sw / rw, sy = (float)sh / rh;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_h = (long long)sh * out;
  resize_h_kernel<<<(unsigned)((n_h + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const uint8_t*>(src), sw, sh, channels, sx, left, out,
      static_cast<float*>(tmp));
  const int n_v = out * out * 3;
  resize_v_kernel<<<(n_v + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(tmp), sh, out, sy, top, static_cast<uint8_t*>(dst));
  return (int)cudaGetLastError();
}

}  // extern "C"
