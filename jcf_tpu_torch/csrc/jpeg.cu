// JPEG decode on the card (nvJPEG), then the short-side resize and center
// crop of the throughput path's host decoder.
//
// Replaces jcf_tpu/native/jcfnative.cpp (a libjpeg + std::thread pool, a
// host library, not a TPU kernel): decode_batch there decodes each JPEG,
// resizes its short side to `resize_to` with a separable triangle filter
// (antialiased bilinear: support max(scale, 1), float weights normalized
// per output pixel) and crops the `out_size` square at the center. The
// card's host has no libjpeg, so the Huffman decode runs in nvJPEG (its
// hybrid backend: Huffman on the host, IDCT and color conversion on the
// card) and the resize runs here. One difference is by design: libjpeg
// decodes at 1/2, 1/4 or 1/8 scale inside the codec when the short side
// is at least twice `resize_to` (jcfnative.cpp:71-80); nvJPEG has no
// scaled decode, so these images are decoded at full size and filtered
// from there (the filter's support grows to cover the same footprint).
//
// The resize is two kernels, the horizontal pass over every source row
// for the crop's columns into an f32 [sh, out, 3] scratch, then the
// vertical pass for the crop's rows to uint8 [out, out, 3], with the C++
// arithmetic: window [floor(c - support), ceil(c + support)] clamped,
// weights max(0, 1 - |i - c| / support), the horizontal weights times
// 1 / sum, the vertical ones times 1 / sum term by term, uint8(clamp(acc
// + 0.5, 0, 255)). A grayscale JPEG decodes to one channel, which both
// passes read for R, G and B.
//
// What bounds it: bytes (the decoded image read once per pass, tiny next
// to the host's Huffman decode); nothing here is tuned.
#include <cuda_runtime.h>
#include <math.h>
#include <nvjpeg.h>
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

}  // namespace

extern "C" {

// nvJPEG's library handle (thread-safe) and a decode state (one per
// decoding thread, destroyed when the thread ends); nvjpegStatus_t codes,
// 0 on success
int jcf_jpeg_create(void** handle) {
  return (int)nvjpegCreateSimple(reinterpret_cast<nvjpegHandle_t*>(handle));
}

int jcf_jpeg_state_create(void* handle, void** state) {
  return (int)nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle),
                                    reinterpret_cast<nvjpegJpegState_t*>(state));
}

int jcf_jpeg_state_destroy(void* state) {
  return (int)nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state));
}

// info[0] components, info[1] width, info[2] height, info[3] chroma
// subsampling (nvjpegChromaSubsampling_t)
int jcf_jpeg_info(void* handle, const void* data, long long length, int* info) {
  int n = 0, widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t sub;
  const nvjpegStatus_t st =
      nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle),
                         static_cast<const unsigned char*>(data), (size_t)length, &n, &sub,
                         widths, heights);
  info[0] = n;
  info[1] = widths[0];
  info[2] = heights[0];
  info[3] = (int)sub;
  return (int)st;
}

// decode to uint8 [h, w, channels] at dst: channels 3 (interleaved RGB)
// or 1 (the luma of a grayscale JPEG); the card's part runs on `stream`
int jcf_jpeg_decode(void* handle, void* state, const void* data, long long length, int channels,
                    int width, void* dst, void* stream) {
  if (channels != 1 && channels != 3) return (int)NVJPEG_STATUS_INVALID_PARAMETER;
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(dst);
  img.pitch[0] = (size_t)width * channels;
  return (int)nvjpegDecode(static_cast<nvjpegHandle_t>(handle),
                           static_cast<nvjpegJpegState_t>(state),
                           static_cast<const unsigned char*>(data), (size_t)length,
                           channels == 3 ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_Y, &img,
                           (cudaStream_t)stream);
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
