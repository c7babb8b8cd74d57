// Shared helpers of the jcf_tpu_torch kernels (sm_90a).
//
// Rounding follows the JAX reference: every float -> int8 quantization
// rounds half to even (rintf), never roundf. Products and sums whose
// rounding the reference fixes use the _rn intrinsics, which nvcc never
// contracts into an FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// widening loads and narrowing stores of the attention kernels' f32 / bf16
// operands
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return bf2f(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// rounding to T's precision, kept in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// opts a kernel in to more than the default 48 KB of shared memory; a
// block over the card's limit is refused here, and the refusal is cleared
// so that the next launch's cudaGetLastError does not report it
template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// warp-level tensor-core products, A row-major and B column-major
// fragments as the PTX ISA lays them out: s8 x s8 -> s32 (m16n8k32) and
// bf16 x bf16 -> f32 (m16n8k16), accumulating into c
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two adjacent bf16 as one 32-bit fragment register
__device__ __forceinline__ unsigned ld_u32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// four 8 x 8 bf16 matrices from shared memory: thread t gives the address
// of row (t & 7) of matrix t >> 3; r[i] is matrix i's fragment (thread t:
// row t >> 2, columns 2 (t & 3) and 2 (t & 3) + 1)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the same, transposed: thread t holds rows 2 (t & 3), 2 (t & 3) + 1 of
// column t >> 2
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// round half to even, saturate to [-127, 127]
__device__ __forceinline__ int8_t round_clip_int8(float x) {
  return (int8_t)fminf(fmaxf(rintf(x), -127.0f), 127.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row statistics of one LayerNorm row held by a warp: PER values per
// lane, element j = lane + 32 * k, valid while j < n. Returns
// (mean, rstd) with mean = sum / n and var = mean((x - mean)^2).
template <int PER>
__device__ __forceinline__ float2 warp_row_stats(const float (&v)[PER], int lane, int n) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (lane + 32 * k < n) s += v[k];
  const float mean = warp_sum(s) / (float)n;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (lane + 32 * k < n) {
      const float d = v[k] - mean;
      q = fmaf(d, d, q);
    }
  const float var = warp_sum(q) / (float)n;
  return make_float2(mean, rsqrtf(var + 1e-5f));
}

// 16-byte cp.async global -> shared; src_bytes 0 zero-fills the chunk
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a 16-byte chunk as 4 f32 or 8 bf16 values (the LayerNorm row kernels' loads)
__device__ __forceinline__ void lnv_unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void lnv_unpack(const uint4& r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// a chunk's values back to 16 bytes of f32 or bf16 (round to nearest even)
__device__ __forceinline__ uint4 lnv_pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 lnv_pack(const float (&f)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Row statistics of a LayerNorm row held by a warp in 16-byte chunks c =
// lane + 32k (the vector row kernels): a lane sums its chunks' f32
// values in order (chunk k, then element), the warp adds the lanes' sums
// by the xor butterfly; then the same for the squared deviations from
// the mean. Returns (mean, rstd) with var = mean((x - mean)^2), as
// warp_row_stats.
template <int CPL, int V>
__device__ __forceinline__ float2 ln_vec_stats(const float (&v)[CPL][V], const bool (&live)[CPL],
                                               int n) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (live[k]) {
#pragma unroll
      for (int i = 0; i < V; ++i) s += v[k][i];
    }
  const float mean = warp_sum(s) / (float)n;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (live[k]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[k][i] - mean;
        q = fmaf(d, d, q);
      }
    }
  const float var = warp_sum(q) / (float)n;
  return make_float2(mean, rsqrtf(var + 1e-5f));
}
