// Probe P4's kernel: o = x + 1 in bf16 over a row stream, the unit of a
// chain whose slope over its length is the cost of one kernel boundary
// (jcf_tpu_torch/scripts/exp_boundary_cost.py).
//
// Replaces copy_kernel (scripts/exp_boundary_cost.py:21-24, its
// pallas_call at :29), which the TPU probe chains over the serving row
// stream [204800, 768] in tiles of 800 rows. The +1 keeps any layer from
// eliding the copy; the sum is taken in f32 and rounded to bf16 (RN), as
// PyTorch's bf16 add rounds, so the kernel equals x + 1 bit for bit.
//
// What bounds it: bytes (each element read once and written once, no
// arithmetic to speak of). One 16-byte load and store a thread (8 bf16),
// neighbouring threads on neighbouring addresses; the wrapper requires a
// multiple of 8 elements and 16-byte aligned pointers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void copy_add_one_kernel(const uint4* __restrict__ x, uint4* __restrict__ o,
                                    long long n_vec) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_vec) return;
  uint4 v = x[i];
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(p[k]);
    p[k] = __floats2bfloat162_rn(f.x + 1.0f, f.y + 1.0f);
  }
  o[i] = v;
}

}  // namespace

extern "C" {

// x, o: bf16 [n] (n a multiple of 8, 16-byte aligned). Returns a cudaError_t.
int jcf_copy_add_one(const void* x, void* o, long long n, void* stream) {
  if (n <= 0 || n % 8 != 0 || ((uintptr_t)x | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_vec = n / 8;
  copy_add_one_kernel<<<(unsigned)((n_vec + THREADS - 1) / THREADS), THREADS, 0,
                        (cudaStream_t)stream>>>(static_cast<const uint4*>(x),
                                                static_cast<uint4*>(o), n_vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
