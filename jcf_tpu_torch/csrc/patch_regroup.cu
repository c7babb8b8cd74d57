// Probe P2's kernels: the im2col regroup of square planes into patch rows
// (jcf_tpu_torch/scripts/exp_patch_regroup.py),
//   out[i, py * G + px, dy * P + dx] = x[i, py * P + dy, px * P + dx]
// for x [n, G*P, G*P] and out [n, G*G, P*P] (224² planes into 49 rows of
// 32² in the probe), f32 or int8: a template over the element type and
// the strategy, one for each TPU kernel (scripts/exp_patch_regroup.py,
// pallas_call :61, grid over planes):
//   A replaces kernel_a (:28, reshape + transpose of the whole plane): a
//     block a plane, through shared memory. It reads the plane in order,
//     writes each 16-byte chunk to its place in the output order in
//     shared memory (dynamic shared memory: an f32 224² plane is 196 KB),
//     then writes the output in order.
//   B replaces kernel_b (:34, a loop over the 32-row bands py): a block a
//     band. A band of x (P rows) and its G patch rows of out are each one
//     contiguous run of G*P*P elements; each thread moves 16-byte chunks
//     from the first straight to their places in the second.
//   C replaces kernel_c (:42, strided rows x[dy::32]): a block a (plane,
//     dy), reading the G rows dy, P + dy, ... and writing column band
//     dy*P..dy*P+P-1 of every patch row.
// Every chunk holds 16 / sizeof(T) elements of one P-element run, which
// stays contiguous on both sides (P * sizeof(T) % 16 == 0), so every load
// and store is 16 bytes.
//
// What bounds them on the H100: bytes (each element read once and written
// once, no arithmetic). A's global traffic runs in order on both sides;
// B's and C's writes land in runs of P elements (128 bytes in f32, 32 in
// int8). A has one block of up to 196 KB resident an SM, B and C many.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Geo {
  static constexpr int V = 16 / sizeof(T);  // elements a chunk
  int G, P;
  __device__ int side() const { return G * P; }
  // output offset in the plane of the chunk at (row r, column c) of x
  __device__ long long out_of(int r, int c) const {
    const int py = r / P, dy = r % P, px = c / P, dx = c % P;
    return (long long)(py * G + px) * P * P + dy * P + dx;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) regroup_a(const T* __restrict__ x, T* __restrict__ out,
                                                     Geo<T> geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int W = geo.side(), row_chunks = W / Geo<T>::V;
  const long long plane = (long long)W * W;
  const T* xp = x + blockIdx.x * plane;
  T* op = out + blockIdx.x * plane;
  const int chunks = W * row_chunks;
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const int r = c / row_chunks, col = (c % row_chunks) * Geo<T>::V;
    *reinterpret_cast<uint4*>(s + geo.out_of(r, col)) =
        *reinterpret_cast<const uint4*>(xp + (long long)r * W + col);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < chunks; c += THREADS)
    reinterpret_cast<uint4*>(op)[c] = reinterpret_cast<const uint4*>(s)[c];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) regroup_b(const T* __restrict__ x, T* __restrict__ out,
                                                     Geo<T> geo) {
  const int W = geo.side(), row_chunks = W / Geo<T>::V;
  const int plane = blockIdx.x / geo.G, py = blockIdx.x % geo.G;
  const long long band = (long long)plane * W * W + (long long)py * geo.P * W;  // same in out
  const T* xb = x + band;
  T* ob = out + band;
  const int chunks = geo.P * row_chunks;
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const int dy = c / row_chunks, col = (c % row_chunks) * Geo<T>::V;
    *reinterpret_cast<uint4*>(ob + geo.out_of(dy, col)) =
        *reinterpret_cast<const uint4*>(xb + (long long)dy * W + col);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) regroup_c(const T* __restrict__ x, T* __restrict__ out,
                                                     Geo<T> geo) {
  const int W = geo.side(), row_chunks = W / Geo<T>::V;
  const int plane = blockIdx.x / geo.P, dy = blockIdx.x % geo.P;
  const long long base = (long long)plane * W * W;
  const int chunks = geo.G * row_chunks;
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const int r = (c / row_chunks) * geo.P + dy, col = (c % row_chunks) * Geo<T>::V;
    *reinterpret_cast<uint4*>(out + base + geo.out_of(r, col)) =
        *reinterpret_cast<const uint4*>(x + base + (long long)r * W + col);
  }
}

template <typename T>
int launch(const void* xv, void* ov, int n, int G, int P, int strategy, cudaStream_t s) {
  if (n <= 0 || G <= 0 || P <= 0 || (P * (int)sizeof(T)) % 16 != 0 ||
      ((uintptr_t)xv | (uintptr_t)ov) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* o = static_cast<T*>(ov);
  const Geo<T> geo{G, P};
  if (strategy == 0) {
    const size_t smem = (size_t)G * P * G * P * sizeof(T);
    const int err = set_smem(regroup_a<T>, smem);
    if (err) return err;
    regroup_a<T><<<n, THREADS, smem, s>>>(x, o, geo);
  } else if (strategy == 1) {
    regroup_b<T><<<n * G, THREADS, 0, s>>>(x, o, geo);
  } else if (strategy == 2) {
    regroup_c<T><<<n * P, THREADS, 0, s>>>(x, o, geo);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, G*P, G*P] -> out [n, G*G, P*P], f32 (elem_bytes 4) or int8 (1),
// both contiguous and 16-byte aligned; strategy 0 (A), 1 (B), 2 (C).
// Returns a cudaError_t.
int jcf_patch_regroup(const void* x, void* out, int n, int G, int P, int elem_bytes,
                      int strategy, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) return launch<float>(x, out, n, G, P, strategy, s);
  if (elem_bytes == 1) return launch<int8_t>(x, out, n, G, P, strategy, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
