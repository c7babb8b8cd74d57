// Probe P2's kernels: the im2col regroup of square planes into patch rows
// (jcf_tpu_torch/scripts/exp_patch_regroup.py),
//   out[i, py * G + px, dy * P + dx] = x[i, py * P + dy, px * P + dx]
// for x [n, G*P, G*P] and out [n, G*G, P*P] (224² planes into 49 rows of
// 32² in the probe), f32 or int8: a template over the element type and
// the strategy, one for each TPU kernel (scripts/exp_patch_regroup.py,
// pallas_call :61, grid over planes):
//   A replaces kernel_a (:28, reshape + transpose of the whole plane): a
//     persistent block owns whole planes and moves them band
//     by band with the Tensor Memory Accelerator. Each P x P tile (py, px)
//     is one 2-D TMA box of x viewed as [n*G*P, G*P]; the box lands
//     row-major, [dy][dx], which is exactly output row py*G + px, so the
//     G boxes of band py fill its G output rows in order, and one bulk
//     copy stores the band to its contiguous run of out. A ring of bands
//     on mbarriers keeps later bands' loads in flight while earlier bands
//     store; one thread issues every copy.
//   B replaces kernel_b (:34, a loop over the 32-row bands py): a block a
//     band. A band of x (P rows) and its G patch rows of out are each one
//     contiguous run of G*P*P elements; each thread moves 16-byte chunks
//     from the first straight to their places in the second.
//   C replaces kernel_c (:42, strided rows x[dy::32]): a block a (plane,
//     dy), reading the G rows dy, P + dy, ... and writing column band
//     dy*P..dy*P+P-1 of every patch row.
// B and C move 16-byte chunks (16 / sizeof(T) elements of one P-element
// run, contiguous on both sides: P * sizeof(T) % 16 == 0, the rule TMA's
// boxes share).
//
// What bounds them on the H100: bytes (each element read once and written
// once, no arithmetic). A reads each band's contiguous P rows and writes
// its contiguous run; B's and C's writes land in runs of P elements (128
// bytes in f32, 32 in int8).
#include "wgmma_gemm.cuh"

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

// A's ring: up to A_STAGES bands of G tiles in dynamic shared memory
// (128-byte aligned, TMA's rule for a box), then a full barrier a band;
// LAG stores may still read the ring when a slot is refilled
constexpr int A_STAGES = 3;
constexpr int A_LAG = 1;

__device__ __forceinline__ void bulk_store(void* gmem, uint32_t smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem),
               "r"(smem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(32) regroup_a(const __grid_constant__ CUtensorMap map,
                                                T* __restrict__ out, int n, int G, int P,
                                                int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if (threadIdx.x != 0) return;
  const uint32_t tile = (uint32_t)(P * P * sizeof(T)), band = G * tile;
  const uint32_t ring = (smem_u32(smem_raw) + 127) & ~127u;
  const uint32_t full0 = ring + stages * band;
  for (int s = 0; s < stages; ++s) mbar_init(full0 + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // the block's bands: planes blockIdx.x, + gridDim.x, ..., each its G bands
  const int planes = (n - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int bands = planes * G;
  auto issue = [&](int b) {
    const int s = b % stages, plane = (int)blockIdx.x + (b / G) * (int)gridDim.x, py = b % G;
    const uint32_t bar = full0 + 8 * s, dst = ring + s * band;
    mbar_expect_tx(bar, band);
    for (int px = 0; px < G; ++px) tma_load(dst + px * tile, &map, bar, px * P, (plane * G + py) * P);
  };
  for (int b = 0; b < bands && b < stages; ++b) issue(b);
  for (int b = 0; b < bands; ++b) {
    const int s = b % stages, plane = (int)blockIdx.x + (b / G) * (int)gridDim.x, py = b % G;
    mbar_wait(full0 + 8 * s, (uint32_t)((b / stages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(out + ((long long)plane * G + py) * G * P * P, ring + s * band, band);
    bulk_commit();
    // band b - LAG's slot takes band b - LAG + stages once its store has read it
    const int next = b - A_LAG + stages;
    if (b >= A_LAG && next < bands) {
      bulk_wait_read<A_LAG>();
      issue(next);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// A: the tensor map of x as [n*G*P rows, G*P] elements in P x P boxes (no
// swizzle), as many bands in the ring as fit in a block's shared memory
// (at least LAG + 1, at most A_STAGES: on the H100 more blocks an SM beat
// a deeper ring), as many blocks as fit on the card at once (two an SM for
// f32 at 224², ten for int8), fewer for fewer planes
template <typename T>
int launch_a(const T* x, T* o, int n, int G, int P, cudaStream_t s) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || P > 256 || (long long)n * G * P > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t band = (size_t)G * P * P * sizeof(T), extra = 128 + 8 * A_STAGES;
  const int fit = smem_max > (int)extra ? (int)((smem_max - extra) / band) : 0;
  const int stages = fit < A_STAGES ? fit : A_STAGES;
  if (stages < A_LAG + 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)G * P, (cuuint64_t)n * G * P};
  const cuuint64_t strides[1] = {(cuuint64_t)G * P * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)P, (cuuint32_t)P};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      &map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<T*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)stages * band + extra;
  const int e = set_smem(regroup_a<T>, smem);
  if (e) return e;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, regroup_a<T>, 32, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = sms * (per_sm > 1 ? per_sm : 1);
  regroup_a<T><<<n < grid ? n : grid, 32, smem, s>>>(map, o, n, G, P, stages);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, void* ov, int n, int G, int P, int strategy, cudaStream_t s) {
  if (n <= 0 || G <= 0 || P <= 0 || (P * (int)sizeof(T)) % 16 != 0 ||
      ((uintptr_t)xv | (uintptr_t)ov) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* o = static_cast<T*>(ov);
  const Geo<T> geo{G, P};
  if (strategy == 0) return launch_a(x, o, n, G, P, s);
  if (strategy == 1) {
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
