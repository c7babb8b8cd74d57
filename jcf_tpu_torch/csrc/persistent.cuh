// The machinery of the persistent whole-layer kernels, K9b (block_float.cu)
// and K9a / K9c (block_int8.cuh): one cooperative launch whose blocks all
// fit on the card at once walk a layer's phases, separated by a grid-wide
// barrier; each GEMM phase draws its tiles from a global counter through
// the wgmma ring of wgmma_gemm.cuh.
// - The grid barrier is an atomic counter that the C entry zeroes before
//   the launch; each phase ends with a proxy fence, so that TMA sees the
//   generic writes before it, and scratch written in the launch is read
//   back only through L2 (cp.async, __ldcg, TMA).
// - A GEMM phase's producer thread (lane 0 of the ninth warp) draws tiles
//   (N-fastest) from the tile counter as the ring frees and hands each
//   tile's index to the consumer warpgroups in a slot of its first stage:
//   drawn statically (block b: tiles b, b + grid, ...), the slowest blocks
//   set each phase's end, and K9b's qkv and c_fc took 16% and 19% longer
//   on one H100 (PERF.md).
// - Every wait is bounded by the global timer: a barrier or ring wait
//   that does not complete within PHASE_WAIT_NS traps instead of holding
//   the card.
#pragma once

#include "wgmma_gemm.cuh"

namespace {

constexpr int PHASE_BN = 128;  // the GEMM phases' N tile

// ---------------------------------------------------------------------------
// the grid barrier
// ---------------------------------------------------------------------------

// a wait that would never end (a block that is not co-resident, a fault
// in the phases' logic) traps once PHASE_WAIT_NS have passed on the global
// timer instead of holding the card; the longest wait of a correct launch
// is one phase (11 ms at the vision shapes on one H100)
constexpr unsigned long long PHASE_WAIT_NS = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a wait's clock, called on each failed poll: the timer is read every
// 64th; expired() once PHASE_WAIT_NS have passed since its first reading
struct WaitClock {
  unsigned long long t0 = 0;
  unsigned n = 0;
  __device__ __forceinline__ bool expired() {
    if (++n & 63) return false;
    const unsigned long long t = now_ns();
    if (t0 == 0) t0 = t;
    return t - t0 > PHASE_WAIT_NS;
  }
};

// every thread's writes so far are visible to every block after it, to
// loads and to TMA; target counts the arrivals of the barriers so far
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned seen;
    WaitClock clock;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(bar) : "memory");
      if (seen >= target) break;
      if (clock.expired()) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the GEMM phases' ring
// ---------------------------------------------------------------------------

// the ring's position, and (the producer's) the tile counter's value at
// the start of the phase: each phase takes tiles + gridDim.x of it, every
// block's producer drawing once past the phase's last tile
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  unsigned base = 0;
};

// mbar_wait (wgmma_gemm.cuh), bounded as the grid barrier's spin
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
  WaitClock clock;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock.expired()) __trap();
  }
}

// the producer thread: draws the phase's tiles (N-fastest) from the
// global counter ctr as the ring frees, so that a block that falls behind
// takes fewer; writes each tile's index into its first stage's slot (-1
// past the last: the stage then carries no bytes and ends the phase) and
// loads each tile's K slices into the ring; mb2 the lo plane (f32);
// b_row0: the B rows' offset in its map (a layer of stacked weights).
// AHEAD: the next tile is drawn as soon as this one is, so that the
// counter's round trip overlaps this tile's loads (short tiles: the int8
// phases); every block still draws once past the phase's last tile.
// CHUNKED: ma and mb are 3-D maps [rows, chunks, chunk bytes], the depth
// spc stages a chunk (step ks: chunk ks / spc).
template <class R, bool AHEAD = false, bool CHUNKED = false>
__device__ __forceinline__ void produce(const CUtensorMap* ma, const CUtensorMap* mb,
                                        const CUtensorMap* mb2, int tiles, int tiles_n,
                                        int k_steps, uint32_t ring, uint32_t full0,
                                        uint32_t empty0, volatile int* slots, unsigned* ctr,
                                        RingPos& rp, int b_row0 = 0, int spc = 1) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  unsigned drawn = AHEAD ? atomicAdd(ctr, 1u) : 0u;
  for (;;) {
    int t;
    if constexpr (AHEAD) {
      t = (int)(drawn - rp.base);
      if (t < tiles) drawn = atomicAdd(ctr, 1u);
    } else {
      t = (int)(atomicAdd(ctr, 1u) - rp.base);
    }
    ring_wait(empty0 + 8 * rp.stage, rp.phase ^ 1);
    if (t >= tiles) {
      slots[rp.stage] = -1;
      mbar_arrive(full0 + 8 * rp.stage);
      ring_advance(rp.stage, rp.phase, R::STAGES);
      break;
    }
    slots[rp.stage] = t;
    const int m0 = (t / tiles_n) * GEMM_BM, n0 = (t % tiles_n) * R::BN + b_row0;
    for (int ks = 0; ks < k_steps; ++ks) {
      if (ks > 0) ring_wait(empty0 + 8 * rp.stage, rp.phase ^ 1);
      const uint32_t full = full0 + 8 * rp.stage, a = ring + rp.stage * R::STAGE_BYTES;
      mbar_expect_tx(full, R::STAGE_BYTES);
      if constexpr (CHUNKED) {
        const int c = ks / spc, k0 = (ks - c * spc) * GEMM_BK_BYTES;
        tma_load_3d(a, ma, full, k0, c, m0);
        tma_load_3d(a + R::A_BYTES, mb, full, k0, c, n0);
      } else {
        tma_load(a, ma, full, ks * GEMM_BK_BYTES, m0);
        tma_load(a + R::A_BYTES, mb, full, ks * GEMM_BK_BYTES, n0);
        if (R::PLANES == 2)
          tma_load(a + R::A_BYTES + R::B_BYTES, mb2, full, ks * GEMM_BK_BYTES, n0);
      }
      ring_advance(rp.stage, rp.phase, R::STAGES);
    }
  }
  rp.base += tiles + gridDim.x;
}

// the consumers' next tile: waits for the next stage and reads its slot;
// at the phase's end releases that stage and returns -1
template <class R>
__device__ __forceinline__ int next_tile(uint32_t full0, uint32_t empty0,
                                         const volatile int* slots, RingPos& rp) {
  ring_wait(full0 + 8 * rp.stage, rp.phase);
  const int t = slots[rp.stage];
  if (t < 0) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * rp.stage);
    ring_advance(rp.stage, rp.phase, R::STAGES);
  }
  return t;
}

// the tile's stores from wgmma's m64nN layout (f32 or s32; per n8 column
// group rows g and g + 8 of the warp's 16, columns 2t, 2t + 1): epi(m, n,
// v0, v1) for m < M, n < N (N even)
template <typename A, class Epi>
__device__ __forceinline__ void store_tile(const A (&acc)[64], int m0, int n0, int M, int N,
                                           Epi& epi) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int m = m0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < PHASE_BN / 8; ++j) {
    const int n = n0 + j * 8 + tig * 2;
    if (n < N) {
      if (m < M) epi(m, n, acc[4 * j], acc[4 * j + 1]);
      if (m + 8 < M) epi(m + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// launches kernel<<<grid, threads, smem>>>(args...) cooperatively on the
// stream, after zeroing n_bar counters at bar; grid 0: as many blocks as
// fit on the card at once (the occupancy API). A grid that cannot be
// co-resident is refused by the runtime (cudaErrorCooperativeLaunchTooLarge),
// never split.
template <typename... KArgs, typename... Args>
int launch_persistent(void (*kernel)(KArgs...), int threads, size_t smem, unsigned* bar,
                      int n_bar, int grid, cudaStream_t stream, Args... args) {
  int err = set_smem(kernel, smem);
  if (err) return err;
  if (grid <= 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid = per_sm * sms;
  }
  cudaError_t e = cudaMemsetAsync(bar, 0, n_bar * sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
