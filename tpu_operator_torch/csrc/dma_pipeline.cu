// DMA-pipeline copy, out = x, `iters` passes in one launch, for Hopper
// (sm_90a): every byte goes global -> shared -> global through TMA bulk
// copies, with a `slots`-deep ring of shared-memory buffers in each block.
//
// Replaces the Pallas TPU kernel `_pipeline_kernel` / `dma_pipeline_copy`
// (tpu_operator/workloads/hbm_pallas.py:48-117), the hbm-dma probe: the
// DMA engines alone move the buffer, no arithmetic unit touches the data,
// so its rate is the memory system's and not the compute pipeline's.
//
// Bound: memory.  Each pass reads the buffer once and writes it once, so
// the least time is 2 * nbytes * iters over the card's HBM rate (3.35 TB/s
// on an H100 SXM); there is no arithmetic.
//
// Design:
// - The TPU kernel stages 4 MiB chunks in a 4-slot VMEM ring (16 MiB).  A
//   Hopper block has at most 227 KB of shared memory, so the buffer is cut
//   into tiles of `tile_bytes` (at most 32 KiB, chosen by the wrapper so
//   that `slots` tiles fit) and each block keeps its own `slots`-deep ring:
//   `slots` is still the number of copies a block has in flight.
// - The TPU grid is one sequential program; here a grid of one or two
//   blocks per SM splits the buffer.  Each block owns one contiguous byte
//   range (the ranges balanced to 16 bytes), cut into tiles, and copies it
//   `iters` times.  Every pass writes the same bytes and x is read-only, so
//   the passes need no barrier between them: a block runs its passes
//   straight through.  No two blocks ever touch the same bytes, so a pass
//   cannot read what another block's pass just brought into the L2: with a
//   buffer well past the 50 MB L2, every pass streams device memory.  An
//   even split of the pass-major sequence of tile copies would put blocks
//   whole passes apart on the same tiles at the same time, and the L2
//   would serve their reads at a rate above the card's memory rate.
// - One thread per block issues everything.  A load is
//   cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes on
//   the slot's mbarrier, armed with expect_tx; a store is
//   cp.async.bulk.global.shared::cta.bulk_group, one bulk group per store.
//   Before a slot is loaded again, cp.async.bulk.wait_group.read 0 drains
//   the store that reads it: the counterpart of `wr(c, slot).wait()` before
//   `rd(c + slots, slot)` in the TPU kernel.
// - The k-th use of a slot waits for its mbarrier's phase k, so the parity
//   is k & 1, tracked per slot as the sequence wraps the ring.
// - Only the async proxy touches the ring's buffers (TMA writes them, TMA
//   reads them).  The mbarriers are initialized by the generic proxy, so
//   fence.mbarrier_init follows the init; a fence.proxy.async.shared::cta
//   sits before each store as well, which costs nothing next to a 32 KiB
//   copy.
// The copy is bit for bit and dtype-agnostic: the wrapper checks that every
// address and size is a multiple of 16 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;      // one warp; lane 0 issues every copy
constexpr int kMaxBlocksPerSm = 2;
constexpr int kBarrierAlign = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    dma_pipeline_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                        int64_t nbytes, int tile_bytes, int slots, int iters) {
  extern __shared__ __align__(kBarrierAlign) uint8_t smem[];
  if (threadIdx.x != 0) return;

  // this block's byte range [lo, hi), cut into `tiles` tiles, copied
  // `iters` times: copy k is tile k % tiles of pass k / tiles
  const int64_t units = nbytes / 16;
  const int64_t lo = units * blockIdx.x / gridDim.x * 16;
  const int64_t hi = units * (blockIdx.x + 1) / gridDim.x * 16;
  if (hi <= lo) return;
  const int64_t tiles = (hi - lo + tile_bytes - 1) / tile_bytes;
  const int64_t count = tiles * iters;

  const int bar_bytes = (slots * 8 + kBarrierAlign - 1) / kBarrierAlign * kBarrierAlign;
  const uint32_t bars = smem_addr(smem);
  const uint32_t bufs = bars + bar_bytes;
  for (int s = 0; s < slots; ++s) mbar_init(bars + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto offset = [&](int64_t k) -> int64_t { return lo + (k % tiles) * tile_bytes; };
  auto size = [&](int64_t off) -> uint32_t {
    return (uint32_t)(hi - off < tile_bytes ? hi - off : tile_bytes);
  };
  auto load = [&](int64_t k, int slot) {
    const int64_t off = offset(k);
    const uint32_t bytes = size(off);
    const uint32_t bar = bars + 8 * slot;
    mbar_expect_tx(bar, bytes);
    bulk_load(bufs + (uint32_t)slot * tile_bytes, x + off, bytes, bar);
  };

  // warm-up: fill the ring
  const int64_t first = count < slots ? count : slots;
  for (int64_t k = 0; k < first; ++k) load(k, (int)k);

  for (int64_t k = 0; k < count; ++k) {
    const int slot = (int)(k % slots);
    const uint32_t parity = (uint32_t)((k / slots) & 1);
    mbar_wait(bars + 8 * slot, parity);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int64_t off = offset(k);
    bulk_store(out + off, bufs + (uint32_t)slot * tile_bytes, size(off));
    if (k + slots < count) {
      // the slot's store must have read its buffer before the next load
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      load(k + slots, slot);
    }
  }
  // every store complete before the block (and its shared memory) goes
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared memory one launch needs: the slots' mbarriers (rounded up to 128
// bytes), then `slots` buffers of `tile_bytes` each.
int64_t smem_bytes(int tile_bytes, int slots) {
  return (int64_t)(slots * 8 + kBarrierAlign - 1) / kBarrierAlign * kBarrierAlign +
         (int64_t)slots * tile_bytes;
}

int device_attr(cudaDeviceAttr attr, int fallback) {
  int device = 0;
  int value = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&value, attr, device) != cudaSuccess || value <= 0) {
    return fallback;
  }
  return value;
}

}  // namespace

// Launches `iters` passes of out[0:nbytes] = x[0:nbytes] on `stream`;
// returns the launch's cudaError_t (0 on success).  Does not synchronize.
// The caller guarantees: x, out, nbytes and tile_bytes multiples of 16,
// 1 <= slots, iters >= 1, and the shared memory above within the card's
// per-block limit (cudaErrorInvalidValue otherwise).
extern "C" int tpu_dma_pipeline_copy(const void* x, void* out, int64_t nbytes, int tile_bytes,
                                     int slots, int iters, cudaStream_t stream) {
  if (nbytes <= 0) return (int)cudaSuccess;
  if (tile_bytes <= 0 || tile_bytes % 16 || nbytes % 16 || slots < 1 || iters < 1 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t smem = smem_bytes(tile_bytes, slots);
  if (smem > device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 232448)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      dma_pipeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dma_pipeline_kernel, kThreads,
                                                      (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  // no more blocks than whole tiles: a small buffer gets fewer, fuller ranges
  const int64_t num_tiles = (nbytes + tile_bytes - 1) / tile_bytes;
  int64_t blocks = (int64_t)device_attr(cudaDevAttrMultiProcessorCount, 132) * per_sm;
  if (blocks > num_tiles) blocks = num_tiles;
  dma_pipeline_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), nbytes, tile_bytes, slots,
      iters);
  return (int)cudaGetLastError();
}
