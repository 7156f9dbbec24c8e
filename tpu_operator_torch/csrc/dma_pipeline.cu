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
//   `slots` is still the number of tiles in a block's ring.  The wrapper
//   sizes the grid: as many blocks as fit on every SM at once (their rings
//   side by side in its shared memory), at most one per tile.
// - The TPU grid is one sequential program; here the blocks split the
//   buffer in rounds: in round r, block b copies tile r * gridDim.x + b, so
//   at any time the blocks work on one moving window of the buffer, as an
//   elementwise copy's threads do.  The rest that does not fill a round
//   is split evenly, in 16-byte units, one piece per block, so every block
//   moves the same bytes and none finishes a long run passes behind the
//   others.  One contiguous range per block (the earlier design, whose
//   grid works at a hundred or more places of the buffer at once, far
//   apart) ran slower on an H100 at every tile and ring depth tried.
// - A block copies its own tiles `iters` times.  Every pass writes the same
//   bytes and x is read-only, so the passes need no barrier between them.
//   No two blocks ever touch the same bytes, so a pass cannot read what
//   another block's pass just brought into the L2: a block reads a tile
//   again only after the whole grid has streamed the rest of the buffer,
//   which for a buffer well past the 50 MB L2 means every pass streams
//   device memory.  (An even split of the pass-major sequence of tile
//   copies would put blocks whole passes apart on the same tiles at the
//   same time, and the L2 would serve their reads above the memory rate.)
// - One thread per block issues everything.  A load is
//   cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes on
//   the slot's mbarrier, armed with expect_tx; a store is
//   cp.async.bulk.global.shared::cta.bulk_group, one bulk group per store.
//   A slot is loaded again only once the store that reads it has read it
//   out (cp.async.bulk.wait_group.read), the counterpart of `wr(c,
//   slot).wait()` before `rd(c + slots, slot)` in the TPU kernel.  But the
//   slot reloaded after store k is that of store k - 1, so the wait is
//   `.read 1`: it lets store k, issued a moment ago, run on, and store k - 1
//   has had a whole turn to drain.  Waiting on store k itself (`.read 0`)
//   keeps one store in flight per block and stalls the issuing thread for
//   a full tile read-out at every turn.  With one slot there is no older
//   store, and the wait is `.read 0`.
// - The k-th use of a slot waits for its mbarrier's phase k, so the parity
//   is k & 1, tracked per slot as the sequence wraps the ring.
// - Only the async proxy touches the ring's buffers (TMA writes them, TMA
//   reads them).  The mbarriers are initialized by the generic proxy, so
//   fence.mbarrier_init follows the init; a fence.proxy.async.shared::cta
//   sits before each store as well, which costs nothing next to a tile.
// The copy is bit for bit and dtype-agnostic: the wrapper checks that every
// address and size is a multiple of 16 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 32;  // one warp; lane 0 issues every copy
constexpr int kBarrierAlign = 128;

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

  // this block's pieces: tile r * grid + b in each of the `full` rounds,
  // then its share [rest_lo, rest_hi) of what does not fill a round
  const int64_t grid = gridDim.x;
  const int64_t b = blockIdx.x;
  const int64_t round_bytes = grid * tile_bytes;
  const int64_t full = nbytes / round_bytes;
  const int64_t rest_units = (nbytes - full * round_bytes) / 16;
  const int64_t rest_lo = full * round_bytes + rest_units * b / grid * 16;
  const int64_t rest_hi = full * round_bytes + rest_units * (b + 1) / grid * 16;
  const int64_t pieces = full + (rest_hi > rest_lo ? 1 : 0);
  if (pieces == 0) return;
  // copy k is piece k % pieces of pass k / pieces
  const int64_t count = pieces * iters;

  const int bar_bytes = (slots * 8 + kBarrierAlign - 1) / kBarrierAlign * kBarrierAlign;
  const uint32_t bars = smem_u32(smem);
  const uint32_t bufs = bars + bar_bytes;
  for (int s = 0; s < slots; ++s) mbar_init(bars + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto offset = [&](int64_t k) -> int64_t {
    const int64_t i = k % pieces;
    return i < full ? (i * grid + b) * tile_bytes : rest_lo;
  };
  auto size = [&](int64_t k) -> uint32_t {
    return (uint32_t)(k % pieces < full ? tile_bytes : rest_hi - rest_lo);
  };
  auto load = [&](int64_t k, int slot) {
    const uint32_t bar = bars + 8 * slot;
    mbar_expect_tx(bar, size(k));
    bulk_load(bufs + (uint32_t)slot * tile_bytes, x + offset(k), size(k), bar);
  };

  // warm-up: fill the ring
  const int64_t first = count < slots ? count : slots;
  for (int64_t k = 0; k < first; ++k) load(k, (int)k);

  // the slot reloaded after store k is that of store k - lag
  const int lag = slots > 1 ? 1 : 0;
  for (int64_t k = 0; k < count; ++k) {
    const int slot = (int)(k % slots);
    const uint32_t parity = (uint32_t)((k / slots) & 1);
    mbar_wait(bars + 8 * slot, parity);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(out + offset(k), bufs + (uint32_t)slot * tile_bytes, size(k));
    const int64_t j = k - lag;
    if (j >= 0 && j + slots < count) {
      // store j must have read its slot out before the slot is loaded again
      if (lag) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      load(j + slots, (int)(j % slots));
    }
  }
  // every store complete before the block (and its shared memory) goes
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared memory one block needs: the slots' mbarriers (rounded up to 128
// bytes), then `slots` buffers of `tile_bytes` each.  kernels/dma_pipeline.py
// computes the same.
int64_t smem_bytes(int tile_bytes, int slots) {
  return (int64_t)(slots * 8 + kBarrierAlign - 1) / kBarrierAlign * kBarrierAlign +
         (int64_t)slots * tile_bytes;
}

}  // namespace

// Launches `iters` passes of out[0:nbytes] = x[0:nbytes] over `blocks`
// blocks on `stream`; returns the first failing call's cudaError_t (0 on
// success).  Does not synchronize.  The caller guarantees: x, out, nbytes
// and tile_bytes multiples of 16, 1 <= slots, iters >= 1, 1 <= blocks <=
// the number of tiles, and the shared memory above within the card's
// per-block limit (cudaFuncSetAttribute refuses it otherwise).
extern "C" int tpu_dma_pipeline_copy(const void* x, void* out, int64_t nbytes, int tile_bytes,
                                     int slots, int iters, int blocks, cudaStream_t stream) {
  if (nbytes <= 0) return (int)cudaSuccess;
  if (tile_bytes <= 0 || tile_bytes % 16 || nbytes % 16 || slots < 1 || iters < 1 ||
      blocks < 1 || blocks > (nbytes + tile_bytes - 1) / tile_bytes ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t smem = smem_bytes(tile_bytes, slots);
  if (smem > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dma_pipeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dma_pipeline_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), nbytes, tile_bytes, slots,
      iters);
  return (int)cudaGetLastError();
}
