// Elementwise f32 add, out = x + y, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_add_kernel` / `pallas_vector_add`
// (tpu_operator/workloads/collectives.py:96-115), the first check of the
// node readiness gate.  There the add ran over a (rows, 512) array in
// blocks of at most (256, 512) on a cdiv grid whose edge blocks are partial.
//
// Bound: memory.  Each element reads 8 bytes and writes 4 for one add, so
// the least time is 12 * n bytes over the card's HBM rate (3.35 TB/s on an
// H100 SXM); the arithmetic is negligible.  At the gate's 1<<20 elements the
// 12 MiB working set fits in the 50 MB L2, so a repeated run can beat the
// HBM bound there.
//
// Design: the layout does not matter to an elementwise op, so the kernel
// sees the array flat.  When all three pointers are 16-byte aligned, each
// thread moves float4s (16-byte loads and stores, neighbouring threads on
// neighbouring addresses) in a grid-stride loop, and the n % 4 leftover
// elements form a masked scalar tail; otherwise (an unaligned view) the
// whole array takes the scalar grid-stride loop.  The masked tail plays the
// part of the Pallas grid's partial edge blocks.  The grid is sized to fill
// every SM (8 resident blocks of 256 threads each) and no larger, and
// nothing is carried between blocks.  Each output is one IEEE f32 add, the
// same rounding as `x + y` in PyTorch, so the result is bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 = 2048 threads, an SM's maximum

__global__ void add_f32_vec4(const float4* __restrict__ x,
                             const float4* __restrict__ y,
                             float4* __restrict__ out,
                             int64_t n4,
                             const float* __restrict__ x_tail,
                             const float* __restrict__ y_tail,
                             float* __restrict__ out_tail,
                             int tail) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = x[i];
    const float4 b = y[i];
    out[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  // masked tail: at most 3 elements past the last whole float4
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    out_tail[threadIdx.x] = x_tail[threadIdx.x] + y_tail[threadIdx.x];
  }
}

__global__ void add_f32_scalar(const float* __restrict__ x,
                               const float* __restrict__ y,
                               float* __restrict__ out,
                               int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = x[i] + y[i];
  }
}

int sm_count() {
  int device = 0;
  int count = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      count <= 0) {
    count = 132;  // H100 SXM; the launch stays correct with any grid size
  }
  return count;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launches out[i] = x[i] + y[i] for i < n on `stream`; returns the launch's
// cudaError_t (0 on success).  Does not synchronize.
extern "C" int tpu_vector_add_f32(const float* x, const float* y, float* out,
                                  int64_t n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t max_blocks = (int64_t)sm_count() * kBlocksPerSm;
  if (aligned16(x) && aligned16(y) && aligned16(out)) {
    const int64_t n4 = n / 4;
    const int tail = (int)(n - n4 * 4);
    int64_t blocks = (n4 + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;  // the tail alone still needs block 0
    if (blocks > max_blocks) blocks = max_blocks;
    add_f32_vec4<<<(unsigned)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
        reinterpret_cast<float4*>(out), n4, x + n4 * 4, y + n4 * 4,
        out + n4 * 4, tail);
  } else {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > max_blocks) blocks = max_blocks;
    add_f32_scalar<<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, out, n);
  }
  return (int)cudaGetLastError();
}
