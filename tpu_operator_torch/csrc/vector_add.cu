// Elementwise add, out = x + y, in f32, bf16 or f16, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_add_kernel` / `pallas_vector_add`
// (tpu_operator/workloads/collectives.py:96-115), the first check of the
// node readiness gate.  There the add ran over a (rows, 512) array of any
// dtype in blocks of at most (256, 512) on a cdiv grid whose edge blocks
// are partial.
//
// Bound: memory.  Each element reads two operands and writes one, 3 * n *
// sizeof(T) bytes for n adds, so the least time is those bytes over the
// card's HBM rate (3.35 TB/s on an H100 SXM); the arithmetic is
// negligible.  At the gate's 1<<20 f32 elements the 12 MiB working set
// fits in the 50 MB L2, so a repeated run can beat the HBM bound there.
//
// Design: the layout does not matter to an elementwise op, so the kernel
// sees the array flat.  When all three pointers are 16-byte aligned, each
// thread loads one 16-byte vector of each operand (4 f32 or 8 bf16/f16
// elements), neighbouring threads on neighbouring addresses, and stores one:
// a block of 256 threads owns one contiguous 4 KiB piece of each operand,
// and the grid has one block per piece.  There is no grid-stride loop: a
// thread issues both loads at once and retires, and the SM keeps as many
// blocks resident as it holds, so every SM has as many loads in flight as
// its thread slots allow.  The n % (elements per vector) leftover elements
// form a masked scalar tail; an unaligned view takes the scalar kernel over
// the whole array.  The masked tail plays the part of the Pallas grid's
// partial edge blocks.  Nothing is carried between blocks.
//
// Rounding: f32 is one IEEE add.  bf16 and f16 are widened to f32, added,
// and rounded once to nearest-even, as PyTorch computes `x + y` on a CUDA
// bf16/f16 tensor; so every dtype is bit-identical to `x + y`.  (Widening
// two bf16 or f16 values to f32, adding and rounding back gives the
// correctly rounded sum: f32 carries more than 2p + 2 bits, p the narrow
// type's, so the double rounding is innocuous.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

// the dtype codes of tpu_vector_add (kernels/vector_add.py keeps the same)
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
struct Add;

template <>
struct Add<float> {
  static __device__ __forceinline__ float one(float a, float b) { return a + b; }
  static __device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
};

template <>
struct Add<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 one(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  // two bf16 in one 32-bit word
  static __device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b) {
    __nv_bfloat162 va, vb;
    memcpy(&va, &a, 4);
    memcpy(&vb, &b, 4);
    const float2 fa = __bfloat1622float2(va), fb = __bfloat1622float2(vb);
    const __nv_bfloat162 r = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
    uint32_t out;
    memcpy(&out, &r, 4);
    return out;
  }
};

template <>
struct Add<__half> {
  static __device__ __forceinline__ __half one(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
  static __device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b) {
    __half2 va, vb;
    memcpy(&va, &a, 4);
    memcpy(&vb, &b, 4);
    const float2 fa = __half22float2(va), fb = __half22float2(vb);
    const __half2 r = __floats2half2_rn(fa.x + fb.x, fa.y + fb.y);
    uint32_t out;
    memcpy(&out, &r, 4);
    return out;
  }
};

// one 16-byte vector of each operand per thread; then at most 15 bytes of
// tail elements, added one by one by block 0
template <typename T>
__global__ void __launch_bounds__(kThreads)
    add_vec16(const uint4* __restrict__ x, const uint4* __restrict__ y, uint4* __restrict__ out,
              int64_t nvec, const T* __restrict__ x_tail, const T* __restrict__ y_tail,
              T* __restrict__ out_tail, int tail) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    const uint4 a = x[i];
    const uint4 b = y[i];
    out[i] = make_uint4(Add<T>::pair(a.x, b.x), Add<T>::pair(a.y, b.y), Add<T>::pair(a.z, b.z),
                        Add<T>::pair(a.w, b.w));
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    out_tail[threadIdx.x] = Add<T>::one(x_tail[threadIdx.x], y_tail[threadIdx.x]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    add_scalar(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = Add<T>::one(x[i], y[i]);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* xv, const void* yv, void* outv, int64_t n, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* y = static_cast<const T*>(yv);
  T* out = static_cast<T*>(outv);
  if (aligned16(x) && aligned16(y) && aligned16(out)) {
    constexpr int kPerVec = 16 / sizeof(T);
    const int64_t nvec = n / kPerVec;
    const int tail = (int)(n - nvec * kPerVec);
    int64_t blocks = (nvec + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;  // the tail alone still needs block 0
    add_vec16<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(x), reinterpret_cast<const uint4*>(y),
        reinterpret_cast<uint4*>(out), nvec, x + nvec * kPerVec, y + nvec * kPerVec,
        out + nvec * kPerVec, tail);
  } else {
    add_scalar<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(x, y, out, n);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches out[i] = x[i] + y[i] for i < n elements of `dtype` (0 f32, 1
// bf16, 2 f16) on `stream`; returns the launch's cudaError_t (0 on success,
// cudaErrorInvalidValue for another dtype code).  Does not synchronize.
extern "C" int tpu_vector_add(const void* x, const void* y, void* out, int64_t n, int dtype,
                              cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  switch (dtype) {
    case kF32:
      return (int)launch<float>(x, y, out, n, stream);
    case kBF16:
      return (int)launch<__nv_bfloat16>(x, y, out, n, stream);
    case kF16:
      return (int)launch<__half>(x, y, out, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
