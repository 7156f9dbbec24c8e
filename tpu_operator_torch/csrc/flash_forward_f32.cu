// Full flash-attention forward in f32, for Hopper (sm_90a): kernel B5's f32
// entry.
//
// Replaces the Pallas TPU kernel `_flash_full_kernel` /
// `flash_attention_local` (tpu_operator/workloads/longctx.py:47-150) where
// it is called with f32 q/k/v: the serving engine's flash attend
// (tpu_operator/workloads/serving.py:686-718), whose toy model and KV pool
// are f32.  There the kernel ran a (bh, q-tile, k-block) grid whose k-blocks
// fold into an online-softmax state held in VMEM, k-blocks past the tile's
// last query skipped; the serving shapes are BH 2 (the heads), an 8-row
// query tail, Tk the context padded to a 16-token page, D 8 or 16.
//
// Numerics: every product is an f32 FMA on the CUDA cores, never TF32.  The
// serving tokens come from an argmax over logits, and the reference pins the
// flash path's tokens to the dense f32 path's, so the kernel keeps f32's
// error, about 1e-7 of the output, where one TF32 pass would leave 1e-3.
//
// Design: one block of 8 warps per (bh, 8-row q tile), one warp per query
// row.  The block stages 64-key tiles of K and V in shared memory (K rows
// padded to D + 1 floats, so the 32 lanes reading 32 keys' element d hit 32
// banks), and each warp folds a tile into its row's (m, l, acc) state: lane
// j scores keys j and j + 32 (a sequential FMA chain over D), the warp
// reduces the tile's max and sum with shuffles in a fixed order, the
// probabilities go through shared memory, and lane j accumulates the output
// dims j, j + 32, j + 64 and j + 96 over the tile's 64 keys in key order.
// Causal: tiles past the block's last query are never loaded, and a warp
// skips a tile whose first key is past its own row (the fold of a fully
// masked tile is the identity).  Masked scores are NEG_INF and their
// probabilities exactly 0 (the reference's guard), so a row that sees no
// key ends with l = 0: out exactly 0 and lse exactly NEG_INF, as the bf16
// paths give.  Every sum has a fixed order, so two launches on the same
// inputs are bit-identical.
//
// Bound: at the serving shapes the work is a few hundred kFLOP and a few
// tens of KB, far below one launch; the kernel is written to be right and
// simple, not fast.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;        // query rows per block, one warp each
constexpr int kThreads = 32 * kRows;
constexpr int kTile = 64;       // keys per shared-memory tile
constexpr int kMaxDim = 128;
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;
  int tq, tk, d;
  int64_t q_off, k_off;
  int causal;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// keys [0, n) that some query at global position `last_q` or before can see
__device__ __forceinline__ int live_keys(const Params& p, int64_t last_q) {
  if (!p.causal) return p.tk;
  int64_t n = last_q - p.k_off + 1;
  return n <= 0 ? 0 : (n < p.tk ? static_cast<int>(n) : p.tk);
}

__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int ks = d + 1;                 // padded K row stride
  float* sk = smem;                     // [kTile][d + 1]
  float* sv = sk + kTile * ks;          // [kTile][d]
  float* sq = sv + kTile * d;           // [kRows][d]
  float* sp = sq + kRows * d;           // [kRows][kTile] probabilities

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = q0 + warp;
  const bool has_row = row < p.tq;
  const float* qb = p.q + (static_cast<int64_t>(bh) * p.tq) * d;
  const float* kb = p.k + (static_cast<int64_t>(bh) * p.tk) * d;
  const float* vb = p.v + (static_cast<int64_t>(bh) * p.tk) * d;

  const int rows_here = min(kRows, p.tq - q0);
  for (int i = threadIdx.x; i < rows_here * d; i += kThreads) sq[i] = qb[q0 * d + i];

  const int block_keys = live_keys(p, p.q_off + q0 + rows_here - 1);
  const int row_keys = has_row ? live_keys(p, p.q_off + row) : 0;
  const int64_t q_pos = p.q_off + row;

  float m = kNegInf, l = 0.f;
  float acc[kMaxDim / 32] = {0.f, 0.f, 0.f, 0.f};

  for (int t0 = 0; t0 < block_keys; t0 += kTile) {
    const int n = min(kTile, p.tk - t0);
    __syncthreads();  // the previous tile's readers are done (and sq is written)
    for (int i = threadIdx.x; i < n * d; i += kThreads) {
      const int j = i / d, c = i - j * d;
      sk[j * ks + c] = kb[static_cast<int64_t>(t0) * d + i];
      sv[i] = vb[static_cast<int64_t>(t0) * d + i];
    }
    __syncthreads();
    if (!has_row || t0 >= row_keys) continue;  // warp-uniform: the tile is masked for this row

    const float* qr = sq + warp * d;
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      float x = kNegInf;
      const bool visible = j < n && (!p.causal || q_pos >= p.k_off + t0 + j);
      if (visible) {
        const float* kr = sk + j * ks;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        x = dot * p.scale;
      }
      s[h] = x;
    }
    const float m_new = fmaxf(m, warp_max(fmaxf(s[0], s[1])));
    const float corr = expf(m - m_new);
    float e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) e[h] = s[h] <= kNegInf * 0.5f ? 0.f : expf(s[h] - m_new);
    l = l * corr + warp_sum(e[0] + e[1]);
    float* pr = sp + warp * kTile;
    pr[lane] = e[0];
    pr[lane + 32] = e[1];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kMaxDim / 32; ++c) {
      const int dim = lane + 32 * c;
      if (dim < d) {
        float pv = 0.f;
        for (int j = 0; j < n; ++j) pv = fmaf(pr[j], sv[j * d + dim], pv);
        acc[c] = acc[c] * corr + pv;
      }
    }
    __syncwarp();  // pr is rewritten by the next tile
    m = m_new;
  }

  if (!has_row) return;
  const float denom = l > 0.f ? l : 1.f;
  float* orow = p.out + (static_cast<int64_t>(bh) * p.tq + row) * d;
#pragma unroll
  for (int c = 0; c < kMaxDim / 32; ++c) {
    const int dim = lane + 32 * c;
    if (dim < d) orow[dim] = acc[c] / denom;
  }
  if (lane == 0) p.lse[static_cast<int64_t>(bh) * p.tq + row] = m + logf(denom);
}

size_t smem_bytes(int d) {
  return sizeof(float) * (kTile * (d + 1) + kTile * d + kRows * d + kRows * kTile);
}

}  // namespace

// Full flash forward in f32: out [BH, Tq, D] and lse [BH, Tq] from q
// [BH, Tq, D] and k, v [BH, Tk, D], all contiguous f32; D a multiple of 8 up
// to 128; causal positions q_off + row and k_off + col.  Launches on
// `stream` without synchronizing; returns the launch's cudaError_t (0 on
// success).
extern "C" int tpu_flash_forward_f32(const void* q, const void* k, const void* v, void* out,
                                     float* lse, int bh, int tq, int tk, int d, int64_t q_off,
                                     int64_t k_off, int causal, float scale,
                                     cudaStream_t stream) {
  if (d % 8 || d < 8 || d > kMaxDim || bh < 1 || tq < 1 || tk < 1 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.lse = lse;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.scale = scale;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tq + kRows - 1) / kRows, bh);
  flash_f32_kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
