// Flash-attention forward in f32, for Hopper (sm_90a): kernel B5's f32
// entries, the paged decode (`tpu_flash_paged_f32`) and the contiguous
// forward (`tpu_flash_forward_f32`), on one fold.
//
// Replaces the Pallas TPU kernel `_flash_full_kernel` /
// `flash_attention_local` (tpu_operator/workloads/longctx.py:47-150) where
// it is called with f32 q/k/v: the serving engine's flash attend
// (tpu_operator/workloads/serving.py:686-718), whose toy model and KV pool
// are f32.  There the engine gathers each running request's pages into a
// zero-padded [H, T, D] copy and runs the kernel's (bh, q-tile, k-block)
// grid on an 8-row causal query tail, of which it keeps the last row: the
// row at position L - 1, which sees keys 0 .. L - 1.  The paged entry
// computes exactly that row, one per (request, head), for every request of
// a decode step in one launch, reading K and V in place from the pool
// [num_blocks, block_tokens, H, D] through each request's block table:
// token p of request r is at pool[table[r, p / bt], p % bt, h, :].
//
// Numerics: every product is an f32 FMA on the CUDA cores, never TF32.  The
// serving tokens come from an argmax over logits, and the reference pins the
// flash path's tokens to the dense f32 path's, so the kernel keeps f32's
// error, about 1e-7 of the output, where one TF32 pass would leave 1e-3.
// Masked scores are NEG_INF and their probabilities exactly 0 (the
// reference's guard), so a row that sees no key ends with l = 0: out
// exactly 0 and lse exactly NEG_INF.  Every sum has a fixed order that
// depends only on the row's own length and the plan, never on the other
// rows of the launch, so two launches on the same inputs are bit-identical
// and a request's result does not depend on which requests share the step.
//
// Design: one block of 4 warps per (query row, key split).  A query row's
// D dims are spread over a group of G lanes (4 dims a lane, one 16-byte
// load; G = D / 4 rounded up to a power of two), so a warp scores 32 / G
// keys side by side, each lane group a different key, and every lane keeps
// kUnroll keys' K and V loads in flight; the group's partial dots meet in
// a butterfly of shuffles.  Each lane group folds its own keys, in key
// order, into an online-softmax state (m, l, acc); the groups of a warp
// merge by shuffles (a symmetric merge, unfused products), the warps in
// order through shared memory.  A row's keys are cut into `n_splits`
// contiguous ranges of whole pages, n_splits = ceil(pages / split_pages)
// capped at max_splits: a function of the row's own length, so a split
// never depends on the batch.  A row of one split writes out and lse
// itself; the partial states of a row of several go to scratch and a
// second, small launch merges them in split order.  The contiguous entry
// is the same fold over K/V rows [BH, Tk, D] (a row's live keys are those
// its causal position sees), never split.
//
// Bound: the work is 4 D FLOP and 8 D bytes of K and V per (row, live
// key): 0.5 FLOP a byte, far under the card's 20 f32 FLOP a byte, so the
// bytes bound it (each live K/V row read once, at 3.35 TB/s).  Reading the
// pages in place removes the engine's gathers and padding copies; the
// split fills the SMs when a step has few rows and long contexts (8
// requests x 8 heads at 4096 keys: 64 rows x 8 splits = 512 blocks, ~3.9
// per SM of 132); each warp keeps 8 K and 8 V 16-byte loads a lane in
// flight at D 128.  At the serving engine's own step (8 requests, 2 heads,
// D 16, contexts of a few dozen tokens) the bound is tens of nanoseconds
// and one launch's latency is the time: the design's gain there is one
// launch per step where the engine made one per request.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 128;
constexpr float kNegInf = -1e30f;

// The query rows of a launch, where their results go, and the split plan.
struct Rows {
  const float* q;  // [rows, d]
  float* out;      // [rows, d]
  float* lse;      // [rows]
  float* part;     // [rows, max_splits, d] acc, then [rows, max_splits, 2] (m, l)
  int rows, d, max_splits, split_pages;
  float scale;
};

// Keys [0, n) of a row that the fold reads, and where each one lives.
struct PagedRow {
  const int* table;  // the request's block table
  int64_t head, token_stride, page_stride;
  int bt;
  __device__ __forceinline__ int64_t at(int key) const {
    return static_cast<int64_t>(table[key / bt]) * page_stride + (key % bt) * token_stride +
           head;
  }
};

struct Paged {
  const float* k;
  const float* v;
  const int* tables;   // [requests, width] int32
  const int* lengths;  // [requests] int32
  int heads, bt, width;
  __device__ __forceinline__ int page_tokens() const { return bt; }
  __device__ __forceinline__ int keys(int row) const {
    return min(max(lengths[row / heads], 0), width * bt);
  }
  __device__ __forceinline__ PagedRow bind(int row, int d) const {
    const int64_t token_stride = static_cast<int64_t>(heads) * d;
    return {tables + static_cast<int64_t>(row / heads) * width,
            static_cast<int64_t>(row % heads) * d, token_stride, token_stride * bt, bt};
  }
};

struct ContiguousRow {
  int64_t base;
  int d;
  __device__ __forceinline__ int64_t at(int key) const {
    return base + static_cast<int64_t>(key) * d;
  }
};

struct Contiguous {
  const float* k;
  const float* v;
  int tq, tk, causal;
  int64_t q_off, k_off;
  __device__ __forceinline__ int page_tokens() const { return 1; }
  // the keys that query position q_off + (row % tq) sees: all unless causal
  __device__ __forceinline__ int keys(int row) const {
    if (!causal) return tk;
    const int64_t n = q_off + row % tq - k_off + 1;
    return n <= 0 ? 0 : (n < tk ? static_cast<int>(n) : tk);
  }
  __device__ __forceinline__ ContiguousRow bind(int row, int d) const {
    return {static_cast<int64_t>(row / tq) * tk * d, d};
  }
};

__device__ __forceinline__ int split_count(int pages, int split_pages, int max_splits) {
  const int n = (pages + split_pages - 1) / split_pages;
  return n < 1 ? 1 : (n < max_splits ? n : max_splits);
}

// Fold the state (mo, lo, ao) into (m, l, a).  Unfused products and sums,
// so merging a into b and b into a give the same bits.
__device__ __forceinline__ void merge(float& m, float& l, float4& a, float mo, float lo,
                                      float4 ao) {
  const float mx = fmaxf(m, mo);
  const float f = expf(m - mx), fo = expf(mo - mx);
  l = __fadd_rn(__fmul_rn(l, f), __fmul_rn(lo, fo));
  a.x = __fadd_rn(__fmul_rn(a.x, f), __fmul_rn(ao.x, fo));
  a.y = __fadd_rn(__fmul_rn(a.y, f), __fmul_rn(ao.y, fo));
  a.z = __fadd_rn(__fmul_rn(a.z, f), __fmul_rn(ao.z, fo));
  a.w = __fadd_rn(__fmul_rn(a.w, f), __fmul_rn(ao.w, fo));
  m = mx;
}

__device__ __forceinline__ float4 shfl_xor4(float4 a, int o) {
  return make_float4(__shfl_xor_sync(0xffffffffu, a.x, o), __shfl_xor_sync(0xffffffffu, a.y, o),
                     __shfl_xor_sync(0xffffffffu, a.z, o), __shfl_xor_sync(0xffffffffu, a.w, o));
}

template <int G, class Keys>
__global__ void __launch_bounds__(kThreads) fold_kernel(const Rows p, const Keys keys) {
  constexpr int kGroups = 32 / G;                 // keys side by side in a warp
  constexpr int kUnroll = G >= 8 ? G / 4 : 1;     // keys in flight per lane group
  constexpr int kStep = kUnroll * kWarps * kGroups;
  __shared__ float s_ml[kWarps][2];
  __shared__ float4 s_acc[kWarps][kMaxDim / 4];

  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int n = keys.keys(row);
  const int pt = keys.page_tokens();
  const int pages = (n + pt - 1) / pt;
  const int n_splits = split_count(pages, p.split_pages, p.max_splits);
  if (split >= n_splits) return;  // block-uniform: this row has fewer splits
  const int lo = static_cast<int>(static_cast<int64_t>(pages) * split / n_splits) * pt;
  const int hi =
      min(static_cast<int>(static_cast<int64_t>(pages) * (split + 1) / n_splits) * pt, n);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / G;  // the key this lane group scores
  const int c = lane % G;    // this lane's dims: 4c .. 4c + 3
  const bool holds = 4 * c < p.d;
  const auto rk = keys.bind(row, p.d);
  float4 q4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (holds) q4 = *reinterpret_cast<const float4*>(p.q + static_cast<int64_t>(row) * p.d + 4 * c);

  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = lo; base < hi; base += kStep) {
    float x[kUnroll];
    float4 vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + (u * kWarps + warp) * kGroups + grp;
      float dot = 0.f;
      vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key < hi && holds) {
        const int64_t at = rk.at(key) + 4 * c;
        const float4 k4 = __ldg(reinterpret_cast<const float4*>(keys.k + at));
        vr[u] = __ldg(reinterpret_cast<const float4*>(keys.v + at));
        dot = fmaf(q4.w, k4.w, fmaf(q4.z, k4.z, fmaf(q4.y, k4.y, q4.x * k4.x)));
      }
      x[u] = dot;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
      const int key = base + (u * kWarps + warp) * kGroups + grp;
      x[u] = key < hi ? x[u] * p.scale : kNegInf;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, x[u]);
    const float corr = expf(m - mx);
    l *= corr;
    acc.x *= corr;
    acc.y *= corr;
    acc.z *= corr;
    acc.w *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float e = x[u] <= kNegInf * 0.5f ? 0.f : expf(x[u] - mx);
      l += e;
      acc.x = fmaf(e, vr[u].x, acc.x);
      acc.y = fmaf(e, vr[u].y, acc.y);
      acc.z = fmaf(e, vr[u].z, acc.z);
      acc.w = fmaf(e, vr[u].w, acc.w);
    }
    m = mx;
  }

  // the warp's lane groups, then the block's warps in order
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo_ = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, acc, mo, lo_, shfl_xor4(acc, o));
  }
  if (grp == 0) {
    if (c == 0) {
      s_ml[warp][0] = m;
      s_ml[warp][1] = l;
    }
    if (holds) s_acc[warp][c] = acc;
  }
  __syncthreads();
  if (warp != 0 || grp != 0) return;
  for (int w = 1; w < kWarps; ++w)
    merge(m, l, acc, s_ml[w][0], s_ml[w][1], holds ? s_acc[w][c] : make_float4(0.f, 0.f, 0.f, 0.f));

  if (n_splits == 1) {
    const float denom = l > 0.f ? l : 1.f;
    if (holds)
      *reinterpret_cast<float4*>(p.out + static_cast<int64_t>(row) * p.d + 4 * c) =
          make_float4(acc.x / denom, acc.y / denom, acc.z / denom, acc.w / denom);
    if (c == 0) p.lse[row] = m + logf(denom);
    return;
  }
  const int64_t slot = static_cast<int64_t>(row) * p.max_splits + split;
  if (holds)
    *reinterpret_cast<float4*>(p.part + slot * p.d + 4 * c) = acc;
  if (c == 0) {
    float* ml = p.part + static_cast<int64_t>(p.rows) * p.max_splits * p.d + 2 * slot;
    ml[0] = m;
    ml[1] = l;
  }
}

// The rows of several splits: m* = max m_s, l* = sum l_s exp(m_s - m*),
// acc* likewise, in split order; one warp a row.
template <class Keys>
__global__ void __launch_bounds__(kThreads) merge_kernel(const Rows p, const Keys keys) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  const int pt = keys.page_tokens();
  const int n_splits = split_count((keys.keys(row) + pt - 1) / pt, p.split_pages, p.max_splits);
  if (n_splits == 1) return;  // the fold wrote this row
  const int64_t slot = static_cast<int64_t>(row) * p.max_splits;
  const float* acc = p.part + slot * p.d;
  const float* ml = p.part + static_cast<int64_t>(p.rows) * p.max_splits * p.d + 2 * slot;
  float m = kNegInf;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) l = fmaf(ml[2 * s + 1], expf(ml[2 * s] - m), l);
  const float denom = l > 0.f ? l : 1.f;
  for (int dim = lane; dim < p.d; dim += 32) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) a = fmaf(acc[s * p.d + dim], expf(ml[2 * s] - m), a);
    p.out[static_cast<int64_t>(row) * p.d + dim] = a / denom;
  }
  if (lane == 0) p.lse[row] = m + logf(denom);
}

template <class Keys>
int launch(const Rows& p, const Keys& keys, cudaStream_t stream) {
  int g = 2;
  while (4 * g < p.d) g <<= 1;
  const dim3 grid(p.rows, p.max_splits);
  switch (g) {
    case 2: fold_kernel<2><<<grid, kThreads, 0, stream>>>(p, keys); break;
    case 4: fold_kernel<4><<<grid, kThreads, 0, stream>>>(p, keys); break;
    case 8: fold_kernel<8><<<grid, kThreads, 0, stream>>>(p, keys); break;
    case 16: fold_kernel<16><<<grid, kThreads, 0, stream>>>(p, keys); break;
    default: fold_kernel<32><<<grid, kThreads, 0, stream>>>(p, keys); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.max_splits == 1) return static_cast<int>(err);
  merge_kernel<<<(p.rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(p, keys);
  return static_cast<int>(cudaGetLastError());
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
  if (d % 8 || d < 8 || d > kMaxDim || bh < 1 || tq < 1 || tk < 1 ||
      static_cast<int64_t>(bh) * tq > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows p{static_cast<const float*>(q), static_cast<float*>(out), lse, nullptr, bh * tq, d,
               1, 1, scale};
  const Contiguous keys{static_cast<const float*>(k), static_cast<const float*>(v), tq, tk,
                        causal, q_off, k_off};
  return launch(p, keys, stream);
}

// Paged decode in f32: out [R, H, D] and lse [R, H] for query q [R, H, D]
// against request r's first lengths[r] tokens, read from k_pool, v_pool
// [num_blocks, block_tokens, H, D] through block_tables [R, width] (int32;
// entries past a request's live pages are never read); lengths past width
// x block_tokens are cut there.  D a multiple of 8 up to 128.  `part` holds
// R x H x max_splits x (D + 2) floats when max_splits > 1 (else may be
// null); a row's split count is ceil(pages / split_pages) capped at
// max_splits.  Launches the fold, and the merge when max_splits > 1, on
// `stream` without synchronizing; returns the first cudaError_t (0 on
// success).
extern "C" int tpu_flash_paged_f32(const void* q, const void* k_pool, const void* v_pool,
                                   const int* block_tables, const int* lengths, void* out,
                                   float* lse, float* part, int requests, int heads, int d,
                                   int block_tokens, int width, int max_splits, int split_pages,
                                   float scale, cudaStream_t stream) {
  if (d % 8 || d < 8 || d > kMaxDim || requests < 1 || heads < 1 || block_tokens < 1 ||
      width < 1 || max_splits < 1 || max_splits > 65535 || split_pages < 1 ||
      static_cast<int64_t>(requests) * heads > INT_MAX ||
      static_cast<int64_t>(width) * block_tokens > INT_MAX || (max_splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows p{static_cast<const float*>(q), static_cast<float*>(out), lse, part,
               requests * heads, d, max_splits, split_pages, scale};
  const Paged keys{static_cast<const float*>(k_pool), static_cast<const float*>(v_pool),
                   block_tables, lengths, heads, block_tokens, width};
  return launch(p, keys, stream);
}
