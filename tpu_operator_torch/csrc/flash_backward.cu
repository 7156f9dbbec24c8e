// The ring-remat training path's flash kernels for Hopper (sm_90a), f32 and
// bf16 storage, on the CUDA cores:
//
//   tpu_flash_block_backward_f32 / _bf16  replace `_flash_block_bwd_kernel` /
//       `flash_block_backward` (tpu_operator/workloads/ring_attention.py:
//       577-683): the FlashAttention-2 backward of one ring hop, adding
//       this hop's dq, dk, dv into the travelling f32 accumulators in place.
//   tpu_flash_block_update_f32  is kernel B3 (`_flash_block_kernel` /
//       `flash_block_update`, ring_attention.py:118-218) on f32 q, k, v:
//       the remat forward of the transformer step, whose weights, and so
//       q, k, v, are f32 (the bf16 entry is in flash_attention.cu).
//
// Numerics are the reference's.  Scores s = dot_f32(q, k) * scale, masked
// scores are out (causal on global positions q_off + row >= k_off + col),
// and the guard s <= NEG_INF / 2 -> 0 with NEG_INF = -1e30.
//   Backward: P = exp(s - lse) from the forward's saved lse; dV += P^T dO;
//   dP = dO V^T; dS = P (dP - D) with D = rowsum(dO O) given; dQ += dS K
//   scale; dK += dS^T Q scale.  In bf16, P is rounded to bf16 before P^T
//   dO and dS before dS K and dS^T Q (`.astype(q.dtype)` at :602 and :609),
//   every product accumulated in f32.  In f32 nothing is rounded.
//   Forward fold: m' = max(m, rowmax s), corr = exp(m - m'), e = exp(s -
//   m'), l' = l corr + rowsum e, o' = o corr + e V, all f32.
// Every product and sum runs in f32 FMA on the CUDA cores, not TF32: TF32
// keeps 10 mantissa bits, and the reference's f32 pins were set for f32.
//
// Bound, on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35
// TB/s): the train hop (BH 128, T 2048, D 128, causal, diagonal) does 10 D
// FLOP per unmasked (query, key) pair in the backward, 3.4e11 FLOP, 5.1 ms,
// against 0.40 ms for its 1.34 GB of q/k/v/dO/lse/D read and dq/dk/dv read
// and written: operations.  The forward fold does 4 D per pair, 1.4e11
// FLOP, 2.1 ms: operations.
//
// Design.  A Hopper block has 227 KB of shared memory where the TPU kernel
// had megabytes of VMEM, and blocks run in no order, so the TPU kernel's
// revisit-and-accumulate grid (one dq tile per grid step, dk/dv summed over
// the hop's q tiles in place) becomes two kernels with no atomics:
//   - dk/dv: one block per (bh, 64-key tile), walking the q tiles that see
//     any of its keys, dK and dV in registers;
//   - dq: one block per (bh, 64-row q tile), walking the k tiles it sees,
//     dQ in registers.
// Each output element is written by one block, in a fixed order, so the
// result is deterministic; the price is S and dP computed twice.  Tiles of
// 64 rows are staged in shared memory as f32 (bf16 converted on the way in)
// with a row stride of D + 1 floats, zero-filled past T and past D, so the
// kernel takes any T and masks the ragged edge itself.  256 threads, 16 x
// 16: each computes a 4 x 4 patch of the 64 x 64 score tile (rows ty*4+i,
// keys tx+16j) and holds 4 rows x D/16 columns of its accumulator.  P and
// dS go through shared memory for the transposed products.  D is padded to
// 16, 32, 64 or 128 (one template instance each); at D 128 in f32 the dk/dv
// kernel takes 165 KB.  Tiles past the causal diagonal are skipped, which
// changes nothing (their P is exactly 0 under the guard); a block with no
// visible tile writes nothing, so a fully masked hop leaves dq/dk/dv bit
// for bit.  Not done here, left to later work: tensor cores (wgmma on bf16;
// 3xTF32 for f32), cp.async/TMA staging, and more than one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;           // q rows of a q tile, keys of a k tile
constexpr int kThreads = 256;       // 16 x 16, one 4 x 4 score patch each
constexpr int kPStride = kTile + 1;  // row stride of the P and dS tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the reference's `.astype(q.dtype)` on an f32 value, back in f32
template <typename T>
struct Round;
template <>
struct Round<float> {
  __device__ __forceinline__ static float apply(float x) { return x; }
};
template <>
struct Round<__nv_bfloat16> {
  __device__ __forceinline__ static float apply(float x) {
    return __bfloat162float(__float2bfloat16(x));  // round to nearest even
  }
};

template <typename T>
struct BwdParams {
  const T* q;         // [BH, Tq, D]
  const T* k;         // [BH, Tk, D]
  const T* v;         // [BH, Tk, D]
  const T* dout;      // [BH, Tq, D]
  const float* lse;   // [BH, Tq]
  const float* dsum;  // [BH, Tq]  rowsum(dO * O)
  float* dq;          // [BH, Tq, D]  accumulated in place
  float* dk;          // [BH, Tk, D]  accumulated in place
  float* dv;          // [BH, Tk, D]  accumulated in place
  int bh, tq, tk, d;
  int64_t q_off, k_off;
  int causal;
  float scale;
};

struct FoldParams {
  const float* q;  // [BH, Tq, D]
  const float* k;  // [BH, Tk, D]
  const float* v;  // [BH, Tk, D]
  float* m;        // [BH, Tq]     in place
  float* l;        // [BH, Tq]     in place
  float* o;        // [BH, Tq, D]  in place
  int bh, tq, tk, d;
  int64_t q_off, k_off;
  int causal;
  float scale;
};

// Rows [r0, r0 + kTile) of one head of a [BH, T, D] tensor into shared
// memory as f32, row stride DP + 1, zero past T and past D.
template <int DP, typename T>
__device__ __forceinline__ void load_tile(float* s, const T* g, int bh, int t, int d, int r0) {
  constexpr int kStride = DP + 1;
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    const int row = r0 + r;
    float x = 0.f;
    if (row < t && c < d) x = to_f32(g[((int64_t)bh * t + row) * d + c]);
    s[r * kStride + c] = x;
  }
}

// acc[i][j] = sum over c of a[ty*4 + i][c] * b[tx + 16 j][c]: one 4 x 4
// patch of a 64 x 64 product of two staged tiles.
template <int DP>
__device__ __forceinline__ void patch_dot(float (&acc)[4][4], const float* a, const float* b,
                                          int ty, int tx) {
  constexpr int kStride = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float av[4];
    float bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * kStride + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kStride + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The score patch's P and dS for q tile q0 against k tile k0, written to
// shared memory (rounded to the storage type) at [q row][key].
template <int DP, typename T>
__device__ __forceinline__ void probs_and_grads(const BwdParams<T>& p, const float* qs,
                                                const float* dos, const float* ks,
                                                const float* vs, const float (&lse)[4],
                                                const float (&dsum)[4], int q0, int k0,
                                                float* ps, float* dss) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float s[4][4];
  float dp[4][4];
  patch_dot<DP>(s, qs, ks, ty, tx);
  patch_dot<DP>(dp, dos, vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool live = row < p.tq && key < p.tk &&
                        (!p.causal || p.q_off + row >= p.k_off + key);
      const float x = s[i][j] * p.scale;
      // exact probabilities from the saved lse; the guard covers a row
      // whose lse collapsed to NEG_INF
      const float prob = (!live || x <= kNegInf * 0.5f) ? 0.f : expf(x - lse[i]);
      const float ds = prob * (dp[i][j] - dsum[i]);
      const int at = (ty * 4 + i) * kPStride + tx + 16 * j;
      if (ps != nullptr) ps[at] = Round<T>::apply(prob);
      dss[at] = Round<T>::apply(ds);
    }
  }
}

template <typename T>
__device__ __forceinline__ void row_scalars(const BwdParams<T>& p, int bh, int q0,
                                            float (&lse)[4], float (&dsum)[4]) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool ok = row < p.tq;
    lse[i] = ok ? p.lse[(int64_t)bh * p.tq + row] : 0.f;
    dsum[i] = ok ? p.dsum[(int64_t)bh * p.tq + row] : 0.f;
  }
}

// One block per (bh, 64-key tile): dK and dV of its keys over every q tile
// that sees one of them, added into dk/dv once at the end.
template <int DP, typename T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const BwdParams<T> p) {
  constexpr int kStride = DP + 1;
  constexpr int kTileElems = kTile * kStride;
  constexpr int kCols = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTileElems;
  float* qs = vs + kTileElems;
  float* dos = qs + kTileElems;
  float* ps = dos + kTileElems;
  float* dss = ps + kTile * kPStride;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int n_q = (p.tq + kTile - 1) / kTile;
  int first = 0;
  if (p.causal) {
    // query rows before `need` see none of this tile's keys
    const int64_t need = p.k_off + k0 - p.q_off;
    if (need >= p.tq) {
      first = n_q;
    } else if (need > 0) {
      first = (int)(need / kTile);
    }
  }
  if (first >= n_q) return;  // a fully masked tile: dk/dv untouched

  load_tile<DP>(ks, p.k, bh, p.tk, p.d, k0);
  load_tile<DP>(vs, p.v, bh, p.tk, p.d, k0);
  float dk[4][kCols];
  float dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int it = first; it < n_q; ++it) {
    const int q0 = it * kTile;
    __syncthreads();  // the last tile's readers are done with qs, dos, ps, dss
    load_tile<DP>(qs, p.q, bh, p.tq, p.d, q0);
    load_tile<DP>(dos, p.dout, bh, p.tq, p.d, q0);
    float lse[4];
    float dsum[4];
    row_scalars(p, bh, q0, lse, dsum);
    __syncthreads();
    probs_and_grads<DP>(p, qs, dos, ks, vs, lse, dsum, q0, k0, ps, dss);
    __syncthreads();
    // dV[key][c] += sum_r P[r][key] dO[r][c]; dK[key][c] += sum_r dS[r][key] Q[r][c]
    for (int r = 0; r < kTile; ++r) {
      float pv[4];
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * kPStride + ty * 4 + i];
        sv[i] = dss[r * kPStride + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float dov = dos[r * kStride + tx + 16 * c];
        const float qv = qs[r * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pv[i], dov, dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= p.tk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col >= p.d) continue;
      const int64_t at = ((int64_t)bh * p.tk + key) * p.d + col;
      p.dk[at] += dk[i][c] * p.scale;
      p.dv[at] += dv[i][c];
    }
  }
}

// One block per (bh, 64-row q tile): dQ of its rows over every k tile it
// sees, added into dq once at the end.
template <int DP, typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdParams<T> p) {
  constexpr int kStride = DP + 1;
  constexpr int kTileElems = kTile * kStride;
  constexpr int kCols = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTileElems;
  float* ks = dos + kTileElems;
  float* vs = ks + kTileElems;
  float* dss = vs + kTileElems;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  int n_k = (p.tk + kTile - 1) / kTile;
  if (p.causal) {
    // the last key any row of this tile sees
    const int last_row = min(q0 + kTile, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kTile + 1;
    if (need < n_k) n_k = (int)need;
  }
  if (n_k == 0) return;  // every key past every query: dq untouched

  load_tile<DP>(qs, p.q, bh, p.tq, p.d, q0);
  load_tile<DP>(dos, p.dout, bh, p.tq, p.d, q0);
  float lse[4];
  float dsum[4];
  row_scalars(p, bh, q0, lse, dsum);
  float dq[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;
  }

  for (int jt = 0; jt < n_k; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();  // the last tile's readers are done with ks, vs, dss
    load_tile<DP>(ks, p.k, bh, p.tk, p.d, k0);
    load_tile<DP>(vs, p.v, bh, p.tk, p.d, k0);
    __syncthreads();
    probs_and_grads<DP>(p, qs, dos, ks, vs, lse, dsum, q0, k0, nullptr, dss);
    __syncthreads();
    // dQ[row][c] += sum_key dS[row][key] K[key][c]
    for (int kk = 0; kk < kTile; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = ks[kk * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(sv[i], kv, dq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.tq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) p.dq[((int64_t)bh * p.tq + row) * p.d + col] += dq[i][c] * p.scale;
    }
  }
}

// Kernel B3 on f32 storage: one block per (bh, 64-row q tile) folds every
// 64-key tile it sees into the (m, l, o) state of its rows, held in
// registers, and writes the state back once.  A tile past the causal
// diagonal is skipped: its update is an exact no-op.
template <int DP>
__global__ void __launch_bounds__(kThreads) fold_f32_kernel(const FoldParams p) {
  constexpr int kStride = DP + 1;
  constexpr int kTileElems = kTile * kStride;
  constexpr int kCols = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kTileElems;
  float* vs = ks + kTileElems;
  float* es = vs + kTileElems;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  int n_k = (p.tk + kTile - 1) / kTile;
  if (p.causal) {
    const int last_row = min(q0 + kTile, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kTile + 1;
    if (need < n_k) n_k = (int)need;
  }
  if (n_k == 0) return;  // a fully masked block: the state stays as it is

  load_tile<DP>(qs, p.q, bh, p.tq, p.d, q0);
  float m[4];
  float l[4];
  float o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool ok = row < p.tq;
    const int64_t at = (int64_t)bh * p.tq + row;
    m[i] = ok ? p.m[at] : kNegInf;
    l[i] = ok ? p.l[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      o[i][c] = (ok && col < p.d) ? p.o[at * p.d + col] : 0.f;
    }
  }

  for (int jt = 0; jt < n_k; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();  // the last tile's readers are done with ks, vs, es
    load_tile<DP>(ks, p.k, bh, p.tk, p.d, k0);
    load_tile<DP>(vs, p.v, bh, p.tk, p.d, k0);
    __syncthreads();
    float s[4][4];
    patch_dot<DP>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = key < p.tk && (!p.causal || p.q_off + row >= p.k_off + key);
        s[i][j] = live ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // a row's 64 keys sit in the 16 lanes of one half warp (the tx bits)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[i][j];
        const float e = x <= kNegInf * 0.5f ? 0.f : expf(x - m_new);  // fully masked guard
        es[(ty * 4 + i) * kPStride + tx + 16 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= corr;
    }
    __syncthreads();
    // o[row][c] += sum_key e[row][key] V[key][c]
    for (int kk = 0; kk < kTile; ++kk) {
      float ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ev[i] = es[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[kk * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(ev[i], vv, o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.tq) continue;
    const int64_t at = (int64_t)bh * p.tq + row;
    if (tx == 0) {
      p.m[at] = m[i];
      p.l[at] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) p.o[at * p.d + col] = o[i][c];
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int tile_bytes(int dp) { return kTile * (dp + 1) * (int)sizeof(float); }
constexpr int score_bytes() { return kTile * kPStride * (int)sizeof(float); }

template <int DP, typename T>
int launch_backward(const BwdParams<T>& p, cudaStream_t stream) {
  constexpr int kDkdvSmem = 4 * tile_bytes(DP) + 2 * score_bytes();
  constexpr int kDqSmem = 4 * tile_bytes(DP) + score_bytes();
  int err = set_smem(dkdv_kernel<DP, T>, kDkdvSmem);
  if (err != 0) return err;
  err = set_smem(dq_kernel<DP, T>, kDqSmem);
  if (err != 0) return err;
  dkdv_kernel<DP, T><<<dim3((p.tk + kTile - 1) / kTile, p.bh), kThreads, kDkdvSmem, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_kernel<DP, T><<<dim3((p.tq + kTile - 1) / kTile, p.bh), kThreads, kDqSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fold(const FoldParams& p, cudaStream_t stream) {
  constexpr int kSmem = 3 * tile_bytes(DP) + score_bytes();
  const int err = set_smem(fold_f32_kernel<DP>, kSmem);
  if (err != 0) return err;
  fold_f32_kernel<DP><<<dim3((p.tq + kTile - 1) / kTile, p.bh), kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int tq, int tk, int d) {
  return d <= 0 || d > 128 || d % 8 != 0 || bh > 65535 || tq < 0 || tk < 0;
}

template <typename T>
int backward(const BwdParams<T>& p, cudaStream_t stream) {
  if (bad_shape(p.bh, p.tq, p.tk, p.d)) return (int)cudaErrorInvalidValue;
  if (p.bh == 0 || p.tq == 0 || p.tk == 0) return (int)cudaSuccess;
  if (p.d <= 16) return launch_backward<16, T>(p, stream);
  if (p.d <= 32) return launch_backward<32, T>(p, stream);
  if (p.d <= 64) return launch_backward<64, T>(p, stream);
  return launch_backward<128, T>(p, stream);
}

template <typename T>
int backward_entry(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dsum, float* dq, float* dk, float* dv, int bh,
                   int tq, int tk, int d, int64_t q_off, int64_t k_off, int causal, float scale,
                   cudaStream_t stream) {
  BwdParams<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.lse = lse;
  p.dsum = dsum;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.bh = bh;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.scale = scale;
  return backward(p, stream);
}

}  // namespace

// One ring hop's backward: adds this hop's dq [BH, Tq, D], dk and dv [BH,
// Tk, D] (f32, in place) from q, dout [BH, Tq, D] and k, v [BH, Tk, D] (f32,
// or bf16 in the _bf16 entry), lse and dsum [BH, Tq] f32; all contiguous; D
// a multiple of 8 up to 128.  Two kernels on `stream`, no synchronize;
// returns the first failing launch's cudaError_t (0 on success).
extern "C" int tpu_flash_block_backward_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* dsum, float* dq, float* dk, float* dv,
                                            int bh, int tq, int tk, int d, int64_t q_off,
                                            int64_t k_off, int causal, float scale,
                                            cudaStream_t stream) {
  return backward_entry<float>(q, k, v, dout, lse, dsum, dq, dk, dv, bh, tq, tk, d, q_off, k_off,
                               causal, scale, stream);
}

extern "C" int tpu_flash_block_backward_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* dsum, float* dq, float* dk, float* dv,
                                             int bh, int tq, int tk, int d, int64_t q_off,
                                             int64_t k_off, int causal, float scale,
                                             cudaStream_t stream) {
  return backward_entry<__nv_bfloat16>(q, k, v, dout, lse, dsum, dq, dk, dv, bh, tq, tk, d, q_off,
                                       k_off, causal, scale, stream);
}

// Kernel B3 on f32: folds k, v [BH, Tk, D] into the online-softmax state of
// q [BH, Tq, D]: m, l [BH, Tq] and o [BH, Tq, D], updated in place; all f32
// and contiguous.  The signature of tpu_flash_block_update_bf16.
extern "C" int tpu_flash_block_update_f32(const void* q, const void* k, const void* v, float* m,
                                          float* l, float* o, int bh, int tq, int tk, int d,
                                          int64_t q_off, int64_t k_off, int causal, float scale,
                                          cudaStream_t stream) {
  if (bad_shape(bh, tq, tk, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || tq == 0 || tk == 0) return (int)cudaSuccess;
  FoldParams p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.m = m;
  p.l = l;
  p.o = o;
  p.bh = bh;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.scale = scale;
  if (d <= 16) return launch_fold<16>(p, stream);
  if (d <= 32) return launch_fold<32>(p, stream);
  if (d <= 64) return launch_fold<64>(p, stream);
  return launch_fold<128>(p, stream);
}
