// The ring-remat training path's flash kernels for Hopper (sm_90a), f32 and
// bf16 storage, on the tensor cores through `mma.sync`:
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
//   m'), l' = l corr + rowsum e, o' = o corr + e V, all f32.  exp is
//   exp2f(x log2 e) (`exp_f32`).
//
// Products.  bf16 runs `mma.sync` m16n8k16 bf16 -> f32.  f32 runs every
// product as 3xTF32 on `mma.sync` m16n8k8: each operand x is split into
// hi = rna(x) and lo = rna(x - hi), rna being cvt.rna.tf32.f32's rounding
// (`tf32` below), and a b accumulates as a_lo b_hi + a_hi b_lo, then
// a_hi b_hi, in f32 (PyTorch's f32 SDPA backward does the same, as
// CUTLASS's OpMultiplyAddFastF32).  A single TF32 pass keeps 10 mantissa
// bits and misses the f32 limit 1e-4 of max |plain| by 5-12 x; the split
// stays within 1.4 x of a plain f32 product (tests/test_torch_tf32_split.py
// emulates both).  No product runs as one TF32 pass.  The tensor cores'
// f32 accumulation truncates, so a long sum drifts more than an FMA chain:
// dk and dv of the train hop (768 products into each accumulator) land
// near 2.5e-5 of max |plain|, dq and the fold within 5e-6.  Each pass runs
// over a group of output tiles before the next (mma_all), so no product
// waits on the one just issued into the same accumulator.
//
// Bound, on an H100 SXM (494.5 TFLOP/s TF32 dense, 3 passes: 164.8 TFLOP/s
// of f32 work; 3.35 TB/s): the train hop (BH 128, T 2048, D 128, causal,
// diagonal) does 10 D FLOP per unmasked (query, key) pair in the backward,
// 3.4e11 FLOP, 2.09 ms, against 0.40 ms for its 1.34 GB of q/k/v/dO/lse/D
// read and dq/dk/dv read and written: operations.  The forward fold does 4
// D per pair, 1.4e11 FLOP, 0.83 ms: operations.  (On the CUDA cores, 67
// TFLOP/s, the same work takes 5.13 and 2.05 ms.)
//
// Design.  Blocks run in no order, so the TPU kernel's revisit-and-
// accumulate grid becomes two kernels with no atomics, each output element
// written by one block in a fixed order, so the result is deterministic;
// the price is S and dP computed twice (14 D FLOP per pair, not 10):
//   - dk/dv: one block per (bh, 128-key tile), walking the 32-row q tiles
//     that see any of its keys;
//   - dq: one block per (bh, 128-row q tile), walking the 32-key tiles it
//     sees;
//   - the fold: one block per (bh, 128-row q tile), walking 64-key tiles.
// Eight warps; each owns 16 rows of the block's fixed tile and keeps their
// accumulators (dK and dV, dQ, or m, l and O) in registers for the whole
// walk.  The fixed tiles (K and V, Q and dO, or Q) sit in shared memory;
// the walked tiles stream through a two-stage cp.async ring, the next
// tile's 16-byte copies in flight while this one computes, with zero fill
// past T and past D, so the kernels take any T.  Every warp reads the whole
// walked tile as B operands, so in B4's f32 entry the block splits a landed
// tile once (split_tile: hi in place, lo into a one-stage buffer beside the
// ring) instead of each warp splitting each fragment it loads; the fold has
// no room for a lo buffer beside 64-key stages and splits as it loads,
// which measured faster than 32-key stages split once.  The fixed tiles' A
// fragments and the accumulators turned into A fragments are split as
// they are loaded, by the one warp that uses them.  Rows are stored in 16-byte
// chunks XOR-swizzled by row (chunk ^ row % 8, rows of at least 128 bytes),
// so every fragment load below is free of bank conflicts.  The dk/dv kernel
// computes S^T = K Q^T and dP^T = V dO^T with keys as M, so P^T and dS^T are
// already in the registers of the warp that needs them as the A operand of
// dV += P^T dO and dK += dS^T Q; the dq kernel keeps dS in registers as the
// A operand of dQ += dS K; the fold keeps e as the A operand of O += e V.
// An m16n8 accumulator is not a tf32 m16n8k8 A fragment: lane (g, t) holds
// columns 2t and 2t+1, the fragment wants t and t + 4.  The kernel takes the
// columns in that order instead: k index t is column 2t and t + 4 is 2t + 1,
// and the B operand reads its rows in the same order, so the accumulator is
// the fragment as it stands and no shuffle is needed.  In bf16 two adjacent
// accumulators are the m16n8k16 fragment (FA2's reuse).  D is padded to 16,
// 32, 64 or 128 (one template instance each).  Under the causal mask the
// blocks with the most tiles launch first, tiles past the diagonal are
// skipped, and a warp whose rows see none of a tile's keys skips it, which
// changes nothing (P = 0 and e = 0 there); a block with no visible tile
// writes nothing, so a fully masked hop leaves dq/dk/dv, and a fully masked
// block the state, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows of a block's fixed tile
constexpr int kStages = 2;
constexpr int kBwdStep = 32;   // rows of a walked tile in the backward kernels
constexpr int kFoldStep = 64;  // keys of a walked tile in the fold

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

// ---------------------------------------------------------------------------
// shared-memory tiles and copies

// A tile of rows of DP elements of T, row-major, its 16-byte chunks
// XOR-swizzled by row; a row holds at least 128 bytes (8 chunks).
template <typename T, int DP>
struct Smem {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int kShift = kVec == 4 ? 2 : 3;
  static constexpr int kRowElems = DP * (int)sizeof(T) >= 128 ? DP : 128 / (int)sizeof(T);
  __device__ __forceinline__ static int at(int r, int c) {
    return r * kRowElems + ((((c >> kShift) ^ (r & 7)) << kShift) | (c & (kVec - 1)));
  }
  static constexpr int bytes(int rows) { return rows * kRowElems * (int)sizeof(T); }
};

// 16 bytes global -> shared; zero fill when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of one head (rows `base` on of a [BH, t, d] tensor)
// into a swizzled tile, zero past t and past d.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void stage(T* s, const T* g, int64_t base, int t, int d, int r0) {
  using L = Smem<T, DP>;
  constexpr int kChunks = DP / L::kVec;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * L::kVec;
    const int row = r0 + r;
    const bool ok = row < t && c < d;
    cp_async16(s + L::at(r, c), ok ? g + (base + row) * d + c : g, ok);
  }
}

// ---------------------------------------------------------------------------
// warp-level products: C[16 x 8] += A[16 x K] B[K x 8], one K step at a time

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, 10 of the
// 23 mantissa bits kept), in two integer operations that give the same bits
// for every finite x and issue faster than the cvt on sm_90
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// e^x as 2^(x log2 e): within about 1e-6 relative of expf where the
// softmax's terms matter (|x| < 20), in fewer instructions
__device__ __forceinline__ float exp_f32(float x) { return exp2f(x * 1.4426950408889634f); }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// A landed f32 tile of `rows` rows, split once for every warp that reads
// it: its hi parts in place, its lo parts at the same places in `lo`.
template <typename T, int DP>
__device__ __forceinline__ void split_tile(T* s, T* lo, int rows) {
  if constexpr (sizeof(T) == 4) {
    const int n = rows * Smem<T, DP>::kRowElems;
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
      float4 x = *reinterpret_cast<float4*>(s + i);
      uint4 h, l;
      split(x.x, h.x, l.x);
      split(x.y, h.y, l.y);
      split(x.z, h.z, l.z);
      split(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(s + i) = h;
      *reinterpret_cast<uint4*>(lo + i) = l;
    }
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragments of lane (g, t) = (lane / 4, lane % 4), per storage type:
//   load_a<L>(s, r0, k0):   A[m][k] = s[r0 + m][k0 + k]
//   load_b_nk<L, PRE>(s, lo, n0, k0): B[k][n] = s[n0 + n][k0 + k]
//   load_b_kn<L, PRE>(s, lo, k0, n0): B[k][n] = s[k0 + k][n0 + n], k in
//       a_acc's order; in f32 with PRE `s` holds the B tile's hi parts and
//       `lo` its lo parts (split_tile), else B is split as it is loaded; bf16
//       reads no `lo`
//   a_acc(c, j): the A operand of the j-th K step whose columns are the
//       accumulators c[...] of 8 columns each
//   mma_all<G>(c, a, b): c[j] += a b[j] for G tiles, in f32 each of the
//       three passes over all G before the next
template <typename T>
struct Mma;

// f32 storage: 3xTF32 on m16n8k8.  k index t of a step is column 2t and
// t + 4 is column 2t + 1 in a_acc and load_b_kn (module comment).
template <>
struct Mma<float> {
  static constexpr int kK = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  __device__ __forceinline__ static A a(float x0, float x1, float x2, float x3) {
    A f;
    split(x0, f.hi[0], f.lo[0]);
    split(x1, f.hi[1], f.lo[1]);
    split(x2, f.hi[2], f.lo[2]);
    split(x3, f.hi[3], f.lo[3]);
    return f;
  }
  template <class L>
  __device__ __forceinline__ static A load_a(const float* s, int r0, int k0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    return a(s[L::at(r0 + g, k0 + t)], s[L::at(r0 + g + 8, k0 + t)],
             s[L::at(r0 + g, k0 + t + 4)], s[L::at(r0 + g + 8, k0 + t + 4)]);
  }
  template <bool PRE>
  __device__ __forceinline__ static B b(const float* s, const float* lo, int i0, int i1) {
    B f;
    if (PRE) {
      f.hi[0] = __float_as_uint(s[i0]);
      f.hi[1] = __float_as_uint(s[i1]);
      f.lo[0] = __float_as_uint(lo[i0]);
      f.lo[1] = __float_as_uint(lo[i1]);
    } else {
      split(s[i0], f.hi[0], f.lo[0]);
      split(s[i1], f.hi[1], f.lo[1]);
    }
    return f;
  }
  template <class L, bool PRE>
  __device__ __forceinline__ static B load_b_nk(const float* s, const float* lo, int n0, int k0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    return b<PRE>(s, lo, L::at(n0 + g, k0 + t), L::at(n0 + g, k0 + t + 4));
  }
  template <class L, bool PRE>
  __device__ __forceinline__ static B load_b_kn(const float* s, const float* lo, int k0, int n0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    return b<PRE>(s, lo, L::at(k0 + 2 * t, n0 + g), L::at(k0 + 2 * t + 1, n0 + g));
  }
  template <int N>
  __device__ __forceinline__ static A a_acc(const float (&c)[N][4], int j) {
    return a(c[j][0], c[j][2], c[j][1], c[j][3]);
  }
  template <int G>
  __device__ __forceinline__ static void mma_all(float (*c)[4], const A& x, const B (&y)[G]) {
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(c[j], x.lo, y[j].hi[0], y[j].hi[1]);
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(c[j], x.hi, y[j].lo[0], y[j].lo[1]);
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(c[j], x.hi, y[j].hi[0], y[j].hi[1]);
  }
};

// bf16 storage: m16n8k16; a_acc rounds P and dS to bf16, as the reference.
template <>
struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };
  __device__ __forceinline__ static uint32_t word(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ static uint32_t pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  template <class L>
  __device__ __forceinline__ static A load_a(const __nv_bfloat16* s, int r0, int k0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    return {{word(s + L::at(r0 + g, k0 + 2 * t)), word(s + L::at(r0 + g + 8, k0 + 2 * t)),
             word(s + L::at(r0 + g, k0 + 2 * t + 8)), word(s + L::at(r0 + g + 8, k0 + 2 * t + 8))}};
  }
  template <class L, bool>
  __device__ __forceinline__ static B load_b_nk(const __nv_bfloat16* s, const __nv_bfloat16*,
                                                int n0, int k0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    return {{word(s + L::at(n0 + g, k0 + 2 * t)), word(s + L::at(n0 + g, k0 + 2 * t + 8))}};
  }
  template <class L, bool>
  __device__ __forceinline__ static B load_b_kn(const __nv_bfloat16* s, const __nv_bfloat16*,
                                                int k0, int n0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    const int r = k0 + 2 * t;
    return {{pair(s[L::at(r, n0 + g)], s[L::at(r + 1, n0 + g)]),
             pair(s[L::at(r + 8, n0 + g)], s[L::at(r + 9, n0 + g)])}};
  }
  template <int N>
  __device__ __forceinline__ static A a_acc(const float (&c)[N][4], int j) {
    return {{pack_bf16(c[2 * j][0], c[2 * j][1]), pack_bf16(c[2 * j][2], c[2 * j][3]),
             pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]),
             pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3])}};
  }
  template <int G>
  __device__ __forceinline__ static void mma_all(float (*c)[4], const A& x, const B (&y)[G]) {
#pragma unroll
    for (int j = 0; j < G; ++j) mma_bf16(c[j], x.x, y[j].x[0], y[j].x[1]);
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// c[16 x 8N] = A B^T over DP columns: A's 16 rows from r0 of `a`, B's 8N
// rows from n0 = 0 of `b` (with PRE, lo parts in `b_lo`), row-major tiles
template <typename T, int DP, bool PRE, int N>
__device__ __forceinline__ void rows_dot(float (&c)[N][4], const T* a, int r0, const T* b,
                                         const T* b_lo) {
  using L = Smem<T, DP>;
  using M = Mma<T>;
  zero(c);
#pragma unroll 2
  for (int k0 = 0; k0 < DP; k0 += M::kK) {
    const typename M::A x = M::template load_a<L>(a, r0, k0);
    typename M::B y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = M::template load_b_nk<L, PRE>(b, b_lo, 8 * j, k0);
    M::template mma_all<N>(c, x, y);
  }
}

// acc[16 x DP] += P b: P's 16 x 8N from the accumulators p, b's first 8N
// rows (with PRE, lo parts in `b_lo`), DP columns
template <typename T, int DP, bool PRE, int N>
__device__ __forceinline__ void acc_dot(float (&acc)[DP / 8][4], const float (&p)[N][4],
                                        const T* b, const T* b_lo) {
  using L = Smem<T, DP>;
  using M = Mma<T>;
#pragma unroll
  for (int j = 0; j < 8 * N / M::kK; ++j) {
    const typename M::A x = M::a_acc(p, j);
    constexpr int G = DP / 8 < 4 ? DP / 8 : 4;
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += G) {
      typename M::B y[G];
#pragma unroll
      for (int n = 0; n < G; ++n) y[n] = M::template load_b_kn<L, PRE>(b, b_lo, j * M::kK, 8 * (n0 + n));
      M::template mma_all<G>(acc + n0, x, y);
    }
  }
}

// acc[r] += x[r] * scale over this lane's rows and columns of one warp's 16
// rows [row0, row0 + 16) of a [BH, t, d] f32 tensor
template <int DP>
__device__ __forceinline__ void add_rows(float* out, const float (&x)[DP / 8][4], int64_t base,
                                         int row0, int t, int d, float scale) {
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= t) continue;
    float* o = out + (base + row) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      if (c >= d) continue;
      float2 y = *reinterpret_cast<float2*>(o + c);
      y.x += x[n][2 * r] * scale;
      y.y += x[n][2 * r + 1] * scale;
      *reinterpret_cast<float2*>(o + c) = y;
    }
  }
}

// ---------------------------------------------------------------------------
// kernel B4

// the lo parts of a walked stage's two tiles (f32 only)
template <typename T>
__host__ __device__ constexpr int lo_stages() { return sizeof(T) == 4 ? 1 : 0; }

template <typename T, int DP>
constexpr int dkdv_smem() {
  return 2 * Smem<T, DP>::bytes(kRows) +
         (kStages + lo_stages<T>()) * 2 * Smem<T, DP>::bytes(kBwdStep) +
         kStages * 2 * kBwdStep * (int)sizeof(float);
}

template <typename T, int DP>
constexpr int dq_smem() {
  return 2 * Smem<T, DP>::bytes(kRows) +
         (kStages + lo_stages<T>()) * 2 * Smem<T, DP>::bytes(kBwdStep);
}

// One block per (bh, 128-key tile): dK and dV of its keys over every 32-row
// q tile that sees one of them, added into dk/dv once at the end.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(const BwdParams<T> p) {
  using L = Smem<T, DP>;
  constexpr int kFixed = kRows * L::kRowElems;
  constexpr int kStep = kBwdStep * L::kRowElems;
  constexpr int kN = kBwdStep / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kFixed;
  T* qs = vs + kFixed;                // [stage][kBwdStep rows]
  T* dos = qs + kStages * kStep;      // [stage][kBwdStep rows]
  T* q_lo = dos + kStages * kStep;    // this tile's lo parts (f32)
  T* do_lo = q_lo + lo_stages<T>() * kStep;
  float* lses = reinterpret_cast<float*>(do_lo + lo_stages<T>() * kStep);  // [stage][kBwdStep]
  float* dsums = lses + kStages * kBwdStep;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;  // key tile 0 sees the most q tiles: first
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int wk0 = k0 + warp * 16;  // this warp's first key
  const int n_q = (p.tq + kBwdStep - 1) / kBwdStep;
  int first = 0;
  if (p.causal) {
    // query rows before `need` see none of this tile's keys
    const int64_t need = p.k_off + k0 - p.q_off;
    if (need >= p.tq) {
      first = n_q;
    } else if (need > 0) {
      first = (int)(need / kBwdStep);
    }
  }
  if (first >= n_q) return;  // a fully masked tile: dk/dv untouched

  const int64_t kbase = (int64_t)bh * p.tk;
  const int64_t qbase = (int64_t)bh * p.tq;
  auto stage_q = [&](int it, int s) {
    const int q0 = it * kBwdStep;
    stage<T, DP, kBwdStep>(qs + s * kStep, p.q, qbase, p.tq, p.d, q0);
    stage<T, DP, kBwdStep>(dos + s * kStep, p.dout, qbase, p.tq, p.d, q0);
    const int i = threadIdx.x % kBwdStep;
    const int row = q0 + i;
    const bool ok = row < p.tq;
    if (threadIdx.x < kBwdStep) {
      cp_async4(lses + s * kBwdStep + i, ok ? p.lse + qbase + row : p.lse, ok);
    } else if (threadIdx.x < 2 * kBwdStep) {
      cp_async4(dsums + s * kBwdStep + i, ok ? p.dsum + qbase + row : p.dsum, ok);
    }
  };
  stage<T, DP, kRows>(ks, p.k, kbase, p.tk, p.d, k0);
  stage<T, DP, kRows>(vs, p.v, kbase, p.tk, p.d, k0);
  stage_q(first, 0);
  cp_async_commit();

  float dk[DP / 8][4];
  float dv[DP / 8][4];
  zero(dk);
  zero(dv);
  for (int it = first; it < n_q; ++it) {
    const int s = (it - first) % kStages;
    if (it + 1 < n_q) stage_q(it + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_1();  // tile it has landed; only tile it + 1 may be in flight
    __syncthreads();
    T* qt = qs + s * kStep;
    T* dot = dos + s * kStep;
    if constexpr (lo_stages<T>() > 0) {
      split_tile<T, DP>(qt, q_lo, kBwdStep);
      split_tile<T, DP>(dot, do_lo, kBwdStep);
      __syncthreads();
    }
    const int q0 = it * kBwdStep;
    const int64_t last_q = p.q_off + min(q0 + kBwdStep, p.tq) - 1;
    if (wk0 < p.tk && (!p.causal || last_q >= p.k_off + wk0)) {
      // S^T = K Q^T and dP^T = V dO^T, keys as rows
      float st[kN][4];
      float dpt[kN][4];
      rows_dot<T, DP, true>(st, ks, warp * 16, qt, q_lo);
      rows_dot<T, DP, true>(dpt, vs, warp * 16, dot, do_lo);
      // every (key, row) pair live: no mask to evaluate
      const bool full = q0 + kBwdStep <= p.tq && wk0 + 16 <= p.tk &&
                        (!p.causal || p.q_off + q0 >= p.k_off + wk0 + 15);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = wk0 + g + 8 * (i >> 1);
          const int col = 8 * j + 2 * t4 + (i & 1);
          const int row = q0 + col;
          const bool live = full || (row < p.tq && key < p.tk &&
                                     (!p.causal || p.q_off + row >= p.k_off + key));
          const float x = st[j][i] * p.scale;
          // exact probabilities from the saved lse; the guard covers a row
          // whose lse collapsed to NEG_INF
          const float prob =
              (!live || x <= kNegInf * 0.5f) ? 0.f : exp_f32(x - lses[s * kBwdStep + col]);
          st[j][i] = prob;
          dpt[j][i] = prob * (dpt[j][i] - dsums[s * kBwdStep + col]);
        }
      }
      // dV += P^T dO; dK += dS^T Q
      acc_dot<T, DP, true>(dv, st, dot, do_lo);
      acc_dot<T, DP, true>(dk, dpt, qt, q_lo);
    }
    __syncthreads();  // the stage is free for tile it + 2
  }
  add_rows<DP>(p.dk, dk, kbase, wk0, p.tk, p.d, p.scale);
  add_rows<DP>(p.dv, dv, kbase, wk0, p.tk, p.d, 1.f);
}

// One block per (bh, 128-row q tile): dQ of its rows over every 32-key tile
// it sees, added into dq once at the end.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const BwdParams<T> p) {
  using L = Smem<T, DP>;
  constexpr int kFixed = kRows * L::kRowElems;
  constexpr int kStep = kBwdStep * L::kRowElems;
  constexpr int kN = kBwdStep / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kFixed;
  T* ks = dos + kFixed;           // [stage][kBwdStep rows]
  T* vs = ks + kStages * kStep;   // [stage][kBwdStep rows]
  T* k_lo = vs + kStages * kStep;  // this tile's lo parts (f32)
  T* v_lo = k_lo + lo_stages<T>() * kStep;

  const int bh = blockIdx.x;
  // the causal q tiles see more keys the later they are: last tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int wq0 = q0 + warp * 16;
  int n_k = (p.tk + kBwdStep - 1) / kBwdStep;
  if (p.causal) {
    // the last key any row of this tile sees
    const int last_row = min(q0 + kRows, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kBwdStep + 1;
    if (need < n_k) n_k = (int)need;
  }
  if (n_k == 0) return;  // every key past every query: dq untouched

  const int64_t kbase = (int64_t)bh * p.tk;
  const int64_t qbase = (int64_t)bh * p.tq;
  auto stage_k = [&](int jt, int s) {
    stage<T, DP, kBwdStep>(ks + s * kStep, p.k, kbase, p.tk, p.d, jt * kBwdStep);
    stage<T, DP, kBwdStep>(vs + s * kStep, p.v, kbase, p.tk, p.d, jt * kBwdStep);
  };
  stage<T, DP, kRows>(qs, p.q, qbase, p.tq, p.d, q0);
  stage<T, DP, kRows>(dos, p.dout, qbase, p.tq, p.d, q0);
  stage_k(0, 0);
  cp_async_commit();

  float lse[2];
  float dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    const bool ok = row < p.tq;
    lse[r] = ok ? p.lse[qbase + row] : 0.f;
    dsum[r] = ok ? p.dsum[qbase + row] : 0.f;
  }
  float dq[DP / 8][4];
  zero(dq);
  const int64_t last_q = p.q_off + min(wq0 + 16, p.tq) - 1;  // this warp's last row
  for (int jt = 0; jt < n_k; ++jt) {
    const int s = jt % kStages;
    if (jt + 1 < n_k) stage_k(jt + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    T* kt = ks + s * kStep;
    T* vt = vs + s * kStep;
    if constexpr (lo_stages<T>() > 0) {
      split_tile<T, DP>(kt, k_lo, kBwdStep);
      split_tile<T, DP>(vt, v_lo, kBwdStep);
      __syncthreads();
    }
    const int kt0 = jt * kBwdStep;
    if (wq0 < p.tq && (!p.causal || last_q >= p.k_off + kt0)) {
      float sc[kN][4];
      float ds[kN][4];
      rows_dot<T, DP, true>(sc, qs, warp * 16, kt, k_lo);
      rows_dot<T, DP, true>(ds, dos, warp * 16, vt, v_lo);
      const bool full = wq0 + 16 <= p.tq && kt0 + kBwdStep <= p.tk &&
                        (!p.causal || p.q_off + wq0 >= p.k_off + kt0 + kBwdStep - 1);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int row = wq0 + g + 8 * r;
          const int key = kt0 + 8 * j + 2 * t4 + (i & 1);
          const bool live = full || (row < p.tq && key < p.tk &&
                                     (!p.causal || p.q_off + row >= p.k_off + key));
          const float x = sc[j][i] * p.scale;
          const float prob = (!live || x <= kNegInf * 0.5f) ? 0.f : exp_f32(x - lse[r]);
          ds[j][i] = prob * (ds[j][i] - dsum[r]);
        }
      }
      acc_dot<T, DP, true>(dq, ds, kt, k_lo);  // dQ += dS K
    }
    __syncthreads();
  }
  add_rows<DP>(p.dq, dq, qbase, wq0, p.tq, p.d, p.scale);
}

// ---------------------------------------------------------------------------
// kernel B3 on f32 storage

template <int DP>
constexpr int fold_smem() {
  return Smem<float, DP>::bytes(kRows) + kStages * 2 * Smem<float, DP>::bytes(kFoldStep);
}

// One block per (bh, 128-row q tile) folds every 64-key tile it sees into
// the (m, l, o) state of its rows, held in registers, and writes the state
// back once.  A tile past the causal diagonal is skipped: its update is an
// exact no-op.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) fold_f32_kernel(const FoldParams p) {
  using L = Smem<float, DP>;
  constexpr int kFixed = kRows * L::kRowElems;
  constexpr int kStep = kFoldStep * L::kRowElems;
  constexpr int kN = kFoldStep / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kFixed;          // [stage][kFoldStep rows]
  float* vs = ks + kStages * kStep;  // [stage][kFoldStep rows]

  const int bh = blockIdx.x;
  const int q_tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kRows;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int wq0 = q0 + warp * 16;
  int n_k = (p.tk + kFoldStep - 1) / kFoldStep;
  if (p.causal) {
    const int last_row = min(q0 + kRows, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kFoldStep + 1;
    if (need < n_k) n_k = (int)need;
  }
  if (n_k == 0) return;  // a fully masked block: the state stays as it is

  const int64_t kbase = (int64_t)bh * p.tk;
  const int64_t qbase = (int64_t)bh * p.tq;
  auto stage_k = [&](int jt, int s) {
    stage<float, DP, kFoldStep>(ks + s * kStep, p.k, kbase, p.tk, p.d, jt * kFoldStep);
    stage<float, DP, kFoldStep>(vs + s * kStep, p.v, kbase, p.tk, p.d, jt * kFoldStep);
  };
  stage<float, DP, kRows>(qs, p.q, qbase, p.tq, p.d, q0);
  stage_k(0, 0);
  cp_async_commit();

  float m[2];
  float l[2];
  float o[DP / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    const bool ok = row < p.tq;
    const int64_t at = qbase + row;
    m[r] = ok ? p.m[at] : kNegInf;
    l[r] = ok ? p.l[at] : 0.f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      float2 x = make_float2(0.f, 0.f);
      if (ok && c < p.d) x = *reinterpret_cast<const float2*>(p.o + at * p.d + c);
      o[n][2 * r] = x.x;
      o[n][2 * r + 1] = x.y;
    }
  }

  const int64_t last_q = p.q_off + min(wq0 + 16, p.tq) - 1;
  for (int jt = 0; jt < n_k; ++jt) {
    const int s = jt % kStages;
    if (jt + 1 < n_k) stage_k(jt + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const float* kt = ks + s * kStep;
    const float* vt = vs + s * kStep;
    const int kt0 = jt * kFoldStep;
    if (wq0 < p.tq && (!p.causal || last_q >= p.k_off + kt0)) {
      float sc[kN][4];
      rows_dot<float, DP, false>(sc, qs, warp * 16, kt, nullptr);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wq0 + g + 8 * (i >> 1);
          const int key = kt0 + 8 * j + 2 * t4 + (i & 1);
          const bool live = key < p.tk && (!p.causal || p.q_off + row >= p.k_off + key);
          sc[j][i] = live ? sc[j][i] * p.scale : kNegInf;
          mx[i >> 1] = fmaxf(mx[i >> 1], sc[j][i]);
        }
      }
      float corr[2];
      float m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // a row's keys sit in the four lanes of one quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
        corr[r] = exp_f32(m[r] - m_new[r]);
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = sc[j][i];
          const float e = x <= kNegInf * 0.5f ? 0.f : exp_f32(x - m_new[i >> 1]);  // masked guard
          sc[j][i] = e;
          sum[i >> 1] += e;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
        m[r] = m_new[r];
      }
      // once the row maxima settle, corr is exactly 1: skip the rescale
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          o[n][0] *= corr[0];
          o[n][1] *= corr[0];
          o[n][2] *= corr[1];
          o[n][3] *= corr[1];
        }
      }
      acc_dot<float, DP, false>(o, sc, vt, nullptr);  // o += e V
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    if (row >= p.tq) continue;
    const int64_t at = qbase + row;
    if (t4 == 0) {
      p.m[at] = m[r];
      p.l[at] = l[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      if (c < p.d) {
        *reinterpret_cast<float2*>(p.o + at * p.d + c) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int tiles(int t, int rows) { return (t + rows - 1) / rows; }

template <int DP, typename T>
int launch_backward(const BwdParams<T>& p, cudaStream_t stream) {
  constexpr int kDkdvSmem = dkdv_smem<T, DP>();
  constexpr int kDqSmem = dq_smem<T, DP>();
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "a block's shared memory");
  int err = set_smem(dkdv_kernel<T, DP>, kDkdvSmem);
  if (err != 0) return err;
  err = set_smem(dq_kernel<T, DP>, kDqSmem);
  if (err != 0) return err;
  dkdv_kernel<T, DP><<<dim3(p.bh, tiles(p.tk, kRows)), kThreads, kDkdvSmem, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_kernel<T, DP><<<dim3(p.bh, tiles(p.tq, kRows)), kThreads, kDqSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fold(const FoldParams& p, cudaStream_t stream) {
  constexpr int kSmem = fold_smem<DP>();
  static_assert(kSmem <= 232448, "a block's shared memory");
  const int err = set_smem(fold_f32_kernel<DP>, kSmem);
  if (err != 0) return err;
  fold_f32_kernel<DP><<<dim3(p.bh, tiles(p.tq, kRows)), kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int tq, int tk, int d) {
  return d <= 0 || d > 128 || d % 8 != 0 || bh > 65535 || tq < 0 || tk < 0 ||
         tq > 65535 * kRows || tk > 65535 * kRows;
}

// the copies move 16 bytes of q/k/v/dO at a time, the write-backs 8 of f32
bool misaligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes != 0; }

template <typename T>
int backward(const BwdParams<T>& p, cudaStream_t stream) {
  if (bad_shape(p.bh, p.tq, p.tk, p.d)) return (int)cudaErrorInvalidValue;
  if (misaligned(p.q, 16) || misaligned(p.k, 16) || misaligned(p.v, 16) ||
      misaligned(p.dout, 16) || misaligned(p.lse, 4) || misaligned(p.dsum, 4) ||
      misaligned(p.dq, 8) || misaligned(p.dk, 8) || misaligned(p.dv, 8)) {
    return (int)cudaErrorMisalignedAddress;
  }
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

template <typename T>
int backward_smem(int d, int which) {
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
  switch (dp) {
    case 16: return which == 0 ? dkdv_smem<T, 16>() : dq_smem<T, 16>();
    case 32: return which == 0 ? dkdv_smem<T, 32>() : dq_smem<T, 32>();
    case 64: return which == 0 ? dkdv_smem<T, 64>() : dq_smem<T, 64>();
    default: return which == 0 ? dkdv_smem<T, 128>() : dq_smem<T, 128>();
  }
}

}  // namespace

// One ring hop's backward: adds this hop's dq [BH, Tq, D], dk and dv [BH,
// Tk, D] (f32, in place) from q, dout [BH, Tq, D] and k, v [BH, Tk, D] (f32,
// or bf16 in the _bf16 entry), lse and dsum [BH, Tq] f32; all contiguous; D
// a multiple of 8 up to 128; q/k/v/dout 16-byte aligned.  Two kernels on
// `stream`, no synchronize; returns the first failing launch's cudaError_t
// (0 on success).
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
// and contiguous, q/k/v 16-byte aligned.  The signature of
// tpu_flash_block_update_bf16.
extern "C" int tpu_flash_block_update_f32(const void* q, const void* k, const void* v, float* m,
                                          float* l, float* o, int bh, int tq, int tk, int d,
                                          int64_t q_off, int64_t k_off, int causal, float scale,
                                          cudaStream_t stream) {
  if (bad_shape(bh, tq, tk, d)) return (int)cudaErrorInvalidValue;
  if (misaligned(q, 16) || misaligned(k, 16) || misaligned(v, 16) || misaligned(o, 8)) {
    return (int)cudaErrorMisalignedAddress;
  }
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

// Dynamic shared memory a block of each kernel takes at head dim d:
// kernel 0 the dk/dv kernel, 1 the dq kernel (bf16 storage when bf16 is
// non-zero), 2 the f32 fold.
extern "C" int tpu_flash_train_smem_bytes(int kernel, int d, int bf16) {
  if (d <= 0 || d > 128) return -1;
  if (kernel == 2) {
    return d <= 16 ? fold_smem<16>() : d <= 32 ? fold_smem<32>() : d <= 64 ? fold_smem<64>()
                                                                            : fold_smem<128>();
  }
  return bf16 ? backward_smem<__nv_bfloat16>(d, kernel) : backward_smem<float>(d, kernel);
}
