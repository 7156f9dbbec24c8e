// The ring-remat training path's flash kernels for Hopper (sm_90a), f32 and
// bf16 storage, on the tensor cores:
//
//   tpu_flash_block_backward_f32 / _bf16  replace `_flash_block_bwd_kernel` /
//       `flash_block_backward` (tpu_operator/workloads/ring_attention.py:
//       577-683): the FlashAttention-2 backward of one ring hop (kernel B4),
//       adding this hop's dq, dk, dv into the travelling f32 accumulators in
//       place.  f32 runs on `wgmma` fed by TMA, bf16 on `mma.sync`.
//   tpu_flash_block_update_f32  is kernel B3 (`_flash_block_kernel` /
//       `flash_block_update`, ring_attention.py:118-218) on f32 q, k, v:
//       the remat forward of the transformer step, whose weights, and so
//       q, k, v, are f32 (the bf16 entry is in flash_attention.cu), on
//       `mma.sync`.
//
// Numerics are the reference's.  Scores s = dot_f32(q, k) * scale, masked
// scores are out (causal on global positions q_off + row >= k_off + col;
// with a sliding window W, f32 only, also q_off + row - k_off - col < W),
// and the guard s <= NEG_INF / 2 -> 0 with NEG_INF = -1e30.
//   Backward: P = exp(s - lse) from the forward's saved lse; dV += P^T dO;
//   dP = dO V^T; dS = P (dP - D) with D = rowsum(dO O) given; dQ += dS K
//   scale; dK += dS^T Q scale.  In bf16, P is rounded to bf16 before P^T
//   dO and dS before dS K and dS^T Q (`.astype(q.dtype)` at :602 and :609),
//   every product accumulated in f32.  In f32 nothing is rounded.
//   Forward fold: m' = max(m, rowmax s), corr = exp(m - m'), e = exp(s -
//   m'), l' = l corr + rowsum e, o' = o corr + e V, all f32.  exp is
//   exp2f(x log2 e) (`exp_f32`), in B4's f32 kernels its MUFU form with
//   subnormal results flushed to zero.
//
// Products.  bf16 runs `mma.sync` m16n8k16 bf16 -> f32.  f32 runs every
// product as 3xTF32: each operand x is split into hi = rna(x) and lo =
// rna(x - hi), rna being cvt.rna.tf32.f32's rounding (`tf32` below), and a b
// accumulates as a_lo b_hi + a_hi b_lo, then a_hi b_hi, in f32, one k step
// of 8 at a time (PyTorch's f32 SDPA backward does the same, as CUTLASS's
// OpMultiplyAddFastF32).  A single TF32 pass keeps 10 mantissa bits and
// misses the f32 limit 1e-4 of max |plain| by 5-12 x; the split stays
// within 1.4 x of a plain f32 product (tests/test_torch_tf32_split.py
// emulates both).  No product runs as one TF32 pass, and no hi part is a raw
// f32 left for the tensor cores to truncate.  The tensor cores' f32
// accumulation truncates, so a long sum of small terms drifts low: B4's
// dk and dv, whose causal rows at T 32768 sum 32768 terms that shrink
// along the walk, land 2e-4 of max |plain| off when one accumulator takes
// the whole walk.  B4 f32 adds its accumulators into dq/dk/dv every 32
// walked tiles (`flush`), which bounds the drift at any T; B3's fold keeps
// one accumulator for its whole walk.
//
// Bound, on an H100 SXM (494.5 TFLOP/s TF32 dense, 3 passes: 164.8 TFLOP/s
// of f32 work; 3.35 TB/s): the train hop (BH 128, T 2048, D 128, causal,
// diagonal) does 10 D FLOP per unmasked (query, key) pair in the backward,
// 3.4e11 FLOP, 2.09 ms, against 0.40 ms for its 1.34 GB of q/k/v/dO/lse/D
// read and dq/dk/dv read and written: operations.  The long-context hop
// (BH 32, T 32768) does 2.2e13 FLOP, 133 ms.  The forward fold does 4 D
// per pair: 0.83 ms at the train hop.
//
// Design of B4.  Blocks run in no order, so the TPU kernel's revisit-and-
// accumulate grid becomes two kernels with no atomics, each output element
// written by one block in a fixed order, so the result is deterministic;
// the price is S and dP computed twice (14 D FLOP per pair, not 10):
//   - dk/dv: one block per (bh, 64-key tile), walking the 32-row q tiles
//     that see any of its keys;
//   - dq: one block per (bh, 64-row q tile), walking the 32-key tiles it
//     sees.
// Under the causal mask the blocks with the most tiles launch first and
// tiles past the diagonal are never loaded; a block with no visible tile
// writes nothing, so a fully masked hop leaves dq/dk/dv bit for bit.  A
// sliding window bounds the walks at the band's far edge too: dk/dv's walk
// over q tiles ends at the last row that sees the block's last key, dq's
// and the fold's walk over key tiles starts at the first key the block's
// first row sees, so tiles wholly outside the band are never loaded either.
// The band is a compile-time choice (`kBand`) with kernels of its own
// (`fold_band_kernel`, `dkdv_band_kernel`, `dq_band_kernel`), launched for a
// hop with a window, so a hop without one runs the causal kernels as they
// were, with no extra test; the banded instances fold the causal test and
// the band's into one unsigned compare, 0 <= query - key < W.
//
// f32 (`dkdv_f32`, `dq_f32`): three warpgroups, 384 threads.  A producer
// (setmaxnreg 40) loads the fixed tile pair (K and V, or Q and dO: 64 rows)
// once and every walked tile pair (Q and dO, or K and V: 32 rows) by TMA
// into a two-stage ring of 128-byte swizzled boxes of 32 columns; rows past
// T and columns past D arrive as zeros, so the kernels take any T and every
// D up to 128 (padded to 64 or 128).  Its 128 threads then store the walked
// rows' lse and dsum, split the landed tile once for every product that
// reads it (hi parts in place, lo parts into the stage's lo buffer) and
// mark the stage ready (mbarriers: full on TMA's bytes, ready on the
// producer, empty on the 256 product threads before a stage is reloaded),
// so loads and splits run a tile ahead of the products.  Two product
// warpgroups (setmaxnreg 232) run `wgmma` m64nNk8 tf32.  tf32 `wgmma` reads
// A and B only K-major, with no transpose flag for 32-bit types, so a
// product that contracts over the walked rows would need the walked tile
// transposed.  Each product is arranged so that no transposed copy is kept
// in shared memory:
//   - a product over D (S^T = K Q^T, dP^T = V dO^T; S = Q K^T, dP = dO V^T)
//     takes the fixed tile as A and the walked tile as B, K-major as it
//     lies (N 32).  The fixed tile is split once: its hi parts go to
//     registers, its lo parts stay in place, so two of a k step's three
//     passes read A from registers and the product moves 5 KB of shared
//     memory a k step, not 8;
//   - a product over the walked rows runs transposed, with D as M: dV^T +=
//     dO^T P^T, dK^T += Q^T dS^T, dQ^T += K^T dS^T (N 64).  A is the walked
//     tile transposed into registers by the loads that fill the fragments,
//     B the [64][32] tile P^T, dS^T or dS, written from the accumulators
//     K-major (its rows are the accumulator's) as hi and lo parts.  The k
//     index t of a step reads walked row 2t and t + 4 row 2t + 1, in A and
//     in B, which makes every fragment load free of bank conflicts.
// The work is divided by product: in dk/dv warpgroup 0 computes S^T, P^T
// and dV^T, warpgroup 1 dP^T, dS^T and dK^T, with P^T handed over through
// dS^T's buffer; in dq warpgroup 0 computes S and P, warpgroup 1 dP and dS,
// and each runs one 64-row half of dQ^T.  The mask is a branch of its own,
// taken only by tiles that cross the diagonal or the ragged ends, and P's
// exp is ex2.approx.ftz on the MUFU unit (a P under 2^-126 adds nothing an
// f32 sum keeps).
// Shared memory at D 128 (one block per SM): fixed tiles 64 KB, ring 64 KB,
// its lo parts 64 KB, the [64][32] operands' hi and lo 32 KB, lse and dsum
// 512 bytes: 230,968 bytes with alignment slack, of 232,448 (132,664 at D
// 64).  Walked tiles of 64 rows would need 320 KB, and the fixed tiles'
// hi parts in shared memory too 64 KB more.  Registers: a product thread
// holds its accumulators (dV^T or dK^T at D 128: 64; dQ^T 32), the fixed
// tile's hi parts (64), a score tile (16) and, in a product over the walked
// rows, up to 64 of A fragments; no spills.
// Measured on an H100 SXM at 700 W: the train hop 6.0 ms (the `mma.sync`
// kernels it replaced: 10.8), 0.35 of its 3xTF32 bound; the long-context
// hop 365 ms, 0.37, of which the flushes take ~19 ms.  A dk/dv step of the heaviest block (clock64 stamps)
// takes ~5,300 cycles: ~3,400 in the products, ~1,300 in the score work
// between them (exp or dS, B's stores, the fence, the barriers) while the
// tensor cores wait, the rest in hand-offs; the ~550 KB of shared memory a
// step moves bound it next.
//
// bf16 (`dkdv_mma`, `dq_mma`), and B3's f32 fold on the same machinery: one
// block per (bh, 128-row fixed tile), eight warps each owning 16 rows and
// keeping their accumulators in registers for the whole walk; the walked
// tiles stream through a two-stage cp.async ring (32 rows, or 64 keys in
// the fold) with zero fill past T and past D; rows are stored in 16-byte
// chunks XOR-swizzled by row (chunk ^ row % 8, rows of at least 128 bytes),
// so every fragment load is free of bank conflicts.  The dk/dv kernel
// computes S^T = K Q^T and dP^T = V dO^T with keys as M, so P^T and dS^T are
// already the A operand of dV += P^T dO and dK += dS^T Q; the dq kernel
// keeps dS as the A operand of dQ += dS K; the fold keeps e as the A operand
// of O += e V.  The fold splits its f32 operands as it loads them, and
// runs each pass over a group of output tiles before the next (mma_all), so
// no product waits on the one just issued into the same accumulator.  An
// m16n8 accumulator is not a tf32 m16n8k8 A fragment: lane (g, t) holds
// columns 2t and 2t+1, the fragment wants t and t + 4.  The fold takes the
// columns in that order instead: k index t is column 2t and t + 4 is 2t + 1,
// and the B operand reads its rows in the same order, so the accumulator is
// the fragment as it stands.  In bf16 two adjacent accumulators are the
// m16n8k16 fragment (FA2's reuse).  D is padded to 16, 32, 64 or 128, and a
// warp whose rows see none of a tile's keys skips it, which changes nothing
// (P = 0 and e = 0 there).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows of a block's fixed tile
constexpr int kStages = 2;
constexpr int kBwdStep = 32;   // rows of a walked tile in the backward kernels
constexpr int kFoldStep = 64;  // keys of a walked tile in the fold
// the window of a causal hop with no band: larger than any distance between
// a query and a key (tiles' offsets are clamped to kFar), so that 0 <=
// query - key < kNoWindow is the causal test alone
constexpr int kNoWindow = 1 << 30;
constexpr int kFar = 1 << 28;
constexpr int64_t kMaxWindow = 1 << 27;  // a window at least this long is none

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
  int window;  // a key at query - key >= window is out; kNoWindow: none
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
  int window;  // a key at query - key >= window is out; kNoWindow: none
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
//   load_b_nk<L>(s, n0, k0): B[k][n] = s[n0 + n][k0 + k]
//   load_b_kn<L>(s, k0, n0): B[k][n] = s[k0 + k][n0 + n], k in a_acc's
//       order; f32 splits B as it is loaded
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
  __device__ __forceinline__ static B b(float x0, float x1) {
    B f;
    split(x0, f.hi[0], f.lo[0]);
    split(x1, f.hi[1], f.lo[1]);
    return f;
  }
  template <class L>
  __device__ __forceinline__ static B load_b_nk(const float* s, int n0, int k0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    return b(s[L::at(n0 + g, k0 + t)], s[L::at(n0 + g, k0 + t + 4)]);
  }
  template <class L>
  __device__ __forceinline__ static B load_b_kn(const float* s, int k0, int n0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    return b(s[L::at(k0 + 2 * t, n0 + g)], s[L::at(k0 + 2 * t + 1, n0 + g)]);
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
  template <class L>
  __device__ __forceinline__ static B load_b_nk(const __nv_bfloat16* s, int n0, int k0) {
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
    return {{word(s + L::at(n0 + g, k0 + 2 * t)), word(s + L::at(n0 + g, k0 + 2 * t + 8))}};
  }
  template <class L>
  __device__ __forceinline__ static B load_b_kn(const __nv_bfloat16* s, int k0, int n0) {
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
// rows from n0 = 0 of `b`, row-major tiles
template <typename T, int DP, int N>
__device__ __forceinline__ void rows_dot(float (&c)[N][4], const T* a, int r0, const T* b) {
  using L = Smem<T, DP>;
  using M = Mma<T>;
  zero(c);
#pragma unroll 2
  for (int k0 = 0; k0 < DP; k0 += M::kK) {
    const typename M::A x = M::template load_a<L>(a, r0, k0);
    typename M::B y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = M::template load_b_nk<L>(b, 8 * j, k0);
    M::template mma_all<N>(c, x, y);
  }
}

// acc[16 x DP] += P b: P's 16 x 8N from the accumulators p, b's first 8N
// rows, DP columns
template <typename T, int DP, int N>
__device__ __forceinline__ void acc_dot(float (&acc)[DP / 8][4], const float (&p)[N][4],
                                        const T* b) {
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
      for (int n = 0; n < G; ++n) y[n] = M::template load_b_kn<L>(b, j * M::kK, 8 * (n0 + n));
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
// kernel B4 on bf16: mma.sync

template <typename T, int DP>
constexpr int dkdv_smem() {
  return 2 * Smem<T, DP>::bytes(kRows) + kStages * 2 * Smem<T, DP>::bytes(kBwdStep) +
         kStages * 2 * kBwdStep * (int)sizeof(float);
}

template <typename T, int DP>
constexpr int dq_smem() {
  return 2 * Smem<T, DP>::bytes(kRows) + kStages * 2 * Smem<T, DP>::bytes(kBwdStep);
}

// One block per (bh, 128-key tile): dK and dV of its keys over every 32-row
// q tile that sees one of them, added into dk/dv once at the end.
template <typename T, int DP>
__device__ __forceinline__ void dkdv_mma(const BwdParams<T>& p, unsigned char* smem) {
  using L = Smem<T, DP>;
  constexpr int kFixed = kRows * L::kRowElems;
  constexpr int kStep = kBwdStep * L::kRowElems;
  constexpr int kN = kBwdStep / 8;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kFixed;
  T* qs = vs + kFixed;            // [stage][kBwdStep rows]
  T* dos = qs + kStages * kStep;  // [stage][kBwdStep rows]
  float* lses = reinterpret_cast<float*>(dos + kStages * kStep);  // [stage][kBwdStep]
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
    const int q0 = it * kBwdStep;
    const int64_t last_q = p.q_off + min(q0 + kBwdStep, p.tq) - 1;
    if (wk0 < p.tk && (!p.causal || last_q >= p.k_off + wk0)) {
      // S^T = K Q^T and dP^T = V dO^T, keys as rows
      float st[kN][4];
      float dpt[kN][4];
      rows_dot<T, DP>(st, ks, warp * 16, qt);
      rows_dot<T, DP>(dpt, vs, warp * 16, dot);
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
      acc_dot<T, DP>(dv, st, dot);
      acc_dot<T, DP>(dk, dpt, qt);
    }
    __syncthreads();  // the stage is free for tile it + 2
  }
  add_rows<DP>(p.dk, dk, kbase, wk0, p.tk, p.d, p.scale);
  add_rows<DP>(p.dv, dv, kbase, wk0, p.tk, p.d, 1.f);
}

// One block per (bh, 128-row q tile): dQ of its rows over every 32-key tile
// it sees, added into dq once at the end.
template <typename T, int DP>
__device__ __forceinline__ void dq_mma(const BwdParams<T>& p, unsigned char* smem) {
  using L = Smem<T, DP>;
  constexpr int kFixed = kRows * L::kRowElems;
  constexpr int kStep = kBwdStep * L::kRowElems;
  constexpr int kN = kBwdStep / 8;
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kFixed;
  T* ks = dos + kFixed;          // [stage][kBwdStep rows]
  T* vs = ks + kStages * kStep;  // [stage][kBwdStep rows]

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
    const int kt0 = jt * kBwdStep;
    if (wq0 < p.tq && (!p.causal || last_q >= p.k_off + kt0)) {
      float sc[kN][4];
      float ds[kN][4];
      rows_dot<T, DP>(sc, qs, warp * 16, kt);
      rows_dot<T, DP>(ds, dos, warp * 16, vt);
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
      acc_dot<T, DP>(dq, ds, kt);  // dQ += dS K
    }
    __syncthreads();
  }
  add_rows<DP>(p.dq, dq, qbase, wq0, p.tq, p.d, p.scale);
}

// ---------------------------------------------------------------------------
// kernel B4 on f32: wgmma fed by TMA

constexpr int kFixedRows = 64;  // rows of a block's fixed tile: one wgmma M
constexpr int kWalkRows = 32;   // rows of a walked tile
constexpr int kBoxCols = 32;    // f32 in the 128-byte row of a swizzled box
constexpr int kOpBytes = kFixedRows * kWalkRows * 4;  // one part of a [64][32] B operand
constexpr int kConsumers = 256;  // two warpgroups of products; a third produces
// walked tiles summed on the tensor cores before an f32 add takes the sum
// (`flush`): 384 truncating adds, 1,024 rows
constexpr int kFlushTiles = 32;

// The four inputs as 3-D TMA maps over [BH, T, D] f32, boxes of 32 rows by
// 32 columns, 128-byte swizzle, rows past T read as zeros.
struct Maps {
  CUtensorMap q, k, v, dout;
};

// Shared memory of either f32 kernel, in bytes from a 1024-aligned base.
// X and Y are the fixed tiles (K and V, or Q and dO): their lo parts in
// place of what TMA landed.  The ring holds two stages of the two walked
// tiles, hi parts in place, and Lo their lo parts, a stage each; P and Ds
// the hi and lo parts of the [64][32] B operands made from registers, the
// hi part of Ds holding warpgroup 0's f32 P, [register][thread], until
// warpgroup 1 has read it; Rv a stage's lse and dsum (dk/dv).
template <int DP>
struct Wg {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kFixedBytes = kBoxes * kFixedRows * 128;
  static constexpr int kWalkBytes = kBoxes * kWalkRows * 128;
  static constexpr int kX = 0;
  static constexpr int kY = kFixedBytes;
  static constexpr int kRing = 2 * kFixedBytes;        // [stage][tensor]
  static constexpr int kLo = kRing + 4 * kWalkBytes;   // [stage][tensor]
  static constexpr int kP = kLo + 4 * kWalkBytes;      // hi, lo
  static constexpr int kDs = kP + 2 * kOpBytes;        // hi (or f32 P), lo
  static constexpr int kRv = kDs + 2 * kOpBytes;       // [stage][lse, dsum][32]
  static constexpr int kBars = kRv + 2 * 2 * kWalkRows * 4;
  // fixed, full[2], ready[2], empty[2]; + slack to align the base
  static constexpr int kSmem = kBars + 7 * 8 + 1024;
};

// Rows [r0, r0 + ROWS) of head bh into a tile of DP / 32 boxes, each ROWS
// rows of 128 bytes.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int r0, int bh) {
#pragma unroll
  for (int h = 0; h < DP / kBoxCols; ++h) {
#pragma unroll
    for (int rb = 0; rb < ROWS / kWalkRows; ++rb) {
      tma_load_3d(dst + (h * ROWS + rb * kWalkRows) * 128, map, bar, h * kBoxCols,
                  r0 + rb * kWalkRows, bh);
    }
  }
}

// Byte offset of element (r, c) in a tile of `rows` rows kept as 128-byte
// swizzled boxes of 32 columns: TMA's CU_TENSOR_MAP_SWIZZLE_128B layout,
// which is also the K-major layout wgmma reads with a 128-byte swizzle.
__device__ __forceinline__ uint32_t sw(int rows, int r, int c) {
  return (c >> 5) * rows * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ float lds(const unsigned char* s, uint32_t off) {
  return *reinterpret_cast<const float*>(s + off);
}

// Shared memory written by threads, made visible to wgmma and TMA.  It
// compiles to a membar that also waits for the thread's loads from global
// memory in flight.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d[64 x 32] += A[64 x 8] B[8 x 32]: A tf32 in registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += A[64 x 8] B[8 x 32]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 8] B[8 x 64]: A tf32 in registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Fragments of thread (w, g, t) = (warp of the warpgroup, lane / 4, lane % 4)
// in the tf32 A layout: a0 (16w + g, t), a1 (+8, t), a2 (g, t + 4), a3 (+8,
// t + 4).  The accumulators hold (16w + g (+8), 8j + 2t (+1)) at 4j + i.

// The fixed tile at x (64 rows as TMA landed them) split once by the
// warpgroup that reads it: lo parts written back in place, the A operand of
// the lo pass from shared memory; hi parts kept in registers, this thread's
// fragment of each k step: hi[kk] = hi(x[16w + m][8kk + k]).
template <int DP>
__device__ __forceinline__ void split_fixed(unsigned char* x, uint32_t (&hi)[DP / 8][4]) {
  const int l = threadIdx.x % 128;
  const int r = 16 * (l / 32) + (l % 32) / 4;
  const int t = l % 4;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const uint32_t at[4] = {sw(kFixedRows, r, 8 * kk + t), sw(kFixedRows, r + 8, 8 * kk + t),
                            sw(kFixedRows, r, 8 * kk + t + 4),
                            sw(kFixedRows, r + 8, 8 * kk + t + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t lo;
      split(lds(x, at[i]), hi[kk][i], lo);
      *reinterpret_cast<uint32_t*>(x + at[i]) = lo;
    }
  }
}

// The products over the walked rows take their k steps' rows in another
// order: k index t of step kk is row 8kk + 2t, t + 4 is row 8kk + 2t + 1
// (store_op writes B in the same order).  A thread's A fragment then reads
// two neighbouring rows, which the 128-byte swizzle puts in distinct banks
// for every lane.  This thread's byte offsets in a walked tile (32 rows) of
// the elements its transposed A fragments read, less mt * 8192 + kk * 1024:
// [h][e] for rows + 8h of M (columns of the tile) and k index t + 4e.  With
// c = 64mt + 16w + g + 8h and r = 8kk + 2t + e, sw(32, r, c) splits so.
__device__ __forceinline__ void walked_offsets(uint32_t (&off)[2][2]) {
  const int l = threadIdx.x % 128;
  const int w = l / 32, g = (l % 32) / 4, t = l % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int chunk = 4 * (w & 1) + (g >> 2) + 2 * h;
      off[h][e] = (w >> 1) * 4096 + (2 * t + e) * 128 + ((chunk ^ (2 * t + e)) << 4) + (g & 3) * 4;
    }
  }
}

// The two landed walked tiles of a stage, split once for every product
// that reads them, by the producer's 128 threads: hi parts in place, lo
// parts at the same offsets in `lo`.
template <int DP>
__device__ __forceinline__ void split_walked(unsigned char* stage, unsigned char* lo, int pt) {
  constexpr int kChunks = 2 * Wg<DP>::kWalkBytes / 16;
  static_assert(kChunks % 128 == 0, "whole chunks a thread");
#pragma unroll 4
  for (int n = 0; n < kChunks / 128; ++n) {
    const int i = pt + n * 128;
    const float4 x = reinterpret_cast<const float4*>(stage)[i];
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(stage)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// c[64 x 32] = X W^T over DP columns in 3xTF32: X the fixed tile (A: its hi
// parts x_hi in registers, its lo parts at x_lo in shared memory), W the
// walked tile's parts at w_hi and w_lo (B).  Each k step is three wgmma:
// lo hi, hi lo, then hi hi; two of them read A from registers, which keeps
// the product's shared-memory traffic under the bandwidth.  Addresses are
// in the shared space.
template <int DP>
__device__ __forceinline__ void rows_product(float (&c)[16], const uint32_t (&x_hi)[DP / 8][4],
                                             uint32_t x_lo, uint32_t w_hi, uint32_t w_lo) {
  const uint64_t a = desc_sw128(x_lo, 16);
  const uint64_t b_hi = desc_sw128(w_hi, 16);
  const uint64_t b_lo = desc_sw128(w_lo, 16);
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = 0.f;
  fence_regs(c);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    // k step kk: box kk / 4, 32 bytes a step inside its 128-byte rows
    const uint32_t a_at = ((kk >> 2) * kFixedRows * 128 + (kk & 3) * 32) >> 4;
    const uint32_t b_at = ((kk >> 2) * kWalkRows * 128 + (kk & 3) * 32) >> 4;
    wgmma_n32_ss(c, a + a_at, b_hi + b_at);
    wgmma_n32(c, x_hi[kk], b_lo + b_at);
    wgmma_n32(c, x_hi[kk], b_hi + b_at);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(c);
}

// c[t][64 x 64] += W^T B for m tiles mt0 + t in 3xTF32: W the walked tile's
// parts at w_hi and w_lo (A, transposed into registers through `off`), B the
// [64][32] operand whose parts are at b (hi) and b + kOpBytes (lo), a
// shared-space address.  A tile's fragments load while the one before runs.
template <int NT>
__device__ __forceinline__ void cols_product(float (&c)[NT][32], const unsigned char* w_hi,
                                             const unsigned char* w_lo,
                                             const uint32_t (&off)[2][2], int mt0, uint32_t b) {
  const uint64_t b_hi = desc_sw128(b, 16);
  const uint64_t b_lo = desc_sw128(b + kOpBytes, 16);
  uint32_t ah[NT][4][4];
  uint32_t al[NT][4][4];
#pragma unroll
  for (int mt = 0; mt < NT; ++mt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t at = off[i & 1][i >> 1] + (mt0 + mt) * 8192 + kk * 1024;
        ah[mt][kk][i] = __float_as_uint(lds(w_hi, at));
        al[mt][kk][i] = __float_as_uint(lds(w_lo, at));
      }
    }
    fence_regs(c[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_n64(c[mt], al[mt][kk], b_hi + 2 * kk);
      wgmma_n64(c[mt], ah[mt][kk], b_lo + 2 * kk);
      wgmma_n64(c[mt], ah[mt][kk], b_hi + 2 * kk);
    }
    wgmma_commit();
  }
  wgmma_wait0();
#pragma unroll
  for (int mt = 0; mt < NT; ++mt) fence_regs(c[mt]);
}

// P = exp(x - lse) with x = s * scale, over a [64 x 32] score accumulator,
// in place: 0 where x <= NEG_INF / 2 (the guard of a row whose lse
// collapsed) and, unless every pair is live (`full`), where the pair is
// masked.  Element 4j + e is (a, b) = (16w + g + 8 (e / 2), 8j + 2t + e % 2)
// of the tile; with QA its query is a and its key b (dq), else the other
// way round (dk/dv), and its lse is lse[e / 2] or lse[2j + e % 2].  A query
// at index >= q_left lies past Tq, a key at >= k_left past Tk, and a pair
// is masked when query - key + diag < 0 (with `kBand` unless 0 <= query -
// key + diag < window, one unsigned compare), diag being the tile's first
// query's position less its first key's, clamped (or kFar when not causal):
// 32-bit tests, in a branch of their own, so a tile with every pair live
// pays for none.  exp is 2^(x log2 e) on the MUFU unit with
// subnormal results flushed to zero (ex2.approx.ftz, as B5's prefill):
// a P under 2^-126 adds nothing an f32 sum keeps.
template <bool QA, bool kBand>
__device__ __forceinline__ void probs(float (&c)[16], const float (&lse)[8], float scale,
                                      bool full, int q_left, int k_left, int diag, int window) {
  if (!full) {
    const int l = threadIdx.x % 128;
    const int a0 = 16 * (l / 32) + (l % 32) / 4;
    const int b0 = 2 * (l % 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = a0 + 8 * (e >> 1);
        const int b = b0 + 8 * j + (e & 1);
        const int q = QA ? a : b;
        const int k = QA ? b : a;
        const bool out = kBand ? (unsigned)(q - k + diag) >= (unsigned)window : q - k + diag < 0;
        if (q >= q_left || k >= k_left || out) {
          c[4 * j + e] = __int_as_float(0xff800000);  // -inf: x under the guard
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = c[4 * j + e] * scale;
      const float r = lse[QA ? e >> 1 : 2 * j + (e & 1)];
      // exact probabilities from the saved lse; masked scores and a row
      // whose lse collapsed to NEG_INF fall under the guard
      float p;
      asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(p) : "f"((x - r) * 1.4426950408889634f));
      c[4 * j + e] = x <= kNegInf * 0.5f ? 0.f : p;
    }
  }
}

// The causal offset of a tile whose first query sits at q_pos and first key
// at k_pos, clamped to +-kFar (tiles are far smaller, windows shorter than
// kMaxWindow); kFar when not causal.
__device__ __forceinline__ int tile_diag(bool causal, int64_t q_pos, int64_t k_pos) {
  const int64_t far = kFar;
  if (!causal) return (int)far;
  const int64_t d = q_pos - k_pos;
  return (int)(d > far ? far : d < -far ? -far : d);
}

// An accumulator c of a [64 x 32] tile, split into the hi and lo parts of a
// K-major B operand at `op` (rows the accumulator's rows), each k step's
// columns in walked_offsets' order: column 8j + 2t + e goes to k index t +
// 4e of step j, in chunk 2j + e of the row, which the swizzle XORs with the
// row's r % 8 = g.
__device__ __forceinline__ void store_op(unsigned char* op, const float (&c)[16]) {
  const int l = threadIdx.x % 128;
  const int g = (l % 32) / 4, t = l % 4;
  const uint32_t row = (16 * (l / 32) + g) * 128 + t * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t at = row + h * 1024 + (((2 * j + e) ^ g) << 4);
        uint32_t hi, lo;
        split(c[4 * j + 2 * h + e], hi, lo);
        *reinterpret_cast<uint32_t*>(op + at) = hi;
        *reinterpret_cast<uint32_t*>(op + kOpBytes + at) = lo;
      }
    }
  }
}

// The 1024-aligned base of the dynamic shared memory, as a pointer and as a
// shared-space address; thread 0 sets up the barriers: fixed and full[2]
// complete on TMA's bytes, ready[2] on the producer's 128 threads, empty[2]
// on the 256 consumers.
template <int DP>
__device__ __forceinline__ unsigned char* wg_setup(unsigned char* raw, uint32_t& s32) {
  const uint32_t raw32 = smem_u32(raw);
  s32 = (raw32 + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    const uint32_t bars = s32 + Wg<DP>::kBars;
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    for (int i = 3; i < 5; ++i) mbar_init(bars + 8 * i, 128);
    for (int i = 5; i < 7; ++i) mbar_init(bars + 8 * i, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return raw + (s32 - raw32);
}

// The producer warpgroup (threads kConsumers on): its elected thread loads
// the fixed tiles (a, b: rows r0 of head bh) by TMA, then for walked tile i
// (rows 32 (first + i) of maps c, d) it waits until the consumers are done
// with the stage's previous tile, loads the tile by TMA, stores the rows'
// lse and dsum (when given) in Rv, splits the tile and marks it ready.  It
// gives up its registers to the consumers.
template <int DP>
__device__ __forceinline__ void produce(unsigned char* s, uint32_t s32, const CUtensorMap* a,
                                        const CUtensorMap* b, int r0, const CUtensorMap* c,
                                        const CUtensorMap* d, int first, int n, int bh,
                                        const float* lse, const float* dsum, int64_t base,
                                        int t) {
  using L = Wg<DP>;
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
  const int pt = threadIdx.x - kConsumers;
  const uint32_t bars = s32 + L::kBars;
  if (pt == 0) {
    mbar_expect_tx(bars, 2 * L::kFixedBytes);
    load_tile<DP, kFixedRows>(s32 + L::kX, a, bars, r0, bh);
    load_tile<DP, kFixedRows>(s32 + L::kY, b, bars, r0, bh);
  }
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    const int row0 = (first + i) * kWalkRows;
    if (i >= 2) mbar_wait(bars + 40 + 8 * st, ((i >> 1) - 1) & 1);  // tile i - 2 is done
    const uint32_t full = bars + 8 + 8 * st;
    const int stage = L::kRing + st * 2 * L::kWalkBytes;
    if (pt == 0) {
      mbar_expect_tx(full, 2 * L::kWalkBytes);
      load_tile<DP, kWalkRows>(s32 + stage, c, full, row0, bh);
      load_tile<DP, kWalkRows>(s32 + stage + L::kWalkBytes, d, full, row0, bh);
    }
    if (lse != nullptr && pt < 2 * kWalkRows) {
      const int row = row0 + pt % kWalkRows;
      const float* from = pt < kWalkRows ? lse : dsum;
      reinterpret_cast<float*>(s + L::kRv)[st * 2 * kWalkRows + pt] =
          row < t ? from[base + row] : 0.f;
    }
    mbar_wait(full, (i >> 1) & 1);
    split_walked<DP>(s + stage, s + L::kLo + st * 2 * L::kWalkBytes, pt);
    fence_async();
    mbar_arrive(bars + 24 + 8 * st);
  }
}

// Adds this thread's part of a transposed accumulator (dK^T, dV^T or dQ^T:
// m tile mt holds columns d0 + 64 mt on of out, its own columns rows r0 on)
// times `scale` into out, [rows][d] f32 from row `base`, and zeroes it.  The
// tensor cores' f32 accumulation aligns a term to the accumulator and
// truncates the bits it drops, so a long sum of small terms into a large
// accumulator drifts low: a causal dK/dV row of T 32768 summed whole lands
// 2e-4 of max |plain| low.  Flushed every kFlushTiles walked tiles, no
// accumulator sums more than 384 such terms, and the adds into out round to
// nearest.  A second accumulator to add into would fit neither the 232
// registers nor the shared memory, so the sum goes to out itself, whose
// elements this block alone writes, in a fixed order: still deterministic.
template <int NT>
__device__ __forceinline__ void flush(float (&acc)[NT][32], float* out, int64_t base, int r0,
                                      int rows, int d0, int d, float scale) {
  // the thread's index through an opaque move, so that none of the flush's
  // 64 addresses is hoisted out of the walk, where each would hold a
  // register for the whole of it
  int l;
  asm volatile("mov.u32 %0, %1;\n" : "=r"(l) : "r"((int)threadIdx.x % 128));
  const int dc = d0 + 16 * (l / 32) + (l % 32) / 4;
  const int t4 = l % 4;
  // 16 elements at a time, their loads before their stores: the compiler
  // cannot tell the addresses apart, so a load after a store would wait for
  // the one before it, one memory latency an element
#pragma unroll
  for (int h = 0; h < 2 * NT; ++h) {
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = dc + 64 * (h / 2) + 8 * ((i % 4) >> 1);
      const int row = r0 + 8 * (4 * (h % 2) + i / 4) + 2 * t4 + (i & 1);
      v[i] = col < d && row < rows ? out[(base + row) * d + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = dc + 64 * (h / 2) + 8 * ((i % 4) >> 1);
      const int row = r0 + 8 * (4 * (h % 2) + i / 4) + 2 * t4 + (i & 1);
      float& a = acc[h / 2][16 * (h % 2) + i];
      if (col < d && row < rows) out[(base + row) * d + col] = v[i] + a * scale;
      a = 0.f;
    }
  }
}

// One block per (bh, 64-key tile): dK and dV of its keys over every 32-row
// q tile that sees one of them, added into dk/dv every kFlushTiles tiles
// and at the end.
// Warpgroup 0 runs S^T = K Q^T, P^T, then dV^T += dO^T P^T; warpgroup 1
// dP^T = V dO^T, dS^T = P^T (dP^T - D) with P^T from warpgroup 0, then
// dK^T += Q^T dS^T; warpgroup 2 produces.
template <int DP, bool kBand>
__device__ __forceinline__ void dkdv_f32(const Maps& maps, const BwdParams<float>& p,
                                         unsigned char* raw) {
  using L = Wg<DP>;
  constexpr int kTiles = DP / 64;  // m tiles of dK^T and dV^T
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kFixedRows;  // key tile 0 sees the most q tiles: first
  int first = 0;
  int last = (p.tq + kWalkRows - 1) / kWalkRows;
  if (p.causal) {
    // query rows before `need` see none of this tile's keys
    const int64_t need = p.k_off + k0 - p.q_off;
    if (need >= p.tq) {
      first = last;
    } else if (need > 0) {
      first = (int)(need / kWalkRows);
    }
    if constexpr (kBand) {
      // nor do rows after `stop`, past the band of the tile's last key
      const int64_t stop = p.k_off + k0 + kFixedRows - 2 + p.window - p.q_off;
      if (stop < 0) {
        last = 0;
      } else if (stop / kWalkRows + 1 < last) {
        last = (int)(stop / kWalkRows + 1);
      }
    }
  }
  if (first >= last) return;  // a fully masked tile: dk/dv untouched

  uint32_t s32;
  unsigned char* s = wg_setup<DP>(raw, s32);
  const int64_t qbase = (int64_t)bh * p.tq;
  const int n = last - first;
  if (threadIdx.x >= kConsumers) {
    produce<DP>(s, s32, &maps.k, &maps.v, k0, &maps.q, &maps.dout, first, n, bh, p.lse, p.dsum,
                qbase, p.tq);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const uint32_t bars = s32 + L::kBars;
  const int wg = threadIdx.x / 128;
  const int l = threadIdx.x % 128;
  const int t4 = l % 4;
  const int64_t kbase = (int64_t)bh * p.tk;
  float* out = wg == 0 ? p.dv : p.dk;
  const float scale = wg == 0 ? 1.f : p.scale;
  float* praw = reinterpret_cast<float*>(s + L::kDs);
  uint32_t off[2][2];
  walked_offsets(off);
  float acc[kTiles][32];
#pragma unroll
  for (int mt = 0; mt < kTiles; ++mt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;
  }
  // K (warpgroup 0) or V (warpgroup 1): lo in place, hi in registers
  const int x_at = wg == 0 ? L::kX : L::kY;
  uint32_t x_hi[DP / 8][4];
  mbar_wait(bars, 0);
  split_fixed<DP>(s + x_at, x_hi);
  fence_async();
  bar_sync(1, kConsumers);
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    const int q0 = (first + i) * kWalkRows;
    const int q_hi = L::kRing + st * 2 * L::kWalkBytes;  // dO's at + kWalkBytes
    const int q_lo = L::kLo + st * 2 * L::kWalkBytes;
    mbar_wait(bars + 24 + 8 * st, (i >> 1) & 1);  // split and ready
    // lse (warpgroup 0) or dsum (warpgroup 1) of this thread's columns,
    // read before the product takes the shared memory's bandwidth
    const float* rows = reinterpret_cast<const float*>(s + L::kRv) + (2 * st + wg) * kWalkRows;
    float rv[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rv[2 * j] = rows[8 * j + 2 * t4];
      rv[2 * j + 1] = rows[8 * j + 2 * t4 + 1];
    }
    float c[16];
    if (wg == 0) {
      rows_product<DP>(c, x_hi, s32 + L::kX, s32 + q_hi, s32 + q_lo);  // S^T = K Q^T
      // every (key, row) pair live: no mask to evaluate
      const bool full = q0 + kWalkRows <= p.tq && k0 + kFixedRows <= p.tk &&
                        (!p.causal || (p.q_off + q0 >= p.k_off + k0 + kFixedRows - 1 &&
                                       (!kBand || p.q_off + q0 + kWalkRows - 1 - p.k_off - k0 <
                                                      p.window)));
      probs<false, kBand>(c, rv, p.scale, full, p.tq - q0, p.tk - k0,
                   tile_diag(p.causal, p.q_off + q0, p.k_off + k0), p.window);
      if (i > 0) bar_sync(5, kConsumers);  // warpgroup 1 is done with Ds of tile i - 1
#pragma unroll
      for (int e = 0; e < 16; ++e) praw[e * 128 + l] = c[e];
      bar_arrive(2, kConsumers);  // P^T for warpgroup 1
      store_op(s + L::kP, c);
      fence_async();
      bar_sync(3, 128);
      // dV^T += dO^T P^T
      cols_product(acc, s + q_hi + L::kWalkBytes, s + q_lo + L::kWalkBytes, off, 0, s32 + L::kP);
    } else {
      // dP^T = V dO^T
      rows_product<DP>(c, x_hi, s32 + L::kY, s32 + q_hi + L::kWalkBytes,
                       s32 + q_lo + L::kWalkBytes);
      bar_sync(2, kConsumers);  // P^T from warpgroup 0
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        c[e] = praw[e * 128 + l] * (c[e] - rv[2 * (e >> 2) + (e & 1)]);
      }
      bar_sync(4, 128);  // P^T read by the whole warpgroup: Ds is free
      store_op(s + L::kDs, c);
      fence_async();
      bar_sync(4, 128);
      cols_product(acc, s + q_hi, s + q_lo, off, 0, s32 + L::kDs);  // dK^T += Q^T dS^T
      if (i + 1 < n) bar_arrive(5, kConsumers);
    }
    mbar_arrive(bars + 40 + 8 * st);  // the stage is free
    if ((i + 1) % kFlushTiles == 0 || i + 1 == n) flush(acc, out, kbase, k0, p.tk, 0, p.d, scale);
  }
}

// One block per (bh, 64-row q tile): dQ of its rows over every 32-key tile
// it sees, added into dq every kFlushTiles tiles and at the end.  Warpgroup 0 runs S = Q K^T and
// P; warpgroup 1 dP = dO V^T and dS = P (dP - D); then warpgroup m runs m
// tile m of dQ^T += K^T dS^T; warpgroup 2 produces.
template <int DP, bool kBand>
__device__ __forceinline__ void dq_f32(const Maps& maps, const BwdParams<float>& p,
                                       unsigned char* raw) {
  using L = Wg<DP>;
  constexpr int kTiles = DP / 64;  // m tiles of dQ^T
  const int bh = blockIdx.x;
  // the causal q tiles see more keys the later they are: last tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFixedRows;
  int n_k = (p.tk + kWalkRows - 1) / kWalkRows;
  int first = 0;
  if (p.causal) {
    // the last key any row of this tile sees
    const int last_row = min(q0 + kFixedRows, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kWalkRows + 1;
    if (need < n_k) n_k = (int)need;
    if constexpr (kBand) {
      // the first key the tile's first row sees in its band
      const int64_t first_key = p.q_off + q0 - p.window + 1 - p.k_off;
      if (first_key > 0) first = first_key / kWalkRows < n_k ? (int)(first_key / kWalkRows) : n_k;
    }
  }
  if (first >= n_k) return;  // every key outside every query's band: dq untouched
  const int n = n_k - first;

  uint32_t s32;
  unsigned char* s = wg_setup<DP>(raw, s32);
  if (threadIdx.x >= kConsumers) {
    produce<DP>(s, s32, &maps.q, &maps.dout, q0, &maps.k, &maps.v, first, n, bh, nullptr,
                nullptr, 0, 0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const uint32_t bars = s32 + L::kBars;
  const int wg = threadIdx.x / 128;
  const int l = threadIdx.x % 128;
  const int wq = 16 * (l / 32) + (l % 32) / 4;  // this thread's first row of the tile
  const int64_t qbase = (int64_t)bh * p.tq;
  // lse (warpgroup 0) or dsum (warpgroup 1) of this thread's two rows
  const float* per_row = wg == 0 ? p.lse : p.dsum;
  float rv[8] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wq + 8 * h;
    rv[h] = row < p.tq ? per_row[qbase + row] : 0.f;
  }
  float* praw = reinterpret_cast<float*>(s + L::kDs);
  uint32_t off[2][2];
  walked_offsets(off);
  float acc[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = 0.f;
  // Q (warpgroup 0) or dO (warpgroup 1): lo in place, hi in registers
  const int x_at = wg == 0 ? L::kX : L::kY;
  uint32_t x_hi[DP / 8][4];
  mbar_wait(bars, 0);
  split_fixed<DP>(s + x_at, x_hi);
  fence_async();
  bar_sync(1, kConsumers);
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    const int kt0 = (first + i) * kWalkRows;
    const int k_hi = L::kRing + st * 2 * L::kWalkBytes;  // V's at + kWalkBytes
    const int k_lo = L::kLo + st * 2 * L::kWalkBytes;
    mbar_wait(bars + 24 + 8 * st, (i >> 1) & 1);  // split and ready
    float c[16];
    if (wg == 0) {
      rows_product<DP>(c, x_hi, s32 + L::kX, s32 + k_hi, s32 + k_lo);  // S = Q K^T
      const bool full = q0 + kFixedRows <= p.tq && kt0 + kWalkRows <= p.tk &&
                        (!p.causal || (p.q_off + q0 >= p.k_off + kt0 + kWalkRows - 1 &&
                                       (!kBand || p.q_off + q0 + kFixedRows - 1 - p.k_off - kt0 <
                                                      p.window)));
      probs<true, kBand>(c, rv, p.scale, full, p.tq - q0, p.tk - kt0,
                  tile_diag(p.causal, p.q_off + q0, p.k_off + kt0), p.window);
      if (i > 0) bar_sync(5, kConsumers);  // warpgroup 1 is done with Ds of tile i - 1
#pragma unroll
      for (int e = 0; e < 16; ++e) praw[e * 128 + l] = c[e];
      bar_arrive(2, kConsumers);  // P for warpgroup 1
    } else {
      // dP = dO V^T
      rows_product<DP>(c, x_hi, s32 + L::kY, s32 + k_hi + L::kWalkBytes,
                       s32 + k_lo + L::kWalkBytes);
      bar_sync(2, kConsumers);  // P from warpgroup 0
#pragma unroll
      for (int e = 0; e < 16; ++e) c[e] = praw[e * 128 + l] * (c[e] - rv[(e >> 1) & 1]);
      bar_sync(4, 128);  // P read by the whole warpgroup: Ds is free
      store_op(s + L::kDs, c);
      fence_async();
    }
    bar_sync(3, kConsumers);  // dS for both warpgroups
    // dQ^T += K^T dS^T
    if (wg < kTiles) cols_product(acc, s + k_hi, s + k_lo, off, wg, s32 + L::kDs);
    if (wg == 1 && i + 1 < n) bar_arrive(5, kConsumers);
    mbar_arrive(bars + 40 + 8 * st);  // the stage is free
    if (wg < kTiles && ((i + 1) % kFlushTiles == 0 || i + 1 == n)) {
      flush(acc, p.dq, qbase, q0, p.tq, 64 * wg, p.d, p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel B4's two kernels: f32 storage on wgmma, bf16 on mma.sync (the maps
// are read only in f32).  The two routes share nothing but these templates,
// which exist for their names alone: the benchmark finds B4 f32 in a trace
// by `dkdv_kernel<float` and `dq_kernel<float` (benchmark/readings.py,
// held to this file by tests/test_torch_flash_backward.py).  Once the
// benchmark matches `dkdv_f32`/`dq_f32` itself, each route can take a
// __global__ of its own, with its own thread count and no Maps in bf16.

template <typename T, int DP>
__global__ void __launch_bounds__(sizeof(T) == 4 ? kConsumers + 128 : kThreads, 1)
    dkdv_kernel(const __grid_constant__ Maps maps, const BwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 4) {
    dkdv_f32<DP, false>(maps, p, smem);
  } else {
    dkdv_mma<T, DP>(p, smem);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(sizeof(T) == 4 ? kConsumers + 128 : kThreads, 1)
    dq_kernel(const __grid_constant__ Maps maps, const BwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 4) {
    dq_f32<DP, false>(maps, p, smem);
  } else {
    dq_mma<T, DP>(p, smem);
  }
}

// B4 f32 with a sliding window: kernels of their own, so that the causal
// kernels above stay as they were (the benchmark reads these names too).
template <int DP>
__global__ void __launch_bounds__(kConsumers + 128, 1)
    dkdv_band_kernel(const __grid_constant__ Maps maps, const BwdParams<float> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkdv_f32<DP, true>(maps, p, smem);
}

template <int DP>
__global__ void __launch_bounds__(kConsumers + 128, 1)
    dq_band_kernel(const __grid_constant__ Maps maps, const BwdParams<float> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_f32<DP, true>(maps, p, smem);
}

// ---------------------------------------------------------------------------
// kernel B3 on f32 storage

template <int DP>
constexpr int fold_smem() {
  return Smem<float, DP>::bytes(kRows) + kStages * 2 * Smem<float, DP>::bytes(kFoldStep);
}

// One block per (bh, 128-row q tile) folds every 64-key tile it sees into
// the (m, l, o) state of its rows, held in registers, and writes the state
// back once.  A tile past the causal diagonal, or before the band of a
// sliding window, is skipped: its update is an exact no-op.
template <int DP, bool kBand>
__device__ __forceinline__ void fold_f32(const FoldParams& p, unsigned char* smem) {
  using L = Smem<float, DP>;
  constexpr int kFixed = kRows * L::kRowElems;
  constexpr int kStep = kFoldStep * L::kRowElems;
  constexpr int kN = kFoldStep / 8;
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
  int first = 0;
  if (p.causal) {
    const int last_row = min(q0 + kRows, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kFoldStep + 1;
    if (need < n_k) n_k = (int)need;
    if constexpr (kBand) {
      // the first key the block's first row sees in its band
      const int64_t first_key = p.q_off + q0 - p.window + 1 - p.k_off;
      if (first_key > 0) first = first_key / kFoldStep < n_k ? (int)(first_key / kFoldStep) : n_k;
    }
  }
  if (first >= n_k) return;  // a fully masked block: the state stays as it is

  const int64_t kbase = (int64_t)bh * p.tk;
  const int64_t qbase = (int64_t)bh * p.tq;
  auto stage_k = [&](int jt, int s) {
    stage<float, DP, kFoldStep>(ks + s * kStep, p.k, kbase, p.tk, p.d, jt * kFoldStep);
    stage<float, DP, kFoldStep>(vs + s * kStep, p.v, kbase, p.tk, p.d, jt * kFoldStep);
  };
  stage<float, DP, kRows>(qs, p.q, qbase, p.tq, p.d, q0);
  stage_k(first, 0);
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
  // the distance from this warp's first row to a tile's last key, less kt0
  const int64_t reach = p.q_off + wq0 - p.k_off - (kFoldStep - 1);
  for (int jt = first; jt < n_k; ++jt) {
    const int s = (jt - first) % kStages;
    if (jt + 1 < n_k) stage_k(jt + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const float* kt = ks + s * kStep;
    const float* vt = vs + s * kStep;
    const int kt0 = jt * kFoldStep;
    const bool sees = !p.causal || (last_q >= p.k_off + kt0 && (!kBand || reach - kt0 < p.window));
    if (wq0 < p.tq && sees) {
      float sc[kN][4];
      rows_dot<float, DP>(sc, qs, warp * 16, kt);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wq0 + g + 8 * (i >> 1);
          const int key = kt0 + 8 * j + 2 * t4 + (i & 1);
          const bool seen =
              kBand ? (uint64_t)(p.q_off + row - p.k_off - key) < (uint64_t)p.window
                    : p.q_off + row >= p.k_off + key;
          const bool live = key < p.tk && (!p.causal || seen);
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
      acc_dot<float, DP>(o, sc, vt);  // o += e V
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

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) fold_f32_kernel(const FoldParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  fold_f32<DP, false>(p, smem);
}

// the fold with a sliding window, a kernel of its own as B4's
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) fold_band_kernel(const FoldParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  fold_f32<DP, true>(p, smem);
}

// ---------------------------------------------------------------------------
// launches

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int tiles(int t, int rows) { return (t + rows - 1) / rows; }

template <int DP>
int launch_backward_f32(const Maps& maps, const BwdParams<float>& p, cudaStream_t stream) {
  constexpr int kSmem = Wg<DP>::kSmem;
  static_assert(kSmem <= 232448, "a block's shared memory");
  const dim3 dkdv_grid(p.bh, tiles(p.tk, kFixedRows)), dq_grid(p.bh, tiles(p.tq, kFixedRows));
  if (p.window != kNoWindow) {
    int err = set_smem(dkdv_band_kernel<DP>, kSmem);
    if (err != 0) return err;
    err = set_smem(dq_band_kernel<DP>, kSmem);
    if (err != 0) return err;
    dkdv_band_kernel<DP><<<dkdv_grid, kConsumers + 128, kSmem, stream>>>(maps, p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    dq_band_kernel<DP><<<dq_grid, kConsumers + 128, kSmem, stream>>>(maps, p);
    return (int)cudaGetLastError();
  }
  int err = set_smem(dkdv_kernel<float, DP>, kSmem);
  if (err != 0) return err;
  err = set_smem(dq_kernel<float, DP>, kSmem);
  if (err != 0) return err;
  dkdv_kernel<float, DP><<<dkdv_grid, kConsumers + 128, kSmem, stream>>>(maps, p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_kernel<float, DP><<<dq_grid, kConsumers + 128, kSmem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_backward_mma(const BwdParams<__nv_bfloat16>& p, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int kDkdvSmem = dkdv_smem<T, DP>();
  constexpr int kDqSmem = dq_smem<T, DP>();
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "a block's shared memory");
  int err = set_smem(dkdv_kernel<T, DP>, kDkdvSmem);
  if (err != 0) return err;
  err = set_smem(dq_kernel<T, DP>, kDqSmem);
  if (err != 0) return err;
  const Maps none{};  // bf16 reads its tiles with cp.async
  dkdv_kernel<T, DP><<<dim3(p.bh, tiles(p.tk, kRows)), kThreads, kDkdvSmem, stream>>>(none, p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_kernel<T, DP><<<dim3(p.bh, tiles(p.tq, kRows)), kThreads, kDqSmem, stream>>>(none, p);
  return (int)cudaGetLastError();
}

// A 3-D map over [BH, T, D] f32 in boxes of 32 rows x 32 columns, 128-byte
// swizzle; rows past T and columns past D read as zeros.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int bh, int t, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)t * d * 4};
  const cuuint32_t box[3] = {kBoxCols, kWalkRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// f32: 999 when the driver has no cuTensorMapEncodeTiled, 1000 + the
// CUresult when a map cannot be encoded
int backward_f32(const BwdParams<float>& p, cudaStream_t stream) {
  if (p.tq > 65535 * kFixedRows || p.tk > 65535 * kFixedRows) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  Maps maps;
  CUtensorMap* out[4] = {&maps.q, &maps.k, &maps.v, &maps.dout};
  const void* ptrs[4] = {p.q, p.k, p.v, p.dout};
  const int ts[4] = {p.tq, p.tk, p.tk, p.tq};
  for (int i = 0; i < 4; ++i) {
    const CUresult res = encode(fn, out[i], ptrs[i], p.bh, ts[i], p.d);
    if (res != CUDA_SUCCESS) return 1000 + (int)res;
  }
  if (p.d <= 64) return launch_backward_f32<64>(maps, p, stream);
  return launch_backward_f32<128>(maps, p, stream);
}

int backward_bf16(const BwdParams<__nv_bfloat16>& p, cudaStream_t stream) {
  if (p.d <= 16) return launch_backward_mma<16>(p, stream);
  if (p.d <= 32) return launch_backward_mma<32>(p, stream);
  if (p.d <= 64) return launch_backward_mma<64>(p, stream);
  return launch_backward_mma<128>(p, stream);
}

template <int DP>
int launch_fold(const FoldParams& p, cudaStream_t stream) {
  constexpr int kSmem = fold_smem<DP>();
  static_assert(kSmem <= 232448, "a block's shared memory");
  const dim3 grid(p.bh, tiles(p.tq, kRows));
  if (p.window != kNoWindow) {
    const int err = set_smem(fold_band_kernel<DP>, kSmem);
    if (err != 0) return err;
    fold_band_kernel<DP><<<grid, kThreads, kSmem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  const int err = set_smem(fold_f32_kernel<DP>, kSmem);
  if (err != 0) return err;
  fold_f32_kernel<DP><<<grid, kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int tq, int tk, int d) {
  return d <= 0 || d > 128 || d % 8 != 0 || bh > 65535 || tq < 0 || tk < 0 ||
         tq > 65535 * kRows || tk > 65535 * kRows;
}

// the copies move 16 bytes of q/k/v/dO at a time, the write-backs 8 of f32
bool misaligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes != 0; }

// The kernels' window of a hop: kNoWindow unless causal with a window
// shorter than kMaxWindow (a longer one hides no key of any block).
int band(int causal, int window) {
  return causal && window > 0 && window < kMaxWindow ? window : kNoWindow;
}

template <typename T>
int backward(const BwdParams<T>& p, cudaStream_t stream) {
  if (bad_shape(p.bh, p.tq, p.tk, p.d)) return (int)cudaErrorInvalidValue;
  // bf16's mma.sync kernels have no band
  if (sizeof(T) != 4 && p.window != kNoWindow) return (int)cudaErrorInvalidValue;
  if (misaligned(p.q, 16) || misaligned(p.k, 16) || misaligned(p.v, 16) ||
      misaligned(p.dout, 16) || misaligned(p.lse, 4) || misaligned(p.dsum, 4) ||
      misaligned(p.dq, 8) || misaligned(p.dk, 8) || misaligned(p.dv, 8)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (p.bh == 0 || p.tq == 0 || p.tk == 0) return (int)cudaSuccess;
  if constexpr (sizeof(T) == 4) {
    return backward_f32(p, stream);
  } else {
    return backward_bf16(p, stream);
  }
}

template <typename T>
int backward_entry(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dsum, float* dq, float* dk, float* dv, int bh,
                   int tq, int tk, int d, int64_t q_off, int64_t k_off, int causal, int window,
                   float scale, cudaStream_t stream) {
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
  p.window = band(causal, window);
  p.scale = scale;
  return backward(p, stream);
}

int backward_smem_bf16(int d, int which) {
  using T = __nv_bfloat16;
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
// a multiple of 8 up to 128; q/k/v/dout 16-byte aligned.  `window` > 0 on a
// causal hop keeps only keys within window - 1 positions before a query
// (f32 only; 0 for none).  Two kernels on `stream`, no synchronize; returns
// the first failing launch's cudaError_t (0 on success).
extern "C" int tpu_flash_block_backward_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* dsum, float* dq, float* dk, float* dv,
                                            int bh, int tq, int tk, int d, int64_t q_off,
                                            int64_t k_off, int causal, int window, float scale,
                                            cudaStream_t stream) {
  return backward_entry<float>(q, k, v, dout, lse, dsum, dq, dk, dv, bh, tq, tk, d, q_off, k_off,
                               causal, window, scale, stream);
}

extern "C" int tpu_flash_block_backward_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* dsum, float* dq, float* dk, float* dv,
                                             int bh, int tq, int tk, int d, int64_t q_off,
                                             int64_t k_off, int causal, int window,
                                             float scale, cudaStream_t stream) {
  return backward_entry<__nv_bfloat16>(q, k, v, dout, lse, dsum, dq, dk, dv, bh, tq, tk, d, q_off,
                                       k_off, causal, window, scale, stream);
}

// Kernel B3 on f32: folds k, v [BH, Tk, D] into the online-softmax state of
// q [BH, Tq, D]: m, l [BH, Tq] and o [BH, Tq, D], updated in place; all f32
// and contiguous, q/k/v 16-byte aligned.  The signature of
// tpu_flash_block_update_bf16 with the sliding window after `causal`, as in
// the backward's entries.
extern "C" int tpu_flash_block_update_f32(const void* q, const void* k, const void* v, float* m,
                                          float* l, float* o, int bh, int tq, int tk, int d,
                                          int64_t q_off, int64_t k_off, int causal, int window,
                                          float scale, cudaStream_t stream) {
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
  p.window = band(causal, window);
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
  if (bf16) return backward_smem_bf16(d, kernel);
  return d <= 64 ? Wg<64>::kSmem : Wg<128>::kSmem;  // both f32 kernels
}
