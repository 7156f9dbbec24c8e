// The ring-remat training path's flash kernels for Hopper (sm_90a) on f32
// storage, on the tensor cores (`wgmma` fed by TMA):
//
//   tpu_flash_block_backward_f32  replaces `_flash_block_bwd_kernel` /
//       `flash_block_backward` (tpu_operator/workloads/ring_attention.py:
//       577-683): the FlashAttention-2 backward of one ring hop (kernel B4),
//       adding this hop's dq, dk, dv into the travelling f32 accumulators in
//       place (the bf16 entry is in flash_attention.cu).
//   tpu_flash_block_update_f32  is kernel B3 (`_flash_block_kernel` /
//       `flash_block_update`, ring_attention.py:118-218) on f32 q, k, v:
//       the remat forward of the transformer step, whose weights, and so
//       q, k, v, are f32 (the bf16 entry is in flash_attention.cu).
//
// Numerics are the reference's.  Scores s = dot_f32(q, k) * scale, masked
// scores are out (causal on global positions q_off + row >= k_off + col;
// with a sliding window W also q_off + row - k_off - col < W), and the guard
// s <= NEG_INF / 2 -> 0 with NEG_INF = -1e30.
//   Backward: P = exp(s - lse) from the forward's saved lse; dV += P^T dO;
//   dP = dO V^T; dS = P (dP - D) with D = rowsum(dO O) given; dQ += dS K
//   scale; dK += dS^T Q scale.  In f32 nothing is rounded.
//   Forward fold: m' = max(m, rowmax s), corr = exp(m - m'), e = exp(s -
//   m'), l' = l corr + rowsum e, o' = o corr + e V, all f32.  exp is
//   exp2f(x log2 e) (`exp_f32`), in B4's kernels its MUFU form with
//   subnormal results flushed to zero.
//
// Products.  Every product runs as 3xTF32: each operand x is split into hi
// = rna(x) and lo = rna(x - hi), rna being cvt.rna.tf32.f32's rounding
// (`tf32` below), and a b accumulates as a_lo b_hi + a_hi b_lo, then a_hi
// b_hi, in f32, one k step of 8 at a time (PyTorch's f32 SDPA backward does
// the same, as CUTLASS's OpMultiplyAddFastF32).  A single TF32 pass keeps 10
// mantissa bits and misses the f32 limit 1e-4 of max |plain| by 5-12 x; the
// split stays within 1.4 x of a plain f32 product
// (tests/test_torch_tf32_split.py emulates both).  No product runs as one
// TF32 pass, and no hi part is a raw f32 left for the tensor cores to
// truncate.  The tensor cores' f32 accumulation truncates, so a long sum of
// small terms drifts low: B4's dk and dv, whose causal rows at T 32768 sum
// 32768 terms that shrink along the walk, land 2e-4 of max |plain| off when
// one accumulator takes the whole walk.  B4 adds its accumulators into
// dq/dk/dv every 32 walked tiles (`flush`), which bounds the drift at any
// T.  B3's fold keeps one accumulator for its whole walk: its o / l is a
// weighted mean, and at T 32768 it lands 4e-6 of max |plain| off
// (`chip_smoke.py`'s long hop).
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
// Kernels (`dkdv_f32`, `dq_f32`): three warpgroups, 384 threads.  A producer
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
// Measured on an H100 SXM at 700 W: the train hop 6.0 ms (the warp-level
// kernels it replaced: 10.8), 0.35 of its 3xTF32 bound; the long-context
// hop 365 ms, 0.37, of which the flushes take ~19 ms.  A dk/dv step of the
// heaviest block (clock64 stamps) takes ~5,300 cycles: ~3,400 in the
// products, ~1,300 in the score work between them (exp or dS, B's stores,
// the fence, the barriers) while the tensor cores wait, the rest in
// hand-offs; the ~550 KB of shared memory a step moves bound it next.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 128;  // query rows of a fold block: two consumers of 64
// the window of a causal hop with no band: larger than any distance between
// a query and a key (tiles' offsets are clamped to kFar), so that 0 <=
// query - key < kNoWindow is the causal test alone
constexpr int kNoWindow = 1 << 30;
constexpr int kFar = 1 << 28;
constexpr int64_t kMaxWindow = 1 << 27;  // a window at least this long is none

struct BwdParams {
  const float* q;     // [BH, Tq, D]
  const float* k;     // [BH, Tk, D]
  const float* v;     // [BH, Tk, D]
  const float* dout;  // [BH, Tq, D]
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
// 3xTF32 splits and exp

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

// d[64 x 128] += A[64 x 8] B[8 x 128]: A tf32 in registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
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
// in the shared space.  rows_issue commits the product as one group and
// returns while it runs; rows_product waits for it.
template <int DP>
__device__ __forceinline__ void rows_issue(float (&c)[16], const uint32_t (&x_hi)[DP / 8][4],
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
}

template <int DP>
__device__ __forceinline__ void rows_product(float (&c)[16], const uint32_t (&x_hi)[DP / 8][4],
                                             uint32_t x_lo, uint32_t w_hi, uint32_t w_lo) {
  rows_issue<DP>(c, x_hi, x_lo, w_hi, w_lo);
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
__device__ __forceinline__ void dkdv_f32(const Maps& maps, const BwdParams& p,
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
__device__ __forceinline__ void dq_f32(const Maps& maps, const BwdParams& p,
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
// kernel B4's two kernels.  The benchmark finds B4 f32 in a device trace by
// their demangled names, `dkdv_kernel<float` and `dq_kernel<float`
// (benchmark/readings.py, held to this file by
// tests/test_torch_flash_backward.py): hence a storage-type parameter that
// only float takes.

template <typename T, int DP>
__global__ void __launch_bounds__(kConsumers + 128, 1)
    dkdv_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  static_assert(std::is_same<T, float>::value, "B4 here is f32; bf16 is in flash_attention.cu");
  extern __shared__ __align__(128) unsigned char smem[];
  dkdv_f32<DP, false>(maps, p, smem);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kConsumers + 128, 1)
    dq_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  static_assert(std::is_same<T, float>::value, "B4 here is f32; bf16 is in flash_attention.cu");
  extern __shared__ __align__(128) unsigned char smem[];
  dq_f32<DP, false>(maps, p, smem);
}

// B4 f32 with a sliding window: kernels of their own, so that the causal
// kernels above stay as they were (the benchmark reads these names too).
template <int DP>
__global__ void __launch_bounds__(kConsumers + 128, 1)
    dkdv_band_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkdv_f32<DP, true>(maps, p, smem);
}

template <int DP>
__global__ void __launch_bounds__(kConsumers + 128, 1)
    dq_band_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_f32<DP, true>(maps, p, smem);
}

// ---------------------------------------------------------------------------
// kernel B3 on f32: wgmma fed by TMA
//
// Replaces `_flash_block_kernel` (tpu_operator/workloads/ring_attention.py:
// 118-218) on f32 q, k, v.  Bound by its operations: 4 D FLOP per kept pair
// in three TF32 passes, 0.834 ms at the train hop (128, 2048, 128) and 53.4
// ms at the long-context hop (32, 32768, 128), against 0.2 ms and 0.8 ms for
// its bytes.
//
// Design (`fold_f32`): one block per (bh, 128-row q tile), three
// warpgroups.  A producer (setmaxnreg 40) loads the tile's rows of Q once
// and every walked tile of 32 keys of K and V by TMA, splits K once for
// both consumers (hi in place, lo beside) and writes V's hi and lo parts
// transposed (`transpose_v`): tf32 wgmma reads B only K-major, so o += e V
// needs V with its keys contiguous, and the producer puts them in the order
// in which S's accumulator is the A fragment of e, so e never leaves the
// registers.  Two consumers (setmaxnreg 232) each own 64 rows: S = Q K^T as
// m64n32k8 with Q's hi parts in registers and its lo parts in place (B4's
// `rows_issue`), the online softmax in registers, o += e V as m64nDk8 with e
// in registers; each issues S_i and the tile before's e V together and runs
// the softmax of S_i while that e V does.  K and V^T have rings of two stages
// each, released apart: K once S is done, V^T once e V is.
// Shared memory at D 128: Q 64 KB, the K ring 64 KB, the V^T ring 64 KB, V
// as landed 32 KB, barriers: 230,504 bytes of 232,448 (D 64: half).  Walked
// tiles of 64 keys in two stages would need 352 KB.  Registers: a consumer
// thread holds o (64 at D 128), Q's hi parts (64), a score tile (16) and
// e's A fragments (32), under its 232, with no spills.
// The consumers are not made to take turns on the tensor cores: a turn
// barrier around each one's products (FA3's ping-pong) changed nothing at
// the train hop and cost 2 % at the long hop and 16 % at the windowed one.
// Measured on an H100 SXM at 700 W: the train hop 1.51 ms (the warp-level
// fold it replaced: 3.02 in the same call), 0.55 of its bound; the long hop
// 85.0 ms (172.1), 0.63; the windowed hop (256, 4096, 128), W 128, 1.71 ms
// (2.57).  A consumer's step of the heaviest block (clock64 stamps) takes
// ~4,400 cycles: ~2,000-2,600 issuing S and e V and waiting for S, ~1,400-
// 1,800 in the softmax while e V runs, ~300 waiting for the producer, ~200
// waiting for e V and splitting e.  The producer is busy ~4,300 cycles a
// tile (K's split ~1,800, V's transpose ~2,400): the two sides are matched,
// and a faster fold needs both less split work a key and larger S products.

// Shared memory of the fold, in bytes from a 1024-aligned base: the two
// consumers' fixed tiles of 64 query rows (Q as TMA landed it, then its lo
// parts in place); two stages of the walked K tile (hi parts in place, lo
// parts beside); two of V^T's parts, DP rows of 32 keys each (`transpose_v`);
// two of V as TMA landed it; the barriers.
template <int DP>
struct Fold {
  static constexpr int kQBytes = Wg<DP>::kFixedBytes;  // one consumer's rows
  static constexpr int kTile = Wg<DP>::kWalkBytes;     // 32 rows of DP, or DP rows of 32
  static constexpr int kQ = 0;                         // [consumer]
  static constexpr int kK = 2 * kQBytes;               // [stage][hi, lo]
  static constexpr int kVt = kK + 4 * kTile;           // [stage][hi, lo]
  static constexpr int kV = kVt + 4 * kTile;           // [stage]
  static constexpr int kBars = kV + 2 * kTile;
  // fixed, then [stage] each of: K landed, V landed, K split, V^T split, K
  // done with, V^T done with; + slack to align the base
  static constexpr int kSmem = kBars + 13 * 8 + 1024;
};

// the fold's barriers, offsets from Fold::kBars, [stage st]
constexpr uint32_t kFixedBar = 0;
__device__ __forceinline__ uint32_t k_full(int st) { return 8 + 8 * st; }
__device__ __forceinline__ uint32_t v_full(int st) { return 24 + 8 * st; }
__device__ __forceinline__ uint32_t k_ready(int st) { return 40 + 8 * st; }
__device__ __forceinline__ uint32_t v_ready(int st) { return 56 + 8 * st; }
__device__ __forceinline__ uint32_t k_empty(int st) { return 72 + 8 * st; }
__device__ __forceinline__ uint32_t v_empty(int st) { return 88 + 8 * st; }

// V's landed tile (32 keys of DP columns in TMA's boxes) as the B operand of
// O += e V: V^T, DP rows of 32 keys, K-major with the 128-byte swizzle, hi
// and lo parts.  tf32 wgmma reads B only K-major, and e is the A operand
// straight from S's accumulator, whose thread (g, t) holds keys 2t and 2t +
// 1 of each 8 where the A fragment wants k indices t and t + 4: so key 8j +
// 2a + b sits at position 8j + a + 4b of its row, and the accumulator is
// the fragment as it stands.  Thread pt reads the 16-byte chunks of key pt %
// 32 and writes each element to its own row: a warp's 8-lane phases read 8
// distinct chunks, and its 32 lanes write the 32 banks of one row.
template <int DP>
__device__ __forceinline__ void transpose_v(const unsigned char* v, unsigned char* hi,
                                            unsigned char* lo, int pt) {
  const int key = pt % 32;
  const int at = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
#pragma unroll 2
  for (int c4 = pt / 32; c4 < DP / 4; c4 += 4) {
    const float4 x = *reinterpret_cast<const float4*>(v + sw(kWalkRows, key, 4 * c4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t to = sw(DP, 4 * c4 + e, at);
      uint32_t h, l;
      split(xs[e], h, l);
      *reinterpret_cast<uint32_t*>(hi + to) = h;
      *reinterpret_cast<uint32_t*>(lo + to) = l;
    }
  }
}

// The walked K tile split once for both consumers: hi parts in place, lo
// parts at the same offsets in `lo`.
template <int DP>
__device__ __forceinline__ void split_k(unsigned char* k, unsigned char* lo, int pt) {
  constexpr int kChunks = Fold<DP>::kTile / 16;
  static_assert(kChunks % 128 == 0, "whole chunks a thread");
#pragma unroll 2
  for (int n = 0; n < kChunks / 128; ++n) {
    const int i = pt + n * 128;
    const float4 x = reinterpret_cast<const float4*>(k)[i];
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(k)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// The producer warpgroup of the fold (threads kConsumers on).  Its elected
// thread loads the two consumers' query rows (q0 on, head bh) and walked
// tile 0 by TMA.  Then, for walked tile i (keys 32 (first + i) on), all 128
// threads split K once it lands and mark it ready; the elected thread loads
// tile i + 1 once the consumers are done with tile i - 1's K; all transpose
// and split V once it lands and the consumers are done with tile i - 2's
// V^T, and mark V^T ready.  A consumer folds tile i's e V while it scores
// tile i + 1, so K is wanted a tile before V^T.  The producer gives up its
// registers to the consumers.
template <int DP>
__device__ __forceinline__ void fold_produce(unsigned char* s, uint32_t s32, const Maps& maps,
                                             int q0, int first, int n, int bh) {
  using L = Fold<DP>;
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
  const int pt = threadIdx.x - kConsumers;
  const uint32_t bars = s32 + L::kBars;
  auto load = [&](int i) {
    const int st = i & 1;
    const int row0 = (first + i) * kWalkRows;
    mbar_expect_tx(bars + k_full(st), L::kTile);
    load_tile<DP, kWalkRows>(s32 + L::kK + st * 2 * L::kTile, &maps.k, bars + k_full(st), row0,
                             bh);
    mbar_expect_tx(bars + v_full(st), L::kTile);
    load_tile<DP, kWalkRows>(s32 + L::kV + st * L::kTile, &maps.v, bars + v_full(st), row0, bh);
  };
  if (pt == 0) {
    mbar_expect_tx(bars + kFixedBar, 2 * L::kQBytes);
    load_tile<DP, kFixedRows>(s32 + L::kQ, &maps.q, bars + kFixedBar, q0, bh);
    load_tile<DP, kFixedRows>(s32 + L::kQ + L::kQBytes, &maps.q, bars + kFixedBar,
                              q0 + kFixedRows, bh);
    load(0);
  }
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    unsigned char* k = s + L::kK + st * 2 * L::kTile;
    mbar_wait(bars + k_full(st), ph);
    split_k<DP>(k, k + L::kTile, pt);
    fence_async();
    mbar_arrive(bars + k_ready(st));
    if (pt == 0 && i + 1 < n) {
      // stage st ^ 1: V's landed tile is free (the bar below), K once the
      // consumers are done with tile i - 1
      if (i >= 1) mbar_wait(bars + k_empty(st ^ 1), ((i - 1) >> 1) & 1);
      load(i + 1);
    }
    if (i >= 2) mbar_wait(bars + v_empty(st), ((i >> 1) - 1) & 1);  // tile i - 2's V^T
    mbar_wait(bars + v_full(st), ph);
    unsigned char* vt = s + L::kVt + st * 2 * L::kTile;
    transpose_v<DP>(s + L::kV + st * L::kTile, vt, vt + L::kTile, pt);
    fence_async();
    mbar_arrive(bars + v_ready(st));
    bar_sync(5, 128);  // every producer thread is done with V's landed tile
  }
}

// o[64 x DP] *= corr by row, unless corr is exactly 1 for every row of the
// warp (once the row maxima settle)
template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], const float (&corr)[2]) {
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  }
}

// o[64 x DP] += e V over one walked tile in 3xTF32: e in registers as the A
// fragments of its four k steps (hi and lo parts), V^T's parts at vt and vt
// + kTile.  Committed as one group; returns while it runs.
template <int DP>
__device__ __forceinline__ void pv_issue(float (&o)[DP / 2], const uint32_t (&e_hi)[4][4],
                                         const uint32_t (&e_lo)[4][4], uint32_t vt) {
  const uint64_t b_hi = desc_sw128(vt, 16);
  const uint64_t b_lo = desc_sw128(vt + Fold<DP>::kTile, 16);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (DP == 128) {
      wgmma_n128(o, e_lo[j], b_hi + 2 * j);
      wgmma_n128(o, e_hi[j], b_lo + 2 * j);
      wgmma_n128(o, e_hi[j], b_hi + 2 * j);
    } else {
      wgmma_n64(o, e_lo[j], b_hi + 2 * j);
      wgmma_n64(o, e_hi[j], b_lo + 2 * j);
      wgmma_n64(o, e_hi[j], b_hi + 2 * j);
    }
  }
  wgmma_commit();
}

// One block per (bh, 128-row q tile) folds every 32-key tile its rows see
// into their (m, l, o) state, held in registers, and writes the state back
// once; warpgroups 0 and 1 each own 64 of the rows, warpgroup 2 produces.
// A tile past the causal diagonal, or before the band of a sliding window,
// is never loaded.
//
// A consumer's step over walked tile i: issue S_i = Q K_i^T, then o = o
// corr + e V_{i-1}, the tile before's; wait for S_i and release K_i; the
// online softmax of S_i in registers (m', corr, e, l) while that e V runs on
// the tensor cores; wait for it and release V_{i-1}; split e into the A
// fragments of the next step's e V.  Per tile the state updates in the
// reference's order, o corr, then += e V, and each k step of a product runs
// lo hi, hi lo, then hi hi.  Both consumers walk every tile of the block,
// one whose rows see none of its keys included (the mask makes its update
// an exact no-op: m' = m, corr = 1, e = 0): a product issued in a branch
// that depends on the warpgroup stays in flight past the branch, and ptxas
// then orders every wgmma of the kernel after the one before (C7518), which
// made the fold 1.4 x slower at the train hop.
template <int DP, bool kBand>
__device__ __forceinline__ void fold_f32(const Maps& maps, const FoldParams& p,
                                         unsigned char* raw) {
  using L = Fold<DP>;
  // the causal q tiles see more keys the later they are: last tiles first
  const int bh = blockIdx.x;
  const int q_tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kRows;
  int n_k = (p.tk + kWalkRows - 1) / kWalkRows;
  int first = 0;
  if (p.causal) {
    const int last_row = min(q0 + kRows, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kWalkRows + 1;
    if (need < n_k) n_k = (int)need;
    if constexpr (kBand) {
      // the first key the block's first row sees in its band
      const int64_t first_key = p.q_off + q0 - p.window + 1 - p.k_off;
      if (first_key > 0) first = first_key / kWalkRows < n_k ? (int)(first_key / kWalkRows) : n_k;
    }
  }
  if (first >= n_k) return;  // a fully masked block: the state stays as it is
  const int n = n_k - first;

  const uint32_t raw32 = smem_u32(raw);
  const uint32_t s32 = (raw32 + 1023u) & ~1023u;
  unsigned char* s = raw + (s32 - raw32);
  const uint32_t bars = s32 + L::kBars;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bars + 8 * i, 1);            // TMA's bytes
    for (int i = 5; i < 9; ++i) mbar_init(bars + 8 * i, 128);          // the producer
    for (int i = 9; i < 13; ++i) mbar_init(bars + 8 * i, kConsumers);  // the consumers
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    fold_produce<DP>(s, s32, maps, q0, first, n, bh);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int l = threadIdx.x % 128;
  const int g = (l % 32) / 4, t4 = l % 4;
  const int r0 = q0 + wg * kFixedRows;         // this consumer's first row
  const int row = r0 + 16 * (l / 32) + g;      // this thread's rows: row, row + 8
  const int64_t qbase = (int64_t)bh * p.tq;

  // the carried state of this thread's rows, o in the accumulator's layout
  float m[2], lsum[2], o[DP / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < p.tq;
    const int64_t at = qbase + row + 8 * h;
    m[h] = ok ? p.m[at] : kNegInf;
    lsum[h] = ok ? p.l[at] : 0.f;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      float2 x = make_float2(0.f, 0.f);
      if (ok && c < p.d) x = *reinterpret_cast<const float2*>(p.o + at * p.d + c);
      o[4 * j + 2 * h] = x.x;
      o[4 * j + 2 * h + 1] = x.y;
    }
  }

  // this consumer's rows of Q: lo parts in place, hi parts in registers
  const uint32_t q_at = s32 + L::kQ + wg * L::kQBytes;
  uint32_t q_hi[DP / 8][4];
  mbar_wait(bars + kFixedBar, 0);
  split_fixed<DP>(s + L::kQ + wg * L::kQBytes, q_hi);
  fence_async();
  bar_sync(1 + wg, 128);
  const int64_t r_first = p.q_off + r0;  // position of this consumer's first row
  uint32_t e_hi[4][4], e_lo[4][4];
  float corr[2] = {1.f, 1.f};
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    const int kt0 = (first + i) * kWalkRows;
    const int64_t k_first = p.k_off + kt0;
    mbar_wait(bars + k_ready(st), (i >> 1) & 1);
    if (i > 0) mbar_wait(bars + v_ready(st ^ 1), ((i - 1) >> 1) & 1);
    float c[16];
    const uint32_t k = s32 + L::kK + st * 2 * L::kTile;
    rows_issue<DP>(c, q_hi, q_at, k, k + L::kTile);  // S = Q K^T
    if (i > 0) {
      rescale<DP>(o, corr);
      pv_issue<DP>(o, e_hi, e_lo, s32 + L::kVt + (st ^ 1) * 2 * L::kTile);  // o += e V
      wgmma_wait1();
    } else {
      wgmma_wait0();
    }
    fence_regs(c);
    mbar_arrive(bars + k_empty(st));
    // every (row, key) pair live: no mask to evaluate
    const bool full = kt0 + kWalkRows <= p.tk &&
                      (!p.causal || (r_first >= k_first + kWalkRows - 1 &&
                                     (!kBand || r_first + kFixedRows - 1 - k_first < p.window)));
    const int diag = tile_diag(p.causal, r_first, k_first);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // element 4j + e: row 16w + g + 8 (e / 2), key 8j + 2t + e % 2 of the tile
        bool live = true;
        if (!full) {
          const int a = 16 * (l / 32) + g + 8 * (e >> 1);
          const int b = 8 * j + 2 * t4 + (e & 1);
          const bool out =
              kBand ? (unsigned)(a - b + diag) >= (unsigned)p.window : a - b + diag < 0;
          live = b < p.tk - kt0 && !out;
        }
        c[4 * j + e] = live ? c[4 * j + e] * p.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], c[4 * j + e]);
      }
    }
    float m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a row's keys sit in the four lanes of one quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
      corr[h] = exp_f32(m[h] - m_new[h]);
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = c[4 * j + e];
        const float ex = x <= kNegInf * 0.5f ? 0.f : exp_f32(x - m_new[e >> 1]);  // masked guard
        c[4 * j + e] = ex;
        sum[e >> 1] += ex;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      lsum[h] = lsum[h] * corr[h] + sum[h];
      m[h] = m_new[h];
    }
    if (i > 0) {
      wgmma_wait0();  // e V of tile i - 1
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fence_regs(e_hi[j]);
        fence_regs(e_lo[j]);
      }
      mbar_arrive(bars + v_empty(st ^ 1));
    }
    // e as the A fragments of its four k steps: k index t is key 8j + 2t,
    // t + 4 key 8j + 2t + 1 (transpose_v puts V's rows in that order)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split(c[4 * j], e_hi[j][0], e_lo[j][0]);
      split(c[4 * j + 2], e_hi[j][1], e_lo[j][1]);
      split(c[4 * j + 1], e_hi[j][2], e_lo[j][2]);
      split(c[4 * j + 3], e_hi[j][3], e_lo[j][3]);
    }
  }
  {
    const int st = (n - 1) & 1;
    mbar_wait(bars + v_ready(st), ((n - 1) >> 1) & 1);
    rescale<DP>(o, corr);
    pv_issue<DP>(o, e_hi, e_lo, s32 + L::kVt + st * 2 * L::kTile);
    wgmma_wait0();
    fence_regs(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = row + 8 * h;
    if (rr >= p.tq) continue;
    const int64_t at = qbase + rr;
    if (t4 == 0) {
      p.m[at] = m[h];
      p.l[at] = lsum[h];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (c < p.d) {
        *reinterpret_cast<float2*>(p.o + at * p.d + c) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kConsumers + 128, 1)
    fold_f32_kernel(const __grid_constant__ Maps maps, const FoldParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  fold_f32<DP, false>(maps, p, smem);
}

// the fold with a sliding window, a kernel of its own as B4's
template <int DP>
__global__ void __launch_bounds__(kConsumers + 128, 1)
    fold_band_kernel(const __grid_constant__ Maps maps, const FoldParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  fold_f32<DP, true>(maps, p, smem);
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
int launch_backward_f32(const Maps& maps, const BwdParams& p, cudaStream_t stream) {
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

template <int DP>
int launch_fold(const Maps& maps, const FoldParams& p, cudaStream_t stream) {
  constexpr int kSmem = Fold<DP>::kSmem;
  static_assert(kSmem <= 232448, "a block's shared memory");
  const dim3 grid(p.bh, tiles(p.tq, kRows));
  if (p.window != kNoWindow) {
    const int err = set_smem(fold_band_kernel<DP>, kSmem);
    if (err != 0) return err;
    fold_band_kernel<DP><<<grid, kConsumers + 128, kSmem, stream>>>(maps, p);
    return (int)cudaGetLastError();
  }
  const int err = set_smem(fold_f32_kernel<DP>, kSmem);
  if (err != 0) return err;
  fold_f32_kernel<DP><<<grid, kConsumers + 128, kSmem, stream>>>(maps, p);
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

// 999 when the driver has no cuTensorMapEncodeTiled, 1000 + the CUresult
// when a map cannot be encoded
int backward(const BwdParams& p, cudaStream_t stream) {
  if (bad_shape(p.bh, p.tq, p.tk, p.d)) return (int)cudaErrorInvalidValue;
  if (misaligned(p.q, 16) || misaligned(p.k, 16) || misaligned(p.v, 16) ||
      misaligned(p.dout, 16) || misaligned(p.lse, 4) || misaligned(p.dsum, 4) ||
      misaligned(p.dq, 8) || misaligned(p.dk, 8) || misaligned(p.dv, 8)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (p.bh == 0 || p.tq == 0 || p.tk == 0) return (int)cudaSuccess;
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

}  // namespace

// One ring hop's backward: adds this hop's dq [BH, Tq, D], dk and dv [BH,
// Tk, D] (in place) from q, dout [BH, Tq, D] and k, v [BH, Tk, D], lse and
// dsum [BH, Tq]; all f32 and contiguous; D a multiple of 8 up to 128;
// q/k/v/dout 16-byte aligned.  `window` > 0 on a causal hop keeps only keys
// within window - 1 positions before a query (0 for none).  Two kernels on
// `stream`, no synchronize; returns the first failing launch's cudaError_t
// (0 on success).
extern "C" int tpu_flash_block_backward_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* dsum, float* dq, float* dk, float* dv,
                                            int bh, int tq, int tk, int d, int64_t q_off,
                                            int64_t k_off, int causal, int window, float scale,
                                            cudaStream_t stream) {
  BwdParams p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
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

// Kernel B3 on f32: folds k, v [BH, Tk, D] into the online-softmax state of
// q [BH, Tq, D]: m, l [BH, Tq] and o [BH, Tq, D], updated in place; all f32
// and contiguous, q/k/v 16-byte aligned.  The signature of
// tpu_flash_block_update_bf16 with the sliding window after `causal`, as in
// the backward's entry.
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
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  Maps maps{};
  CUtensorMap* out[3] = {&maps.q, &maps.k, &maps.v};
  const void* ptrs[3] = {q, k, v};
  const int ts[3] = {tq, tk, tk};
  for (int i = 0; i < 3; ++i) {
    const CUresult res = encode(fn, out[i], ptrs[i], bh, ts[i], d);
    if (res != CUDA_SUCCESS) return 1000 + (int)res;
  }
  if (d <= 64) return launch_fold<64>(maps, p, stream);
  return launch_fold<128>(maps, p, stream);
}

// Dynamic shared memory a block of each kernel takes at head dim d: kernel
// 0 the dk/dv kernel, 1 the dq kernel, 2 the fold.
extern "C" int tpu_flash_train_smem_bytes(int kernel, int d) {
  if (d <= 0 || d > 128) return -1;
  if (kernel == 2) return d <= 64 ? Fold<64>::kSmem : Fold<128>::kSmem;
  return d <= 64 ? Wg<64>::kSmem : Wg<128>::kSmem;  // both B4 kernels
}
