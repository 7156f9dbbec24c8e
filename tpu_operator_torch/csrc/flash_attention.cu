// Flash attention on bf16 tiles for Hopper (sm_90a): three entries over one
// shared online-softmax tile update.
//
//   tpu_flash_forward_bf16       replaces `_flash_full_kernel` /
//       `flash_attention_local` (tpu_operator/workloads/longctx.py:47-150):
//       the full forward, causal or not, returning out (bf16) and lse (f32).
//   tpu_flash_forward_split_bf16 the same function for short query tails
//       against long caches (the decode): a split over the keys.
//   tpu_flash_block_update_bf16  replaces `_flash_block_kernel` /
//       `flash_block_update` (tpu_operator/workloads/ring_attention.py:118-218):
//       folds one K/V block into the carried (m, l, o) state, in place,
//       in 16-row q tiles whose warps split the keys (the split update).
//
// Both TPU kernels run `online_softmax_block_update`
// (ring_attention.py:86-115); here that is `fold_tile`, and its numerics are
// the reference's:
//   s = dot_f32(q, k) * scale, scale = 1/sqrt(D) applied after the product;
//   masked scores are NEG_INF = -1e30 (never -inf), causal on global
//   positions q_off + row >= k_off + col;
//   m' = max(m, rowmax(s)), corr = exp(m - m'), e = exp(s - m'), and e = 0
//   where s <= NEG_INF / 2 (the fully-masked guard); the fold takes exp(y)
//   as exp2(y * log2(e)), one special-function op, where the accurate expf
//   took twice as long on the card (exp(0) stays exactly 1);
//   l' = l * corr + rowsum(e) in f32, acc' = acc * corr + bf16(e) @ v in f32.
// The forward finishes with out = acc / (l > 0 ? l : 1) rounded to bf16 and
// lse = m + log(l > 0 ? l : 1).  A fully masked row gives out 0 and lse
// NEG_INF.  The kernel walks its own 64-key tiles where the TPU kernel took
// whole `block_k` blocks, so e is rounded against a different running max
// and sums run in another order: out agrees to bf16 rounding, m exactly,
// l and lse to f32 rounding.
//
// Bound, on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   prefill (BH 8, T 32768, D 128, causal): 4 * BH * D * T(T+1)/2 = 2.2e12
//     FLOP, 2.22 ms; its 268 MB of q/k/v/out/lse take 0.08 ms: operations;
//   decode (8 query rows at the end of a 32768-key cache): the K/V cache,
//     2 * 8 * 32768 * 128 * 2 B = 134 MB, 40.1 us: bytes;
//   ring hop (BH 4, T 512, D 128, causal): 3.7 MB of q/k/v and f32 state,
//     about 1.1 us: bytes.  A walk of 64-row q tiles takes latency there: 32
//     blocks of 4 warps for 132 SMs, each a serial chain of 8 tile folds,
//     one warp per scheduler, nothing to hide a copy or an mma chain behind;
//     hence the split update below.
//
// Design.  One thread block of 4 warps per (bh, 64-row q-tile); each warp
// owns 16 query rows.  A loop inside the block walks 64-key K/V tiles, which
// takes the place of the TPU grid's sequential k axis and its VMEM scratch;
// the (m, l, acc) state stays in registers in f32 for the whole walk and
// out is written once.  K/V tiles are staged in shared memory through a
// two-stage cp.async ring (the next tile loads while this one computes),
// with zero fill for keys past Tk and head dims past D, so the kernel masks
// the ragged edge itself and takes any T (40 and 136 at D 8 and 16, the
// serving page shapes, as well as 32768).  Products are `mma.sync`
// m16n8k16 bf16 -> f32: Q fragments sit in registers for the whole walk,
// K fragments are read from shared memory row-major, V fragments through
// `ldmatrix.trans`, and the score fragment is rounded to bf16 in registers
// to become the A operand of P @ V.  D is padded to a multiple of 16 (one
// template instance each for 16, 32, 64 and 128).  The causal forward stops
// at the last tile that holds a key at or before the q-tile's last query
// (the TPU kernel's block skip; a fully masked tile is a no-op of the
// update) and launches the heaviest q-tiles first.  The prefill at D 64 and
// 128 runs on the wgmma kernel of csrc/flash_forward_sm90.cu instead.
//
// The split (decode: 8 rows against 32768 keys, BH 8).  The forward's grid
// would be BH blocks for 132 SMs, each streaming its 16.8 MB of K/V alone
// with one warp of four live; the decode is bound by its 134 MB of K/V
// (40.1 us at 3.35 TB/s).  Pass 1 (flash_split_kernel) runs one block per
// (split, 16-row q tile, bh): the live 64-key tiles are cut into n_splits
// contiguous ranges, and each of the block's four warps folds its own
// quarter of its split's range from a fresh state, through its own
// one-tile cp.async stage (warp-scope waits only; 139 KB a block at D 128,
// so a second stage per warp would not fit), with the q tile's 16 rows in
// every warp.  K and V are staged as two copy groups and the fold runs in
// two halves, fold_scores on K and fold_values on V: the next tile's K
// loads while this tile's values fold, and its V while its scores do.  The
// block merges the four warps' states in shared memory, each state's
// weight computed once per row, and writes one unnormalized partial (m, l,
// acc[D]) per row to f32 scratch that the caller allocates.  Pass 2
// (flash_split_combine), one block per (row, bh): m* = max m_s, l* = sum
// l_s exp(m_s - m*), out = bf16(sum acc_s exp(m_s - m*) / (l* > 0 ? l* :
// 1)), lse = m* + log(same).  A split or warp that sees no key leaves
// (NEG_INF, 0, 0), whose weight in the merge is exp(NEG_INF - m*) = 0, or
// which adds only zeros when m* is NEG_INF too: a row masked everywhere
// gives out 0 and lse NEG_INF.  A second launch rather than a last-block
// ticket: it keeps pass 1 free of atomics and fences, and the combine reads
// 1 MB of partials at the decode shape, a few microseconds.
//
// The split update (the ring hop: BH 4, 512 rows, 8 key tiles).  The same
// kernel with one split and the carried state as a fifth state in the
// merge: one block per (16-row q tile, bh), 128 blocks, one wave on 132
// SMs.  Each q tile folds only its live tiles, those holding a key at or
// before its last row's position when causal: a fully masked tile is an
// exact no-op of the sequential update (corr = exp(0) = 1, e = 0), so
// skipping it changes nothing beyond the merge's f32 order.  A warp folds
// at most 2 tiles there instead of 8.  The carried (m, l, o) of the 16 rows
// is copied into shared memory past the tiles at the start, a copy group of
// its own in flight while the warps fold (held in registers, o would be
// loaded late or cost registers the fold needs).  The merge puts (m, l)
// beside the warps' states, computes m* = max(m_c, m_w), the weights
// exp(m_s - m*) once per row, l* = l_c exp(m_c - m*) + sum l_w exp(m_w -
// m*) and o* likewise, in a fixed order (carried, then warps 0-3: two
// launches on the same inputs give the same bits), and writes them back in
// place.  A q tile with no live tile returns before it reads or writes the
// state, so a fully masked hop leaves it bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per thread block
constexpr int kBlockK = 64;           // keys per K/V tile
constexpr int kStages = 2;

struct Params {
  const __nv_bfloat16* q;  // [BH, Tq, D]
  const __nv_bfloat16* k;  // [BH, Tk, D]
  const __nv_bfloat16* v;  // [BH, Tk, D]
  __nv_bfloat16* out;      // [BH, Tq, D]  forward only
  float* lse;              // [BH, Tq]     forward only
  float* m;                // [BH, Tq]     block update only, in place
  float* l;                // [BH, Tq]     block update only, in place
  float* o;                // [BH, Tq, D]  block update only, in place
  int bh, tq, tk, d;
  int64_t q_off, k_off;
  int causal;
  float scale;
};

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared; zero fill when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared, through L1; zero fill when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// Stage keys [k0, k0 + kBlockK) of K and V into one shared-memory stage.
template <int DP>
__device__ __forceinline__ void load_tile(const Params& p, int bh, int k0,
                                          __nv_bfloat16* ks, __nv_bfloat16* vs) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  constexpr int kStride = DP + 8;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int key = k0 + r;
    const bool ok = key < p.tk && c * 8 < p.d;
    const int64_t off = ok ? ((int64_t)bh * p.tk + key) * p.d + c * 8 : 0;
    cp_async16(ks + r * kStride + c * 8, p.k + off, ok);
    cp_async16(vs + r * kStride + c * 8, p.v + off, ok);
  }
}

// The online-softmax update of one warp's 16 rows against one staged tile:
// `online_softmax_block_update` of the reference, in two halves so that a
// caller may stage K and V apart.  Row r0 = g, r1 = g + 8 of the warp's rows
// (g = lane / 4); each thread holds two score columns per 8-key n-tile, and
// the four threads of a quad share a row.
//
// fold_scores: the scores against the staged K tile, scaled after the f32
// product and masked, the running max and sum updated and acc rescaled; s
// holds e for fold_values.
template <int DP>
__device__ __forceinline__ void fold_scores(const Params& p, const uint32_t (&qa)[DP / 16][4],
                                            const __nv_bfloat16* ks, int k0, int64_t q_pos0,
                                            float (&m)[2], float (&l)[2],
                                            float (&acc)[DP / 8][4], float (&s)[kBlockK / 8][4]) {
  constexpr int kStride = DP + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;

#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * kStride + kk * 16 + t4 * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
      mma_bf16_16816(s[nt], qa[kk], b0, b1);
    }
  }

  // the mask on global positions, as a count per row: column c of the tile
  // is live iff k0 + c < Tk and (causal) q_pos >= k_off + k0 + c
  int vis[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int64_t n = p.tk - k0;
    if (p.causal) {
      const int64_t last = q_pos0 + g + 8 * r - p.k_off - k0 + 1;
      n = last < n ? last : n;
    }
    vis[r] = n < 0 ? 0 : (n > kBlockK ? kBlockK : (int)n);
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool live = nt * 8 + t4 * 2 + (i & 1) < vis[i >> 1];
      s[nt][i] = live ? s[nt][i] * p.scale : kNegInf;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
    }
  }
  float corr[2];
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
    corr[r] = exp2f((m[r] - m_new[r]) * kLog2e);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = s[nt][i];
      const float e = x <= kNegInf * 0.5f ? 0.f : exp2f((x - m_new[i >> 1]) * kLog2e);
      s[nt][i] = e;
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
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    acc[nd][0] *= corr[0];
    acc[nd][1] *= corr[0];
    acc[nd][2] *= corr[1];
    acc[nd][3] *= corr[1];
  }
}

// fold_values: acc += bf16(e) @ V of the staged V tile.  The score fragments
// of two adjacent n-tiles are the A fragment of one 16-key step, after
// rounding e to bf16 (v's dtype).
template <int DP>
__device__ __forceinline__ void fold_values(const float (&s)[kBlockK / 8][4],
                                            const __nv_bfloat16* vs, float (&acc)[DP / 8][4]) {
  constexpr int kStride = DP + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]),
        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
    };
    const __nv_bfloat16* vrow = vs + (kk * 16 + lane % 16) * kStride;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, vrow + nd * 8);
      mma_bf16_16816(acc[nd], pa, b0, b1);
    }
  }
}

template <int DP>
__device__ __forceinline__ void fold_tile(const Params& p, const uint32_t (&qa)[DP / 16][4],
                                          const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                          int k0, int64_t q_pos0, float (&m)[2], float (&l)[2],
                                          float (&acc)[DP / 8][4]) {
  float s[kBlockK / 8][4];
  fold_scores<DP>(p, qa, ks, k0, q_pos0, m, l, acc, s);
  fold_values<DP>(s, vs, acc);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr int kStride = DP + 8;
  constexpr int kTileElems = kBlockK * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_smem = k_smem + kStages * kTileElems;

  const int bh = blockIdx.y;
  // the causal forward's last q-tiles walk the most keys: start them first
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int q0 = q_tile * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wq0 = q0 + warp * 16;  // this warp's first row
  const int row[2] = {wq0 + g, wq0 + g + 8};
  const bool warp_live = wq0 < p.tq;

  // Q fragments for the whole walk (zero past Tq and past D)
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c0 = kk * 16 + t4 * 2;
    const int c1 = c0 + 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row[r] < p.tq;
      const __nv_bfloat16* qr = p.q + ((int64_t)bh * p.tq + (ok ? row[r] : 0)) * p.d;
      qa[kk][r] = load_pair(qr + c0, ok && c0 < p.d);
      qa[kk][r + 2] = load_pair(qr + c1, ok && c1 < p.d);
    }
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  int n_tiles = (p.tk + kBlockK - 1) / kBlockK;
  if (p.causal) {
    // the last key any row of this tile can see
    const int last_row = min(q0 + kBlockQ, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kBlockK + 1;
    if (need < n_tiles) n_tiles = (int)need;
  }

  if (n_tiles > 0) load_tile<DP>(p, bh, 0, k_smem, v_smem);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int s = (t + 1) % kStages;
      load_tile<DP>(p, bh, (t + 1) * kBlockK, k_smem + s * kTileElems, v_smem + s * kTileElems);
    }
    cp_async_commit();
    cp_async_wait_1();  // tile t has landed; only tile t + 1 may be in flight
    __syncthreads();
    if (warp_live) {
      const int s = t % kStages;
      fold_tile<DP>(p, qa, k_smem + s * kTileElems, v_smem + s * kTileElems, t * kBlockK,
                    p.q_off + wq0, m, l, acc);
    }
    __syncthreads();  // the stage is free for tile t + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.tq) continue;
    const int64_t i = (int64_t)bh * p.tq + row[r];
    const float denom = l[r] > 0.f ? l[r] : 1.f;
    if (t4 == 0) p.lse[i] = m[r] + logf(denom);
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int c = nd * 8 + t4 * 2;
      if (c < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(p.out + i * p.d + c) =
            __floats2bfloat162_rn(acc[nd][2 * r] / denom, acc[nd][2 * r + 1] / denom);
      }
    }
  }
}

template <int DP>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = kStages * 2 * kBlockK * (DP + 8) * (int)sizeof(__nv_bfloat16);
  auto kernel = flash_kernel<DP>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.tq + kBlockQ - 1) / kBlockQ, p.bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(const Params& p, cudaStream_t stream) {
  if (p.bh <= 0 || p.tq <= 0) return (int)cudaSuccess;
  if (p.d <= 0 || p.d > 128 || p.d % 8 != 0 || p.bh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.d <= 16) return launch<16>(p, stream);
  if (p.d <= 32) return launch<32>(p, stream);
  if (p.d <= 64) return launch<64>(p, stream);
  return launch<128>(p, stream);
}

// ---------------------------------------------------------------------------
// the split over the keys

constexpr int kSplitRows = 16;  // query rows per split block: one warp's m16 tile

// Stage keys [k0, k0 + kBlockK) of K or V (`src`), by one warp's lanes.
template <int DP>
__device__ __forceinline__ void load_tile_warp(const Params& p, const __nv_bfloat16* src, int bh,
                                               int k0, __nv_bfloat16* dst) {
  constexpr int kChunks = DP / 8;
  constexpr int kStride = DP + 8;
  for (int i = threadIdx.x % 32; i < kBlockK * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int key = k0 + r;
    const bool ok = key < p.tk && c * 8 < p.d;
    const int64_t off = ok ? ((int64_t)bh * p.tk + key) * p.d + c * 8 : 0;
    cp_async16(dst + r * kStride + c * 8, src + off, ok);
  }
}

// N = 2 or 4 consecutive floats, 8 or 16 bytes aligned, in one access
template <int N>
__device__ __forceinline__ void load_vec(const float* src, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    x[0] = v.x, x[1] = v.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  }
}

// 64-key tiles holding a key that rows [0, q_end) can see: all of them
// unless causal, else those at or before the last row's position.
__host__ __device__ __forceinline__ int live_tiles(int q_end, int tk, int64_t q_off,
                                                   int64_t k_off, int causal) {
  int64_t live = tk;
  if (causal) {
    const int64_t last = q_off + q_end - k_off;
    live = last < 0 ? 0 : (last < tk ? last : tk);
  }
  return (int)((live + kBlockK - 1) / kBlockK);
}

// Partials, f32: m [S, BH, Tq], then l [S, BH, Tq], then acc [S, BH, Tq, D].
// kUpdate: the split update instead, one split (gridDim.x 1), its own live
// tiles per q tile, the merged state written over the carried one (part and
// n_live unused).
template <int DP, bool kUpdate>
__global__ void __launch_bounds__(kThreads)
    flash_split_kernel(const Params p, float* part, int n_splits, int n_live) {
  constexpr int kStride = DP + 8;
  constexpr int kTileElems = kBlockK * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kSplitRows;
  const int bh = blockIdx.z;
  if (kUpdate) {
    n_live = live_tiles(min(q0 + kSplitRows, p.tq), p.tk, p.q_off, p.k_off, p.causal);
    if (n_live == 0) return;  // a q tile that sees no key: the state stays unread
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row[2] = {q0 + g, q0 + g + 8};
  // this warp's own K and V tile
  __nv_bfloat16* k_smem = reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * 2 * kTileElems;
  __nv_bfloat16* v_smem = k_smem + kTileElems;

  // the Q fragments first: a load queued behind the tile copies waits for them
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c0 = kk * 16 + t4 * 2;
    const int c1 = c0 + 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row[r] < p.tq;
      const __nv_bfloat16* qr = p.q + ((int64_t)bh * p.tq + (ok ? row[r] : 0)) * p.d;
      qa[kk][r] = load_pair(qr + c0, ok && c0 < p.d);
      qa[kk][r + 2] = load_pair(qr + c1, ok && c1 < p.d);
    }
  }

  // the update's carried (m, l, o) of the 16 rows: a copy group of its own,
  // in flight while the warps fold, into shared memory past the tiles (o
  // held in registers that long would be loaded late or cost registers)
  float* carried = reinterpret_cast<float*>(smem_raw + kWarps * 2 * kTileElems * 2);
  if (kUpdate) {
    const float* o_rows = p.o + ((int64_t)bh * p.tq + q0) * p.d;
    for (int i = threadIdx.x; i < kSplitRows * DP / 4; i += kThreads) {
      const int r = i / (DP / 4);
      const int c = i % (DP / 4) * 4;
      const bool ok = q0 + r < p.tq && c < p.d;
      cp_async16(carried + r * DP + c, ok ? o_rows + r * p.d + c : p.o, ok);
    }
    if (threadIdx.x < 2 * kSplitRows) {
      const int r = threadIdx.x % kSplitRows;
      const bool ok = q0 + r < p.tq;
      const float* src = threadIdx.x < kSplitRows ? p.m : p.l;
      cp_async4(carried + kSplitRows * DP + threadIdx.x,
                src + (ok ? (int64_t)bh * p.tq + q0 + r : 0), ok);
    }
  }
  cp_async_commit();

  // the split's tiles [lo, hi), then this warp's quarter of them; the first
  // tile's K and V go as two copy groups
  const int lo = (int)((int64_t)n_live * split / n_splits);
  const int hi = (int)((int64_t)n_live * (split + 1) / n_splits);
  const int w_lo = lo + (hi - lo) * warp / kWarps;
  const int n = lo + (hi - lo) * (warp + 1) / kWarps - w_lo;
  if (n > 0) load_tile_warp<DP>(p, p.k, bh, w_lo * kBlockK, k_smem);
  cp_async_commit();
  if (n > 0) load_tile_warp<DP>(p, p.v, bh, w_lo * kBlockK, v_smem);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  // per tile: the scores once its K has landed; then the next tile's K is
  // in flight while the values wait for this tile's V, and the next V while
  // the next scores run.  One group is committed at each step, empty past
  // the last tile, so waiting for all but the newest is always the right one
  for (int t = 0; t < n; ++t) {
    const int k0 = (w_lo + t) * kBlockK;
    float s[kBlockK / 8][4];
    cp_async_wait_1();
    __syncwarp();  // every lane's copies of K of tile t have landed
    fold_scores<DP>(p, qa, k_smem, k0, p.q_off + q0, m, l, acc, s);
    __syncwarp();  // the K stage is free
    if (t + 1 < n) load_tile_warp<DP>(p, p.k, bh, k0 + kBlockK, k_smem);
    cp_async_commit();
    cp_async_wait_1();
    __syncwarp();  // V of tile t has landed
    fold_values<DP>(s, v_smem, acc);
    __syncwarp();  // the V stage is free
    if (t + 1 < n) load_tile_warp<DP>(p, p.v, bh, k0 + kBlockK, v_smem);
    cp_async_commit();
  }

  // merge the four warps' states in shared memory (the tiles are done);
  // the update's carried (m, l) is state kWarps
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // the carried state too
  __syncthreads();
  constexpr int kStates = kWarps + 1;
  float* ms = reinterpret_cast<float*>(smem_raw);  // [state][row]
  float* ls = ms + kStates * kSplitRows;
  float* fs = ls + kStates * kSplitRows;            // [state][row]: exp(m_s - m*)
  float* accs = fs + kStates * kSplitRows;          // [warp][row][DP]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = warp * kSplitRows + g + 8 * r;
    if (t4 == 0) {
      ms[rr] = m[r];
      ls[rr] = l[r];
    }
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      *reinterpret_cast<float2*>(accs + rr * DP + nd * 8 + t4 * 2) =
          make_float2(acc[nd][2 * r], acc[nd][2 * r + 1]);
    }
  }
  if (kUpdate && threadIdx.x < kSplitRows) {
    ms[kWarps * kSplitRows + threadIdx.x] = carried[kSplitRows * DP + threadIdx.x];
    ls[kWarps * kSplitRows + threadIdx.x] = carried[kSplitRows * DP + kSplitRows + threadIdx.x];
  }
  __syncthreads();
  // per row, by threads 0-15: m*, each state's weight and l*, in a fixed
  // order (the carried state first)
  const int64_t rows = (int64_t)p.bh * p.tq;
  if (threadIdx.x < kSplitRows) {
    const int r = threadIdx.x;
    float mx = kUpdate ? ms[kWarps * kSplitRows + r] : kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * kSplitRows + r]);
    float lsum = 0.f;
    if (kUpdate) {
      const float f = exp2f((ms[kWarps * kSplitRows + r] - mx) * kLog2e);
      fs[kWarps * kSplitRows + r] = f;
      lsum = ls[kWarps * kSplitRows + r] * f;
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f((ms[w * kSplitRows + r] - mx) * kLog2e);
      fs[w * kSplitRows + r] = f;
      lsum += ls[w * kSplitRows + r] * f;
    }
    if (q0 + r < p.tq) {
      const int64_t row_i = (int64_t)bh * p.tq + q0 + r;
      if (kUpdate) {
        p.m[row_i] = mx;
        p.l[row_i] = lsum;
      } else {
        part[split * rows + row_i] = mx;
        part[(n_splits + split) * rows + row_i] = lsum;
      }
    }
  }
  __syncthreads();
  // the merge's share of the q tile's 16 x DP outputs: kVec consecutive
  // columns (a multiple of 8 divides D, so a vector is all in or all out),
  // kPer times, from element kVec * (threadIdx.x + j * kThreads)
  constexpr int kVec = DP / 8 < 4 ? DP / 8 : 4;
  constexpr int kPer = kSplitRows * DP / (kThreads * kVec);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = kVec * (threadIdx.x + j * kThreads) / DP;
    const int c = kVec * (threadIdx.x + j * kThreads) % DP;
    if (q0 + r >= p.tq || c >= p.d) continue;
    const int64_t row_i = (int64_t)bh * p.tq + q0 + r;
    float a[kVec];
    const float f_c = kUpdate ? fs[kWarps * kSplitRows + r] : 0.f;
    if (kUpdate) {
      load_vec(carried + r * DP + c, a);
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[e] *= f_c;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[e] = 0.f;
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = fs[w * kSplitRows + r];
      float x[kVec];
      load_vec(accs + (w * kSplitRows + r) * DP + c, x);
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[e] += x[e] * f;
    }
    store_vec(kUpdate ? p.o + row_i * p.d + c
                      : part + 2 * n_splits * rows + ((int64_t)split * rows + row_i) * p.d + c,
              a);
  }
}

__global__ void __launch_bounds__(128)
    flash_split_combine(const float* part, __nv_bfloat16* out, float* lse, int n_splits, int bh,
                        int tq, int d) {
  const int64_t rows = (int64_t)bh * tq;
  const int64_t idx = (int64_t)blockIdx.y * tq + blockIdx.x;
  const int c = threadIdx.x;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, part[s * rows + idx]);
  float lsum = 0.f;
  float a = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float f = expf(part[s * rows + idx] - mx);
    lsum += part[(n_splits + s) * rows + idx] * f;
    if (c < d) a += part[2 * n_splits * rows + (s * rows + idx) * d + c] * f;
  }
  const float denom = lsum > 0.f ? lsum : 1.f;
  if (c < d) out[idx * d + c] = __float2bfloat16_rn(a / denom);
  if (c == 0) lse[idx] = mx + logf(denom);
}

template <int DP, bool kUpdate>
int launch_split(const Params& p, float* part, int n_splits, int n_live, cudaStream_t stream) {
  // every warp's K and V tile, then the update's carried (o, m, l)
  constexpr int kSmem = kWarps * 2 * kBlockK * (DP + 8) * (int)sizeof(__nv_bfloat16) +
                        (kUpdate ? kSplitRows * (DP + 2) * (int)sizeof(float) : 0);
  static_assert(kSmem >= (3 * (kWarps + 1) + kWarps * DP) * kSplitRows * (int)sizeof(float),
                "the merge reuses the tiles' shared memory");
  auto kernel = flash_split_kernel<DP, kUpdate>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_splits, (p.tq + kSplitRows - 1) / kSplitRows, p.bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(p, part, n_splits, n_live);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kUpdate) return (int)err;
  flash_split_combine<<<dim3(p.tq, p.bh), 128, 0, stream>>>(part, p.out, p.lse, n_splits, p.bh,
                                                            p.tq, p.d);
  return (int)cudaGetLastError();
}

template <bool kUpdate>
int dispatch_split(const Params& p, float* part, int n_splits, int n_live, cudaStream_t stream) {
  if (p.bh <= 0 || p.tq <= 0) return (int)cudaSuccess;
  if (p.d <= 0 || p.d > 128 || p.d % 8 != 0 || p.bh > 65535 || p.tq > 65535 * kSplitRows ||
      n_splits < 1 || n_splits > (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.d <= 16) return launch_split<16, kUpdate>(p, part, n_splits, n_live, stream);
  if (p.d <= 32) return launch_split<32, kUpdate>(p, part, n_splits, n_live, stream);
  if (p.d <= 64) return launch_split<64, kUpdate>(p, part, n_splits, n_live, stream);
  return launch_split<128, kUpdate>(p, part, n_splits, n_live, stream);
}

Params make_params(const void* q, const void* k, const void* v, int bh, int tq, int tk, int d,
                   int64_t q_off, int64_t k_off, int causal, float scale) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.bh = bh;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// Full flash forward: out [BH, Tq, D] bf16 and lse [BH, Tq] f32 from q
// [BH, Tq, D] and k, v [BH, Tk, D], all contiguous, bf16; D a multiple of 8
// up to 128.  Launches on `stream` without synchronizing; returns the
// launch's cudaError_t (0 on success).
extern "C" int tpu_flash_forward_bf16(const void* q, const void* k, const void* v, void* out,
                                      float* lse, int bh, int tq, int tk, int d, int64_t q_off,
                                      int64_t k_off, int causal, float scale,
                                      cudaStream_t stream) {
  Params p = make_params(q, k, v, bh, tq, tk, d, q_off, k_off, causal, scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  return dispatch(p, stream);
}

// The full flash forward as a split over the keys: the same arguments and
// result as tpu_flash_forward_bf16, plus `part`, f32 scratch of
// n_splits * BH * Tq * (D + 2) floats for the partial states, and
// `n_splits` >= 1.  Two launches on `stream`; returns the first failure's
// cudaError_t (0 on success).
extern "C" int tpu_flash_forward_split_bf16(const void* q, const void* k, const void* v,
                                            void* out, float* lse, float* part, int bh, int tq,
                                            int tk, int d, int64_t q_off, int64_t k_off,
                                            int causal, float scale, int n_splits,
                                            cudaStream_t stream) {
  Params p = make_params(q, k, v, bh, tq, tk, d, q_off, k_off, causal, scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  return dispatch_split<false>(p, part, n_splits, live_tiles(tq, tk, q_off, k_off, causal),
                               stream);
}

// Fold k, v [BH, Tk, D] into the online-softmax state of q [BH, Tq, D]:
// m, l [BH, Tq] and o [BH, Tq, D], f32, updated in place.  Same layout
// rules, launch and return as the forward.  The split update: 16-row q
// tiles whose warps split the live key tiles.
extern "C" int tpu_flash_block_update_bf16(const void* q, const void* k, const void* v, float* m,
                                           float* l, float* o, int bh, int tq, int tk, int d,
                                           int64_t q_off, int64_t k_off, int causal, float scale,
                                           cudaStream_t stream) {
  Params p = make_params(q, k, v, bh, tq, tk, d, q_off, k_off, causal, scale);
  p.m = m;
  p.l = l;
  p.o = o;
  return dispatch_split<true>(p, nullptr, 1, 0, stream);
}
