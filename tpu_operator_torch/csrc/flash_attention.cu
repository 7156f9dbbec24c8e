// Flash attention on bf16 tiles for Hopper (sm_90a) on `mma.sync`: three
// entries over one shared online-softmax tile update, and the block
// backward.
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
//   tpu_flash_block_backward_bf16  replaces `_flash_block_bwd_kernel` /
//       `flash_block_backward` (ring_attention.py:577-683): one ring hop's
//       backward, its own section below (kernel B4 on bf16).
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

// ---------------------------------------------------------------------------
// kernel B4 on bf16: mma.sync
//
// tpu_flash_block_backward_bf16 replaces `_flash_block_bwd_kernel` /
// `flash_block_backward` (ring_attention.py:577-683) on bf16 q, k, v, dO:
// the FlashAttention-2 backward of one ring hop, adding the hop's dq, dk and
// dv into the travelling f32 accumulators in place (the f32 entry, the
// training path's, is in flash_backward.cu).  Scores and masks as above;
// P = exp(s - lse) from the forward's saved lse, under the same guard; dV +=
// P^T dO; dP = dO V^T; dS = P (dP - D) with D = rowsum(dO O) given; dQ +=
// dS K scale; dK += dS^T Q scale.  P is rounded to bf16 before P^T dO and dS
// before dS K and dS^T Q (`.astype(q.dtype)` at :602 and :609), every
// product accumulated in f32.
//
// Two kernels with no atomics, each output element written by one block in
// a fixed order, so two launches give the same bits; S and dP are computed
// in both.  dkdv_mma_kernel runs one block per (bh, 128-key tile), walking
// the 32-row q tiles that see any of its keys; dq_mma_kernel one block per
// (bh, 128-row q tile), walking the 32-key tiles it sees.  Under the causal
// mask tiles past the diagonal are never loaded, and a block with no visible
// tile writes nothing, so a fully masked hop leaves dq/dk/dv bit for bit.
// Eight warps each own 16 rows and keep their accumulators in registers for
// the whole walk; the walked tiles stream through a two-stage cp.async ring
// with zero fill past T and past D; rows are stored in 16-byte chunks
// XOR-swizzled by row (chunk ^ row % 8, rows of at least 128 bytes), so
// every fragment load is free of bank conflicts.  The dk/dv kernel computes
// S^T = K Q^T and dP^T = V dO^T with keys as M, so P^T and dS^T are already
// the A operand of dV += P^T dO and dK += dS^T Q; the dq kernel keeps dS as
// the A operand of dQ += dS K, two adjacent accumulators being the m16n8k16
// fragment (FA2's reuse).  D is padded to 16, 32, 64 or 128, and a warp
// whose rows see none of a tile's keys skips it, which changes nothing (P =
// 0 there).

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdRows = kBwdWarps * 16;  // rows of a block's fixed tile
constexpr int kBwdStep = 32;              // rows of a walked tile

struct BwdParams {
  const __nv_bfloat16* q;     // [BH, Tq, D]
  const __nv_bfloat16* k;     // [BH, Tk, D]
  const __nv_bfloat16* v;     // [BH, Tk, D]
  const __nv_bfloat16* dout;  // [BH, Tq, D]
  const float* lse;           // [BH, Tq]
  const float* dsum;          // [BH, Tq]  rowsum(dO * O)
  float* dq;                  // [BH, Tq, D]  accumulated in place
  float* dk;                  // [BH, Tk, D]  accumulated in place
  float* dv;                  // [BH, Tk, D]  accumulated in place
  int bh, tq, tk, d;
  int64_t q_off, k_off;
  int causal;
  float scale;
};

// A tile of rows of DP bf16, row-major, its 16-byte chunks of 8 elements
// XOR-swizzled by row; a row holds at least 128 bytes (8 chunks).
template <int DP>
struct Smem {
  static constexpr int kRowElems = DP >= 64 ? DP : 64;
  __device__ __forceinline__ static int at(int r, int c) {
    return r * kRowElems + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
  }
  static constexpr int bytes(int rows) { return rows * kRowElems * 2; }
};

// Rows [r0, r0 + ROWS) of one head (rows `base` on of a [BH, t, d] tensor)
// into a swizzled tile, zero past t and past d.
template <int DP, int ROWS>
__device__ __forceinline__ void stage(__nv_bfloat16* s, const __nv_bfloat16* g, int64_t base,
                                      int t, int d, int r0) {
  using L = Smem<DP>;
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kBwdThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = r0 + r;
    const bool ok = row < t && c < d;
    cp_async16(s + L::at(r, c), ok ? g + (base + row) * d + c : g, ok);
  }
}

// Fragments of lane (g, t) = (lane / 4, lane % 4) of m16n8k16 on bf16:
//   load_a<L>(s, r0, k0):   A[m][k] = s[r0 + m][k0 + k]
//   load_b_nk<L>(s, n0, k0): B[k][n] = s[n0 + n][k0 + k]
//   load_b_kn<L>(s, k0, n0): B[k][n] = s[k0 + k][n0 + n]
//   a_acc(c, j): the A operand of the j-th K step whose columns are the
//       accumulators c[...] of 8 columns each, rounded to bf16 (P and dS,
//       as the reference)
//   mma_all<G>(c, a, b): c[j] += a b[j] for G tiles
struct Mma {
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
    for (int j = 0; j < G; ++j) mma_bf16_16816(c[j], x.x, y[j].x[0], y[j].x[1]);
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// c[16 x 8N] = A B^T over DP columns: A's 16 rows from r0 of `a`, B's 8N
// rows from n0 = 0 of `b`, row-major tiles
template <int DP, int N>
__device__ __forceinline__ void rows_dot(float (&c)[N][4], const __nv_bfloat16* a, int r0,
                                         const __nv_bfloat16* b) {
  using L = Smem<DP>;
  zero(c);
#pragma unroll 2
  for (int k0 = 0; k0 < DP; k0 += Mma::kK) {
    const Mma::A x = Mma::load_a<L>(a, r0, k0);
    Mma::B y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = Mma::load_b_nk<L>(b, 8 * j, k0);
    Mma::mma_all<N>(c, x, y);
  }
}

// acc[16 x DP] += P b: P's 16 x 8N from the accumulators p, b's first 8N
// rows, DP columns
template <int DP, int N>
__device__ __forceinline__ void acc_dot(float (&acc)[DP / 8][4], const float (&p)[N][4],
                                        const __nv_bfloat16* b) {
  using L = Smem<DP>;
#pragma unroll
  for (int j = 0; j < 8 * N / Mma::kK; ++j) {
    const Mma::A x = Mma::a_acc(p, j);
    constexpr int G = DP / 8 < 4 ? DP / 8 : 4;
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += G) {
      Mma::B y[G];
#pragma unroll
      for (int n = 0; n < G; ++n) y[n] = Mma::load_b_kn<L>(b, j * Mma::kK, 8 * (n0 + n));
      Mma::mma_all<G>(acc + n0, x, y);
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

template <int DP>
constexpr int dkdv_smem() {
  return 2 * Smem<DP>::bytes(kBwdRows) + kStages * 2 * Smem<DP>::bytes(kBwdStep) +
         kStages * 2 * kBwdStep * (int)sizeof(float);
}

template <int DP>
constexpr int dq_smem() {
  return 2 * Smem<DP>::bytes(kBwdRows) + kStages * 2 * Smem<DP>::bytes(kBwdStep);
}

// One block per (bh, 128-key tile): dK and dV of its keys over every 32-row
// q tile that sees one of them, added into dk/dv once at the end.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1) dkdv_mma_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<DP>;
  constexpr int kFixed = kBwdRows * L::kRowElems;
  constexpr int kStep = kBwdStep * L::kRowElems;
  constexpr int kN = kBwdStep / 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kFixed;
  __nv_bfloat16* qs = vs + kFixed;            // [stage][kBwdStep rows]
  __nv_bfloat16* dos = qs + kStages * kStep;  // [stage][kBwdStep rows]
  float* lses = reinterpret_cast<float*>(dos + kStages * kStep);  // [stage][kBwdStep]
  float* dsums = lses + kStages * kBwdStep;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBwdRows;  // key tile 0 sees the most q tiles: first
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
    stage<DP, kBwdStep>(qs + s * kStep, p.q, qbase, p.tq, p.d, q0);
    stage<DP, kBwdStep>(dos + s * kStep, p.dout, qbase, p.tq, p.d, q0);
    const int i = threadIdx.x % kBwdStep;
    const int row = q0 + i;
    const bool ok = row < p.tq;
    if (threadIdx.x < kBwdStep) {
      cp_async4(lses + s * kBwdStep + i, ok ? p.lse + qbase + row : p.lse, ok);
    } else if (threadIdx.x < 2 * kBwdStep) {
      cp_async4(dsums + s * kBwdStep + i, ok ? p.dsum + qbase + row : p.dsum, ok);
    }
  };
  stage<DP, kBwdRows>(ks, p.k, kbase, p.tk, p.d, k0);
  stage<DP, kBwdRows>(vs, p.v, kbase, p.tk, p.d, k0);
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
    __nv_bfloat16* qt = qs + s * kStep;
    __nv_bfloat16* dot = dos + s * kStep;
    const int q0 = it * kBwdStep;
    const int64_t last_q = p.q_off + min(q0 + kBwdStep, p.tq) - 1;
    if (wk0 < p.tk && (!p.causal || last_q >= p.k_off + wk0)) {
      // S^T = K Q^T and dP^T = V dO^T, keys as rows
      float st[kN][4];
      float dpt[kN][4];
      rows_dot<DP>(st, ks, warp * 16, qt);
      rows_dot<DP>(dpt, vs, warp * 16, dot);
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
          const float prob = (!live || x <= kNegInf * 0.5f)
                                 ? 0.f
                                 : exp2f((x - lses[s * kBwdStep + col]) * kLog2e);
          st[j][i] = prob;
          dpt[j][i] = prob * (dpt[j][i] - dsums[s * kBwdStep + col]);
        }
      }
      // dV += P^T dO; dK += dS^T Q
      acc_dot<DP>(dv, st, dot);
      acc_dot<DP>(dk, dpt, qt);
    }
    __syncthreads();  // the stage is free for tile it + 2
  }
  add_rows<DP>(p.dk, dk, kbase, wk0, p.tk, p.d, p.scale);
  add_rows<DP>(p.dv, dv, kbase, wk0, p.tk, p.d, 1.f);
}

// One block per (bh, 128-row q tile): dQ of its rows over every 32-key tile
// it sees, added into dq once at the end.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1) dq_mma_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<DP>;
  constexpr int kFixed = kBwdRows * L::kRowElems;
  constexpr int kStep = kBwdStep * L::kRowElems;
  constexpr int kN = kBwdStep / 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kFixed;
  __nv_bfloat16* ks = dos + kFixed;          // [stage][kBwdStep rows]
  __nv_bfloat16* vs = ks + kStages * kStep;  // [stage][kBwdStep rows]

  const int bh = blockIdx.x;
  // the causal q tiles see more keys the later they are: last tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int wq0 = q0 + warp * 16;
  int n_k = (p.tk + kBwdStep - 1) / kBwdStep;
  if (p.causal) {
    // the last key any row of this tile sees
    const int last_row = min(q0 + kBwdRows, p.tq) - 1;
    const int64_t last_key = p.q_off + last_row - p.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kBwdStep + 1;
    if (need < n_k) n_k = (int)need;
  }
  if (n_k == 0) return;  // every key past every query: dq untouched

  const int64_t kbase = (int64_t)bh * p.tk;
  const int64_t qbase = (int64_t)bh * p.tq;
  auto stage_k = [&](int jt, int s) {
    stage<DP, kBwdStep>(ks + s * kStep, p.k, kbase, p.tk, p.d, jt * kBwdStep);
    stage<DP, kBwdStep>(vs + s * kStep, p.v, kbase, p.tk, p.d, jt * kBwdStep);
  };
  stage<DP, kBwdRows>(qs, p.q, qbase, p.tq, p.d, q0);
  stage<DP, kBwdRows>(dos, p.dout, qbase, p.tq, p.d, q0);
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
    __nv_bfloat16* kt = ks + s * kStep;
    __nv_bfloat16* vt = vs + s * kStep;
    const int kt0 = jt * kBwdStep;
    if (wq0 < p.tq && (!p.causal || last_q >= p.k_off + kt0)) {
      float sc[kN][4];
      float ds[kN][4];
      rows_dot<DP>(sc, qs, warp * 16, kt);
      rows_dot<DP>(ds, dos, warp * 16, vt);
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
          const float prob = (!live || x <= kNegInf * 0.5f) ? 0.f : exp2f((x - lse[r]) * kLog2e);
          ds[j][i] = prob * (ds[j][i] - dsum[r]);
        }
      }
      acc_dot<DP>(dq, ds, kt);  // dQ += dS K
    }
    __syncthreads();
  }
  add_rows<DP>(p.dq, dq, qbase, wq0, p.tq, p.d, p.scale);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP>
int launch_backward(const BwdParams& p, cudaStream_t stream) {
  constexpr int kDkdvSmem = dkdv_smem<DP>();
  constexpr int kDqSmem = dq_smem<DP>();
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "a block's shared memory");
  int err = set_smem(dkdv_mma_kernel<DP>, kDkdvSmem);
  if (err != 0) return err;
  err = set_smem(dq_mma_kernel<DP>, kDqSmem);
  if (err != 0) return err;
  dkdv_mma_kernel<DP><<<dim3(p.bh, (p.tk + kBwdRows - 1) / kBwdRows), kBwdThreads, kDkdvSmem,
                        stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_mma_kernel<DP><<<dim3(p.bh, (p.tq + kBwdRows - 1) / kBwdRows), kBwdThreads, kDqSmem,
                      stream>>>(p);
  return (int)cudaGetLastError();
}

// the copies move 16 bytes of q/k/v/dO at a time, the write-backs 8 of f32
bool misaligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes != 0; }

int dispatch_backward(const BwdParams& p, cudaStream_t stream) {
  if (p.d <= 0 || p.d > 128 || p.d % 8 != 0 || p.bh > 65535 || p.tq < 0 || p.tk < 0 ||
      p.tq > 65535 * kBwdRows || p.tk > 65535 * kBwdRows) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned(p.q, 16) || misaligned(p.k, 16) || misaligned(p.v, 16) ||
      misaligned(p.dout, 16) || misaligned(p.lse, 4) || misaligned(p.dsum, 4) ||
      misaligned(p.dq, 8) || misaligned(p.dk, 8) || misaligned(p.dv, 8)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (p.bh == 0 || p.tq == 0 || p.tk == 0) return (int)cudaSuccess;
  if (p.d <= 16) return launch_backward<16>(p, stream);
  if (p.d <= 32) return launch_backward<32>(p, stream);
  if (p.d <= 64) return launch_backward<64>(p, stream);
  return launch_backward<128>(p, stream);
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

// One ring hop's backward on bf16 q, k, v, dout [BH, T, D]: adds this hop's
// dq [BH, Tq, D], dk and dv [BH, Tk, D] (f32, in place), from lse and dsum
// [BH, Tq] f32; all contiguous; D a multiple of 8 up to 128; q/k/v/dout
// 16-byte aligned.  The arguments of tpu_flash_block_backward_f32
// (flash_backward.cu) without its sliding window.  Two kernels on `stream`,
// no synchronize; returns the first failing launch's cudaError_t (0 on
// success).
extern "C" int tpu_flash_block_backward_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* dsum, float* dq, float* dk, float* dv,
                                             int bh, int tq, int tk, int d, int64_t q_off,
                                             int64_t k_off, int causal, float scale,
                                             cudaStream_t stream) {
  BwdParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
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
  return dispatch_backward(p, stream);
}
