// Flash attention on bf16 tiles for Hopper (sm_90a): two entries over one
// shared online-softmax tile update.
//
//   tpu_flash_forward_bf16       replaces `_flash_full_kernel` /
//       `flash_attention_local` (tpu_operator/workloads/longctx.py:47-150):
//       the full forward, causal or not, returning out (bf16) and lse (f32).
//   tpu_flash_block_update_bf16  replaces `_flash_block_kernel` /
//       `flash_block_update` (tpu_operator/workloads/ring_attention.py:118-218):
//       folds one K/V block into the carried (m, l, o) state, in place.
//
// Both TPU kernels run `online_softmax_block_update`
// (ring_attention.py:86-115); here that is `fold_tile`, and its numerics are
// the reference's:
//   s = dot_f32(q, k) * scale, scale = 1/sqrt(D) applied after the product;
//   masked scores are NEG_INF = -1e30 (never -inf), causal on global
//   positions q_off + row >= k_off + col;
//   m' = max(m, rowmax(s)), corr = exp(m - m'), e = exp(s - m'), and e = 0
//   where s <= NEG_INF / 2 (the fully-masked guard);
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
//   ring hop (BH 4, T 512, D 128): 3.7 MB of q/k/v and f32 state, about
//     1.1 us: bytes, and far below a launch, so the hop is launch-bound.
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
// update) and launches the heaviest q-tiles first.  The block update never
// skips, as the reference.  Not done here and left to later work: wgmma,
// TMA, warp specialisation, and a split over K for the decode shape, whose
// grid has only BH blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
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
// `online_softmax_block_update` of the reference.  Row r0 = g, r1 = g + 8 of
// the warp's rows (g = lane / 4); each thread holds two score columns per
// 8-key n-tile, and the four threads of a quad share a row.
template <int DP>
__device__ __forceinline__ void fold_tile(const Params& p, const uint32_t (&qa)[DP / 16][4],
                                          const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                          int k0, int64_t q_pos0, float (&m)[2], float (&l)[2],
                                          float (&acc)[DP / 8][4]) {
  constexpr int kStride = DP + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;

  float s[kBlockK / 8][4];
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

  // scale after the f32 product, then mask on global positions
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + nt * 8 + t4 * 2 + (i & 1);
      const int64_t q_pos = q_pos0 + g + (i >= 2 ? 8 : 0);
      const bool live = key < p.tk && (!p.causal || q_pos >= p.k_off + key);
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
    corr[r] = expf(m[r] - m_new[r]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = s[nt][i];
      const float e = x <= kNegInf * 0.5f ? 0.f : expf(x - m_new[i >> 1]);
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

  // P @ V: the score fragments of two adjacent n-tiles are the A fragment
  // of one 16-key step, after rounding e to bf16 (v's dtype)
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

template <int DP, bool kUpdate>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr int kStride = DP + 8;
  constexpr int kTileElems = kBlockK * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_smem = k_smem + kStages * kTileElems;

  const int bh = blockIdx.y;
  // the causal forward's last q-tiles walk the most keys: start them first
  const int q_tile = kUpdate ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
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

  float m[2];
  float l[2];
  float acc[DP / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = kUpdate && row[r] < p.tq;
    const int64_t i = (int64_t)bh * p.tq + row[r];
    m[r] = ok ? p.m[i] : kNegInf;
    l[r] = ok ? p.l[i] : 0.f;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int c = nd * 8 + t4 * 2;
      float2 x = make_float2(0.f, 0.f);
      if (ok && c < p.d) x = *reinterpret_cast<const float2*>(p.o + i * p.d + c);
      acc[nd][2 * r] = x.x;
      acc[nd][2 * r + 1] = x.y;
    }
  }

  int n_tiles = (p.tk + kBlockK - 1) / kBlockK;
  if (!kUpdate && p.causal) {
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
    if (kUpdate) {
      if (t4 == 0) {
        p.m[i] = m[r];
        p.l[i] = l[r];
      }
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        const int c = nd * 8 + t4 * 2;
        if (c < p.d) {
          *reinterpret_cast<float2*>(p.o + i * p.d + c) =
              make_float2(acc[nd][2 * r], acc[nd][2 * r + 1]);
        }
      }
    } else {
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
}

template <int DP, bool kUpdate>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = kStages * 2 * kBlockK * (DP + 8) * (int)sizeof(__nv_bfloat16);
  auto kernel = flash_kernel<DP, kUpdate>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.tq + kBlockQ - 1) / kBlockQ, p.bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kUpdate>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.bh <= 0 || p.tq <= 0) return (int)cudaSuccess;
  if (p.d <= 0 || p.d > 128 || p.d % 8 != 0 || p.bh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.d <= 16) return launch<16, kUpdate>(p, stream);
  if (p.d <= 32) return launch<32, kUpdate>(p, stream);
  if (p.d <= 64) return launch<64, kUpdate>(p, stream);
  return launch<128, kUpdate>(p, stream);
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
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.bh = bh;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.scale = scale;
  return dispatch<false>(p, stream);
}

// Fold k, v [BH, Tk, D] into the online-softmax state of q [BH, Tq, D]:
// m, l [BH, Tq] and o [BH, Tq, D], f32, updated in place.  Same layout
// rules, launch and return as the forward.
extern "C" int tpu_flash_block_update_bf16(const void* q, const void* k, const void* v, float* m,
                                           float* l, float* o, int bh, int tq, int tk, int d,
                                           int64_t q_off, int64_t k_off, int causal, float scale,
                                           cudaStream_t stream) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
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
  return dispatch<true>(p, stream);
}
