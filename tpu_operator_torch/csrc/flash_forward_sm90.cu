// The long-context prefill on Hopper's own machinery (sm_90a): the flash
// forward on wgmma, with K/V brought in by TMA.
//
//   tpu_flash_forward_wgmma_bf16  replaces `_flash_full_kernel` /
//       `flash_attention_local` (tpu_operator/workloads/longctx.py:47-150)
//       at D 64 and 128 where Tq fills 128-row q tiles: the same function
//       as tpu_flash_forward_bf16 in flash_attention.cu, and the same C
//       signature.
//
// Numerics are the reference's (`online_softmax_block_update`,
// ring_attention.py:86-115): f32 scores of bf16 q and k, scaled after the
// product; causal on global positions q_off + row >= k_off + col; a masked
// score contributes e = 0 and leaves the running max alone, as NEG_INF =
// -1e30 and the e = 0 guard do there; l sums the f32 e; P @ V takes e
// rounded to bf16 and accumulates in f32; out = acc / (l > 0 ? l : 1) in
// bf16 and lse = m + log(l > 0 ? l : 1).  The running max m is kept in
// natural-log units and only the exponent goes through exp2: e =
// exp2(s * scale * log2(e) - m * log2(e)), one multiply-add per score.  So
// a row that sees no key keeps m = NEG_INF and its lse is exactly -1e30, not
// -1e30 * ln 2.  The tiles are 128 keys, not the reference's blocks, so e is
// rounded against another running max and sums run in another order: out
// agrees to bf16 rounding, lse to f32 rounding.
//
// Bound, on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the prefill
// (BH 8, T 32768, D 128, causal) is 4 * BH * D * T(T+1)/2 = 2.2e12 FLOP,
// 2.22 ms, against 0.08 ms for its 268 MB: operations, so the design is
// about keeping the tensor cores fed.
//
// Design.  One block per (bh, 128-row q tile), the heaviest causal tiles
// first, one block per SM (160 KB of shared memory at D 128).  Three
// warpgroups:
//   - a producer, which gives up its registers (setmaxnreg 24) and whose
//     one elected thread starts every copy: Q once, then K and V tiles of
//     128 keys into a two-stage ring, each stage with a full barrier for K,
//     one for V and an empty barrier the consumers arrive on (mbarrier
//     transaction counts; TMA signals completion itself);
//   - two consumers (setmaxnreg 240), 64 query rows each.  Per tile:
//     S = Q K^T by wgmma m64n128k16 from shared memory (both operands
//     K-major, 128-byte swizzle); the online softmax on the f32 S fragment
//     in registers (each row lives in the four threads of a quad, as in
//     fold_tile); P rounded to bf16 in registers becomes the A fragment of
//     O += P V by wgmma m64n64k16 with V the B operand from shared memory,
//     transposed (D is its contiguous axis), one instruction per 64 columns
//     of D.  The accumulator fragment of S (rows g, g + 8; columns 8j + 2t,
//     + 1) is already the A-fragment layout of a 16-key step, so P never
//     leaves the registers.
// TMA reads a 3-D map over [BH, T, D], so a box never crosses into the next
// head and rows past T arrive as zeros: a ragged Tq or Tk needs no copy
// masking.  A box of the 128-byte swizzle is 64 bf16 wide, so at D 128 each
// tile is two boxes and the descriptors step across both halves.  The mask
// is applied only on tiles that cross the causal diagonal of the
// warpgroup's rows or the ragged end of Tk; tiles past the q tile's last
// row are never loaded (the reference's `live` block skip, on global
// positions).  The state (m, l, O) stays in f32 registers for the whole
// walk; out and lse are written once.  The tensor maps are encoded on the
// host for every call (the pointers change) through the entry point that
// the CUDA runtime hands out, so the library needs no link to libcuda, and
// they reach the kernel as __grid_constant__ parameters.  Not done here:
// overlap of one tile's softmax with the next tile's S product inside a
// warpgroup, a third stage, and storing out through shared memory and TMA.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int kKeys = 128;       // keys per K/V tile
constexpr int kBoxCols = 64;     // bf16 per row of a 128-byte swizzled box
constexpr int kBoxBytes = 128 * 128;  // one box: 128 rows of 128 bytes
constexpr int kStages = 2;
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;

struct Args {
  __nv_bfloat16* out;  // [BH, Tq, D]
  float* lse;          // [BH, Tq]
  int tq, tk;
  int64_t q_off, k_off;
  int causal;
  float scale;
};

template <int D>
struct Layout {
  static constexpr int kTileBytes = (D / kBoxCols) * kBoxBytes;  // Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;                          // + stage * kTileBytes
  static constexpr int kV = kTileBytes * (1 + kStages);
  static constexpr int kBars = kTileBytes * (1 + 2 * kStages);
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]; 1 KB slack to
  // align the base to the 1024-byte swizzle atom
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

// d[64] (+)= A[64 x 16] * B[16 x 128]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[32] += A[64 x 16] * B[16 x 64]; A in registers (bf16 pairs), B MN-major
// in shared memory (tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, "
      "%34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int bh = blockIdx.y;
  // the causal forward's last q tiles walk the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  int n_tiles = (a.tk + kKeys - 1) / kKeys;
  if (a.causal) {
    // the last key any row of this tile can see
    const int64_t last_key = a.q_off + min(q0 + kRows, a.tq) - 1 - a.k_off;
    const int64_t need = last_key < 0 ? 0 : last_key / kKeys + 1;
    if (need < n_tiles) n_tiles = (int)need;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
      for (int h = 0; h < D / kBoxCols; ++h) {
        tma_load_3d(base + L::kQ + h * kBoxBytes, &tm_q, q_full, h * kBoxCols, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);  // a fresh stage passes
        mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
#pragma unroll
        for (int h = 0; h < D / kBoxCols; ++h) {
          tma_load_3d(base + L::kK + s * L::kTileBytes + h * kBoxBytes, &tm_k, k_full + 8 * s,
                      h * kBoxCols, t * kKeys, bh);
        }
        mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
#pragma unroll
        for (int h = 0; h < D / kBoxCols; ++h) {
          tma_load_3d(base + L::kV + s * L::kTileBytes + h * kBoxBytes, &tm_v, v_full + 8 * s,
                      h * kBoxCols, t * kKeys, bh);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int row0 = q0 + c * 64 + warp * 16 + g;  // and row0 + 8
    const int64_t first_pos = a.q_off + q0 + c * 64;  // this warpgroup's first row
    const float scale_log2 = a.scale * kLog2e;
    const float minus_inf = __int_as_float(0xff800000);  // a masked score
    const uint32_t q_rows = base + L::kQ + c * 64 * 128;  // rows 64c.. of each Q box

    float o[D / kBoxCols][32];
#pragma unroll
    for (int h = 0; h < D / kBoxCols; ++h) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const uint32_t k_tile = base + L::kK + s * L::kTileBytes;
      const uint32_t v_tile = base + L::kV + s * L::kTileBytes;

      // S = Q K^T: D / 16 steps of 16 along D, 32 bytes each inside a box
      float sc[64];
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_sw128(q_rows + off, 16), desc_sw128(k_tile + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // mask only where the tile crosses this warpgroup's diagonal or Tk
      const int key0 = t * kKeys;
      if (key0 + kKeys > a.tk || (a.causal && a.k_off + key0 + kKeys - 1 > first_pos)) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = key0 + j * 8 + t4 * 2 + (i & 1);
            const int64_t pos = a.q_off + row0 + (i >= 2 ? 8 : 0);
            const bool live = key < a.tk && (!a.causal || pos >= a.k_off + key);
            if (!live) sc[4 * j + i] = minus_inf;
          }
        }
      }
      float mx[2] = {minus_inf, minus_inf};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[4 * j + i]);
      }
      float corr[2];
      float mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * a.scale);  // a masked row's max stays NEG_INF
        corr[r] = ex2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        mb[r] = m_new * kLog2e;
      }
      // e = exp(s * scale - m); a masked score (-inf) gives 0
      float sum[2] = {0.f, 0.f};
      uint32_t pa[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = ex2(fmaf(sc[4 * j + i], scale_log2, -mb[i >> 1]));
          sc[4 * j + i] = e;
          sum[i >> 1] += e;
        }
        pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int h = 0; h < D / kBoxCols; ++h) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[h][i] *= corr[(i >> 1) & 1];
      }

      // O += P V: 8 steps of 16 keys (2 KB of V rows each), 64 columns of D
      // per instruction
      mbar_wait(v_full + 8 * s, parity);
#pragma unroll
      for (int h = 0; h < D / kBoxCols; ++h) fence_regs(o[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t pk[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
#pragma unroll
        for (int h = 0; h < D / kBoxCols; ++h) {
          wgmma_rs_n64(o[h], pk, desc_sw128(v_tile + h * kBoxBytes + kk * 16 * 128, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int h = 0; h < D / kBoxCols; ++h) fence_regs(o[h]);
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.tq) continue;
      const float denom = l[r] > 0.f ? l[r] : 1.f;
      const int64_t idx = (int64_t)bh * a.tq + row;
      if (t4 == 0) a.lse[idx] = m[r] + logf(denom);
#pragma unroll
      for (int h = 0; h < D / kBoxCols; ++h) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = h * kBoxCols + j * 8 + t4 * 2;
          *reinterpret_cast<__nv_bfloat162*>(a.out + idx * D + col) =
              __floats2bfloat162_rn(o[h][4 * j + 2 * r] / denom, o[h][4 * j + 2 * r + 1] / denom);
        }
      }
    }
  }
}

// A 3-D map over [BH, T, D] bf16 in boxes of 128 rows x 64 columns, 128-byte
// swizzle; rows past T read as zeros.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int bh, int t, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {kBoxCols, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const CUtensorMap& tq_map, const CUtensorMap& tk_map, const CUtensorMap& tv_map,
           const Args& a, int bh, cudaStream_t stream) {
  auto kernel = flash_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, Layout<D>::kSmem, stream>>>(tq_map, tk_map, tv_map, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Full flash forward: out [BH, Tq, D] bf16 and lse [BH, Tq] f32 from q
// [BH, Tq, D] and k, v [BH, Tk, D], all contiguous, bf16, 16-byte aligned;
// D 64 or 128, Tk >= 1.  Launches on `stream` without synchronizing; returns
// the launch's cudaError_t (0 on success), cudaErrorInvalidValue for a shape
// it does not take, 999 when the driver has no cuTensorMapEncodeTiled, and
// 1000 + the CUresult when a tensor map cannot be encoded.
extern "C" int tpu_flash_forward_wgmma_bf16(const void* q, const void* k, const void* v,
                                            void* out, float* lse, int bh, int tq, int tk, int d,
                                            int64_t q_off, int64_t k_off, int causal,
                                            float scale, cudaStream_t stream) {
  if (bh <= 0 || tq <= 0) return (int)cudaSuccess;
  if ((d != 64 && d != 128) || tk <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 999;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int ts[3] = {tq, tk, tk};
  for (int i = 0; i < 3; ++i) {
    const CUresult res = encode(fn, &maps[i], ptrs[i], bh, ts[i], d);
    if (res != CUDA_SUCCESS) return 1000 + (int)res;
  }
  Args a{};
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = lse;
  a.tq = tq;
  a.tk = tk;
  a.q_off = q_off;
  a.k_off = k_off;
  a.causal = causal;
  a.scale = scale;
  if (d == 64) return launch<64>(maps[0], maps[1], maps[2], a, bh, stream);
  return launch<128>(maps[0], maps[1], maps[2], a, bh, stream);
}
