"""The FlashAttention-2 block backward of one ring hop (``csrc/
flash_backward.cu``) and its plain PyTorch version.

``flash_block_backward`` replaces the Pallas TPU kernel
``_flash_block_bwd_kernel`` / ``flash_block_backward``
(``tpu_operator/workloads/ring_attention.py:577-683``), which the remat
backward of ring attention runs once per hop.  It recomputes the hop's
probabilities from the forward's saved log-sum-exp and adds the hop's dq, dk
and dv into the travelling f32 accumulators, in place.  q, k, v and dO are
f32 (the transformer step's) or bf16; lse, dsum and the accumulators f32.

On a card it is two kernels without atomics, ``dkdv_kernel`` (a block per
64 keys in f32, 128 in bf16, walking 32-row q tiles) and ``dq_kernel`` (a
block per 64 query rows, or 128, walking 32-key tiles), so two launches on
the same inputs give the same bits.  f32 runs every product as 3xTF32 (hi = rna(x), lo = rna(x - hi);
lo hi, hi lo, then hi hi; never one TF32 pass) on Hopper's warpgroup
``wgmma``, bound by the tensor cores' TF32 rate: a producer warpgroup brings
the tiles by TMA into a two-stage ring and splits them, two warpgroups run
the products.  tf32 ``wgmma`` reads both operands K-major only, so the
products over the walked rows run transposed (dV^T += dO^T P^T and the like)
with the walked tile transposed into registers as A, rather than keeping
transposed copies in shared memory: at D 128 a block holds 225 KB of the
card's 227 (fixed tiles 64 KB, the ring and its lo parts 128 KB, the
operands made from registers 32 KB), and a thread of the products up to 232
registers (accumulators 64, the fixed tile's hi parts 64).  The tensor
cores' f32 sums truncate, and a causal dk/dv row at T 32768 sums thousands
of shrinking terms, so every 32 walked tiles the accumulators are added into
dq/dk/dv and start again.  bf16 runs ``mma.sync``.  A wrapper takes the plain version for tensors on the CPU and
launches the kernels for tensors on a card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_operator_torch.kernels import _build
from tpu_operator_torch.kernels.flash_attention import (
    NEG_INF,
    _check_device,
    _check_qkv,
    _check_window,
    _on_card,
    _q_tile,
    visible,
)

# launches of the CUDA kernel pair in this process: a run shows it went
# through the kernel by reading this before and after (chip_smoke.py sets it
# to 0)
backward_launches = 0

# the reference's q-tile budget for the backward, tighter than the forward's
# (``ring_attention.py:643-646``): three score-sized f32 temporaries live at once
Q_TILE_BUDGET = 1 << 20


def flash_block_backward_reference(q, k, v, do, lse, dsum, dq, dk, dv, q_off, k_off, causal,
                                   window=0):
    """The plain block backward, tiled over q by ``_q_tile(tq, tk,
    Q_TILE_BUDGET)`` as the TPU kernel's grid is, with its numerics: f32
    scores of the storage-dtype inputs, scaled after the product; masked
    scores (causal, and outside the sliding ``window`` when one is given)
    NEG_INF and the guard; P and dS rounded to q's dtype before
    their products, accumulated in f32.  dq gains each tile's rows; dk and
    dv gain each tile's contribution in turn.  Returns the new (dq, dk, dv);
    the inputs are left as they are."""
    tq, d = q.shape[1:]
    tk = k.shape[1]
    blk_q = _q_tile(tq, tk, budget_bytes=Q_TILE_BUDGET)
    scale = 1.0 / math.sqrt(d)
    k32, v32 = k.float(), v.float()
    dq, dk, dv = dq.clone(), dk.clone(), dv.clone()
    for i in range(0, tq, blk_q):
        rows = slice(i, i + blk_q)
        q32, do32 = q[:, rows].float(), do[:, rows].float()
        s = torch.matmul(q32, k32.transpose(-1, -2)) * scale  # [BH, blk_q, Tk]
        if causal:
            q_pos = q_off + i + torch.arange(s.shape[1], device=q.device)
            k_pos = k_off + torch.arange(tk, device=q.device)
            s = torch.where(visible(q_pos, k_pos, window), s, NEG_INF)
        # exact probabilities from the saved lse; a row whose lse collapsed
        # to NEG_INF is guarded like the forward
        prob = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - lse[:, rows, None]))
        dv += torch.matmul(prob.to(q.dtype).float().transpose(-1, -2), do32)
        dprob = torch.matmul(do32, v32.transpose(-1, -2))
        ds = (prob * (dprob - dsum[:, rows, None])).to(q.dtype).float()
        dq[:, rows] += torch.matmul(ds, k32) * scale
        dk += torch.matmul(ds.transpose(-1, -2), q32) * scale
    return dq, dk, dv


def _bind() -> ctypes.CDLL:
    lib, _ = _build.library("flash_backward")
    for name in ("tpu_flash_block_backward_f32", "tpu_flash_block_backward_bf16"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [
                *[ctypes.c_void_p] * 9,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, do, lse, dsum, dq, dk, dv) -> None:
    _check_qkv(q, k, v, dtypes=(torch.bfloat16, torch.float32))
    bh, tq, d = q.shape
    tk = k.shape[1]
    if do.dtype != q.dtype:
        raise TypeError(f"dO is {do.dtype} but q is {q.dtype}")
    expected = (("dO", do, (bh, tq, d), q.dtype), ("lse", lse, (bh, tq), torch.float32),
                ("dsum", dsum, (bh, tq), torch.float32), ("dq", dq, (bh, tq, d), torch.float32),
                ("dk", dk, (bh, tk, d), torch.float32), ("dv", dv, (bh, tk, d), torch.float32))
    for name, t, shape, dtype in expected:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} but q on {q.device}")


def flash_block_backward(q, k, v, do, lse, dsum, dq, dk, dv, q_off, k_off, causal, window=0):
    """One hop's dq/dk/dv contributions (kernel B4), the reference's name and
    argument order.

    Merged layout: q/do/dq ``[BH, Tq, D]``, k/v/dk/dv ``[BH, Tk, D]``,
    lse/dsum ``[BH, Tq]`` (the forward's saved log-sum-exp and ``rowsum(dO *
    O)``); ``q_off``/``k_off`` are the blocks' global sequence offsets;
    ``window`` > 0 (causal, f32 on a card) keeps only the keys fewer than
    ``window`` positions before each query.  dq, dk and dv are accumulators,
    updated IN PLACE (the TPU kernel's aliased buffers) and returned.  On a
    card the CUDA kernels (current stream, not synchronized); on the CPU the
    plain version, copied into the accumulators.
    """
    global backward_launches
    _check(q, k, v, do, lse, dsum, dq, dk, dv)
    window = _check_window(causal, window)
    if not _on_card(q):
        new = flash_block_backward_reference(q, k, v, do, lse, dsum, dq, dk, dv, q_off, k_off,
                                             causal, window)
        for t, n in zip((dq, dk, dv), new):
            t.copy_(n)
        return dq, dk, dv
    _check_device(q, k, v, do, lse, dsum, dq, dk, dv)
    if window and q.dtype != torch.float32:
        raise ValueError("the bf16 block backward has no sliding window")
    bh, tq, d = q.shape
    lib = _bind()
    entry = (lib.tpu_flash_block_backward_f32 if q.dtype == torch.float32
             else lib.tpu_flash_block_backward_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(
            *(t.data_ptr() for t in (q, k, v, do, lse, dsum, dq, dk, dv)),
            bh, tq, k.shape[1], d, int(q_off), int(k_off), int(bool(causal)), window,
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash block backward kernel launch failed: cudaError {rc}")
    backward_launches += 1
    return dq, dk, dv
