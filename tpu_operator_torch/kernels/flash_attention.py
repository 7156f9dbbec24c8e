"""The flash-attention kernels (``csrc/flash_attention.cu``) and their plain
PyTorch versions.

- ``flash_attention_local`` replaces the Pallas TPU kernel
  ``_flash_full_kernel`` (``tpu_operator/workloads/longctx.py:47-150``):
  the full forward, causal or not, returning out and the log-sum-exp;
- ``flash_block_update`` replaces ``_flash_block_kernel``
  (``tpu_operator/workloads/ring_attention.py:118-218``): one K/V block
  folded into the carried (m, l, o) state, in place.  bf16 q/k/v go to the
  ``mma.sync`` entry here; f32 q/k/v, the transformer step's (its weights
  are f32), to ``tpu_flash_block_update_f32`` in ``csrc/flash_backward.cu``.

``workloads/longctx.py`` and ``workloads/ring_attention.py`` re-export them
under the same names, the reference's.

Both run ``online_softmax_block_update`` (``ring_attention.py:86-115``),
whose plain version is here too.  Layout ``[BH, T, D]``; q, k, v bf16 (or
f32 for the block update), the state f32.  A wrapper takes the plain version
for tensors on the CPU and launches its kernel for tensors on a card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_operator_torch.kernels import _build

NEG_INF = -1e30  # large-negative instead of -inf: exp() of a fully masked
# row must give 0 through the guard, never nan from (-inf) - (-inf)

# launches of each CUDA kernel in this process: a run shows it went through
# the kernel by reading these before and after (chip_smoke.py sets them to 0)
forward_launches = 0
block_update_launches = 0      # the bf16 entry
block_update_f32_launches = 0  # the f32 entry

MAX_HEAD_DIM = 128


def _block_div(t: int, want: int) -> int:
    """Largest divisor of ``t`` that is <= ``want`` and a multiple of 8;
    ``t`` itself only when no aligned divisor exists (tiny shapes).  The
    reference's tiling rule (``longctx.py:84-93``), kept by the plain
    version so that it folds the same blocks as the TPU kernel."""
    if t <= want:
        return t
    for blk in range(min(t, want - want % 8), 7, -8):
        if t % blk == 0:
            return blk
    return t


def _q_tile(tq: int, tk: int, budget_bytes: int = 4 << 20) -> int:
    """Largest divisor of ``tq`` (multiple of 8) whose [blk_q, Tk] f32 score
    block fits ``budget_bytes``; ``tq`` itself when it already fits.  The
    reference's q tiling of the block update (``ring_attention.py:132-142``);
    the plain version tiles by it, which also bounds its score memory."""
    target = max(8, budget_bytes // (tk * 4))
    if tq <= target:
        return tq
    for blk in range(min(tq, target - target % 8), 7, -8):
        if tq % blk == 0:
            return blk
    return tq


# ---------------------------------------------------------------------------
# plain versions


def online_softmax_block_update(causal, scale, q, k, v, m, l, acc, q_base, k_base):
    """Fold one K/V block's scores into the (m, l, acc) online-softmax state;
    the reference's numerics exactly: f32 scores of the storage-dtype
    inputs, scaled after the product; masked scores NEG_INF; the fully
    masked guard; ``l`` sums the f32 ``e``; the PV product takes ``e``
    rounded to v's dtype, accumulated in f32.

    Shapes: q [..., Bq, D], k/v [..., Bk, D], m/l [..., Bq, 1], acc
    [..., Bq, D] (leading dims batch, the reference's are absent).
    Returns the new (m, l, acc)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_base + torch.arange(q.shape[-2], device=q.device)
        k_pos = k_base + torch.arange(k.shape[-2], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    blk_max = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, blk_max)
    corr = torch.exp(m - m_new)
    e = torch.exp(s - m_new)
    e = torch.where(s <= NEG_INF * 0.5, 0.0, e)  # fully masked guard
    pv = torch.matmul(e.to(v.dtype).float(), v.float())
    return m_new, l * corr + e.sum(dim=-1, keepdim=True), acc * corr + pv


def flash_attention_local_reference(q, k, v, causal=True, block_k=1024, block_q=1024,
                                    q_off=0, k_off=0):
    """The plain full forward: the update above over (q-tile, k-block), the
    tiles chosen by ``_block_div`` as the TPU kernel's grid, batched over
    BH, and k-blocks past the tile's last query skipped when causal.
    Memory stays at one [BH, block_q, block_k] score tile.  Returns
    (out [BH, Tq, D] in q's dtype, lse [BH, Tq] f32)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    block_k = _block_div(tk, block_k)
    block_q = _block_div(tq, block_q)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    for i in range(0, tq, block_q):
        q_base = q_off + i
        m = torch.full((bh, block_q, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, block_q, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, block_q, d), dtype=torch.float32, device=q.device)
        for j in range(0, tk, block_k):
            k_base = k_off + j
            if causal and k_base > q_base + block_q - 1:
                continue
            m, l, acc = online_softmax_block_update(
                causal, scale, q[:, i:i + block_q], k[:, j:j + block_k], v[:, j:j + block_k],
                m, l, acc, q_base, k_base,
            )
        denom = torch.where(l > 0, l, 1.0)
        out[:, i:i + block_q] = (acc / denom).to(q.dtype)
        lse[:, i:i + block_q] = (m + torch.log(denom))[..., 0]
    return out, lse


def flash_block_update_reference(q, k, v, q_off, k_off, m, l, o, causal):
    """The plain block update: the whole K/V block folded into each q-tile
    (``_q_tile``) of the state.  Returns the new (m, l, o); the inputs are
    left as they are."""
    tq, d = q.shape[1:]
    blk_q = _q_tile(tq, k.shape[1])
    scale = 1.0 / math.sqrt(d)
    m_new, l_new, o_new = torch.empty_like(m), torch.empty_like(l), torch.empty_like(o)
    for i in range(0, tq, blk_q):
        rows = slice(i, i + blk_q)
        mi, li, oi = online_softmax_block_update(
            causal, scale, q[:, rows], k, v, m[:, rows, None], l[:, rows, None], o[:, rows],
            q_off + i, k_off,
        )
        m_new[:, rows], l_new[:, rows], o_new[:, rows] = mi[..., 0], li[..., 0], oi
    return m_new, l_new, o_new


# ---------------------------------------------------------------------------
# kernels


def _check_qkv(q, k, v, dtypes=(torch.bfloat16,)) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in dtypes):
        raise TypeError(f"this flash kernel takes {' or '.join(map(str, dtypes))} q/k/v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected [BH, T, D] each, k and v alike")
    bh, _, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on BH or D")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash kernels take contiguous q, k, v")


def _check_device(*tensors) -> None:
    """What only the kernel needs: a head dim it was built for and
    16-byte-aligned storage (its copies move 16 bytes at a time)."""
    d = tensors[0].shape[-1]
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 8 up to {MAX_HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash kernels take 16-byte-aligned tensors")


_ENTRIES = {  # source -> (entry, state pointers)
    "flash_attention": (("tpu_flash_forward_bf16", 2), ("tpu_flash_block_update_bf16", 3)),
    "flash_backward": (("tpu_flash_block_update_f32", 3),),
}


def _bind(source: str = "flash_attention") -> ctypes.CDLL:
    lib, _ = _build.library(source)
    for name, n_state in _ENTRIES[source]:
        fn = getattr(lib, name)
        state = [ctypes.c_void_p] * n_state
        if fn.argtypes is None:
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, *state,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
    return lib


def _on_card(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels run on cuda or cpu, not {q.device}")
    return True


def flash_attention_local(q, k, v, causal=True, block_k=1024, block_q=1024, q_off=0, k_off=0):
    """Flash attention in the merged layout ``[BH, T, D]`` (kernel B5).
    Returns (out [BH, Tq, D] in q's dtype, lse [BH, Tq] f32).
    ``q_off``/``k_off``: global sequence offsets (causal positions are
    ``q_off + row`` and ``k_off + col``).  On a card the CUDA kernel
    (launched on the current stream, not synchronized), which picks its own
    tiles; ``block_q``/``block_k`` are kept for parity with the reference
    and honoured by the plain version (``_block_div``), which tensors on the
    CPU take."""
    global forward_launches
    _check_qkv(q, k, v)
    if not _on_card(q):
        return flash_attention_local_reference(q, k, v, causal, block_k, block_q, q_off, k_off)
    _check_device(q, k, v)
    bh, tq, d = q.shape
    lib = _bind()
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tpu_flash_forward_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, tq, k.shape[1], d, int(q_off), int(k_off), int(bool(causal)),
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash forward kernel launch failed: cudaError {rc}")
    forward_launches += 1
    return out, lse


def flash_block_update(q, k, v, q_off, k_off, m, l, o, causal):
    """Fold one K/V block into the online-softmax state (kernel B3).

    q/k/v ``[BH, T, D]``, all bf16 or all f32; m, l ``[BH, Tq]`` and o
    ``[BH, Tq, D]`` f32; ``q_off``/``k_off`` are the blocks' global sequence
    offsets.  Updates m, l and o IN PLACE (the counterpart of the TPU
    kernel's ``input_output_aliases``) and returns them.  On a card the CUDA
    kernel of q's dtype (current stream, not synchronized); on the CPU the
    plain version, copied into the state."""
    global block_update_launches, block_update_f32_launches
    _check_qkv(q, k, v, dtypes=(torch.bfloat16, torch.float32))
    bh, tq, d = q.shape
    for name, t, shape in (("m", m, (bh, tq)), ("l", l, (bh, tq)), ("o", o, (bh, tq, d))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} but q on {q.device}")
    if not _on_card(q):
        for t, new in zip((m, l, o), flash_block_update_reference(q, k, v, q_off, k_off,
                                                                  m, l, o, causal)):
            t.copy_(new)
        return m, l, o
    _check_device(q, k, v, m, l, o)
    f32 = q.dtype == torch.float32
    lib = _bind("flash_backward" if f32 else "flash_attention")
    entry = lib.tpu_flash_block_update_f32 if f32 else lib.tpu_flash_block_update_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
            bh, tq, k.shape[1], d, int(q_off), int(k_off), int(bool(causal)),
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash block update kernel launch failed: cudaError {rc}")
    if f32:
        block_update_f32_launches += 1
    else:
        block_update_launches += 1
    return m, l, o
