"""Ring attention on PyTorch: sequence-parallel exact attention over the
local cards, and its memory-efficient training path.  Port of
``tpu_operator/workloads/ring_attention.py``.

The sequence axis is sharded over a ring of ranks, one per card
(``_ranks``; NCCL on the cards, gloo on the CPU): every rank holds one block
of Q/K/V, folds the K/V block it currently holds into its online-softmax
state, then passes K/V one hop on (to rank + 1, from rank - 1).  After ``p``
hops every Q block has seen the whole sequence while each rank held one
block.  Causal masking works from global positions: at hop ``s`` the block
held came from rank ``(r - s) mod p``.  A sliding window (training path,
causal) keeps only the keys fewer than ``window`` positions before each
query; the kernels skip the tiles outside that band.  On one card ``p =
1``: a single fold, no rotation.

The fold is the hand-written kernel B3 (``kernels/flash_attention.py``) in
the ``[B*H, T, D]`` layout, or the plain f32 path (``_plain_ring_forward``),
the reference's own oracle.

Training (``ring_attention_remat``, the reference's ``:461-740``) saves only
(q, k, v, out, lse) in the forward and recomputes each hop's scores in a
second ring pass: the FlashAttention-2 block backward per hop, kernel B4
(``kernels/flash_backward.py``) or the plain f32 path.  dK/dV travel with
their K/V block and come home after a full revolution.  Every ring runs over
a process group (the default one, or the transformer's mp group).
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_operator_torch.kernels.flash_attention import (  # noqa: F401  (re-exported)
    NEG_INF,
    _q_tile,
    flash_block_update,
    online_softmax_block_update,
    visible,
)
from tpu_operator_torch.kernels.flash_backward import flash_block_backward
from tpu_operator_torch.obs import flight
from tpu_operator_torch.workloads import _ranks, resolve_device


def reference_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Single-device exact attention [B, T, H, D]: the truth the ring result
    must match.  The reference's dtypes: scores from a product in q's dtype
    (bf16 out), divided in f32; f32 softmax; weights in v's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _block_scores(q, k, scale):
    return torch.einsum("bqhd,bkhd->bhqk", q, k) * scale


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B*H, T, D], contiguous: the kernels' layout."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def split_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, T, D] -> [B, T, H, D] (merge_heads' inverse)."""
    _, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3)


def _hop_scores(q32, k, scale, causal, q_pos, src, block, window=0):
    """Scores of my Q block against the K block produced by rank ``src``,
    causal-masked from global positions (and outside the sliding
    ``window`` when one is given)."""
    scores = _block_scores(q32, k.float(), scale)  # [B, H, Tq, Tk]
    if causal:
        k_pos = src * block + torch.arange(block, device=q32.device)
        scores = torch.where(visible(q_pos, k_pos, window), scores, NEG_INF)
    return scores


def _ring_group(group=None):
    """(rank, size) of the ring: ``group``, else the default process group,
    else one rank when there is none."""
    if group is not None:
        return dist.get_rank(group), dist.get_world_size(group)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _lse_of(m, l):
    """logsumexp per query from the online-softmax state."""
    return m + torch.log(torch.where(l > 0, l, 1.0))


def _plain_ring_forward(q, k, v, causal: bool, group=None, window: int = 0):
    """The plain ring forward: (out [B, T, H, D], lse [B, T, H]), all math
    in f32 on [B, T, H] state, as the reference's jnp path."""
    idx, p = _ring_group(group)
    b, block, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    m = torch.full((b, block, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, block, h), dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    q_pos = idx * block + torch.arange(block, device=q.device)

    def consume(s, m, l, o, k, v):
        src = (idx - s) % p
        scores = _hop_scores(q32, k, scale, causal, q_pos, src, block, window)
        blk_max = scores.amax(dim=-1).permute(0, 2, 1)  # [B, Tq, H]
        m_new = torch.maximum(m, blk_max)
        corr = torch.exp(m - m_new)
        e = torch.exp(scores - m_new.permute(0, 2, 1)[..., None])
        e = torch.where(scores <= NEG_INF * 0.5, 0.0, e)
        l_new = l * corr + e.sum(-1).permute(0, 2, 1)
        blk_o = torch.einsum("bhqk,bkhd->bqhd", e, v.float())
        return m_new, l_new, o * corr[..., None] + blk_o

    # p - 1 fold-and-rotate hops, then the last fold WITHOUT the rotation
    for s in range(p - 1):
        m, l, o = consume(s, m, l, o, k, v)
        k, v = _ranks.rotate(k, v, group=group)
    m, l, o = consume(p - 1, m, l, o, k, v)
    denom = torch.where(l > 0, l, 1.0)
    return (o / denom[..., None]).to(q.dtype), _lse_of(m, l)


def _kernel_ring_forward(q, k, v, causal: bool, group=None, window: int = 0):
    """The ring forward on kernel B3: (out [B, T, H, D], lse [B, T, H]), the
    layouts of ``_plain_ring_forward``."""
    idx, p = _ring_group(group)
    b, block, h, d = q.shape
    m = torch.full((b * h, block), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b * h, block), dtype=torch.float32, device=q.device)
    o = torch.zeros((b * h, block, d), dtype=torch.float32, device=q.device)
    # merge once and rotate in the kernel layout
    qm, k, v = merge_heads(q), merge_heads(k), merge_heads(v)

    def consume(s):
        src = (idx - s) % p
        flash_block_update(qm, k, v, idx * block, src * block, m, l, o, causal, window)

    for s in range(p - 1):
        consume(s)
        k, v = _ranks.rotate(k, v, group=group)
    consume(p - 1)
    denom = torch.where(l > 0, l, 1.0)
    out = split_heads(o / denom[..., None], b, h)

    def split2(x):  # [B*H, T] -> [B, T, H]
        return x.reshape(b, h, block).permute(0, 2, 1)

    return out.to(q.dtype), _lse_of(split2(m), split2(l))


def ring_attention_sharded(q, k, v, causal: bool, use_kernel: bool = False,
                           group=None) -> torch.Tensor:
    """The per-rank program: this rank's [B, T/p, H, D] blocks in, its block
    of the output out.  Runs over ``group`` (default: the default process
    group; one rank when there is none).  ``use_kernel`` folds through
    kernel B3; otherwise the plain path, its reference."""
    forward = _kernel_ring_forward if use_kernel else _plain_ring_forward
    out, _ = forward(q, k, v, causal, group)
    return out


# ---------------------------------------------------------------------------
# The memory-efficient training path (the reference's custom VJP, :461-740).
# Autograd through the forward's loop would keep every hop's residuals; the
# Ring Attention recipe instead saves (q, k, v, out, lse) and recomputes each
# hop's scores in a second ring pass.  K/V rotate p - 1 times as in the
# forward; dK/dV travel with their block for all p rotations, the last one
# peeled (no K/V rotation after the last hop), so every block's gradient
# lands on the rank that owns the block.


def _plain_ring_backward(q, k, v, out, lse, dout, causal: bool, group=None, window: int = 0):
    """The plain remat backward (the reference's ``_remat_bwd``, :502-561):
    (dq, dk, dv) in q's layout and dtypes, all math in f32 on [B, T, H]."""
    idx, p = _ring_group(group)
    b, block, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32, do32 = q.float(), dout.float()
    # D_i = rowsum(dO * O): the softmax-jacobian correction term
    dsum = (do32 * out.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, Tq, 1]
    lse_b = lse.permute(0, 2, 1)[..., None]
    q_pos = idx * block + torch.arange(block, device=q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)

    def consume(s, dq, dk, dv, k, v):
        src = (idx - s) % p
        k32, v32 = k.float(), v.float()
        scores = _hop_scores(q32, k, scale, causal, q_pos, src, block, window)
        # exact probabilities from the SAVED lse; a fully masked row whose
        # lse collapsed to NEG_INF is guarded like the forward
        prob = torch.where(scores <= NEG_INF * 0.5, 0.0, torch.exp(scores - lse_b))
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", prob, do32)
        dprob = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
        dscores = prob * (dprob - dsum)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", dscores, k32) * scale
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", dscores, q32) * scale
        return dq, dk, dv

    for s in range(p - 1):
        dq, dk, dv = consume(s, dq, dk, dv, k, v)
        k, v, dk, dv = _ranks.rotate(k, v, dk, dv, group=group)
    dq, dk, dv = consume(p - 1, dq, dk, dv, k, v)
    if p > 1:  # the accumulators' homing rotation
        dk, dv = _ranks.rotate(dk, dv, group=group)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_ring_backward(q, k, v, out, lse, dout, causal: bool, group=None, window: int = 0):
    """The remat backward on kernel B4 (the reference's
    ``_remat_bwd_pallas``, :686-737): the merged layout throughout, dq/dk/dv
    f32 accumulators that the kernel updates in place, the same rotation as
    ``_plain_ring_backward``."""
    idx, p = _ring_group(group)
    b, block, h, d = q.shape
    qm, km, vm, dom = merge_heads(q), merge_heads(k), merge_heads(v), merge_heads(dout)
    # D_i = rowsum(dO * O) in f32, outside the kernel as in the reference
    dsum = (dom.float() * merge_heads(out).float()).sum(-1)
    lsem = lse.permute(0, 2, 1).reshape(b * h, block).contiguous()
    dq = torch.zeros(qm.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(km.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vm.shape, dtype=torch.float32, device=q.device)

    def consume(s, dk, dv, km, vm):
        src = (idx - s) % p
        flash_block_backward(qm, km, vm, dom, lsem, dsum, dq, dk, dv, idx * block, src * block,
                             causal, window)

    for s in range(p - 1):
        consume(s, dk, dv, km, vm)
        km, vm, dk, dv = _ranks.rotate(km, vm, dk, dv, group=group)
    consume(p - 1, dk, dv, km, vm)
    if p > 1:
        dk, dv = _ranks.rotate(dk, dv, group=group)
    return (split_heads(dq, b, h).to(q.dtype), split_heads(dk, b, h).to(k.dtype),
            split_heads(dv, b, h).to(v.dtype))


class RingAttentionRemat(torch.autograd.Function):
    """Ring attention with an O(1)-residual backward: the forward (kernel B3
    or the plain path) saves only (q, k, v, out, lse); the backward makes a
    second ring pass (kernel B4 or the plain path).  Every rank of the ring
    calls forward and backward in the same order."""

    @staticmethod
    def forward(ctx, q, k, v, causal, use_kernel, group, window):
        forward = _kernel_ring_forward if use_kernel else _plain_ring_forward
        out, lse = forward(q, k, v, causal, group, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.use_kernel, ctx.group, ctx.window = causal, use_kernel, group, window
        return out

    @staticmethod
    def backward(ctx, dout):
        backward = _kernel_ring_backward if ctx.use_kernel else _plain_ring_backward
        dq, dk, dv = backward(*ctx.saved_tensors, dout, ctx.causal, ctx.group, ctx.window)
        return dq, dk, dv, None, None, None, None


def ring_attention_remat(q, k, v, causal: bool, use_kernel: bool = False,
                         group=None, window: int = 0) -> torch.Tensor:
    """``ring_attention_sharded`` with the memory-efficient backward; the
    per-rank program on [B, T/p, H, D] blocks over ``group``.
    ``use_kernel`` runs the forward on B3 and the backward on B4 (f32 for a
    sliding ``window`` > 0, which needs ``causal``)."""
    return RingAttentionRemat.apply(q, k, v, causal, use_kernel, group, int(window or 0))


def remat_launches() -> dict:
    """Launches so far in this process of the two kernels the training path
    runs on f32: B3's f32 entry and B4."""
    from tpu_operator_torch.kernels import flash_attention as fa
    from tpu_operator_torch.kernels import flash_backward as fb

    return {"flash_block_update_f32": fa.block_update_f32_launches,
            "flash_block_backward": fb.backward_launches}


def remat_route(device: torch.device, use_kernel: bool) -> str:
    """What ran the remat attention: the kernels on a card, their plain
    versions on the CPU, or the plain ring path."""
    if not use_kernel:
        return "plain"
    return "cuda-flash-fwd-bwd" if device.type == "cuda" else "plain-flash-fwd-bwd"


def _ring_rank(rank: int, n: int, device: torch.device, qkv, causal: bool,
               use_kernel: bool, tol: float, out_path: str) -> dict:
    """One rank of the ring check: slice my shard of the full host inputs,
    run the ring, hold my rows against the single-device reference; the max
    error is the max over every rank.  With ``out_path``, rank 0 saves the
    gathered output there (.npy, f32)."""
    from tpu_operator_torch.kernels import flash_attention as fa

    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).to(device) for x in qkv)
    b, t, h, d = q.shape
    if t % n:
        raise ValueError(f"sequence {t} does not split over {n} ranks")
    block = t // n
    rows = slice(rank * block, (rank + 1) * block)
    q_s, k_s, v_s = (x[:, rows].contiguous() for x in (q, k, v))

    launches = fa.block_update_launches
    t0 = time.perf_counter()
    out = ring_attention_sharded(q_s, k_s, v_s, causal, use_kernel)
    ref = reference_attention(q, k, v, causal)[:, rows]
    err = (out.float() - ref.float()).abs().max()
    if n > 1:
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
    err = float(err)  # the readback waits for the card
    dt = time.perf_counter() - t0
    if out_path:
        parts = [torch.empty_like(out) for _ in range(n)] if n > 1 else [out]
        if n > 1:
            dist.all_gather(parts, out.contiguous())
        if rank == 0:
            np.save(out_path, torch.cat(parts, dim=1).float().cpu().numpy())
    flight.record("ring-attention", "run", step_s=dt, seq=t, max_error=err)
    return {
        "ok": bool(np.isfinite(err) and err < tol),
        "devices": n,
        "seq": t,
        "seq_per_chip": block,
        "heads": h,
        "head_dim": d,
        "causal": causal,
        "kernel": ("plain" if not use_kernel
                   else "cuda-flash" if device.type == "cuda" else "plain-flash"),
        "max_error": err,
        "time_s": dt,
        "backend": device.type,
        # kernel B3 launches in rank 0's process during this run
        "launches": fa.block_update_launches - launches,
    }


def _run(q, k, v, causal, use_kernel, world_size, device, tol=2e-2, out_path=""):
    """The ring check over ``world_size`` ranks (default: one per card, one
    on the CPU) on full host arrays ``[B, T, H, D]``; every rank gets the
    same arrays."""
    device = resolve_device(device)
    if world_size is None:
        world_size = torch.cuda.device_count() if device.type == "cuda" else 1
    kwargs = dict(qkv=tuple(np.asarray(x, np.float32) for x in (q, k, v)), causal=causal,
                  use_kernel=use_kernel, tol=tol, out_path=out_path)
    if world_size == 1:
        return _ring_rank(0, 1, device, **kwargs)
    return _ranks.run(_ring_rank, world_size, device.type, **kwargs)


def ring_attention(q, k, v, causal: bool = True, use_kernel: bool = False,
                   world_size: Optional[int] = None, device=None) -> np.ndarray:
    """Ring attention of full host arrays ``[B, T, H, D]`` (values rounded
    to bf16) over ``world_size`` ranks, the sequence split evenly; returns
    the gathered output as f32 numpy."""
    with tempfile.TemporaryDirectory(prefix="ring-attention-") as tmp:
        path = os.path.join(tmp, "out.npy")
        _run(q, k, v, causal, use_kernel, world_size, device, out_path=path)
        return np.load(path)


def acceptance(
    batch: int = 1,
    seq_per_chip: int = 128,
    heads: int = 4,
    head_dim: int = 64,
    causal: bool = True,
    world_size: Optional[int] = None,
    tol: float = 2e-2,
    use_kernel: bool = False,
    device=None,
) -> dict:
    """Run ring attention over every local card (``world_size`` ranks on
    the CPU) and hold it against single-device attention on the whole
    sequence (bf16 tolerance).  The inputs are bf16 normals from seed 0,
    made on the host.  Returns the check-result dict (run_validation
    shape)."""
    device = resolve_device(device)
    n = world_size or (torch.cuda.device_count() if device.type == "cuda" else 1)
    q, k, v = bf16_normals((batch, seq_per_chip * n, heads, head_dim))
    return _run(q, k, v, causal, use_kernel, n, device, tol)


def bf16_normals(shape, seed: int = 0) -> tuple:
    """The attention checks' host inputs: three standard-normal draws from
    ``seed``, rounded to bf16, held in f32."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).bfloat16().float() for _ in range(3))


def quick_check(device=None) -> dict:
    """The validator's probe: the shipping shapes on kernel B3 on a card;
    tiny shapes on the CPU (where the wrapper takes the plain version)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return acceptance(seq_per_chip=512, head_dim=128, use_kernel=True, device=device)
    return acceptance(seq_per_chip=16, heads=2, head_dim=8, use_kernel=True, device=device)


def main() -> int:
    import json

    from tpu_operator_torch.validator import status as vstatus

    with flight.activate(flight.recorder_for(vstatus.flight_record_path())):
        result = quick_check()
        flight.record_result("ring-attention", result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
