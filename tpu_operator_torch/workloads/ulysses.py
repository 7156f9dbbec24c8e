"""Ulysses sequence parallelism on PyTorch: all-to-all attention over the
head axis.  Port of ``tpu_operator/workloads/ulysses.py``.

The second long-context strategy beside ring attention.  Where the ring
keeps the sequence sharded and passes K/V around p times, Ulysses
(DeepSpeed-Ulysses, Jacobs et al.) pays two all-to-alls: the first
re-shards [B, T/p, H, D] -> [B, T, H/p, D] (every rank trades sequence
blocks for whole heads), each rank runs plain full-sequence attention over
its H/p heads, and the second re-shards the output back to [B, T/p, H, D].
One rank per card (``_ranks``; NCCL on the cards, gloo on the CPU).

Attention per head is untouched, so the check holds the result against the
same single-device reference the ring uses.  The attention is the plain
``reference_attention``, as in the reference: no kernel lies on this path.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_operator_torch.obs import flight
from tpu_operator_torch.workloads import _ranks, resolve_device
from tpu_operator_torch.workloads.ring_attention import (
    _ring_group,
    bf16_normals,
    reference_attention,
)


def _seq_to_heads(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, T/p, H, D] -> [B, T, H/p, D]: head group i goes to rank i, and
    the blocks received line up along the sequence in source-rank order
    (the reference's tiled all-to-all, split axis 2, concat axis 1)."""
    b, t, h, d = x.shape
    groups = x.reshape(b, t, p, h // p, d).permute(2, 0, 1, 3, 4)  # [p, B, T/p, H/p, D]
    recv = _ranks.all_to_all(groups)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, p * t, h // p, d)


def _heads_to_seq(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, T, H/p, D] -> [B, T/p, H, D]: sequence block j goes to rank j,
    and the head groups received line up in source-rank order (split axis
    1, concat axis 2)."""
    b, t, hp, d = x.shape
    blocks = x.reshape(b, p, t // p, hp, d).permute(1, 0, 2, 3, 4)  # [p, B, T/p, H/p, D]
    recv = _ranks.all_to_all(blocks)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, t // p, p * hp, d)


def ulysses_attention_sharded(q, k, v, causal: bool) -> torch.Tensor:
    """The per-rank program: this rank's [B, T/p, H, D] blocks in (the
    sequence split over the default process group; one rank when there is
    none), its block of the output out.  Needs H % p == 0."""
    _, p = _ring_group()
    h = q.shape[2]
    if h % p:
        raise ValueError(f"ulysses needs heads ({h}) divisible by axis size ({p})")
    qh, kh, vh = (_seq_to_heads(x, p) for x in (q, k, v))
    out = reference_attention(qh, kh, vh, causal)  # the full sequence, H/p heads
    return _heads_to_seq(out.to(q.dtype), p)


def _ulysses_rank(rank: int, n: int, device: torch.device, qkv, causal: bool, tol: float,
                  out_path: str = "") -> dict:
    """One rank of the check: slice my sequence block of the full host
    inputs, run Ulysses, hold my rows against the single-device reference;
    the max error is the max over every rank.  With ``out_path``, rank 0
    saves the gathered output there (.npy, f32)."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).to(device) for x in qkv)
    b, t, h, d = q.shape
    if t % n:
        raise ValueError(f"sequence {t} does not split over {n} ranks")
    block = t // n
    rows = slice(rank * block, (rank + 1) * block)
    q_s, k_s, v_s = (x[:, rows].contiguous() for x in (q, k, v))

    t0 = time.perf_counter()
    out = ulysses_attention_sharded(q_s, k_s, v_s, causal)
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
    flight.record("ulysses", "run", step_s=dt, seq=t, max_error=err)
    return {
        "ok": bool(np.isfinite(err) and err < tol),
        "devices": n,
        "seq": t,
        "seq_per_chip": block,
        "heads": h,
        "head_dim": d,
        "causal": causal,
        "strategy": "ulysses-all-to-all",
        "max_error": err,
        "time_s": dt,
        "backend": device.type,
    }


def _run(q, k, v, causal, world_size, device, tol=2e-2, out_path=""):
    """The check over ``world_size`` ranks on full host arrays [B, T, H, D];
    every rank gets the same arrays."""
    kwargs = dict(qkv=tuple(np.asarray(x, np.float32) for x in (q, k, v)), causal=causal,
                  tol=tol, out_path=out_path)
    if world_size == 1:
        return _ulysses_rank(0, 1, device, **kwargs)
    return _ranks.run(_ulysses_rank, world_size, device.type, **kwargs)


def ulysses_attention(q, k, v, causal: bool = True, world_size: Optional[int] = None,
                      device=None) -> np.ndarray:
    """Ulysses attention of full host arrays [B, T, H, D] (values rounded to
    bf16) over ``world_size`` ranks, the sequence split evenly; returns the
    gathered output as f32 numpy."""
    device = resolve_device(device)
    n = world_size or (torch.cuda.device_count() if device.type == "cuda" else 1)
    with tempfile.TemporaryDirectory(prefix="ulysses-") as tmp:
        path = os.path.join(tmp, "out.npy")
        _run(q, k, v, causal, n, device, out_path=path)
        return np.load(path)


def acceptance(
    batch: int = 1,
    seq_per_chip: int = 128,
    heads: int = 8,
    head_dim: int = 64,
    causal: bool = True,
    world_size: Optional[int] = None,
    tol: float = 2e-2,
    device=None,
) -> dict:
    """Ulysses attention over every local card (``world_size`` ranks on the
    CPU) against single-device attention on the whole sequence (bf16
    tolerance).  The inputs are bf16 normals from seed 0, made on the host.
    Returns the check-result dict (run_validation shape)."""
    device = resolve_device(device)
    n = world_size or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if heads % n:
        # runnable on any card count: round the heads up to a multiple of
        # the axis (the result reports the count used), as the reference
        heads = ((heads + n - 1) // n) * n
    q, k, v = bf16_normals((batch, seq_per_chip * n, heads, head_dim))
    return _run(q, k, v, causal, n, device, tol)


def quick_check(device=None) -> dict:
    """The validator's probe: the reference's shipping shape on the cards
    (512 tokens per card, 8 heads of 128, bf16); tiny shapes on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return acceptance(seq_per_chip=512, head_dim=128, device=device)
    return acceptance(seq_per_chip=16, heads=8, head_dim=8, device=device)


def main() -> int:
    import json

    from tpu_operator_torch.validator import status as vstatus

    with flight.activate(flight.recorder_for(vstatus.flight_record_path())):
        result = quick_check()
        flight.record_result("ulysses", result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
