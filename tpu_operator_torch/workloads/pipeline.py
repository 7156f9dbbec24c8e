"""Pipeline parallelism on PyTorch: GPipe-style microbatch streaming over a
chain of ranks.  Port of ``tpu_operator/workloads/pipeline.py``.

Each rank (one per card, ``_ranks``; NCCL on the cards, gloo on the CPU)
owns one stage's weights.  Microbatches stream through the pipe with one
hop per tick carrying activations to the next stage, a chain with no
wrap-around: M + p - 1 ticks fill and drain it, and the bubble fraction
(p - 1)/(M + p - 1) shrinks as the microbatches grow.

Every rank runs the same tick loop, as the reference's single SPMD scan:
stage 0 is fed microbatch t (clamped), the others take what the last hop
delivered, and the last stage lands finished microbatches in its output
buffer.  A final sum over the ranks replicates the output; only the last
stage's buffer is non-zero.

The pipe is differentiable: the hop's backward (``_Hop``) sends the
gradient one stage back, and the final sum's backward passes the gradient
through unchanged, since every rank already holds the whole cotangent of
the replicated output (JAX's transpose of that ``psum``).  The output slots
of every stage stay in the autograd graph, masked to zero off the last
stage, so every rank runs every hop's backward in the same order.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_operator_torch.obs import flight
from tpu_operator_torch.workloads import _ranks, resolve_device
from tpu_operator_torch.workloads.collectives import _RowParallelSum
from tpu_operator_torch.workloads.ring_attention import _ring_group


def stage_fn(x, w1, w2):
    """One pipeline stage: a residual relu MLP on an f32 carry.  The input
    is rounded to bf16 and the products run in the weights' dtype, as JAX
    promotes them: bf16 weights give bf16 products, and the reference's f32
    weights (``pipeline_params``) lift the rounded input to f32."""
    h = torch.relu(x.to(torch.bfloat16).to(w1.dtype) @ w1)
    return x + (h.to(w2.dtype) @ w2).float()


def _chain_exchange(send: torch.Tensor, forward: bool, group=None) -> Optional[torch.Tensor]:
    """Post this rank's send and receive of one chain hop together: forward
    sends ``send`` to the next stage and receives from the previous one,
    backward the reverse.  The chain is ``group`` (its ranks in group order;
    the default process group when None).  Returns the received tensor, or
    None at the chain's end."""
    s, p = _ring_group(group)
    dst, src = (s + 1, s - 1) if forward else (s - 1, s + 1)
    recv = torch.empty_like(send) if 0 <= src < p else None

    def peer(r):  # P2POp takes global ranks
        return r if group is None else dist.get_global_rank(group, r)

    ops = []
    if 0 <= dst < p:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), peer(dst), group=group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, peer(src), group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


class _Hop(torch.autograd.Function):
    """One tick's hop along the chain ``group`` (the default process group
    when None): ``y`` goes to the next stage; returns what the previous
    stage sent, or ``feed`` on stage 0 (the next microbatch).  The backward
    sends the gradient of what was received one stage back and receives
    ``y``'s gradient from the next stage (zero on the last)."""

    @staticmethod
    def forward(ctx, y, feed, group=None):
        ctx.group = group
        recv = _chain_exchange(y, True, group)
        return feed.clone() if recv is None else recv

    @staticmethod
    def backward(ctx, grad):
        dy = _chain_exchange(grad, False, ctx.group)
        first = _ring_group(ctx.group)[0] == 0
        return (torch.zeros_like(grad) if dy is None else dy), (grad if first else None), None


def pipeline_sharded(x, w1, w2) -> torch.Tensor:
    """The per-rank pipe: ``x`` [M, mb, D] the microbatches (the same on
    every rank), ``w1``/``w2`` this stage's weights, the stage this rank's
    index in the default process group (one stage when there is none).
    Returns the pipe's output [M, mb, D] on every rank after M + p - 1
    ticks."""
    s, p = _ring_group()
    m = x.shape[0]
    ticks = m + p - 1
    last = float(s == p - 1)  # the output mask: only the last stage lands
    x_cur = x[0] if s == 0 else torch.zeros_like(x[0])
    slots = []
    for t in range(ticks):
        y = stage_fn(x_cur, w1, w2)
        if t >= p - 1:  # microbatch t - (p - 1) leaves the last stage
            slots.append(y * last)
        if t + 1 < ticks:  # the last tick's hop would carry nothing used
            x_cur = _Hop.apply(y, x[min(t + 1, m - 1)])
    # replicate: every stage but the last contributed zeros.  The sum's
    # backward passes the gradient through unchanged (every rank holds the
    # whole cotangent of the replicated output, as under JAX's transpose of
    # that psum); summing it again would scale every weight gradient by p
    return _RowParallelSum.apply(torch.stack(slots), None, p)


def pipeline_params(p: int, d_model: int = 64, d_hidden: int = 128, seed: int = 0) -> tuple:
    """Every stage's weights, host arrays (w1 [p, D, H], w2 [p, H, D]):
    bf16-rounded normals from ``default_rng(seed)`` times 1/sqrt(d_model),
    f32 as the reference's are (its bf16 draws times a numpy float64 scale
    promote to f32)."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / np.sqrt(d_model))

    def draw(shape):
        t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return t.bfloat16().float().numpy() * scale

    return draw((p, d_model, d_hidden)), draw((p, d_hidden, d_model))


def pipeline_params_from_jax(w1, w2, rank: int, device="cpu") -> tuple:
    """Stage ``rank``'s weights from every stage's host weights (the
    reference's ``pipeline_params``, or this module's), in their dtype
    (bf16 stays bf16, anything else becomes f32) on ``device``."""
    def put(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX hands it over
            return torch.from_numpy(a.astype(np.float32)).bfloat16().to(device)
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)

    return put(w1[rank]), put(w2[rank])


def _sequential(x, w1, w2, device) -> torch.Tensor:
    """The truth: every stage applied in turn on one device, microbatch by
    microbatch, so each product has the pipe's [mb, D] shape (cuBLAS picks
    its kernel by shape: the same shapes give the same rounding)."""
    stages = [pipeline_params_from_jax(w1, w2, i, device) for i in range(w1.shape[0])]
    outs = []
    for h in x:
        for sw1, sw2 in stages:
            h = stage_fn(h, sw1, sw2)
        outs.append(h)
    return torch.stack(outs)


def _pipeline_rank(rank: int, n: int, device: torch.device, microbatches: int,
                   microbatch: int, d_model: int, d_hidden: int, tol: float) -> dict:
    """One stage of the check: the pipe against the sequential stack on the
    same weights and inputs; the max error is the max over every rank."""
    # the stages' products are f32 (the reference's weights) and the bound
    # 1e-3: full f32 on the card, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    w1, w2 = pipeline_params(n, d_model, d_hidden)
    x = np.random.default_rng(5).standard_normal((microbatches, microbatch, d_model),
                                                 dtype=np.float32)
    x = torch.from_numpy(x).to(device)
    sw1, sw2 = pipeline_params_from_jax(w1, w2, rank, device)

    t0 = time.perf_counter()
    out = pipeline_sharded(x, sw1, sw2)
    ref = _sequential(x, w1, w2, device)
    err = (out - ref).abs().max()
    if n > 1:
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
    err = float(err)  # the readback waits for the card
    dt = time.perf_counter() - t0
    flight.record("pipeline", "run", step_s=dt, max_error=err)
    return {
        "ok": bool(np.isfinite(err) and err < tol),
        "devices": n,
        "stages": n,
        "microbatches": microbatches,
        "ticks": microbatches + n - 1,
        "bubble_fraction": round((n - 1) / (microbatches + n - 1), 4),
        "strategy": "pp-gpipe-microbatch",
        "max_error": err,
        "time_s": dt,
        "backend": device.type,
    }


def acceptance(
    microbatches: int = 8,
    microbatch: int = 4,
    d_model: int = 32,
    d_hidden: int = 64,
    world_size: Optional[int] = None,
    tol: float = 1e-3,
    device=None,
) -> dict:
    """The pipe over every local card (``world_size`` ranks on the CPU)
    against applying every stage in turn on one device: the same weights,
    the same math, M + p - 1 ticks of streaming in between.  Returns the
    check-result dict (run_validation shape)."""
    device = resolve_device(device)
    n = world_size or (torch.cuda.device_count() if device.type == "cuda" else 1)
    kwargs = dict(microbatches=microbatches, microbatch=microbatch, d_model=d_model,
                  d_hidden=d_hidden, tol=tol)
    if n == 1:
        return _pipeline_rank(0, 1, device, **kwargs)
    return _ranks.run(_pipeline_rank, n, device.type, **kwargs)


def quick_check(device=None) -> dict:
    """The validator's probe: the reference's shipping size on the cards
    (the chain hops under streamed compute); its CPU defaults on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return acceptance(microbatches=16, microbatch=64, d_model=512, d_hidden=2048,
                          device=device)
    return acceptance(device=device)


def main() -> int:
    import json

    from tpu_operator_torch.validator import status as vstatus

    with flight.activate(flight.recorder_for(vstatus.flight_record_path())):
        result = quick_check()
        flight.record_result("pipeline", result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
