"""Local multi-rank launcher: one process per local device.

The reference gate is one JAX program over all local chips (``shard_map``);
the port runs one rank per card instead, joined by ``torch.distributed``:
NCCL on the cards, gloo on the CPU (where the tests run four ranks).

- Ranks start from a fresh interpreter (``spawn``), so the launcher works
  from a process that already holds CUDA or threads.
- Rendezvous is a ``FileStore`` in a new directory under the caller's temp
  dir: parallel callers (pytest-xdist workers, concurrent gates) never share
  a port or a path.
- Every rank's process group times out after ``timeout_s``, and the parent
  stops waiting at the same deadline and kills what is left: a hung rank
  fails the check instead of hanging the pod.
- Rank 0's return value is the result; its flight samples come back with it
  and are replayed into the caller's recorder.
- Under a caller's tracer, ``run`` opens ``ranks.run`` and hands its context
  to the ranks, which trace only then: ``ranks.rank_start`` from the
  parent's ``start()`` of the rank to its first line (interpreter, imports,
  unpickling; the parent passes its stamp), ``ranks.rendezvous`` around
  ``set_device`` and ``init_process_group``, then whatever ``fn`` opens.
  Every rank's finished spans come back and are replayed into the caller's
  tracer.

``rotate`` is the ring hop every ring uses (ring-attention's K/V rotation,
the remat backward's K/V and dK/dV, the ring probe's payload): every rank
sends to its successor and receives from its predecessor, in the default
process group or in a subgroup (the transformer's mp ring).  ``all_to_all``
is the exchange of Ulysses' re-sharding and of the MoE dispatch and
return, differentiable.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch

from tpu_operator_torch.obs import flight, trace


def rotate(*blocks, group=None):
    """Pass each block one hop around the ring of ranks: send to rank + 1,
    receive from rank - 1, all posted together (a blocking send before the
    receive would deadlock).  Returns the received blocks.  The ring is
    ``group`` (its ranks in group order; the default process group when
    None), and every rank of it calls this."""
    import torch.distributed as dist

    rank, p = dist.get_rank(group), dist.get_world_size(group)
    nxt, prv = (rank + 1) % p, (rank - 1) % p
    if group is not None:  # the peers' global ranks
        nxt, prv = dist.get_global_rank(group, nxt), dist.get_global_rank(group, prv)
    received = [torch.empty_like(b) for b in blocks]
    ops = []
    for b, r in zip(blocks, received):
        ops.append(dist.P2POp(dist.isend, b, nxt, group=group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` over the leading axis, differentiable: the
    transpose of an all-to-all is the same all-to-all (slice i went to rank
    i, so its cotangent comes back from rank i)."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """The reference's untiled ``all_to_all`` (split and concat on axis 0)
    of a ``[p, ...]`` block over the default process group: slice i goes to
    rank i, and slice j of the result came from rank j.  Identity on one
    rank (no process group); every rank calls it."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    if x.shape[0] != dist.get_world_size():
        raise ValueError(f"all_to_all of {x.shape[0]} slices over {dist.get_world_size()} ranks")
    return _AllToAll.apply(x)


def _rank_main(fn, rank: int, world_size: int, device_type: str,
               workdir: str, timeout_s: float, spawned: float, traceparent: str) -> None:
    begun = time.monotonic()
    import torch.distributed as dist

    out = os.path.join(workdir, f"rank{rank}.json")
    ctx = trace.TraceContext.parse(traceparent)
    tracer = trace.Tracer() if ctx is not None else None
    try:
        with tracer.adopt(ctx) if tracer is not None else contextlib.nullcontext():
            if tracer is not None:
                tracer.record("ranks.rank_start", spawned, begun, rank=rank)
            # written by the parent that spawned this rank, just before
            with open(os.path.join(workdir, "kwargs.pkl"), "rb") as f:
                kwargs = pickle.load(f)
            with trace.span("ranks.rendezvous", rank=rank):
                if device_type == "cuda":
                    torch.cuda.set_device(rank)
                    device = torch.device("cuda", rank)
                    backend = "nccl"
                else:
                    # CPU ranks share the host's cores: one thread each
                    torch.set_num_threads(1)
                    device = torch.device("cpu")
                    backend = "gloo"
                dist.init_process_group(
                    backend,
                    init_method="file://" + os.path.join(workdir, "store"),
                    world_size=world_size,
                    rank=rank,
                    timeout=datetime.timedelta(seconds=timeout_s),
                )
            try:
                recorder = flight.FlightRecorder()  # in memory; shipped back below
                with flight.activate(recorder):
                    result = fn(rank, world_size, device, **kwargs)
                payload = {"result": result if rank == 0 else None,
                           "samples": recorder.samples if rank == 0 else []}
            finally:
                dist.destroy_process_group()
        if tracer is not None:
            payload["spans"] = tracer.spans()
            payload["spans_dropped"] = tracer.dropped
    except BaseException:  # noqa: BLE001 — reported to the parent, then re-raised
        payload = {"error": traceback.format_exc()[-4000:]}
        _write(out, payload)
        raise
    _write(out, payload)


def _write(path: str, payload: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)


def run(fn, world_size: int, device_type: str, timeout_s: float = 300.0, **kwargs) -> dict:
    """Run ``fn(rank, world_size, device, **kwargs)`` on ``world_size`` local
    ranks and return rank 0's result (a JSON-serializable dict).  ``fn`` must
    be a module-level function: it is sent to the ranks by import path.
    Raises RuntimeError when a rank fails or misses the deadline."""
    if device_type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(
            f"{world_size} ranks asked for but {torch.cuda.device_count()} cards visible"
        )
    with trace.span("ranks.run") as sp:
        traceparent = trace.current_traceparent() if sp is not None else ""
        payloads = _spawn(fn, world_size, device_type, timeout_s, kwargs, traceparent)
    # replayed under the caller's span, not ranks.run
    flight.replay(payloads[0]["samples"])
    for payload in payloads:
        trace.replay(payload.get("spans", []), payload.get("spans_dropped", 0))
    return payloads[0]["result"]


def _spawn(fn, world_size: int, device_type: str, timeout_s: float, kwargs: dict,
           traceparent: str) -> list:
    """Start the ranks, wait for them all, and return their payloads, rank
    by rank; raises RuntimeError when a rank fails or misses the deadline."""
    ctx = multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="tpu-ranks-")
    # the arguments go by file: through the spawn pipe, a payload above the
    # pipe's buffer holds each start() until that child has imported its
    # modules, which serializes the ranks' start-up
    with open(os.path.join(workdir, "kwargs.pkl"), "wb") as f:
        pickle.dump(kwargs, f)
    procs = []
    try:
        # each rank's start is stamped here, on the host's monotonic clock
        for rank in range(world_size):
            p = ctx.Process(
                target=_rank_main,
                args=(fn, rank, world_size, device_type, workdir, timeout_s, time.monotonic(),
                      traceparent),
                name=f"rank{rank}",
                daemon=True,
            )
            procs.append(p)
            p.start()
        deadline = time.monotonic() + timeout_s + 30.0  # + interpreter start
        pending = list(procs)
        # wait for every rank, but stop at the first failure: the others
        # would otherwise sit in a collective until their own timeout
        while pending and time.monotonic() < deadline:
            wait([p.sentinel for p in pending], deadline - time.monotonic())
            pending = [p for p in pending if p.is_alive()]
            if any(p.exitcode not in (None, 0) for p in procs):
                break
        stopped = [p.name for p in pending]
        for p in pending:
            p.kill()
            p.join(5.0)
        errors = []
        payloads = []
        for rank, p in enumerate(procs):
            try:
                with open(os.path.join(workdir, f"rank{rank}.json")) as f:
                    payloads.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                payloads.append({})
            if "error" in payloads[-1]:
                errors.append(f"rank {rank}: {payloads[-1]['error']}")
            elif p.exitcode != 0 and p.name not in stopped:
                errors.append(f"rank {rank}: exit code {p.exitcode}")
        if stopped:
            errors.insert(0, (
                f"{', '.join(stopped)} stopped after another rank failed" if errors
                else f"{', '.join(stopped)} did not finish within {timeout_s:g}s"
            ))
        if errors:
            raise RuntimeError(
                f"{world_size}-rank {device_type} run failed:\n" + "\n".join(errors)
            )
        return payloads
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
