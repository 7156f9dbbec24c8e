"""The readiness gate's checks on PyTorch (vector-add, allreduce benchmark,
sharded burn-in), the ring probe, and the flagship transformer layer's train
step alone and as a pipelined stack.  Port of ``tpu_operator/workloads/
collectives.py``.

- ``device_count_check``  — cards CUDA initialized vs the promised count
- ``vector_add``          — single-card sanity through the hand-written CUDA
                            kernel (``kernels/vector_add.py``)
- ``allreduce_benchmark`` — a chain of NCCL all-reduces over every local
                            card; achieved algbw/busbw GB/s
- ``burn_in``             — a (dp, mp)-sharded MLP trained for a few SGD
                            steps: cuBLAS matmuls plus the mp row-parallel
                            all-reduce and the dp gradient all-reduce
- ``ring_benchmark``      — every card's buffer passed around the ring of
                            cards over NCCL send/recv, each hop's payload
                            verified exactly; per-link GB/s
- ``transformer_burn_in`` — one pre-norm transformer layer trained for a few
                            SGD steps over the (dp, mp) mesh: ring-remat
                            attention over mp (kernels B3 and B4 on a card),
                            the Megatron-SP MLP, exact gradients of the
                            global loss
- ``transformer_pipeline_burn_in`` — the GPipe stack of such layers over the
                            (pp, dp, mp) mesh (``make_mesh3``), one layer
                            per pp stage, microbatches handed on over the
                            pp chain

The reference runs one program over all local chips; here every local card
is one rank (``_ranks``), and with one card the check runs in-process with no
process group.  Functions take ``world_size=`` where the reference takes
``devices=``; on the CPU the ranks use gloo.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_operator_torch.kernels.vector_add import vector_add_kernel
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import profile as obs_profile
from tpu_operator_torch.obs import trace
from tpu_operator_torch.workloads import _ranks, resolve_device, ring_attention, timing


# gloo ranks a process runs on the CPU, the counterpart of the reference's
# --xla_force_host_platform_device_count virtual devices (the multi-host
# program's hosts and the partition acceptance's units set it)
CPU_RANKS_ENV = "DIST_CPU_RANKS"


def local_world_size(device: torch.device) -> int:
    """Ranks a check runs on by default: one per visible card; DIST_CPU_RANKS
    (default 1) on the CPU (tests also ask for more with ``world_size``)."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return int(os.environ.get(CPU_RANKS_ENV, "1") or 1)


def _sum(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """In-place sum over ``group`` (identity for an axis of size 1)."""
    if size > 1:
        dist.all_reduce(t, group=group)
    return t


# ---------------------------------------------------------------------------
# device-count truth


def device_count_check(
    expected_local: int,
    num_processes: int = 1,
    world_size: Optional[int] = None,
    device=None,
) -> dict:
    """Assert the devices the runtime actually initialized match what the
    node (or the pod's resource request) promised: a node with a dead card
    must fail here with the counts, not pass every check on the survivors.

    Visible is ``torch.cuda.device_count()`` on a card and the rank count
    (``world_size``, default ``local_world_size``) on the CPU; the global
    count is the initialized process group's size (the multi-host program's
    world), else the local count.  Enforced only on backends named
    in ``DEVICE_COUNT_GATE_BACKENDS`` (default cuda — the CPU rank count is a
    test-harness knob, not hardware truth); unenforced runs still report."""
    device = resolve_device(device)
    if device.type == "cuda":
        visible_local = torch.cuda.device_count()
    else:
        visible_local = world_size or local_world_size(device)
    # every host's ranks when a rendezvous joined them; one host otherwise
    visible_global = dist.get_world_size() if dist.is_initialized() else visible_local
    expected_global = expected_local * max(1, num_processes)
    backend = device.type
    gated = backend in timing.gate_backends("DEVICE_COUNT_GATE_BACKENDS")
    matches = visible_local == expected_local and visible_global == expected_global
    result = {
        "ok": matches or not gated,
        "visible": visible_local,
        "expected": expected_local,
        "visible_global": visible_global,
        "expected_global": expected_global,
        "gated": gated,
        "backend": backend,
    }
    if not matches:
        result["error"] = (
            f"{backend} initialized {visible_local} local / {visible_global} global "
            f"devices but the node advertises {expected_local} local / "
            f"{expected_global} global — dead or missing cards"
        )
    return result


# ---------------------------------------------------------------------------
# vector add (CUDA kernel)


def vector_add(n: int = 1 << 20, seed: int = 0, device=None) -> dict:
    """CUDA vectorAdd analogue; returns {'ok', 'n', 'max_error', 'backend'}.

    The same host-generated numpy inputs as the reference (``default_rng
    (seed)``, f32 ``(n // 512, 512)``); the kernel's output is held against
    the framework's own ``x + y``."""
    device = resolve_device(device)
    cols = 512
    rows = max(8, n // cols)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, cols), dtype=np.float32)).to(device)
    y = torch.from_numpy(rng.standard_normal((rows, cols), dtype=np.float32)).to(device)
    out = vector_add_kernel(x, y)
    err = float((out - (x + y)).abs().max())  # the readback waits for the kernel
    return {"ok": err < 1e-5, "n": rows * cols, "max_error": err, "backend": device.type}


# ---------------------------------------------------------------------------
# allreduce bandwidth


def allreduce_benchmark(
    size_mb: float = 64.0,
    iters: int = 10,
    warmup: int = 2,
    world_size: Optional[int] = None,
    best_of: int = 3,
    device=None,
) -> dict:
    """All-reduce a bf16 buffer across all local cards; report achieved
    algbw GB/s.

    algbw = size / t and busbw = algbw * 2*(n-1)/n, with ``size`` the global
    buffer (all ranks' shards) as the reference counts it: n times the
    NCCL-tests algbw of the per-rank message.  Methodology as the reference:
    ``iters`` collectives per timed repetition ending in one scalar readback
    and a device synchronize, a null-program floor (the same reduction and
    readback, no chain) subtracted, ``best_of`` repetitions with min/median
    reported."""
    device = resolve_device(device)
    n = world_size or local_world_size(device)
    kwargs = dict(size_mb=size_mb, iters=iters, warmup=warmup, best_of=best_of)
    if n == 1:
        return _allreduce_rank(0, 1, device, **kwargs)
    return _ranks.run(_allreduce_rank, n, device.type, **kwargs)


def _allreduce_rank(
    rank: int, n: int, device: torch.device,
    size_mb: float, iters: int, warmup: int, best_of: int,
) -> dict:
    elems_per_dev = max(1, int(size_mb * 1024 * 1024 / 2 / n))  # bf16 = 2 bytes
    elems_per_dev = (elems_per_dev + 127) // 128 * 128  # as the reference pads
    global_elems = elems_per_dev * n
    x = torch.ones(elems_per_dev, dtype=torch.bfloat16, device=device)

    def global_max(err: torch.Tensor) -> float:
        # the worst shard decides, as the reference's max over the global
        # array; the readback waits for the device
        if n > 1:
            dist.all_reduce(err, op=dist.ReduceOp.MAX)
        return float(err)

    def chain_err() -> float:
        s = x.clone()  # the chain works in place; the input stays all ones
        if n > 1:
            # value stays exactly 1.0 every round: sum -> n, /n -> 1
            for _ in range(iters):
                dist.all_reduce(s)
                s.div_(n)
            expected = 1.0
        else:
            # a single card moves no link traffic; accumulate so each round
            # is a real HBM read+write (reported as hbm-local, never gated)
            for _ in range(iters):
                s = s + 1
            expected = 1.0 + iters
        out = s - (expected - 1.0)  # normalize back to ones
        return global_max((out.float() - 1.0).abs().max())

    def baseline() -> float:
        # launch + readback floor: same reduction, no chain
        return global_max((x.float() - 1.0).abs().max())

    baseline()  # first-use setup out of the floor
    # floor is min of 3: one noisy sample must not over-subtract
    overhead = min(timing.timed(baseline, device) for _ in range(3))

    # first chain carries first-use setup (NCCL communicators when n > 1),
    # the counterpart of the reference's compile sample
    compile_s = timing.timed(chain_err, device)
    flight.record("allreduce", "compile", compile_s=compile_s)
    for _ in range(max(1, warmup) - 1):
        chain_err()
    raw = []
    max_err = 0.0
    size_bytes = global_elems * 2
    for rep in range(best_of):
        timing.sync(device)
        t0 = time.perf_counter()
        # worst error across ALL reps: a corrupt repetition must fail the
        # check even when a later one is clean
        max_err = max(max_err, chain_err())
        timing.sync(device)
        raw.append(time.perf_counter() - t0)
        flight.record(
            "allreduce", "step", step=rep,
            step_s=raw[-1],
            # amortized per-collective rate, floor NOT subtracted
            gbps=size_bytes * iters / raw[-1] / 1e9,
        )
        flight.record_step(
            "allreduce", step_seq=rep, wall_s=raw[-1],
            phases={obs_profile.PHASE_COLLECTIVE_WAIT: raw[-1]},
        )
    times, overhead_dominated = timing.subtract_floor(raw, overhead, per=iters)
    dt = times[0]
    dt_median = times[len(times) // 2]

    algbw = size_bytes / dt / 1e9
    busbw = algbw * (2 * (n - 1) / n) if n > 1 else algbw
    return {
        "ok": max_err < 0.1,
        "devices": n,
        "size_mb": size_bytes / 1e6,
        "time_ms": dt * 1e3,
        "time_ms_median": dt_median * 1e3,
        "overhead_ms": overhead * 1e3,
        "overhead_dominated": overhead_dominated,
        "best_of": best_of,
        "algbw_gbps": algbw,
        "algbw_gbps_median": size_bytes / dt_median / 1e9,
        "busbw_gbps": busbw,
        "max_error": max_err,
        # n=1 moves no card-to-card traffic: the number is an HBM copy
        # rate, never gated or reported as a link bandwidth
        "transport": "nvlink" if n > 1 else "hbm-local",
        "backend": device.type,
    }


def apply_allreduce_gate(result: dict, min_gbps: float) -> dict:
    """The allreduce gate (shared rule: timing.apply_min_gate): gates busbw
    over a real card-to-card interconnect only."""
    return timing.apply_min_gate(
        result, metric="busbw_gbps", minimum=min_gbps,
        backends_env="ALLREDUCE_GATE_BACKENDS", label="busbw",
        require_interconnect=True,
    )


# ---------------------------------------------------------------------------
# ring exchange (per-link diagnostic)


def ring_payload(n: int) -> list:
    """The value each rank sends around the ring, as it rides it: 1 + rank
    rounded to bf16 (integers above 256 are not bf16-exact, so the expected
    sums are computed from the rounded values)."""
    ranks = torch.arange(1, n + 1, dtype=torch.float32)
    return ranks.to(torch.bfloat16).float().tolist()


def ring_benchmark(
    size_mb: float = 16.0,
    iters: int = 4,
    best_of: int = 3,
    world_size: Optional[int] = None,
    device=None,
) -> dict:
    """Pass the cards' buffers around the full ring and verify every hop's
    payload: the per-LINK diagnostic the global all-reduce cannot give.

    Each rank's buffer visits every other rank in order, and the f32 sum it
    accumulates is exact only if EVERY link carried its payload intact.  The
    rate is per hop and bottlenecked by the slowest link (every link moves
    at each hop).  One rank per card; each hop posts its send and its
    receive together (``batch_isend_irecv``).  Methodology as the reference:
    ``iters`` revolutions per timed repetition ending in one readback, the
    floor (the error's reduction and readback, no ring) subtracted,
    best-of-N."""
    device = resolve_device(device)
    n = world_size or local_world_size(device)
    if n == 1:
        return {
            "ok": True,
            "devices": 1,
            "skipped": "single card: no ring",
            "transport": "hbm-local",
            "backend": device.type,
        }
    values = ring_payload(n)
    return _ranks.run(
        _ring_rank, n, device.type, size_mb=size_mb, iters=iters, best_of=best_of,
        values=values, distinct_total=float(sum(values)),
    )


def _ring_rank(
    rank: int, n: int, device: torch.device,
    size_mb: float, iters: int, best_of: int, values: list, distinct_total: float,
) -> dict:
    """One rank of the ring: it sends ``values[rank]`` and expects its
    accumulator to hold ``distinct_total`` minus its own payload."""
    elems_per_dev = max(128, int(size_mb * 1024 * 1024 / 2 / n))
    elems_per_dev = (elems_per_dev + 127) // 128 * 128
    # the ring payload is bf16 (the bandwidth under test); the accumulator
    # f32, so rank sums stay exact (bf16 integers are exact only to 256)
    x = torch.full((elems_per_dev,), values[rank], dtype=torch.bfloat16, device=device)
    expected = distinct_total - x.float()

    def ring() -> torch.Tensor:
        buf, acc = x, None
        for _ in range(iters):
            # n-1 accumulating hops sum every other rank's buffer; the
            # completing n-th hop brings mine home for the next revolution
            acc = torch.zeros(elems_per_dev, dtype=torch.float32, device=device)
            for _ in range(n - 1):
                (buf,) = _ranks.rotate(buf)
                acc += buf.float()
            (buf,) = _ranks.rotate(buf)
        return acc

    def err(acc: torch.Tensor) -> float:
        # the worst rank decides; one corrupted hop breaks the equality
        e = (acc - expected).abs().max()
        dist.all_reduce(e, op=dist.ReduceOp.MAX)
        return float(e)

    t_first = time.perf_counter()
    acc0 = ring()  # first use: the NCCL send/recv set-up
    err(acc0)
    flight.record("ring", "compile", compile_s=time.perf_counter() - t_first)
    # floor: the same reduction and readback on a finished accumulator
    floor = min(timing.timed(lambda: err(acc0), device) for _ in range(max(2, best_of)))
    raw = []
    max_err = 0.0
    hop_bytes = elems_per_dev * 2  # bf16 per rank per hop
    for rep in range(best_of):
        timing.sync(device)
        t0 = time.perf_counter()
        max_err = max(max_err, err(ring()))
        raw.append(time.perf_counter() - t0)
        flight.record(
            "ring", "step", step=rep, step_s=raw[-1],
            gbps=hop_bytes * iters * n / raw[-1] / 1e9,
        )
        flight.record_step(
            "ring", step_seq=rep, wall_s=raw[-1],
            phases={obs_profile.PHASE_COLLECTIVE_WAIT: raw[-1]},
        )
    # per-hop time: iters revolutions x n hops each (n-1 accumulating + 1
    # completing)
    times, overhead_dominated = timing.subtract_floor(raw, floor, per=iters * n)
    return {
        # integer payloads, f32 accumulation: the equality is exact by
        # construction, so ANY deviation is a corrupted hop
        "ok": max_err == 0.0,
        "devices": n,
        "size_mb": hop_bytes * n / 1e6,
        "hops": iters * n,
        "hop_ms": times[0] * 1e3,
        "overhead_ms": floor * 1e3,
        "overhead_dominated": overhead_dominated,
        "link_gbps": hop_bytes / times[0] / 1e9,
        "link_gbps_median": hop_bytes / times[len(times) // 2] / 1e9,
        "max_error": max_err,
        "transport": "nvlink",
        "backend": device.type,
    }


def apply_ring_gate(result: dict, min_gbps: float) -> dict:
    """RING_MIN_GBPS gate on the per-link rate (shared rule:
    timing.apply_min_gate; never on a skipped single-card result)."""
    return timing.apply_min_gate(
        result, metric="link_gbps", minimum=min_gbps,
        backends_env="RING_GATE_BACKENDS", label="ring link",
        require_interconnect=True,
    )


# ---------------------------------------------------------------------------
# sharded burn-in (slice acceptance test)


def _split_dp_mp(n: int) -> tuple:
    """(dp, mp) factorization of n cards — both axes populated when
    possible; mp gets the larger factor."""
    if n == 1:
        mp = 1
    elif n % 4 == 0 and n > 4:
        mp = 4
    elif n % 2 == 0 and n > 2:
        mp = 2
    else:
        mp = n
    return n // mp, mp


@dataclass
class Mesh:
    """This rank's place in the (dp, mp) mesh, or in the (pp, dp, mp) mesh
    when ``pp`` is set.  Rank r sits at ``(s·dp + i)·mp + j``, the row-major
    layout of the reference's ``devices.reshape(pp, dp, mp)`` (s = 0 on the
    2-D mesh); the groups are None for an in-process mesh of one."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    dp_group: Optional[object] = None  # ranks with my (pp,) mp index: gradient mean
    mp_group: Optional[object] = None  # ranks with my (pp,) dp index: row-parallel sum
    pp: Optional[int] = None
    pp_group: Optional[object] = None     # ranks with my dp and mp indices: the stage chain
    stage_group: Optional[object] = None  # the dp x mp ranks of my stage

    @property
    def size(self) -> int:
        return (self.pp or 1) * self.dp * self.mp

    @property
    def coords(self) -> tuple:
        """(i, j), or (s, i, j) on the 3-D mesh."""
        s, r = divmod(self.rank, self.dp * self.mp)
        i, j = divmod(r, self.mp)
        return (i, j) if self.pp is None else (s, i, j)

    @property
    def shape(self) -> dict:
        if self.pp is None:
            return {"dp": self.dp, "mp": self.mp}
        return {"pp": self.pp, "dp": self.dp, "mp": self.mp}


def make_mesh(world_size: int = 1, rank: int = 0, device=None, shape=None) -> Mesh:
    """2-D (dp, mp) mesh over ``world_size`` ranks, of ``shape`` (dp, mp)
    when given, else ``_split_dp_mp``'s.  Above one rank it must run inside
    an initialized process group of that size, on every rank (``new_group``
    is collective)."""
    device = resolve_device(device)
    dp, mp = shape or _split_dp_mp(world_size)
    if dp * mp != world_size:
        raise ValueError(f"mesh {dp}x{mp} over {world_size} ranks")
    mesh = Mesh(dp, mp, rank, device)
    if world_size == 1:
        return mesh
    if not dist.is_initialized() or dist.get_world_size() != world_size:
        raise RuntimeError(f"make_mesh({world_size}) needs a process group of that size")
    # every rank creates every group, in the same order
    for i in range(dp):
        group = dist.new_group([i * mp + j for j in range(mp)])
        if i == rank // mp:
            mesh.mp_group = group
    for j in range(mp):
        group = dist.new_group([i * mp + j for i in range(dp)])
        if j == rank % mp:
            mesh.dp_group = group
    return mesh


def _split_pp(n: int) -> tuple:
    """The reference's ``make_mesh3`` shape of n cards: pp 2 from four
    cards up (n even), dp and mp of the rest as ``_split_dp_mp``."""
    pp = 2 if n % 2 == 0 and n >= 4 else 1
    return (pp, *_split_dp_mp(n // pp))


def make_mesh3(world_size: int = 1, rank: int = 0, device=None, shape=None) -> Mesh:
    """3-D (pp, dp, mp) mesh over ``world_size`` ranks, of ``shape`` when
    given, else ``_split_pp``'s: (1, 1, 1) at 1 rank, (1, 1, 2) at 2,
    (2, 1, 2) at 4, (2, 2, 2) at 8.  Above one rank every group exists, one
    of a single rank too (a ring or chain of one never reaches the default
    group), and it must run inside an initialized process group of that
    size, on every rank."""
    device = resolve_device(device)
    pp, dp, mp = shape or _split_pp(world_size)
    if pp * dp * mp != world_size:
        raise ValueError(f"mesh {pp}x{dp}x{mp} over {world_size} ranks")
    mesh = Mesh(dp, mp, rank, device, pp=pp)
    if world_size == 1:
        return mesh
    if not dist.is_initialized() or dist.get_world_size() != world_size:
        raise RuntimeError(f"make_mesh3({world_size}) needs a process group of that size")

    def at(s, i, j):
        return (s * dp + i) * mp + j

    me = mesh.coords
    # every rank creates every group, in the same order
    for s in range(pp):
        for i in range(dp):
            group = dist.new_group([at(s, i, j) for j in range(mp)])
            if (s, i) == me[:2]:
                mesh.mp_group = group
    for s in range(pp):
        for j in range(mp):
            group = dist.new_group([at(s, i, j) for i in range(dp)])
            if (s, j) == (me[0], me[2]):
                mesh.dp_group = group
    for i in range(dp):
        for j in range(mp):
            group = dist.new_group([at(s, i, j) for s in range(pp)])
            if (i, j) == me[1:]:
                mesh.pp_group = group
    for s in range(pp):
        group = dist.new_group([at(s, i, j) for i in range(dp) for j in range(mp)])
        if s == me[0]:
            mesh.stage_group = group
    return mesh


def params_from_jax(w1: np.ndarray, w2: np.ndarray, mesh: Mesh) -> dict:
    """This rank's shard of full host weights (the JAX burn-in's, or any
    ``(d_model, d_hidden)`` / ``(d_hidden, d_model)`` pair), in the
    Megatron layout: W1 column-, W2 row-parallel over mp.

    Stored f32, as the reference's are: its bf16 normal draws times a numpy
    float64 scale promote to float32 under JAX's rules, so its burn-in
    weights, matmuls and updates are all float32."""
    d_hidden = w1.shape[1]
    if d_hidden % mesh.mp or w2.shape[0] != d_hidden:
        raise ValueError(f"d_hidden {d_hidden} does not split over mp={mesh.mp}")
    h = d_hidden // mesh.mp
    j = mesh.coords[-1]

    return {"w1": _put(w1[:, j * h:(j + 1) * h], mesh), "w2": _put(w2[j * h:(j + 1) * h, :], mesh)}


def _put(a: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """A private f32 copy of a host array on the mesh's device (bf16 inputs
    convert exactly)."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(mesh.device)


def _burn_in_weights(d_model: int, d_hidden: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / np.sqrt(d_model))
    w1 = rng.standard_normal((d_model, d_hidden), dtype=np.float32) * scale
    w2 = rng.standard_normal((d_hidden, d_model), dtype=np.float32) * scale
    return w1, w2


def burn_in_params(mesh: Mesh, d_model: int = 512, d_hidden: int = 2048, seed: int = 0) -> dict:
    """Two-layer MLP block params from ``seed``, mp-sharded (Megatron
    layout: the block needs exactly one row-parallel sum)."""
    return params_from_jax(*_burn_in_weights(d_model, d_hidden, seed), mesh)


class _RowParallelSum(torch.autograd.Function):
    """Sum of the row-parallel partial outputs over mp (and of the pipe's
    stage outputs, ``pipeline.py``).  The backward is the identity: the
    reference's ``psum`` under ``shard_map`` turns the partials into one
    value every shard holds, and its transpose hands that value's cotangent
    to each partial unchanged (summing it again would scale the gradient by
    the group's size)."""

    @staticmethod
    def forward(ctx, y, group, size):
        return _sum(y.clone(), group, size)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def burn_in_step(
    mesh: Mesh, params: dict, x: torch.Tensor, lr: float = 0.05
) -> tuple:
    """One SGD step on this rank: its dp shard of the batch through its mp
    shard of the MLP, gradients reduced over dp, each mp shard updating its
    own slice.  The casts follow the reference: the batch rounded to bf16,
    then matmuls, loss and update in the weights' f32.  Returns
    ``(loss, new_params)``, the loss averaged over dp.

    The gradient is the SUM of the dp shards' gradients, as the reference
    computes it: there ``value_and_grad`` of the dp-replicated weights
    already sums over dp (the transpose of their broadcast under
    ``shard_map``'s varying-axis typing), and the ``pmean`` that follows
    leaves that sum as it is.  Its SGD step is thus dp times the step on the
    global mean loss; the port keeps that so both trajectories agree."""
    w1 = params["w1"].detach().requires_grad_()
    w2 = params["w2"].detach().requires_grad_()
    xs = x.to(torch.bfloat16).to(w1.dtype)
    h = torch.relu(xs @ w1)  # [b/dp, hidden/mp]
    y = _RowParallelSum.apply(h @ w2, mesh.mp_group, mesh.mp)
    loss = y.float().square().mean()
    g1, g2 = torch.autograd.grad(loss, (w1, w2))
    g1 = _sum(g1, mesh.dp_group, mesh.dp)
    g2 = _sum(g2, mesh.dp_group, mesh.dp)
    new = {
        "w1": (w1.detach().float() - lr * g1.float()).to(w1.dtype),
        "w2": (w2.detach().float() - lr * g2.float()).to(w2.dtype),
    }
    loss = _sum(loss.detach(), mesh.dp_group, mesh.dp) / mesh.dp
    return loss, new


def _acceptance_run(
    mesh: Mesh, step, params, x, steps: int, name: str = "burn-in"
) -> dict:
    """Run ``steps`` SGD steps; require finite losses with the last below the
    first (a flat line means the step silently stopped training).  Every
    step leaves a flight sample; the first one carries first-use setup
    (cuBLAS handles, NCCL communicators), recorded as the compile phase."""
    losses, step_s = [], []
    t0 = time.perf_counter()
    t_step = t0
    for i in range(steps):
        loss, params = step(params, x)
        losses.append(float(loss))  # the readback waits for the step
        now = time.perf_counter()
        step_s.append(now - t_step)
        flight.record(
            name, "compile" if i == 0 else "step", step=i,
            step_s=now - t_step, loss=losses[-1],
        )
        flight.record_step(
            name, step_seq=i, wall_s=now - t_step,
            phases={(obs_profile.PHASE_COMPILE if i == 0
                     else obs_profile.PHASE_COMPUTE): now - t_step},
        )
        t_step = now
    dt = time.perf_counter() - t0
    finite = all(np.isfinite(v) for v in losses)
    decreasing = len(losses) < 2 or losses[-1] < losses[0]
    return {
        "ok": finite and decreasing,
        "devices": mesh.size,
        "mesh": mesh.shape,
        "steps": steps,
        "losses": losses,
        "time_s": dt,
        "step_s": step_s,
        "backend": mesh.device.type,
    }


def _burn_in_rank(
    rank: int, n: int, device: torch.device,
    w1: np.ndarray, w2: np.ndarray, x: np.ndarray, steps: int,
) -> dict:
    # the burn-in's matmuls are f32: keep them full f32 on the card, as on
    # the reference's CPU backend, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(n, rank, device)
    params = params_from_jax(w1, w2, mesh)
    rows = x.shape[0] // mesh.dp
    i = mesh.coords[0]
    xs = torch.tensor(x[i * rows:(i + 1) * rows], dtype=torch.bfloat16, device=device)
    return _acceptance_run(mesh, functools.partial(burn_in_step, mesh), params, xs, steps)


def burn_in_run(
    w1: np.ndarray,
    w2: np.ndarray,
    x: np.ndarray,
    steps: int = 3,
    world_size: Optional[int] = None,
    device=None,
) -> dict:
    """The acceptance run on given full host weights and batch (``x`` is
    ``(batch, d_model)``, split over dp; the weights over mp)."""
    device = resolve_device(device)
    n = world_size or local_world_size(device)
    if x.shape[0] % _split_dp_mp(n)[0]:
        raise ValueError(f"batch {x.shape[0]} does not split over {n} ranks")
    # plain f32 host arrays: they travel to spawned ranks by pickle
    kwargs = {
        "w1": np.asarray(w1, dtype=np.float32),
        "w2": np.asarray(w2, dtype=np.float32),
        "x": np.asarray(x, dtype=np.float32),
        "steps": steps,
    }
    if n == 1:
        return _burn_in_rank(0, 1, device, **kwargs)
    return _ranks.run(_burn_in_rank, n, device.type, **kwargs)


def burn_in(
    world_size: Optional[int] = None,
    steps: int = 3,
    batch: int = 64,
    d_model: int = 512,
    d_hidden: int = 2048,
    seed: int = 0,
    device=None,
) -> dict:
    """Run the acceptance test; returns loss trajectory + timing.  ``seed``
    varies params AND data."""
    w1, w2 = _burn_in_weights(d_model, d_hidden, seed)
    x = np.random.default_rng(seed + 1).standard_normal((batch, d_model), dtype=np.float32)
    return burn_in_run(w1, w2, x, steps=steps, world_size=world_size, device=device)


# ---------------------------------------------------------------------------
# The flagship transformer layer's train step (the reference's :622-806), over
# the (dp, mp) mesh: batch over dp; the sequence over mp for attention
# (ring-remat attention, K/V passed around the mp ring); Megatron tensor
# parallelism over mp for the MLP in the Megatron-SP arrangement (gather the
# sequence shards, column/row-split matmuls, reduce-scatter back).  The
# attention projections are replicated, so their gradients sum over every
# rank; the mp-sharded MLP slices sum over dp.

TRANSFORMER_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")

# the single-tensor collectives under their newer names where PyTorch has
# them (the older names warn there), else the older ones
_all_gather_single = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


def _rmsnorm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in f32, returned in x's dtype (the reference's).
    x is cast to f32 twice, as in the reference's program: through a bf16
    x, each cast's backward rounds its own cotangent to bf16 before the two
    are summed (in bf16), which is what the reference's transpose does."""
    scale = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
    return (x.float() * scale).to(x.dtype)


def transformer_weights(d_model: int = 256, d_hidden: int = 1024, seed: int = 0) -> dict:
    """One pre-norm layer's full weights, f32 numpy: standard normals from
    ``default_rng(seed)`` times 1/sqrt(d_model), in the reference's order
    and shapes.  f32 as the reference's are (its bf16 draws times a numpy
    float64 scale promote to float32); its ``jax.random`` values are not
    reproduced, and nothing depends on them."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / np.sqrt(d_model))
    shapes = {name: (d_model, d_model) for name in TRANSFORMER_WEIGHTS[:4]}
    shapes.update(w1=(d_model, d_hidden), w2=(d_hidden, d_model))
    return {name: rng.standard_normal(shape, dtype=np.float32) * scale
            for name, shape in shapes.items()}


def transformer_params_from_jax(weights: dict, mesh: Mesh) -> dict:
    """This rank's shard of full host weights (the reference's, or
    ``transformer_weights``'): the attention projections whole, ``w1``
    split by columns over mp and ``w2`` by rows."""
    return {**{name: _put(weights[name], mesh) for name in TRANSFORMER_WEIGHTS[:4]},
            **params_from_jax(weights["w1"], weights["w2"], mesh)}


def _gather_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mp ranks' sequence shards [b, s, d] gathered along axis 1."""
    b, s, d = x.shape
    parts = torch.empty((mesh.mp * b, s, d), dtype=x.dtype, device=x.device)
    _all_gather_single(parts, x.contiguous(), group=mesh.mp_group)
    return parts.reshape(mesh.mp, b, s, d).transpose(0, 1).reshape(b, mesh.mp * s, d)


def _scatter_seq(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the mp ranks of y [b, S, d], cut along axis 1: this
    rank's sequence shard."""
    b, s, d = y.shape
    s_loc = s // mesh.mp
    chunks = y.reshape(b, mesh.mp, s_loc, d).transpose(0, 1).reshape(mesh.mp * b, s_loc, d)
    out = torch.empty((b, s_loc, d), dtype=y.dtype, device=y.device)
    _reduce_scatter_single(out, chunks.contiguous(), group=mesh.mp_group)
    return out


class _GatherSeq(torch.autograd.Function):
    """The reference's ``all_gather(x, "mp", axis=1, tiled=True)``; its
    transpose, the backward, is a reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_seq(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_seq(grad, ctx.mesh), None


class _ScatterSeq(torch.autograd.Function):
    """The reference's ``psum_scatter(y, "mp", scatter_dimension=1,
    tiled=True)``; its transpose, the backward, is an all-gather."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return _scatter_seq(y, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad, ctx.mesh), None


def _layer_fwd(xs, wq, wk, wv, wo, w1, w2, heads: int, mesh: Mesh, use_kernel: bool):
    """The per-rank transformer layer on [b, s_loc, d]: ring-remat attention
    over the mp ring, then the Megatron-SP MLP sandwich.  The casts are the
    reference's, written out (JAX promotes bf16 @ f32 on its own): the
    normalized input is bf16 and the weights f32, so every product and the
    residual stream are f32.  Spans ``train.attn`` and ``train.mlp`` cover
    the two blocks' forwards; the profiler links each backward op to its
    forward."""
    b, s_loc, d = xs.shape
    hd = d // heads
    with trace.span("train.attn"):
        xf = xs.to(torch.bfloat16)
        h = _rmsnorm(xf)
        # one bf16 -> f32 promotion per use, in the reference's order: when xs
        # needs a gradient (a pipeline stage's input) each use's cotangent is
        # rounded to bf16 on its own and the rounded ones are summed in bf16,
        # as the reference's transpose does
        q = (h.float() @ wq).reshape(b, s_loc, heads, hd)
        k = (h.float() @ wk).reshape(b, s_loc, heads, hd)
        v = (h.float() @ wv).reshape(b, s_loc, heads, hd)
        attn = ring_attention.ring_attention_remat(q, k, v, True, use_kernel, mesh.mp_group)
        attn = attn.reshape(b, s_loc, d) @ wo
        xa = xf.float() + attn
    with trace.span("train.mlp"):
        g = _rmsnorm(xa)
        if mesh.mp > 1:
            g = _GatherSeq.apply(g, mesh)
        y = torch.relu(g @ w1) @ w2  # [b, S, d], partial over mp
        if mesh.mp > 1:
            y = _ScatterSeq.apply(y, mesh)
        return xa + y


def transformer_step(
    mesh: Mesh, heads: int, params: dict, x: torch.Tensor, lr: float = 0.05,
    use_kernel: Optional[bool] = None,
) -> tuple:
    """One SGD step of the layer on this rank's x [b, s_loc, d] (batch over
    dp, sequence over mp).  Returns ``(loss, new_params)``, the loss the
    global mean square over every rank's tokens.

    The step follows the exact gradient of that global loss, as the
    reference's does: there the loss is ``psum``-ed before
    ``value_and_grad``, so a replicated weight's gradient is the sum of
    every shard's contribution, and the ``pmean``s after it leave the sum
    as it is (no dp scaling, unlike the burn-in).  Here each rank
    differentiates its own share of the loss, the sequence collectives'
    backwards carry the cross-rank terms, and the gradients are summed:
    the attention weights over every rank, the MLP slices over dp.
    ``use_kernel`` (default: on a card) runs attention on kernels B3 and
    B4; otherwise the plain path.

    Spans (under an active tracer only): ``train.step`` around it all,
    ``train.attn`` and ``train.mlp`` in the layer, ``train.grads`` around
    the loss, the autograd call, the sums and the update.  Host spans: on a
    card they time the enqueue, not the work."""
    if use_kernel is None:
        use_kernel = mesh.device.type == "cuda"
    b, s_loc, d = x.shape
    with trace.span("train.step", rank=mesh.rank):
        ws = [params[name].detach().requires_grad_() for name in TRANSFORMER_WEIGHTS]
        out = _layer_fwd(x, *ws, heads, mesh, use_kernel)
        with trace.span("train.grads"):
            count = b * mesh.dp * s_loc * mesh.mp * d
            share = out.float().square().sum() / count
            grads = torch.autograd.grad(share, ws)
            new = {}
            for name, w, g in zip(TRANSFORMER_WEIGHTS, ws, grads):
                if name in ("w1", "w2"):
                    g = _sum(g, mesh.dp_group, mesh.dp)
                else:
                    g = _sum(g, None, mesh.size)
                new[name] = (w.detach().float() - lr * g.float()).to(w.dtype)
            return _sum(share.detach(), None, mesh.size), new


def _gather_mp(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """An mp-sharded weight put back together along ``dim``."""
    if mesh.mp == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.mp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.mp_group)
    return torch.cat(parts, dim=dim)


def _transformer_rank(
    rank: int, n: int, device: torch.device, weights: dict, x: np.ndarray, heads: int,
    steps: int, use_kernel: Optional[bool], out_path: str,
) -> dict:
    # f32 products in full f32 on the card, as on the reference's CPU
    # backend, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(n, rank, device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    params = transformer_params_from_jax(weights, mesh)
    i, j = mesh.coords
    b, s = x.shape[0] // mesh.dp, x.shape[1] // mesh.mp
    xs = torch.tensor(x[i * b:(i + 1) * b, j * s:(j + 1) * s], dtype=torch.bfloat16,
                      device=device)
    final = {}

    def step(params, xs):
        loss, new = transformer_step(mesh, heads, params, xs, use_kernel=use_kernel)
        final.update(new)
        return loss, new

    launches = ring_attention.remat_launches()
    result = _acceptance_run(mesh, step, params, xs, steps, name="transformer")
    result["attention_kernel"] = ring_attention.remat_route(device, use_kernel)
    # kernel launches in rank 0's process during this run
    result["launches"] = {key: count - launches[key]
                          for key, count in ring_attention.remat_launches().items()}
    if out_path:
        full = {name: final[name] for name in TRANSFORMER_WEIGHTS[:4]}
        full.update(w1=_gather_mp(final["w1"], mesh, 1), w2=_gather_mp(final["w2"], mesh, 0))
        if rank == 0:
            np.savez(out_path, **{name: w.cpu().numpy() for name, w in full.items()})
    return result


def transformer_run(
    weights: dict, x: np.ndarray, heads: int, steps: int = 3,
    world_size: Optional[int] = None, use_kernel: Optional[bool] = None, device=None,
    out_path: str = "",
) -> dict:
    """The acceptance run on given full host weights (``transformer_weights``'
    names and shapes) and batch x [B, S, d], B split over dp and S over mp,
    values rounded to bf16.  With ``out_path``, rank 0 saves the updated
    full weights there (.npz, f32)."""
    device = resolve_device(device)
    n = world_size or local_world_size(device)
    dp, mp = _split_dp_mp(n)
    if x.shape[0] % dp or x.shape[1] % mp:
        raise ValueError(f"x {x.shape} does not split over dp={dp}, mp={mp}")
    # plain f32 host arrays: they travel to spawned ranks by pickle
    kwargs = {
        "weights": {name: np.asarray(weights[name], np.float32) for name in TRANSFORMER_WEIGHTS},
        "x": np.asarray(x, np.float32), "heads": heads, "steps": steps,
        "use_kernel": use_kernel, "out_path": out_path,
    }
    if n == 1:
        return _transformer_rank(0, 1, device, **kwargs)
    return _ranks.run(_transformer_rank, n, device.type, **kwargs)


def transformer_burn_in(
    world_size: Optional[int] = None,
    steps: int = 3,
    batch_per_dp: int = 4,
    seq_per_mp: int = 16,
    d_model: int = 128,
    d_hidden: int = 256,
    heads: int = 4,
    use_kernel: Optional[bool] = None,
    device=None,
) -> dict:
    """Acceptance run of the transformer step at the reference's defaults;
    same contract as ``burn_in``, plus ``attention_kernel`` and the kernels'
    ``launches``.  On a card attention runs on kernels B3 and B4 (head dim
    32, 16 tokens per rank), where the reference's check takes its jnp path:
    in the port a plain version never runs on the main path when a card is
    present."""
    device = resolve_device(device)
    n = world_size or local_world_size(device)
    dp, mp = _split_dp_mp(n)
    weights = transformer_weights(d_model, d_hidden, seed=0)
    x = np.random.default_rng(1).standard_normal(
        (batch_per_dp * dp, seq_per_mp * mp, d_model), dtype=np.float32)
    return transformer_run(weights, x, heads, steps, n, use_kernel, device)


# ---------------------------------------------------------------------------
# The full composition (the reference's :808-1003): a GPipe stack of
# transformer stages over the (pp, dp, mp) mesh.  Each pp stage owns one
# layer's weights; microbatches stream through the stages with one hop per
# tick over the pp chain (``pipeline._Hop``), and inside a stage the layer
# runs as in ``transformer_step``: batch over dp, ring-remat attention over
# mp, the Megatron-SP MLP over mp.


def transformer_pipeline_weights(pp: int, d_model: int = 128, d_hidden: int = 256,
                                 seed: int = 0) -> dict:
    """Every stage's full weights, f32 numpy of shape (pp, ...): standard
    normals from ``default_rng(seed)`` times 1/sqrt(d_model), in the
    reference's order.  f32 as the reference's are (its bf16 draws times a
    numpy float64 scale promote to float32)."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / np.sqrt(d_model))
    shapes = {name: (pp, d_model, d_model) for name in TRANSFORMER_WEIGHTS[:4]}
    shapes.update(w1=(pp, d_model, d_hidden), w2=(pp, d_hidden, d_model))
    return {name: rng.standard_normal(shape, dtype=np.float32) * scale
            for name, shape in shapes.items()}


def transformer_pipeline_params_from_jax(weights: dict, mesh: Mesh) -> dict:
    """This rank's shard of every stage's full host weights (the
    reference's, or ``transformer_pipeline_weights``'): its stage's slice,
    ``w1`` split by columns over mp and ``w2`` by rows."""
    s = mesh.coords[0]
    return transformer_params_from_jax({name: weights[name][s] for name in TRANSFORMER_WEIGHTS},
                                       mesh)


def transformer_pipeline_step(
    mesh: Mesh, heads: int, params: dict, x: torch.Tensor, lr: float = 0.05,
    use_kernel: Optional[bool] = None,
) -> tuple:
    """One SGD step of the pipelined stack on this rank's microbatches x
    [M, b, s_loc, d] (f32; batch over dp, sequence over mp).  Returns
    ``(loss, new_params)``, the loss the global mean square of the last
    stage's outputs over every microbatch and token.

    Every rank runs M + pp - 1 ticks of its stage's layer, the fill and
    drain ticks included (their outputs are masked out of the loss, not
    skipped, so every rank runs the same launches and the same backward):
    stage 0 is fed microbatch min(t, M - 1), the others take what the last
    hop delivered, and the last stage adds sum(y²) from tick pp - 1 on.  As
    in ``transformer_step`` each rank differentiates its own share of the
    loss; the hops' and the sequence collectives' backwards carry the terms
    of the other ranks.  A stage's weights are private to it: the attention
    weights' gradients are summed over the stage's dp x mp ranks, the MLP
    slices' over its dp ranks, nothing over pp (the reference's pmeans over
    the gradient that ``value_and_grad`` already summed)."""
    from tpu_operator_torch.workloads.pipeline import _Hop

    if use_kernel is None:
        use_kernel = mesh.device.type == "cuda"
    pp, s_pp = mesh.pp, mesh.coords[0]
    ws = [params[name].detach().requires_grad_() for name in TRANSFORMER_WEIGHTS]
    m, b, s_loc, d = x.shape
    ticks = m + pp - 1
    x_cur = x[0] if s_pp == 0 else torch.zeros_like(x[0])
    total = x.new_zeros(())
    for t in range(ticks):
        y = _layer_fwd(x_cur, *ws, heads, mesh, use_kernel)
        # the last stage lands microbatch t - (pp - 1); the mask keeps every
        # rank's outputs in the graph, so every rank runs every backward
        lands = s_pp == pp - 1 and t >= pp - 1
        total = total + y.square().sum() * float(lands)
        if t + 1 < ticks:  # the last tick's hop would carry nothing used
            feed = x[min(t + 1, m - 1)]
            x_cur = _Hop.apply(y, feed, mesh.pp_group) if pp > 1 else feed
    count = m * b * mesh.dp * s_loc * mesh.mp * d
    share = total / count
    grads = torch.autograd.grad(share, ws)
    new = {}
    for name, w, g in zip(TRANSFORMER_WEIGHTS, ws, grads):
        if name in ("w1", "w2"):
            g = _sum(g, mesh.dp_group, mesh.dp)
        else:
            g = _sum(g, mesh.stage_group, mesh.dp * mesh.mp)
        new[name] = (w.detach().float() - lr * g.float()).to(w.dtype)
    # outside autograd: a differentiable sum would scale every gradient
    return _sum(share.detach(), None, mesh.size), new


def _transformer_pipeline_rank(
    rank: int, n: int, device: torch.device, weights: dict, x: np.ndarray, heads: int,
    steps: int, use_kernel: Optional[bool], shape: Optional[tuple], out_path: str,
) -> dict:
    # f32 products in full f32 on the card, as on the reference's CPU
    # backend, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh3(n, rank, device, shape)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    params = transformer_pipeline_params_from_jax(weights, mesh)
    _, i, j = mesh.coords
    b, s = x.shape[1] // mesh.dp, x.shape[2] // mesh.mp
    xs = torch.tensor(x[:, i * b:(i + 1) * b, j * s:(j + 1) * s], dtype=torch.float32,
                      device=device)
    final = {}

    def step(params, xs):
        loss, new = transformer_pipeline_step(mesh, heads, params, xs, use_kernel=use_kernel)
        final.update(new)
        return loss, new

    launches = ring_attention.remat_launches()
    result = _acceptance_run(mesh, step, params, xs, steps, name="transformer-pp")
    if mesh.pp == 1:
        # below four cards no stage boundary is crossed: say so rather than
        # let a dead pp path read as exercised (the reference's flag)
        result["pp_degenerate"] = True
    result["attention_kernel"] = ring_attention.remat_route(device, use_kernel)
    # kernel launches in rank 0's process during this run
    result["launches"] = {key: count - launches[key]
                          for key, count in ring_attention.remat_launches().items()}
    if out_path:
        # every stage's full weights, gathered to rank 0
        mine = {name: final[name] for name in TRANSFORMER_WEIGHTS[:4]}
        mine.update(w1=_gather_mp(final["w1"], mesh, 1), w2=_gather_mp(final["w2"], mesh, 0))
        stages = [mine]
        if mesh.pp > 1:
            stages = [{name: torch.empty_like(w) for name, w in mine.items()}
                      for _ in range(mesh.pp)]
            for name in TRANSFORMER_WEIGHTS:
                dist.all_gather([st[name] for st in stages], mine[name].contiguous(),
                                group=mesh.pp_group)
        if rank == 0:
            np.savez(out_path, **{name: torch.stack([st[name] for st in stages]).cpu().numpy()
                                  for name in TRANSFORMER_WEIGHTS})
    return result


def transformer_pipeline_run(
    weights: dict, x: np.ndarray, heads: int, steps: int = 3,
    world_size: Optional[int] = None, use_kernel: Optional[bool] = None, device=None,
    shape: Optional[tuple] = None, out_path: str = "",
) -> dict:
    """The acceptance run on given full host weights
    (``transformer_pipeline_weights``' names and shapes, pp stages) and
    microbatches x [M, B, S, d] (f32), B split over dp and S over mp, on a
    (pp, dp, mp) mesh of ``shape`` (default ``make_mesh3``'s).  With
    ``out_path``, rank 0 saves every stage's updated full weights there
    (.npz, f32)."""
    device = resolve_device(device)
    n = world_size or local_world_size(device)
    pp, dp, mp = shape or _split_pp(n)
    if weights["wq"].shape[0] != pp:
        raise ValueError(f"{weights['wq'].shape[0]} stages of weights for pp={pp}")
    if x.shape[1] % dp or x.shape[2] % mp:
        raise ValueError(f"x {x.shape} does not split over dp={dp}, mp={mp}")
    # plain f32 host arrays: they travel to spawned ranks by pickle
    kwargs = {
        "weights": {name: np.asarray(weights[name], np.float32) for name in TRANSFORMER_WEIGHTS},
        "x": np.asarray(x, np.float32), "heads": heads, "steps": steps,
        "use_kernel": use_kernel, "shape": shape, "out_path": out_path,
    }
    if n == 1:
        return _transformer_pipeline_rank(0, 1, device, **kwargs)
    return _ranks.run(_transformer_pipeline_rank, n, device.type, **kwargs)


def transformer_pipeline_burn_in(
    world_size: Optional[int] = None,
    steps: int = 3,
    microbatches: int = 4,
    batch_per_dp: int = 2,
    seq_per_mp: int = 16,
    d_model: int = 64,
    d_hidden: int = 128,
    heads: int = 4,
    use_kernel: Optional[bool] = None,
    device=None,
) -> dict:
    """Acceptance run of the full pp/dp/mp composition at the reference's
    defaults (its shipping sizes); same contract as ``burn_in``, plus
    ``pp_degenerate`` below four cards, ``attention_kernel`` and the
    kernels' ``launches``.  On a card each stage's attention runs on
    kernels B3 and B4 (head dim 16, 16 tokens per rank), where the
    reference's check takes its jnp path."""
    device = resolve_device(device)
    n = world_size or local_world_size(device)
    pp, dp, mp = _split_pp(n)
    weights = transformer_pipeline_weights(pp, d_model, d_hidden, seed=0)
    x = np.random.default_rng(1).standard_normal(
        (microbatches, batch_per_dp * dp, seq_per_mp * mp, d_model), dtype=np.float32)
    return transformer_pipeline_run(weights, x, heads, steps, n, use_kernel, device)
