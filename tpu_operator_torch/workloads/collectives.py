"""The readiness gate's checks on PyTorch (vector-add, allreduce benchmark,
sharded burn-in) and the ring probe.  Port of the main-path subset of
``tpu_operator/workloads/collectives.py``.

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

The reference runs one program over all local chips; here every local card
is one rank (``_ranks``), and with one card the check runs in-process with no
process group.  Functions take ``world_size=`` where the reference takes
``devices=``; on the CPU the ranks use gloo.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_operator_torch.kernels.vector_add import vector_add_kernel
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import profile as obs_profile
from tpu_operator_torch.workloads import _ranks, resolve_device, timing


def local_world_size(device: torch.device) -> int:
    """Ranks a check runs on by default: one per visible card; one on the
    CPU (tests ask for more with ``world_size``)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


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
    (``world_size``, default 1) on the CPU.  Enforced only on backends named
    in ``DEVICE_COUNT_GATE_BACKENDS`` (default cuda — the CPU rank count is a
    test-harness knob, not hardware truth); unenforced runs still report."""
    device = resolve_device(device)
    if device.type == "cuda":
        visible_local = torch.cuda.device_count()
    else:
        visible_local = world_size or 1
    # one host per gate in this port: the multi-host gate brings its own
    # global count
    visible_global = visible_local
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
    """This rank's place in the (dp, mp) mesh.  Rank r sits at
    ``divmod(r, mp)``, the row-major layout of the reference's
    ``devices.reshape(dp, mp)``; the groups are None for an in-process mesh
    of one."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    dp_group: Optional[object] = None  # ranks with my mp index: gradient mean
    mp_group: Optional[object] = None  # ranks with my dp index: row-parallel sum

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def coords(self) -> tuple:
        return divmod(self.rank, self.mp)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": self.mp}


def make_mesh(world_size: int = 1, rank: int = 0, device=None) -> Mesh:
    """2-D (dp, mp) mesh over ``world_size`` ranks.  Above one rank it must
    run inside an initialized process group of that size, on every rank
    (``new_group`` is collective)."""
    device = resolve_device(device)
    dp, mp = _split_dp_mp(world_size)
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
    j = mesh.coords[1]

    def put(a: np.ndarray) -> torch.Tensor:
        # a private f32 copy (bf16 inputs convert exactly)
        a = np.array(a, dtype=np.float32, order="C")
        return torch.from_numpy(a).to(mesh.device)

    return {"w1": put(w1[:, j * h:(j + 1) * h]), "w2": put(w2[j * h:(j + 1) * h, :])}


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
    """Sum of the row-parallel partial outputs over mp.  The backward is the
    identity: the reference's ``psum`` under ``shard_map`` turns the mp
    partials into one value every shard holds, and its transpose hands that
    value's cotangent to each partial unchanged (summing it again would
    scale the gradient by mp)."""

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
    losses = []
    t0 = time.perf_counter()
    t_step = t0
    for i in range(steps):
        loss, params = step(params, x)
        losses.append(float(loss))  # the readback waits for the step
        now = time.perf_counter()
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
