"""Runner of the training cells: the program's train step
(``tpu_operator_torch.workloads.collectives.transformer_step``) in a closed
loop of one job, in this process on one card and one rank a card under the
program's launcher (``workloads/_ranks.py``) on several.

Set-up draws the weights and a pool of distinct global batches on the card
from the seed, then drives the step through its first ``checked_steps``
steps, on batches 0, 1, 2, with the same call and feed as the window, and
reads the program's state: each leaf's first gradient from the weights
after one step, ((w0 − w1) / lr, the SGD update), and each leaf's change
after the last checked step.  The same state then goes on into the window:
a fixed number of steps, as many as fill ``--seconds`` at the checked
steps' pace, back to back with no host read, ended by a synchronize; a
CUDA event on rank 0's stream marks each step's end.  With ``--trace 1`` a
short profiled window follows.  After it, with the program's state freed,
the reference (``reference/layer.py``) repeats the checked steps from the
same seed on rank 0's card, and ``compare.train_gaps`` holds the program's
readings against it."""

from __future__ import annotations

import importlib
import math
import time

import torch

from benchmark import compare, counts, modcheck
from benchmark import trace as btrace
from benchmark.reference import layer as reference
from benchmark.spec import Run

LEAVES = reference.LEAVES
SHARDED = ("w1", "w2")  # split over mp: W1 by columns, W2 by rows


def apply_patch(patch: str) -> None:
    """Call ``module:function`` (a fault or a control of the tests and the
    calibration; never set by a benchmark run)."""
    if patch:
        module, fn = patch.split(":")
        getattr(importlib.import_module(module), fn)()


def global_shape(traffic: dict) -> tuple:
    dp, mp = traffic["mesh"]
    return traffic["batch_per_dp"] * dp, traffic["seq_per_mp"] * mp


def make_inputs(config: dict, traffic: dict, seed: int, device, batches: int) -> tuple:
    """The full weights, float32 as the step keeps them, and the first
    ``batches`` global batches [B, S, d] in bfloat16, drawn on ``device``
    from ``seed``: normals, the weights times 1/sqrt(d_model).  The same
    seed gives the same values, whatever the number of batches."""
    d, dh = config["d_model"], config["d_ff"]
    b, s = global_shape(traffic)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, dh),
              "w2": (dh, d)}
    weights = {name: torch.randn(shape, generator=gen, device=device) / math.sqrt(d)
               for name, shape in shapes.items()}
    xs = [torch.randn((b, s, d), generator=gen, device=device, dtype=torch.bfloat16)
          for _ in range(batches)]
    return weights, xs


def shard(weights: dict, mesh) -> dict:
    """This rank's parameters in the program's layout: the attention
    projections whole, W1's columns and W2's rows of mp index j."""
    j = mesh.coords[-1]
    h = weights["w1"].shape[1] // mesh.mp
    params = {name: weights[name].clone() for name in LEAVES if name not in SHARDED}
    params["w1"] = weights["w1"][:, j * h:(j + 1) * h].contiguous()
    params["w2"] = weights["w2"][j * h:(j + 1) * h].contiguous()
    return params


def local(x: torch.Tensor, mesh, traffic: dict) -> torch.Tensor:
    """This rank's rows (over dp) and tokens (over mp) of a global batch."""
    i, j = mesh.coords
    b, s = traffic["batch_per_dp"], traffic["seq_per_mp"]
    return x[i * b:(i + 1) * b, j * s:(j + 1) * s].contiguous()


def leaf_norms(tensors: dict, mesh) -> dict:
    """Each leaf's norm as this rank sees the full leaf (a sharded leaf's
    squares summed over its mp group), in float64."""
    import torch.distributed as dist

    out = {}
    for name in LEAVES:
        sq = tensors[name].double().square().sum()
        if name in SHARDED and mesh.mp > 1:
            dist.all_reduce(sq, group=mesh.mp_group)
        out[name] = float(sq.sqrt())
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _share(values: list, n: int) -> list:
    """``values`` of every rank, on every rank (itself alone on one)."""
    import torch.distributed as dist

    if n == 1:
        return [values]
    out = [None] * n
    dist.all_gather_object(out, values)
    return out


class Job:
    """The training job of one rank: its mesh, parameters and feed, and the
    step the window calls."""

    def __init__(self, rank: int, n: int, device, config: dict, traffic: dict, seed: int):
        from tpu_operator_torch.workloads import collectives

        self.collectives = collectives
        self.device = device
        self.mesh = collectives.make_mesh(n, rank, device, shape=tuple(traffic["mesh"]))
        self.heads, self.lr = config["n_heads"], config["lr"]
        weights, xs = make_inputs(config, traffic, seed, device, traffic["batches"])
        self.params = shard(weights, self.mesh)
        self.feed = [local(x, self.mesh, traffic) for x in xs]
        self.taken = 0  # batches fed so far

    def step(self) -> torch.Tensor:
        """One step on the next batch of the pool; returns its loss (on the
        card, not read)."""
        x = self.feed[self.taken % len(self.feed)]
        self.taken += 1
        loss, self.params = self.collectives.transformer_step(
            self.mesh, self.heads, self.params, x, lr=self.lr)
        return loss

    def checked(self, steps: int) -> tuple:
        """The first ``steps`` steps with the program's state read: (losses,
        first-gradient norms, change norms, seconds a step after the
        first)."""
        start = {name: t.clone() for name, t in self.params.items()}
        losses = [self.step()]
        grads = leaf_norms({n: (start[n] - self.params[n]) / self.lr for n in LEAVES}, self.mesh)
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            losses.append(self.step())
        sync(self.device)
        per_step = (time.perf_counter() - t0) / max(1, steps - 1)
        change = leaf_norms({n: self.params[n] - start[n] for n in LEAVES}, self.mesh)
        return [float(x) for x in losses], grads, change, per_step


def readings(losses: list, views: list) -> dict:
    """The program's readings as ``compare.train_gaps`` takes them, from
    every rank's (first-gradient norms, change norms, ...)."""
    return {"losses": losses,
            "grad_norms": {name: [v[0][name] for v in views] for name in LEAVES},
            "change_norms": {name: [v[1][name] for v in views] for name in LEAVES}}


def _agree(n: int, device, values: list) -> list:
    """Rank 0's ``values`` (whole numbers) on every rank."""
    import torch.distributed as dist

    if n == 1:
        return values
    t = torch.tensor(values, dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return [int(v) for v in t.tolist()]


def _rank(rank: int, n: int, device, config: dict, traffic: dict, seed: int, seconds: float,
          trace: bool, started: float, patch: str) -> dict:
    import torch.distributed as dist

    apply_patch(patch)
    # the configuration's float32 products: TF32 off, as the probe runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = Job(rank, n, device, config, traffic, seed)
    checked = traffic["checked_steps"]
    losses, grads, change, per_step = job.checked(checked)
    steps, traced = _agree(n, device, [max(2, round(seconds / per_step)),
                                       max(2, math.ceil(traffic["traced_seconds"] / per_step))])

    sync(device)
    setup_s = time.monotonic() - started
    on_card = device.type == "cuda"
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)] if on_card else []
    host_marks = []
    t0 = time.perf_counter()
    if on_card:
        marks[0].record()
    window_losses = []
    for k in range(steps):
        window_losses.append(job.step())
        if on_card:
            marks[k + 1].record()
        else:
            host_marks.append(time.perf_counter())
    sync(device)
    window_s = time.perf_counter() - t0
    if on_card:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + host_marks, host_marks)]
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())

    summary = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            sync(device)
            with torch.profiler.record_function(btrace.WINDOW):
                for _ in range(traced):
                    job.step()
                sync(device)
        summary = btrace.summarize_profile(prof)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    views = _share([grads, change, summary, peak, modcheck.banned_modules()], n)
    del job, window_losses, marks
    if on_card:
        torch.cuda.empty_cache()

    result = None
    if rank == 0:
        weights, xs = make_inputs(config, traffic, seed, device, checked)
        ref = reference.train(weights, xs, config["n_heads"], config["lr"], steps=checked)
        del weights, xs
        b, s = global_shape(traffic)
        mp = traffic["mesh"][1]
        result = {
            "setup_s": setup_s, "window_s": window_s, "steps": steps, "step_ms": step_ms,
            "failed": failed, "tokens_per_step": b * s, "cards": n,
            "flops_per_step": counts.step_model_flops(b, s, config["d_model"], config["d_ff"]),
            "program": readings(losses, views),
            "reference": ref,
            "memory_peak_bytes": max(v[3] for v in views),
            "device_kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "trace": [v[2] for v in views] if trace else None,
            "traced_steps": traced,
            "attn": {"bh": traffic["batch_per_dp"] * config["n_heads"],
                     "block": traffic["seq_per_mp"],
                     "d_head": config["d_model"] // config["n_heads"],
                     "hops": [counts.ring_hops(mp, r % mp, traffic["seq_per_mp"])
                              for r in range(n)]},
            "banned": sorted({m for v in views for m in v[4]}),
        }
    if n > 1:
        dist.barrier()
    return result


def p95(values: list) -> float:
    """The 95th percentile by nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def run(r: Run) -> dict:
    kwargs = dict(config=r.config, traffic=r.traffic, seed=r.seed, seconds=r.seconds,
                  trace=r.trace, started=r.started, patch=r.patch)
    if r.chips == 1:
        device = torch.device("cuda", 0) if r.device == "cuda" else torch.device("cpu")
        res = _rank(0, 1, device, **kwargs)
    else:
        from tpu_operator_torch.workloads import _ranks

        res = _ranks.run(_rank, r.chips, r.device, timeout_s=300.0, **kwargs)
    numbers = compare.train_gaps(res["program"], res["reference"])
    correct, compared = compare.verdict(numbers, r.limits)
    summaries = res["trace"] or []
    device = {"kind": res["device_kind"], "count": res["cards"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if r.trace:
        device["busy_s"] = sum(s.get("busy_s", 0.0) for s in summaries) / len(summaries)
        device["window_s"] = sum(s.get("window_s", 0.0) for s in summaries) / len(summaries)
    return {
        "end_to_end": {
            "setup_s": res["setup_s"],
            "train_tokens_per_s": res["steps"] * res["tokens_per_step"] / res["window_s"],
            "train_step_p95_ms": p95(res["step_ms"]),
        },
        "layer": {key: res[key] for key in ("steps", "window_s", "flops_per_step", "cards",
                                             "traced_steps", "trace", "attn", "device_kind")},
        "attempted": res["steps"],
        "failed": res["failed"],
        "correct": correct and res["failed"] == 0,
        "compared": compared,
        "device": device,
        "breakdown": btrace.breakdown(summaries) if r.trace else None,
        "banned": res["banned"],
    }
