"""Runner of the language-model training cells: the program's train step
(``tpu_operator_torch.workloads.lm.train_step``) in a closed loop of one
job on one card.

Set-up draws the weights and a pool of ``batches`` distinct batches of
token ids on the card from the seed, then drives the step through its
first ``checked_steps`` steps, on batches 0, 1, ..., with the same call
and feed as the window, and reads the program's state: each leaf's first
gradient from the weights after one step ((w0 − w1) / lr, the SGD update)
and each leaf's change after the last checked step, w0 drawn again leaf by
leaf from the seed (each leaf has a generator of its own), so no second
copy of the weights is held.  The same state then goes on into the window:
a fixed number of steps, as many as fill ``--seconds`` at the checked
steps' pace, back to back with no host read of the runner's, ended by a
synchronize; a CUDA event marks each step's end.  With ``--trace 1`` a
short profiled window follows under an active ``Tracer``: its Chrome trace
goes to ``trace.summarize`` (device busy, ops, idle gaps),
``phases.attribute`` and ``phases_lm.attribute`` (device time by span),
and the tracer's ``train.moe`` spans give the pairs the held experts ran.
After it, with the program's state freed, the reference
(``reference/k_exaone.py``) repeats the checked steps from the same seed
on the card, and ``compare_lm.train_gaps`` holds the program's readings
against it: leaf by leaf (a layer's held experts one leaf each of gate, up
and down), and token by token the first step's losses, which the program
gives from a forward at the first step's weights before the checked
steps."""

from __future__ import annotations

import json
import math
import os
import tempfile
import time

import torch

from benchmark import compare, compare_lm, counts_lm, modcheck, phases, phases_lm
from benchmark import trace as btrace
from benchmark.kinds.train import apply_patch, p95, sync
from benchmark.reference import k_exaone as reference
from benchmark.spec import Run
from tpu_operator_torch.obs import trace as ptrace
from tpu_operator_torch.workloads import collectives, lm

# a generator a leaf: its seed is the run's seed and the leaf's index
_LEAF_STRIDE = 1_000_003


def draw_leaf(config: dict, seed: int, name: str, device) -> torch.Tensor:
    """One leaf of the weights from ``seed``: normals times 1/sqrt(fan in)
    (the embedding's rows unit normals), norm gains 1 + normals / 10."""
    table = reference.shapes(reference.model(config))
    shape = table[name]
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * _LEAF_STRIDE + list(table).index(name)) % (1 << 63))
    w = torch.randn(shape, generator=gen, device=device)
    if name.endswith("norm"):
        return 1.0 + 0.1 * w
    return w if name == "embed" else w / math.sqrt(shape[-2])


def draw_weights(config: dict, seed: int, device) -> dict:
    names = reference.shapes(reference.model(config))
    return {name: draw_leaf(config, seed, name, device) for name in names}


def draw_batches(config: dict, traffic: dict, seed: int, device, n: int) -> list:
    """The first ``n`` batches of token ids [B, S + 1], uniform over the
    vocabulary slice, drawn on ``device`` from ``seed`` (after the
    weights' generators, one of its own)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * _LEAF_STRIDE - 1) % (1 << 63))
    b, s = traffic["batch_per_dp"], traffic["seq_per_mp"]
    return [torch.randint(0, config["vocab_size"], (b, s + 1), generator=gen, device=device)
            for _ in range(n)]


def _norms(config: dict, seed: int, params: dict, device, scale: float) -> dict:
    """Each leaf's norm of (``params`` − w0) · ``scale``, w0 drawn again."""
    out = {}
    for name, w in params.items():
        out[name] = float(((w - draw_leaf(config, seed, name, device)) * scale).double().norm())
    return out


class Job:
    """The training job: its mesh, model, parameters and feed, and the
    step the window calls."""

    def __init__(self, device, config: dict, traffic: dict, seed: int):
        self.device, self.config, self.seed = device, config, seed
        self.mesh = collectives.make_mesh(1, 0, device, shape=tuple(traffic["mesh"]))
        self.model = lm.LMConfig.from_dict(config)
        self.lr = config["lr"]
        self.params = draw_weights(config, seed, device)
        self.feed = draw_batches(config, traffic, seed, device, traffic["batches"])
        self.taken = 0

    def step(self) -> torch.Tensor:
        ids = self.feed[self.taken % len(self.feed)]
        self.taken += 1
        loss, self.params = lm.train_step(self.mesh, self.model, self.params, ids, self.lr)
        return loss

    def checked(self, steps: int) -> tuple:
        """The first ``steps`` steps with the program's state read: (losses,
        first-gradient norms, change norms, seconds a step after the first,
        each token's loss under the first step's weights and batch)."""
        tokens = lm.token_losses(self.mesh, self.model, self.params, self.feed[0]).cpu()
        losses = [self.step()]
        grads = _norms(self.config, self.seed, self.params, self.device, -1.0 / self.lr)
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            losses.append(self.step())
        sync(self.device)
        per_step = (time.perf_counter() - t0) / max(1, steps - 1)
        change = _norms(self.config, self.seed, self.params, self.device, 1.0)
        return [float(x) for x in losses], grads, change, per_step, tokens


def readings(losses: list, grads: dict, change: dict, tokens: torch.Tensor) -> dict:
    """The program's readings as ``compare_lm.train_gaps`` takes them (one
    rank's view)."""
    return {"losses": losses, "grad_norms": {n: [v] for n, v in grads.items()},
            "change_norms": {n: [v] for n, v in change.items()}, "token_losses": tokens}


def reference_readings(config: dict, traffic: dict, seed: int, device, steps: int,
                       tf32: bool = False) -> dict:
    """The reference's readings from the same seed: ``reference.train``'s
    and each token's loss under the first step's weights and batch."""
    weights = draw_weights(config, seed, device)
    batches = draw_batches(config, traffic, seed, device, steps)
    out = reference.train(config, weights, batches, config["lr"], steps=steps, tf32=tf32)
    out["token_losses"] = reference.token_losses(config, weights, batches[0], tf32=tf32).cpu()
    return out


def _traced(job: Job, steps: int, on_card: bool) -> tuple:
    """``steps`` steps under the profiler and an active tracer: (the trace
    summary, device seconds by span, the pairs the held experts ran)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    tracer = ptrace.Tracer()
    with tracer.adopt(None), torch.profiler.profile(activities=activities) as prof:
        sync(job.device)
        with torch.profiler.record_function(btrace.WINDOW):
            for _ in range(steps):
                job.step()
            sync(job.device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="benchmark-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    pairs = [sp["attrs"] for sp in tracer.spans() if sp["name"] == "train.moe"]
    by_span = phases_lm.attribute(events)
    blocks = phases.attribute(events)
    return btrace.summarize(events), by_span, blocks, {
        "routed_pairs": sum(a.get("routed_pairs", 0) for a in pairs),
        "max_load": max((a.get("max_load", 0) for a in pairs), default=0),
        "host_reads": sum(a.get("host_reads", 0) for a in pairs),
        "moe_layers": len(pairs)}


def run(r: Run) -> dict:
    if r.chips != 1 or tuple(r.traffic["mesh"]) != (1, 1):
        raise ValueError("the language-model runner takes one card, mesh (1, 1)")
    device = torch.device("cuda", 0) if r.device == "cuda" else torch.device("cpu")
    on_card = device.type == "cuda"
    config, traffic = r.config, r.traffic
    apply_patch(r.patch)
    # the configuration's float32 products: TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = Job(device, config, traffic, r.seed)
    checked = traffic["checked_steps"]
    losses, grads, change, per_step, tokens = job.checked(checked)
    steps = max(2, round(r.seconds / per_step))
    traced = max(2, math.ceil(traffic["traced_seconds"] / per_step))

    sync(device)
    setup_s = time.monotonic() - r.started
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

    summary = by_span = blocks = load = None
    if r.trace:
        summary, by_span, blocks, load = _traced(job, traced, on_card)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del job, window_losses, marks
    if on_card:
        torch.cuda.empty_cache()

    ref = reference_readings(config, traffic, r.seed, device, checked)
    numbers = compare_lm.train_gaps(readings(losses, grads, change, tokens), ref)
    correct, compared = compare.verdict(numbers, r.limits)
    b, s = traffic["batch_per_dp"], traffic["seq_per_mp"]
    m = reference.model(config)
    device_info = {"kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if r.trace:
        device_info["busy_s"] = summary.get("busy_s", 0.0)
        device_info["window_s"] = summary.get("window_s", 0.0)
    return {
        "end_to_end": {"setup_s": setup_s, "train_tokens_per_s": steps * b * s / window_s,
                       "train_step_p95_ms": p95(step_ms)},
        "layer": {
            "steps": steps, "window_s": window_s, "cards": 1, "traced_steps": traced,
            "flops_per_step": counts_lm.step_model_flops(config, b, s),
            "device_kind": device_info["kind"], "trace": [summary] if r.trace else None,
            "lm": {"spans": by_span, "blocks": blocks, "load": load, "batch": b, "seq": s,
                   "heads": m.heads, "d_head": m.d_head, "d_model": m.d,
                   "expert_width": m.expert, "windows": list(m.windows)},
        },
        "attempted": steps,
        "failed": failed,
        "correct": correct and failed == 0,
        "compared": compared,
        "device": device_info,
        "breakdown": btrace.breakdown([summary]) if r.trace else None,
        "banned": modcheck.banned_modules(),
    }
