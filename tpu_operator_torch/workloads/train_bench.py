"""Training-throughput benchmark on PyTorch: the flagship step's tokens/sec
and MFU.  Port of ``tpu_operator/workloads/train_bench.py``.

It measures what a user of the node gets: full train steps of the flagship
transformer layer (``collectives.transformer_step``: dp batch, ring-remat
attention over mp on kernels B3 and B4, the Megatron-SP MLP), forward,
backward and the SGD update with its gradient collectives.

Methodology as the reference (``workloads/timing.py``'s rule): ``steps`` SGD
steps back to back with no host readback between them, then one
synchronize and one readback of the loss; the floor (a null op plus its
readback) is subtracted, and the overhead-dominated flag is set when the
floor rivals the measurement.  The reference runs its steps in one compiled
``lax.scan``; PyTorch runs eagerly, and the host enqueues a step's work
while the card runs the step before.

MFU accounting as the reference: model FLOPs per step are 3 x the forward,
forward = 24·b·s·d² (QKVO and the 4d MLP) + 4·b·s²·d (scores and PV, causal
masking not discounted), against the dense bf16 peak x cards, as the
reference's is.  The step itself runs in f32 (the reference's weights are
f32): f32 matmuls with TF32 off and the f32 kernels, so the figure compares
with the reference's, not with what f32 can reach.

``TRAIN_MODEL`` names a model of ``lm.MODELS`` to run in the probe's place
(``lm.train_step``: its published widths, one card's share of each expert
layer; on the CPU the same layers at tiny widths); the probe stays the
default.  Its model FLOPs count the expert layers' pairs at their
expectation and the attention pairs its masks keep.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from tpu_operator_torch.k8s import nodeinfo
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import profile as obs_profile
from tpu_operator_torch.workloads import (
    _ranks,
    collectives,
    lm,
    resolve_device,
    ring_attention,
    timing,
)

MODEL_ENV = "TRAIN_MODEL"
# a model's layers at widths the CPU runs in seconds
CPU_WIDTHS = dict(hidden_size=64, num_attention_heads=8, num_key_value_heads=2, head_dim=16,
                  sliding_window=8, num_experts=8, expert_parallel=2, num_experts_per_tok=4,
                  moe_intermediate_size=32, intermediate_size=128, vocab_size=97)


def step_model_flops(batch: int, seq: int, d_model: int, d_hidden: int) -> float:
    """Analytic model FLOPs for one train step of the flagship layer."""
    fwd_proj = 8.0 * batch * seq * d_model * d_model          # Q,K,V,O
    fwd_mlp = 4.0 * batch * seq * d_model * d_hidden          # two halves
    fwd_attn = 4.0 * batch * seq * seq * d_model              # scores + PV
    return 3.0 * (fwd_proj + fwd_mlp + fwd_attn)


def lm_model_flops(cfg: lm.LMConfig, batch: int, seq: int) -> float:
    """Model FLOPs of one train step of ``lm.train_step``: 3 x the forward;
    the forward 2 a token per weight it goes through (the held experts'
    pairs at their expectation) and 4·D a kept (query, key) pair and head."""
    d, hd = cfg.d_model, cfg.head_dim
    weights = d * cfg.vocab
    pairs = 0
    for layer in cfg.layers:
        weights += 2 * d * cfg.heads * hd + 2 * d * cfg.kv_heads * hd
        w = min(layer.window or seq, seq)
        pairs += w * (w + 1) // 2 + (seq - w) * w
        if layer.dense:
            weights += 3 * d * cfg.dense_width
        else:
            weights += d * cfg.experts + 3 * d * cfg.shared_width
            weights += 3 * d * cfg.expert_width * cfg.top_k * cfg.experts_held / cfg.experts
    return 3.0 * (2.0 * batch * seq * weights + 4.0 * hd * cfg.heads * pairs * batch)


def _train_rank(
    rank: int, n: int, device: torch.device, batch_per_dp: int, seq_per_mp: int,
    d_model: int, d_hidden: int, heads: int, steps: int, best_of: int,
    use_kernel: bool, model: Optional[dict] = None,
) -> dict:
    # f32 products in full f32, not TF32 (the reference's f32 step)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = collectives.make_mesh(n, rank, device)
    b, s = batch_per_dp * mesh.dp, seq_per_mp * mesh.mp
    i, j = mesh.coords
    if model is not None:
        # every rank draws the same weights and ids from seed 0 and keeps its
        # rows, its sequence shard and the next shard's first token
        cfg = lm.LMConfig.from_dict(model)
        d_model, d_hidden, heads = cfg.d_model, cfg.dense_width, cfg.heads
        params = lm.init_params(cfg, 0, device)
        gen = torch.Generator(device=device).manual_seed(2)
        ids = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen, device=device)
        ids = ids[i * batch_per_dp:(i + 1) * batch_per_dp,
                  j * seq_per_mp:(j + 1) * seq_per_mp + 1].contiguous()
        xs = ids

        def one(params):
            return lm.train_step(mesh, cfg, params, ids, lr=0.05, use_kernel=use_kernel)
    else:
        # every rank draws the same full weights and batch from the seeds and
        # keeps its shard (the reference's params seed 0, batch key 2)
        params = collectives.transformer_params_from_jax(
            collectives.transformer_weights(d_model, d_hidden, seed=0), mesh)
        x = np.random.default_rng(2).standard_normal((b, s, d_model), dtype=np.float32)
        xs = torch.tensor(x[i * batch_per_dp:(i + 1) * batch_per_dp,
                            j * seq_per_mp:(j + 1) * seq_per_mp], dtype=torch.bfloat16,
                          device=device)
        del x

        def one(params):
            return collectives.transformer_step(mesh, heads, params, xs, use_kernel=use_kernel)

    def run(params):
        for _ in range(steps):
            loss, params = one(params)
        return loss, params

    def null() -> float:
        return float(xs[0, :1].float().sum())

    null()
    overhead = min(timing.timed(null, device) for _ in range(3))

    launches = ring_attention.remat_launches()
    t_compile = time.perf_counter()
    loss, params = run(params)  # first use: library loads, cuBLAS and NCCL set-up
    loss0 = float(loss)
    flight.record("train", "compile", compile_s=time.perf_counter() - t_compile)

    raw = []
    for rep in range(best_of):
        timing.sync(device)
        t0 = time.perf_counter()
        loss, params = run(params)
        last = float(loss)  # the one readback waits for the card
        raw.append(time.perf_counter() - t0)
        flight.record("train", "step", step=rep, step_s=raw[-1] / steps,
                      tokens_per_sec=b * s * steps / raw[-1])
        flight.record_step("train", step_seq=rep, wall_s=raw[-1],
                           phases={obs_profile.PHASE_COMPUTE: raw[-1]})
    times, overhead_dominated = timing.subtract_floor(raw, overhead, per=steps)
    step_s = times[0]
    step_s_median = times[len(times) // 2]

    flops = (lm_model_flops(cfg, b, s) if model is not None
             else step_model_flops(b, s, d_model, d_hidden))
    tflops = flops / step_s / 1e12
    generation = nodeinfo.detect_generation(device)
    peak = nodeinfo.generation_info(generation).peak_bf16_tflops * n
    result = {
        "ok": bool(np.isfinite(loss0)),
        "model": "transformer-layer" if model is None else model.get("name", "lm"),
        "devices": n,
        "mesh": mesh.shape,
        "batch": b,
        "seq": s,
        "d_model": d_model,
        "d_hidden": d_hidden,
        "steps_per_run": steps,
        "overhead_ms": overhead * 1e3,
        "overhead_dominated": overhead_dominated,
        "step_time_ms": step_s * 1e3,
        "step_time_ms_median": step_s_median * 1e3,
        "step_time_ms_max": times[-1] * 1e3,
        "tokens_per_sec": b * s / step_s,
        "tokens_per_sec_spread": {
            "min": b * s / times[-1],
            "median": b * s / step_s_median,
            "max": b * s / step_s,
        },
        "model_tflops": tflops,
        "backend": device.type,
        "generation": generation,
        # both kernels: B3 runs the remat forward, B4 its backward
        "attention_kernel": ring_attention.remat_route(device, use_kernel),
        "loss": loss0,
        "loss_last": last,
        "step_times_ms": [t * 1e3 for t in times],
        # kernel launches in rank 0's process during this run
        "launches": {key: count - launches[key]
                     for key, count in ring_attention.remat_launches().items()},
    }
    if peak > 0:
        result["train_mfu"] = round(tflops / peak, 4)
        result["train_mfu_median"] = round(flops / step_s_median / 1e12 / peak, 4)
        result["train_mfu_min"] = round(flops / times[-1] / 1e12 / peak, 4)
    return result


def train_benchmark(
    batch_per_dp: int = 4,
    seq_per_mp: int = 2048,
    d_model: int = 4096,
    d_hidden: int = 16384,
    heads: int = 32,
    steps: int = 4,
    best_of: int = 3,
    world_size: Optional[int] = None,
    use_kernel: Optional[bool] = None,
    device=None,
    model: Optional[dict] = None,
) -> dict:
    """Measure sustained train-step throughput on every local card (one rank
    each; ``world_size`` ranks on the CPU).  Returns tokens/sec, step time,
    model TFLOP/s and, when the card's peak is known, training MFU.
    ``use_kernel`` defaults to the kernels on a card and the plain path on
    the CPU.  ``model``: a configuration of ``lm.LMConfig.from_dict``, run
    with ``lm.train_step`` in the layer's place (``d_model``, ``d_hidden``
    and ``heads`` then come from it)."""
    device = resolve_device(device)
    n = world_size or collectives.local_world_size(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    kwargs = dict(batch_per_dp=batch_per_dp, seq_per_mp=seq_per_mp, d_model=d_model,
                  d_hidden=d_hidden, heads=heads, steps=steps, best_of=best_of,
                  use_kernel=use_kernel, model=model)
    if n == 1:
        return _train_rank(0, 1, device, **kwargs)
    return _ranks.run(_train_rank, n, device.type, **kwargs)


def quick_check(device=None) -> dict:
    """The validator's probe: the reference's TPU shapes on a card; its tiny
    shapes on the CPU (full train steps would crawl there).  With
    ``TRAIN_MODEL`` set, that model of ``lm.MODELS``: one sequence of 4096
    tokens a card at its published widths, or 2 of 32 at ``CPU_WIDTHS``."""
    device = resolve_device(device)
    name = os.environ.get(MODEL_ENV, "")
    if name:
        model = dict(lm.MODELS[name], name=name)
        if device.type == "cuda":
            return train_benchmark(batch_per_dp=1, seq_per_mp=4096, steps=2, best_of=2,
                                   device=device, model=model)
        return train_benchmark(batch_per_dp=2, seq_per_mp=32, steps=2, best_of=2, device=device,
                               model=dict(model, **CPU_WIDTHS))
    if device.type == "cuda":
        return train_benchmark(device=device)
    return train_benchmark(
        batch_per_dp=2, seq_per_mp=32, d_model=64, d_hidden=128, heads=4,
        steps=2, best_of=2, device=device,
    )


def main() -> int:
    import json

    from tpu_operator_torch.validator import status as vstatus

    with flight.activate(flight.recorder_for(vstatus.flight_record_path())):
        result = quick_check()
        flight.record_result("train", result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
