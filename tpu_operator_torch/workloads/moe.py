"""Expert parallelism on PyTorch: a Switch-style MoE layer with all-to-all
dispatch (port of ``tpu_operator/workloads/moe.py``), and the expert layer
of the language-model training path (``workloads/lm.py``), which is told
which experts this card holds.

Experts shard one group per rank (one rank per card, ``_ranks``; NCCL on the
cards, gloo on the CPU), tokens are routed top-1 (Switch Transformer, Fedus
et al.), and two all-to-alls move each token to its expert's rank and back.
The dispatch all-to-all is the only collective whose traffic crosses every
pair of cards, so a bad link that the neighbour ring skips still shows here.

Shapes are static as in the reference: routing builds a ``[tokens, E, C]``
one-hot dispatch tensor (capacity C per expert per shard), and tokens over
capacity are dropped (their combine weight is zero).  The routing statistics
(``aux_loss``, ``dropped_fraction``) are means over the ranks and are not
differentiated; the layer's output is, through both all-to-alls.

The language model's expert layer routes without capacity
(``route_sigmoid_topk``: DeepSeek-V3's sigmoid top-k over every expert of
the layer, no token dropped) and computes the part of the result that this
card's contiguous range of experts gives (``held_experts``); the shared
expert (``swiglu``) every card computes alike.  One float32 GEMM chain a
held expert on cuBLAS, over the tokens routed to it; the per-expert counts
are read on the host once a forward.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_operator_torch.obs import flight
from tpu_operator_torch.workloads import _ranks, resolve_device
from tpu_operator_torch.workloads.ring_attention import _ring_group


def _capacity(tokens_per_shard: int, num_experts: int, capacity_factor: float) -> int:
    return max(1, int(np.ceil(tokens_per_shard * capacity_factor / num_experts)))


def route_top1(logits: torch.Tensor, capacity: int):
    """Top-1 routing with per-expert capacity.

    ``logits`` [N, E] -> (dispatch [N, E, C] one-hot, combine [N, E, C]
    prob-weighted, aux).  A token's slot in its expert's buffer is its rank
    among the tokens routed there (cumsum order); ranks >= C are dropped
    (all-zero rows in both tensors).  ``argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    n, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)  # [N]
    prob = probs.amax(dim=-1)  # [N]
    onehot = F.one_hot(expert, e).float()  # [N, E]
    # rank within the expert: the exclusive cumsum of the one-hot down tokens
    rank = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1).long()
    kept = rank < capacity
    # F.one_hot rejects ranks >= C where jax.nn.one_hot gives a zero row;
    # the clamp's row is zeroed by ``kept`` either way
    slot = F.one_hot(rank.clamp(max=capacity - 1), capacity).float() * kept[:, None]
    dispatch = onehot[:, :, None] * slot[:, None, :]  # [N, E, C]
    combine = dispatch * prob[:, None, None]
    # the Switch aux (mean prob x mean assignment per expert, times E) and
    # the drop accounting
    aux = {
        "aux_loss": (onehot.mean(0) * probs.mean(0)).sum() * e,
        "dropped_fraction": 1.0 - kept.float().mean(),
    }
    return dispatch, combine, aux


def moe_weights(d_model: int, d_hidden: int, experts: int, seed: int = 0) -> tuple:
    """Full host weights (wr [D, E], w1 [E, D, H], w2 [E, H, D]), f32 normals
    from ``default_rng(seed)`` times 1/sqrt(d_model), as the reference's
    ``moe_params`` shapes and scales them (its ``jax.random`` values are not
    reproduced, and nothing depends on them)."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / np.sqrt(d_model))
    wr = rng.standard_normal((d_model, experts), dtype=np.float32) * scale
    w1 = rng.standard_normal((experts, d_model, d_hidden), dtype=np.float32) * scale
    w2 = rng.standard_normal((experts, d_hidden, d_model), dtype=np.float32) * scale
    return wr, w1, w2


def moe_params_from_jax(wr, w1, w2, rank: int, p: int, device="cpu") -> dict:
    """This rank's share of full host weights (the reference's, or
    ``moe_weights``'): the router whole, the experts ``rank * E/p`` up to
    the next group, f32 on ``device``."""
    e = w1.shape[0]
    if e % p:
        raise ValueError(f"{e} experts do not split over {p} ranks")
    e_loc = e // p
    experts = slice(rank * e_loc, (rank + 1) * e_loc)

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)

    return {"wr": put(wr), "w1": put(w1[experts]), "w2": put(w2[experts])}


def moe_layer_sharded(xs, wr, w1, w2, capacity_factor: float = 2.0):
    """The per-rank MoE program: ``xs`` [n_loc, D] this rank's tokens,
    ``w1``/``w2`` [E_loc, ...] its experts, ``wr`` whole.  Runs over the
    default process group (one rank when there is none).

    Route -> dispatch einsum -> all-to-all (tokens travel to their expert's
    rank) -> expert FFN -> all-to-all back -> combine.  Returns (out
    [n_loc, D], aux means over the ranks)."""
    _, p = _ring_group()
    n_loc, d = xs.shape
    e_loc = w1.shape[0]
    e = e_loc * p
    c = _capacity(n_loc, e, capacity_factor)

    dispatch, combine, aux = route_top1(xs @ wr, c)  # [n, E, C]
    aux = {k: v.detach().clone() for k, v in aux.items()}
    if p > 1:  # the reference's pmean
        for v in aux.values():
            dist.all_reduce(v)
    aux = {k: v / p for k, v in aux.items()}
    # per-rank expert buffers, split p ways by the owner of each expert
    # group: after the all-to-all every rank holds [p, E_loc, C, D], every
    # shard's tokens for its own experts
    buf = torch.einsum("nec,nd->ecd", dispatch, xs).reshape(p, e_loc, c, d)
    recv = _ranks.all_to_all(buf)
    h = torch.relu(torch.einsum("secd,edh->sech", recv, w1))
    out = torch.einsum("sech,ehd->secd", h, w2)  # [p, E_loc, C, D]
    # the results travel home; combine un-permutes
    back = _ranks.all_to_all(out).reshape(e, c, d)
    return torch.einsum("nec,ecd->nd", combine, back), aux


def dense_reference(x, wr, w1, w2, n_shards: int, capacity_factor: float) -> torch.Tensor:
    """Single-device truth: every expert on every token, then per-token
    selection, with the same per-shard capacity accounting the sharded path
    applies (ranks counted within each shard's block of tokens)."""
    n, d = x.shape
    e = w1.shape[0]
    n_loc = n // n_shards
    c = _capacity(n_loc, e, capacity_factor)

    def per_shard(xs):
        dispatch, combine, _ = route_top1(xs @ wr, c)
        buf = torch.einsum("nec,nd->ecd", dispatch, xs)
        h = torch.relu(torch.einsum("ecd,edh->ech", buf, w1))
        out = torch.einsum("ech,ehd->ecd", h, w2)
        return torch.einsum("nec,ecd->nd", combine, out)

    return torch.cat([per_shard(x[s * n_loc:(s + 1) * n_loc]) for s in range(n_shards)])


def acceptance_inputs(n_tokens: int, d_model: int, d_hidden: int, experts: int) -> tuple:
    """The check's host inputs: tokens quantized to 1/8 (seed 7) and the
    router to 1/128 (weights from seed 0), as the reference quantizes them.
    Router logits are then exact f32 sums of exact products, so the sharded
    path and the reference route every token alike whatever the order of
    their sums: no argmax near-tie can flip."""
    wr, w1, w2 = moe_weights(d_model, d_hidden, experts)
    wr = np.round(wr * 128) / 128
    x = np.random.default_rng(7).standard_normal((n_tokens, d_model), dtype=np.float32)
    return np.round(x * 8) / 8, wr, w1, w2


def _moe_rank(rank: int, n: int, device: torch.device, tokens_per_shard: int, d_model: int,
              d_hidden: int, experts_per_shard: int, capacity_factor: float,
              tol: float) -> dict:
    """One rank of the check: its tokens through the sharded layer, held
    against the dense reference on the same tokens with every expert; the
    max error is the max over every rank."""
    # the expert FFN is f32 and the bound 1e-4: full f32 on the card, not
    # TF32's 10-bit products
    torch.backends.cuda.matmul.allow_tf32 = False
    experts = n * experts_per_shard
    x, wr, w1, w2 = acceptance_inputs(tokens_per_shard * n, d_model, d_hidden, experts)
    mine = slice(rank * tokens_per_shard, (rank + 1) * tokens_per_shard)
    params = moe_params_from_jax(wr, w1, w2, rank, n, device)
    xs = torch.from_numpy(x[mine]).to(device)

    t0 = time.perf_counter()
    out, aux = moe_layer_sharded(xs, params["wr"], params["w1"], params["w2"],
                                 capacity_factor)
    full = moe_params_from_jax(wr, w1, w2, 0, 1, device)
    ref = dense_reference(xs, full["wr"], full["w1"], full["w2"], 1, capacity_factor)
    err = (out - ref).abs().max()
    if n > 1:
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
    err = float(err)  # the readback waits for the card
    dt = time.perf_counter() - t0
    flight.record("moe", "run", step_s=dt, tokens=tokens_per_shard * n, max_error=err)
    return {
        "ok": bool(np.isfinite(err) and err < tol),
        "devices": n,
        "experts": experts,
        "tokens": tokens_per_shard * n,
        "capacity_factor": capacity_factor,
        "dropped_fraction": float(aux["dropped_fraction"]),
        "aux_loss": float(aux["aux_loss"]),
        "strategy": "ep-all-to-all-top1",
        "max_error": err,
        "time_s": dt,
        "backend": device.type,
    }


def acceptance(
    tokens_per_shard: int = 64,
    d_model: int = 32,
    d_hidden: int = 64,
    experts_per_shard: int = 1,
    capacity_factor: float = 2.0,
    world_size: Optional[int] = None,
    tol: float = 1e-4,
    device=None,
) -> dict:
    """The sharded MoE over every local card (``world_size`` ranks on the
    CPU) against the dense reference on identical inputs and weights.
    Returns the check-result dict (run_validation shape)."""
    device = resolve_device(device)
    n = world_size or (torch.cuda.device_count() if device.type == "cuda" else 1)
    kwargs = dict(tokens_per_shard=tokens_per_shard, d_model=d_model, d_hidden=d_hidden,
                  experts_per_shard=experts_per_shard, capacity_factor=capacity_factor,
                  tol=tol)
    if n == 1:
        return _moe_rank(0, 1, device, **kwargs)
    return _ranks.run(_moe_rank, n, device.type, **kwargs)


# ---------------------------------------------------------------------------
# the language model's expert layer: dropless sigmoid top-k, a held share


def route_sigmoid_topk(x: torch.Tensor, wr: torch.Tensor, top_k: int, normalize: bool = True,
                       scale: float = 1.0) -> tuple:
    """DeepSeek-V3's router (``DeepseekV3TopkRouter`` at ``n_group`` =
    ``topk_group`` = 1) over every expert: scores s = sigmoid(x·wr) in
    float32; the ``top_k`` largest of s + b choose, b the correction bias,
    held at zero here; their weights are the chosen s, divided by their sum
    + 1e-20 when ``normalize``, times ``scale``.  Returns (experts [N, k]
    int64, weights [N, k] float32)."""
    scores = torch.sigmoid(x.float() @ wr.float())
    experts = torch.topk(scores, top_k, dim=-1).indices
    weights = scores.gather(1, experts)
    if normalize:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return experts, weights * scale


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """(silu(x·Wg) ⊙ x·Wu)·Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def held_experts(x: torch.Tensor, experts: torch.Tensor, weights: torch.Tensor, first: int,
                 w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> tuple:
    """Σ w_e · SwiGLU_e(x) over each token's chosen experts that this card
    holds: experts ``first`` up to ``first + E`` of the layer, ``w_gate``,
    ``w_up`` [E, d, f] and ``w_down`` [E, f, d].  Every (token, expert) pair
    on a held expert is computed; none is dropped.

    The pairs are sorted by held expert (the rest after them), the counts
    read on the host once, and each expert runs one GEMM chain on its
    tokens, gathered; the weighted results are added back at their tokens.
    Returns (out [N, d], counts: the tokens of each held expert)."""
    n_held = w_gate.shape[0]
    local = experts - first
    key = torch.where((local >= 0) & (local < n_held), local, n_held).flatten()
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_held + 1).tolist()[:n_held]  # the host read
    pairs = order[:sum(counts)]
    tokens = pairs // experts.shape[1]
    xs = x[tokens]
    parts = [swiglu(xe, w_gate[e], w_up[e], w_down[e])
             for e, xe in enumerate(torch.split(xs, counts))]
    y = torch.cat(parts) * weights.flatten()[pairs, None]
    return torch.zeros_like(x).index_add(0, tokens, y), counts


def quick_check(device=None) -> dict:
    """The validator's probe: the reference's shipping size over every card
    (the all-pairs all-to-all is the point); its CPU defaults on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return acceptance(tokens_per_shard=1024, d_model=256, d_hidden=1024,
                          experts_per_shard=2, device=device)
    return acceptance(device=device)


def main() -> int:
    import json

    from tpu_operator_torch.validator import status as vstatus

    with flight.activate(flight.recorder_for(vstatus.flight_record_path())):
        result = quick_check()
        flight.record_result("moe", result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
