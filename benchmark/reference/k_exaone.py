"""The plain reference of ``k-exaone-236b-a23b-ep16``: K-EXAONE-236B-A23B's
first layers with one card's share of each expert layer, their loss and
gradients and SGD steps, written from the model's equations in plain
PyTorch at float32 (TF32 off for cuBLAS and cuDNN).  It imports no kernel
of the program and is never handed the program's choices: it parses the
configuration and routes on its own scores.

Per sequence (ids [S + 1]: inputs ids[:-1], labels ids[1:]):

- x = E[inputs];
- every layer: q = x·Wq as H heads of D, k = x·Wk, v = x·Wv as G heads;
  q, k ← RMSNorm over D (eps) × gains; rotary positions 0..S−1 (θ,
  rotate-half) on sliding layers only, the global ones have none (EXAONE
  4.0 with a window); a = softmax(q·kᵀ/√D + mask)·v, causal, sliding
  layers also only keys j > i − W; query head h reads key-value head
  ⌊h·G/H⌋; x ← x + RMSNorm(a·Wo)·γ_attn;
- the dense layer: f = (silu(x·Wg) ⊙ x·Wu)·Wd; an expert layer: s =
  sigmoid(x·Wr) over every expert, the top k of s (correction bias zero),
  w = s_chosen / (Σ s_chosen + 1e-20) · scale, f = Σ over chosen held
  experts w_e·SwiGLU_e(x) + SwiGLU_shared(x); x ← x + RMSNorm(f)·γ_ffn;
- logits = RMSNorm(x)·γ_final·W_head; loss = Σ cross-entropy / (B·S)
  over the whole batch, and w ← w − lr·∂loss/∂w for every leaf.

Attention runs in blocks of query rows, each against the keys it can see,
with a backward that recomputes each block's probabilities from the saved
log-sum-exp, as ``layer.py``'s; the expert layer loops over the experts it
is given: the held ones, or every expert for the uncut layer.
With ``tf32`` every product takes its operands rounded to TF32 (the
control)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference.layer import full_float32, mm


@dataclass(frozen=True)
class Model:
    """What the equations read of the configuration."""

    d: int
    heads: int
    kv_heads: int
    d_head: int
    vocab: int
    dense: int
    expert: int
    shared: int
    experts: int      # the router's outputs: every expert of the layer
    held: int
    first: int
    top_k: int
    normalize: bool
    scale: float
    eps: float
    theta: float
    windows: tuple    # per layer: the window, 0 on a global layer
    ropes: tuple      # per layer: rotary positions or not
    denses: tuple     # per layer: a dense FFN or the expert layer


def model(config: dict) -> Model:
    """The reference's reading of a configuration in ``config.json``'s
    keys (EXAONE's), with the card's share: ``num_experts`` held of
    ``num_experts`` × ``expert_parallel``, from the ``expert_shard``-th."""
    n = config["num_hidden_layers"]
    window = config.get("sliding_window") or 0
    kinds = config["layer_types"][:n]
    held, ep = config["num_experts"], config.get("expert_parallel", 1)
    return Model(
        d=config["hidden_size"], heads=config["num_attention_heads"],
        kv_heads=config["num_key_value_heads"], d_head=config["head_dim"],
        vocab=config["vocab_size"], dense=config["intermediate_size"],
        expert=config["moe_intermediate_size"],
        shared=config["moe_intermediate_size"] * config["num_shared_experts"],
        experts=held * ep, held=held, first=held * config.get("expert_shard", 0),
        top_k=config["num_experts_per_tok"], normalize=config["norm_topk_prob"],
        scale=config["routed_scaling_factor"], eps=config["rms_norm_eps"],
        theta=float(config["rope_parameters"]["rope_theta"]),
        windows=tuple(window if k == "sliding_attention" else 0 for k in kinds),
        ropes=tuple(not window or k == "sliding_attention" for k in kinds),
        denses=tuple(m == "dense" for m in config["mlp_layer_types"][:n]))


def shapes(m: Model) -> dict:
    """Each leaf's name and shape; a layer's held experts stacked as one leaf
    each of gate, up and down."""
    held = m.held
    out = {"embed": (m.vocab, m.d)}
    for i, dense in enumerate(m.denses):
        p = f"l{i}."
        out.update({p + "wq": (m.d, m.heads * m.d_head), p + "wk": (m.d, m.kv_heads * m.d_head),
                    p + "wv": (m.d, m.kv_heads * m.d_head), p + "wo": (m.heads * m.d_head, m.d),
                    p + "q_norm": (m.d_head,), p + "k_norm": (m.d_head,), p + "attn_norm": (m.d,)})
        if dense:
            out.update({p + "w_gate": (m.d, m.dense), p + "w_up": (m.d, m.dense),
                        p + "w_down": (m.dense, m.d)})
        else:
            out.update({p + "router": (m.d, m.experts),
                        p + "experts.w_gate": (held, m.d, m.expert),
                        p + "experts.w_up": (held, m.d, m.expert),
                        p + "experts.w_down": (held, m.expert, m.d)})
            if m.shared:
                out.update({p + "shared.w_gate": (m.d, m.shared),
                            p + "shared.w_up": (m.d, m.shared),
                            p + "shared.w_down": (m.shared, m.d)})
        out[p + "ffn_norm"] = (m.d,)
    out.update({"final_norm": (m.d,), "head": (m.d, m.vocab)})
    return out


def rms_norm(x, gain, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def rotate(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S−1 on x [S, H, D], rotate-half form."""
    s, _, d = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    angles = torch.arange(s, device=x.device).float()[:, None] * inv_freq[None, :]
    angles = torch.cat((angles, angles), dim=-1)[:, None, :]
    half = d // 2
    return x * angles.cos() + torch.cat((-x[..., half:], x[..., :half]), dim=-1) * angles.sin()


def _keys(i0: int, i1: int, window: int) -> int:
    """The first key any query of rows [i0, i1) sees."""
    return max(0, i0 - window + 1) if window else 0


def _mask(i0: int, i1: int, j0: int, window: int, device) -> torch.Tensor:
    """True where query i in [i0, i1) does NOT see key j in [j0, i1)."""
    gap = (torch.arange(i0, i1, device=device)[:, None]
           - torch.arange(j0, i1, device=device)[None, :])
    hidden = gap < 0
    return hidden | (gap >= window) if window else hidden


class BandAttention(torch.autograd.Function):
    """softmax(q·kᵀ·scale + mask)·v of one sequence, q, k, v [H, S, D]
    float32, causal and, with ``window``, only the keys fewer than
    ``window`` positions back; in blocks of ``rows`` queries."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, rows: int, tf32: bool):
        heads, seq, d = q.shape
        scale = 1.0 / math.sqrt(d)
        out = torch.empty_like(q)
        lse = torch.empty((heads, seq), dtype=q.dtype, device=q.device)
        for i0 in range(0, seq, rows):
            i1 = min(seq, i0 + rows)
            j0 = _keys(i0, i1, window)
            s = mm(q[:, i0:i1], k[:, j0:i1].transpose(1, 2), tf32) * scale
            s.masked_fill_(_mask(i0, i1, j0, window, q.device), float("-inf"))
            mx = s.amax(-1, keepdim=True)
            p = torch.exp(s - mx)
            total = p.sum(-1, keepdim=True)
            out[:, i0:i1] = mm(p, v[:, j0:i1], tf32) / total
            lse[:, i0:i1] = (mx + torch.log(total)).squeeze(-1)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.rows, ctx.tf32 = window, rows, tf32
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        window, tf32 = ctx.window, ctx.tf32
        heads, seq, d = q.shape
        scale = 1.0 / math.sqrt(d)
        dout = dout.contiguous()
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = (dout * out).sum(-1)
        for i0 in range(0, seq, ctx.rows):
            i1 = min(seq, i0 + ctx.rows)
            j0 = _keys(i0, i1, window)
            s = mm(q[:, i0:i1], k[:, j0:i1].transpose(1, 2), tf32) * scale
            s.masked_fill_(_mask(i0, i1, j0, window, q.device), float("-inf"))
            p = torch.exp(s - lse[:, i0:i1, None])
            do = dout[:, i0:i1]
            dv[:, j0:i1] += mm(p.transpose(1, 2), do, tf32)
            dp = mm(do, v[:, j0:i1].transpose(1, 2), tf32)
            ds = p * (dp - delta[:, i0:i1, None])
            dq[:, i0:i1] = mm(ds, k[:, j0:i1], tf32) * scale
            dk[:, j0:i1] += mm(ds.transpose(1, 2), q[:, i0:i1], tf32) * scale
        return dq, dk, dv, None, None, None


def swiglu(x, w_gate, w_up, w_down, tf32: bool):
    return mm(F.silu(mm(x, w_gate, tf32)) * mm(x, w_up, tf32), w_down, tf32)


def expert_layer(m: Model, w: dict, p: str, x: torch.Tensor, tf32: bool,
                 first: int = None) -> torch.Tensor:
    """The expert layer on x [N, d]: routed over every expert on its own
    scores, each expert of ``w`` (from ``first``, by default the card's
    first held one) on the tokens that chose it, weighted, plus the shared
    expert."""
    first = m.first if first is None else first
    scores = torch.sigmoid(mm(x, w[p + "router"], tf32))
    chosen = torch.topk(scores, m.top_k, dim=-1).indices
    weights = scores.gather(1, chosen)
    if m.normalize:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    weights = weights * m.scale
    out = torch.zeros_like(x)
    for e in range(w[p + "experts.w_gate"].shape[0]):
        picked = chosen == first + e                  # [N, k]: at most one a row
        tokens = picked.any(-1).nonzero().squeeze(1)
        if tokens.numel() == 0:
            continue
        y = swiglu(x[tokens], w[p + "experts.w_gate"][e], w[p + "experts.w_up"][e],
                   w[p + "experts.w_down"][e], tf32)
        out = out.index_add(0, tokens, y * (weights * picked)[tokens].sum(-1, keepdim=True))
    if m.shared:
        out = out + swiglu(x, w[p + "shared.w_gate"], w[p + "shared.w_up"],
                           w[p + "shared.w_down"], tf32)
    return out


def sequence_loss(m: Model, w: dict, ids: torch.Tensor, count: int, rows: int,
                  tf32: bool, reduction: str = "sum") -> torch.Tensor:
    """Σ cross-entropy / ``count`` of one sequence ids [S + 1]; with
    ``reduction`` "none" each token's cross-entropy [S] instead."""
    inputs, labels = ids[:-1], ids[1:]
    seq = inputs.shape[0]
    group = m.heads // m.kv_heads
    x = w["embed"][inputs]
    for i, (window, rope, dense) in enumerate(zip(m.windows, m.ropes, m.denses)):
        p = f"l{i}."
        q = rms_norm(mm(x, w[p + "wq"], tf32).view(seq, m.heads, m.d_head), w[p + "q_norm"], m.eps)
        k = rms_norm(mm(x, w[p + "wk"], tf32).view(seq, m.kv_heads, m.d_head), w[p + "k_norm"],
                     m.eps)
        v = mm(x, w[p + "wv"], tf32).view(seq, m.kv_heads, m.d_head)
        if rope:
            q, k = rotate(q, m.theta), rotate(k, m.theta)
        heads = [t.transpose(0, 1).contiguous() for t in (q, k, v)]     # [H or G, S, D]
        kh, vh = (t.repeat_interleave(group, dim=0) for t in heads[1:])  # head h on h // group
        a = BandAttention.apply(heads[0], kh, vh, window, rows, tf32)
        a = a.transpose(0, 1).reshape(seq, m.heads * m.d_head)
        x = x + rms_norm(mm(a, w[p + "wo"], tf32), w[p + "attn_norm"], m.eps)
        if dense:
            f = swiglu(x, w[p + "w_gate"], w[p + "w_up"], w[p + "w_down"], tf32)
        else:
            f = expert_layer(m, w, p, x, tf32)
        x = x + rms_norm(f, w[p + "ffn_norm"], m.eps)
    logits = mm(rms_norm(x, w["final_norm"], m.eps), w["head"], tf32)
    if reduction == "none":
        return F.cross_entropy(logits, labels, reduction="none")
    return F.cross_entropy(logits, labels, reduction="sum") / count


def token_losses(config: dict, weights: dict, ids: torch.Tensor, tf32: bool = False,
                 rows: int = 512) -> torch.Tensor:
    """Each token's cross-entropy [B, S] on the batch ids [B, S + 1] at
    ``weights``, a sequence at a time, with no gradient."""
    m = model(config)
    with full_float32(), torch.no_grad():
        return torch.stack([sequence_loss(m, weights, seq, 1, rows, tf32, reduction="none")
                            for seq in ids])


def loss_and_grads(m: Model, w: dict, ids: torch.Tensor, rows: int, tf32: bool = False):
    """(loss, gradients) on the batch ids [B, S + 1], a sequence at a time,
    the gradients of the sequences added up."""
    count = ids.shape[0] * (ids.shape[1] - 1)
    names = list(w)
    leaves = {n: w[n].detach().requires_grad_() for n in names}
    grads = {n: torch.zeros_like(w[n]) for n in names}
    loss = 0.0
    for b in range(ids.shape[0]):
        part = sequence_loss(m, leaves, ids[b], count, rows, tf32)
        for n, g in zip(names, torch.autograd.grad(part, [leaves[n] for n in names])):
            grads[n] += g
        loss += float(part.detach())
    return loss, grads


def train(config: dict, weights: dict, batches: list, lr: float, steps: int = 2,
          tf32: bool = False, rows: int = 512, dtype=torch.float32) -> dict:
    """``steps`` SGD steps from ``weights`` (every leaf, float32), step t on
    ``batches[t]`` (ids [B, S + 1]).  Returns the readings the program is
    held to: each step's loss, each leaf's first gradient norm, each leaf's
    change norm after the last step.  The first gradient is read as the
    program's is, from the first update, (w1 − w0) · (−1/lr) in the
    weights' dtype: w1 keeps the update to the weight's last place (at lr
    0.05 a weight near 1, the embedding's and the gains', loses ~2e-6 of
    its gradient that way), and reading both sides alike puts that loss on
    both.  ``dtype`` float64 makes a second witness of the float32
    reference."""
    m = model(config)
    w = {n: t.to(dtype).clone() for n, t in weights.items()}
    losses, grad_norms = [], {}
    with full_float32():
        for t in range(steps):
            loss, grads = loss_and_grads(m, w, batches[t], rows, tf32)
            losses.append(loss)
            for n in list(w):
                new = w[n] - lr * grads.pop(n)
                if t == 0:
                    grad_norms[n] = float(((new - w[n]) * (-1.0 / lr)).double().norm())
                w[n] = new
    change_norms = {n: float((w[n] - weights[n].to(dtype)).double().norm()) for n in w}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
