"""A decoder-only language model on the training path, built from its
published configuration: K-EXAONE-236B-A23B's block (EXAONE 4.0's
attention and post-norms, DeepSeek-V3's expert layer) at its published
widths, with one card's share of each expert layer.

The model (float32 throughout, TF32 off; attention on kernels B3 f32 and
B4 f32 on a card, 3xTF32):

- ``x = E[ids]`` over the vocabulary slice;
- every layer's attention: q = x·Wq (H heads of D), k = x·Wk, v = x·Wv (G
  key-value heads); q and k RMS-normalised over each head's D with gains;
  rotary positions (θ, rotate-half) on the layers the configuration gives
  them (EXAONE 4.0: the sliding ones when the model has a window); a =
  softmax(q·kᵀ/√D + mask)·v, causal and, on sliding layers, only the keys
  fewer than ``window`` positions back, query head h reading key-value head
  ⌊h·G/H⌋ (K and V repeated over the group before the kernels; autograd
  sums their gradients back); x ← x + RMSNorm(a·Wo)·γ;
- the feed-forward block, a dense SwiGLU or the expert layer
  (``moe.route_sigmoid_topk``, ``moe.held_experts`` over this card's
  experts, plus the shared expert), then x ← x + RMSNorm(f)·γ;
- logits = RMSNorm(x)·γ·W_head over the slice; the loss is the mean
  next-token cross-entropy over every sequence's tokens;
- one SGD step w ← w − lr·∂loss/∂w on every leaf.

``train_step`` runs on ``collectives.Mesh``: the batch over dp, the
sequence over mp (ring attention over the mp group, rotary positions from
the rank's offset), every weight whole on every rank and its gradient
summed over the mesh with ``collectives._sum``, as ``transformer_step``
sums its attention weights.  A rank's ids are its sequence shard and one
token more, the next shard's first, whose label it is.

Spans (under an active tracer only): ``train.step`` ⊃ per layer
``train.attn`` (attrs ``layer``, ``kind``) and ``train.ffn`` (a dense
layer) or ``train.moe`` ⊃ ``train.moe.route``, ``train.moe.experts``,
``train.moe.shared``, whose attrs count the pairs on held experts
(``routed_pairs``), the busiest held expert's tokens (``max_load``) and the
layer's host reads (``host_reads``); then ``train.head`` (final norm,
head, cross-entropy) and ``train.grads`` (autograd, sums, update).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_operator_torch.obs import trace
from tpu_operator_torch.workloads import collectives, moe, ring_attention

SLIDING, GLOBAL = "sliding_attention", "full_attention"


@dataclasses.dataclass(frozen=True)
class Layer:
    window: int  # the sliding window; 0 on a global layer
    rope: bool   # rotary positions on q and k
    dense: bool  # a dense SwiGLU; else the expert layer

    @property
    def kind(self) -> str:
        return "sliding" if self.window else "global"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int           # rows of the vocabulary this card holds
    dense_width: int
    expert_width: int
    shared_width: int    # 0: no shared expert
    experts: int         # experts of a layer, all of which the router scores
    experts_held: int
    first_held: int
    top_k: int
    normalize: bool      # the chosen weights divided by their sum
    routed_scale: float
    eps: float
    rope_theta: float
    layers: tuple

    @classmethod
    def from_dict(cls, c: dict) -> "LMConfig":
        """The configuration as ``config.json`` names it (EXAONE's keys),
        with the card's share of each expert layer: ``num_experts`` held,
        ``expert_parallel`` cards sharing a layer, this card the
        ``expert_shard``-th.  Only what this model computes is taken;
        anything else is refused."""
        if c.get("scoring_func", "sigmoid") != "sigmoid":
            raise ValueError(f"router scoring {c['scoring_func']!r}: only sigmoid")
        if c.get("n_group", 1) != 1 or c.get("topk_group", 1) != 1:
            raise ValueError("group-limited routing is not implemented")
        n = c["num_hidden_layers"]
        window = c.get("sliding_window") or 0
        kinds, ffns = c["layer_types"][:n], c["mlp_layer_types"][:n]
        layers = tuple(Layer(window=window if kind == SLIDING else 0,
                             rope=not window or kind == SLIDING, dense=ffn == "dense")
                       for kind, ffn in zip(kinds, ffns))
        held = c["num_experts"]
        ep = c.get("expert_parallel", 1)
        return cls(
            d_model=c["hidden_size"], heads=c["num_attention_heads"],
            kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"], vocab=c["vocab_size"],
            dense_width=c["intermediate_size"], expert_width=c["moe_intermediate_size"],
            shared_width=c["moe_intermediate_size"] * c.get("num_shared_experts", 0),
            experts=held * ep, experts_held=held, first_held=held * c.get("expert_shard", 0),
            top_k=c["num_experts_per_tok"], normalize=bool(c.get("norm_topk_prob", True)),
            routed_scale=float(c.get("routed_scaling_factor", 1.0)), eps=c["rms_norm_eps"],
            rope_theta=float(c["rope_parameters"]["rope_theta"]), layers=layers)


# The configurations the perf pod's ``train`` check runs by name
# (``train_bench``; the benchmark keeps its own copy of each under
# ``benchmark/configs/``): K-EXAONE-236B-A23B's published settings
# (huggingface.co/LGAI-EXAONE/K-EXAONE-236B-A23B, config.json) cut to one
# card of a 16-way expert-parallel deployment: layers 0-4 of 48 (dense,
# then L L G L), experts 0-7 of 128 held, an eighth of the vocabulary.
MODELS = {
    "k-exaone-236b-a23b-ep16": {
        "hidden_size": 6144, "num_attention_heads": 64, "num_key_value_heads": 8,
        "head_dim": 128, "intermediate_size": 18432, "moe_intermediate_size": 2048,
        "num_experts": 8, "expert_parallel": 16, "expert_shard": 0, "num_experts_per_tok": 8,
        "num_shared_experts": 1, "norm_topk_prob": True, "routed_scaling_factor": 2.5,
        "scoring_func": "sigmoid", "n_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5,
        "rope_parameters": {"rope_theta": 1000000, "rope_type": "default"},
        "sliding_window": 128, "num_hidden_layers": 5, "vocab_size": 19200,
        "layer_types": [SLIDING] * 3 + [GLOBAL] + [SLIDING],
        "mlp_layer_types": ["dense"] + ["sparse"] * 4,
    },
}


def shapes(cfg: LMConfig) -> dict:
    """Every leaf's name and shape, in the order of the step's leaves: a
    layer's held experts are one leaf each of gate, up and down."""
    d, hd = cfg.d_model, cfg.head_dim
    out = {"embed": (cfg.vocab, d)}
    for i, layer in enumerate(cfg.layers):
        p = f"l{i}."
        out.update({p + "wq": (d, cfg.heads * hd), p + "wk": (d, cfg.kv_heads * hd),
                    p + "wv": (d, cfg.kv_heads * hd), p + "wo": (cfg.heads * hd, d),
                    p + "q_norm": (hd,), p + "k_norm": (hd,), p + "attn_norm": (d,)})
        if layer.dense:
            f = cfg.dense_width
            out.update({p + "w_gate": (d, f), p + "w_up": (d, f), p + "w_down": (f, d)})
        else:
            e, f = cfg.experts_held, cfg.expert_width
            out.update({p + "router": (d, cfg.experts), p + "experts.w_gate": (e, d, f),
                        p + "experts.w_up": (e, d, f), p + "experts.w_down": (e, f, d)})
            if cfg.shared_width:
                s = cfg.shared_width
                out.update({p + "shared.w_gate": (d, s), p + "shared.w_up": (d, s),
                            p + "shared.w_down": (s, d)})
        out[p + "ffn_norm"] = (d,)
    out.update({"final_norm": (d,), "head": (d, cfg.vocab)})
    return out


def init_params(cfg: LMConfig, seed: int, device) -> dict:
    """Weights drawn on ``device`` from ``seed``: normals times 1/sqrt(fan
    in) (the embedding's rows unit normals), norm gains 1 + normals / 10."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {}
    for name, shape in shapes(cfg).items():
        w = torch.randn(shape, generator=gen, device=device)
        if name.endswith("norm"):
            w = 1.0 + 0.1 * w
        elif name != "embed":
            w = w / math.sqrt(shape[-2])
        params[name] = w
    return params


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions in the rotate-half form on x [B, S, H, D] at
    ``positions`` [S]."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = emb.cos()[:, None, :], emb.sin()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat((-x2, x1), dim=-1) * sin


def _attention(cfg: LMConfig, layer: Layer, w: dict, p: str, x: torch.Tensor,
               positions: torch.Tensor, mesh, use_kernel: bool) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = rms_norm((x @ w[p + "wq"]).view(b, s, cfg.heads, hd), w[p + "q_norm"], cfg.eps)
    k = rms_norm((x @ w[p + "wk"]).view(b, s, cfg.kv_heads, hd), w[p + "k_norm"], cfg.eps)
    v = (x @ w[p + "wv"]).view(b, s, cfg.kv_heads, hd)
    if layer.rope:
        q, k = rotary(q, positions, cfg.rope_theta), rotary(k, positions, cfg.rope_theta)
    group = cfg.heads // cfg.kv_heads

    def repeat(t):  # [B, S, G, D] -> [B, S, H, D], query head h on key-value head h // group
        t = t[:, :, :, None].expand(b, s, cfg.kv_heads, group, hd)
        return t.reshape(b, s, cfg.heads, hd)

    a = ring_attention.ring_attention_remat(q, repeat(k), repeat(v), True, use_kernel,
                                            mesh.mp_group, layer.window)
    return rms_norm(a.reshape(b, s, cfg.heads * hd) @ w[p + "wo"], w[p + "attn_norm"], cfg.eps)


def _experts(cfg: LMConfig, w: dict, p: str, x: torch.Tensor, sp) -> torch.Tensor:
    """The expert layer on x [N, d]: route over every expert, this card's
    held ones, the shared expert.  Its counts go into ``sp``'s attrs when a
    tracer is active (they come from the layer's own host read)."""
    with trace.span("train.moe.route"):
        experts, weights = moe.route_sigmoid_topk(x, w[p + "router"], cfg.top_k, cfg.normalize,
                                                  cfg.routed_scale)
    with trace.span("train.moe.experts"):
        f, counts = moe.held_experts(x, experts, weights, cfg.first_held, w[p + "experts.w_gate"],
                                     w[p + "experts.w_up"], w[p + "experts.w_down"])
    if sp is not None:
        sp.attrs.update(routed_pairs=sum(counts), max_load=max(counts), host_reads=1)
    if cfg.shared_width:
        with trace.span("train.moe.shared"):
            f = f + moe.swiglu(x, w[p + "shared.w_gate"], w[p + "shared.w_up"],
                               w[p + "shared.w_down"])
    return f


def _layers(cfg: LMConfig, w: dict, ids: torch.Tensor, mesh, use_kernel: bool) -> torch.Tensor:
    """The embedding and every layer on ``ids`` [b, s + 1]: inputs
    ``ids[:, :-1]`` at positions s·j on (j the rank's mp index).  Returns x
    [b, s, d] before the final norm."""
    inputs = ids[:, :-1]
    b, s = inputs.shape
    positions = mesh.coords[-1] * s + torch.arange(s, device=ids.device)
    x = F.embedding(inputs, w["embed"])
    for i, layer in enumerate(cfg.layers):
        p = f"l{i}."
        with trace.span("train.attn", layer=i, kind=layer.kind):
            x = x + _attention(cfg, layer, w, p, x, positions, mesh, use_kernel)
        if layer.dense:
            with trace.span("train.ffn", layer=i):
                f = moe.swiglu(x, w[p + "w_gate"], w[p + "w_up"], w[p + "w_down"])
        else:
            with trace.span("train.moe", layer=i) as sp:
                f = _experts(cfg, w, p, x.reshape(b * s, -1), sp).view(b, s, -1)
        x = x + rms_norm(f, w[p + "ffn_norm"], cfg.eps)
    return x


def forward_loss(cfg: LMConfig, w: dict, ids: torch.Tensor, mesh, use_kernel: bool,
                 count: int) -> torch.Tensor:
    """Σ cross-entropy / ``count`` of this rank's tokens: ``ids`` [b, s + 1],
    inputs ``ids[:, :-1]``, labels ``ids[:, 1:]``."""
    x = _layers(cfg, w, ids, mesh, use_kernel)
    with trace.span("train.head"):
        logits = rms_norm(x, w["final_norm"], cfg.eps) @ w["head"]
        return F.cross_entropy(logits.flatten(0, 1), ids[:, 1:].reshape(-1),
                               reduction="sum") / count


def token_losses(mesh, cfg: LMConfig, params: dict, ids: torch.Tensor,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Each token's cross-entropy [b, s] under the train step's forward on
    this rank's ids [b, s + 1], with no gradient: the loss token by token,
    where ``train_step`` gives its mean."""
    if use_kernel is None:
        use_kernel = mesh.device.type == "cuda"
    with torch.no_grad():
        x = _layers(cfg, params, ids, mesh, use_kernel)
        logits = rms_norm(x, params["final_norm"], cfg.eps) @ params["head"]
        labels = ids[:, 1:]
        return F.cross_entropy(logits.flatten(0, 1), labels.reshape(-1),
                               reduction="none").view(labels.shape)


def train_step(mesh, cfg: LMConfig, params: dict, ids: torch.Tensor, lr: float,
               use_kernel: Optional[bool] = None) -> tuple:
    """One SGD step on this rank's ids [b, s_loc + 1] (batch over dp, the
    sequence over mp).  Returns ``(loss, new_params)``, the loss the mean
    over every rank's tokens.  ``use_kernel`` (default: on a card) runs
    attention on kernels B3 and B4; otherwise the plain path."""
    if use_kernel is None:
        use_kernel = mesh.device.type == "cuda"
    b, s = ids.shape[0], ids.shape[1] - 1
    with trace.span("train.step", rank=mesh.rank):
        names = list(params)
        ws = {name: params[name].detach().requires_grad_() for name in names}
        share = forward_loss(cfg, ws, ids, mesh, use_kernel, b * mesh.dp * s * mesh.mp)
        with trace.span("train.grads"):
            # a leaf the loss does not reach (none, as configured) takes a zero gradient
            grads = list(torch.autograd.grad(share, [ws[n] for n in names], allow_unused=True))
            new = {}
            for i, name in enumerate(names):
                g = grads[i] if grads[i] is not None else torch.zeros_like(ws[name])
                g = collectives._sum(g, None, mesh.size)
                grads[i] = None
                new[name] = ws[name].detach() - lr * g
            return collectives._sum(share.detach(), None, mesh.size), new
