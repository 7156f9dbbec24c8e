"""Operations and bytes of the language-model cells, from shapes alone:
the (query, key) pairs a causal mask with a sliding window keeps, the work
of kernels B3 f32 and B4 f32 on such a hop, and the model FLOPs of one
train step of ``reference/k_exaone.py``'s equations.  They count what the
inputs need, whatever an implementation does."""

from __future__ import annotations

from benchmark import counts


def window_pairs(tq: int, tk: int, q_off: int, k_off: int, window: int = 0) -> int:
    """(query, key) pairs with 0 <= query position − key position < window
    between a query block at ``q_off`` and a key block at ``k_off``; the
    causal pairs when ``window`` is 0."""
    pairs = counts.causal_pairs(tq, tk, q_off, k_off)
    if window:
        # pairs window or more apart: the causal pairs of the queries moved back by it
        pairs -= counts.causal_pairs(tq, tk, q_off - window, k_off)
    return pairs


def b3_f32_work(bh: int, t: int, d: int, window: int) -> tuple:
    """(FLOPs, bytes) of one fold of a sequence's own keys (a hop at offset
    0): 4·D per kept pair, the bytes of ``counts.b3_f32_work``."""
    _, nbytes = counts.b3_f32_work(bh, t, t, d, 0, 0)
    return 4.0 * d * bh * window_pairs(t, t, 0, 0, window), nbytes


def b4_f32_work(bh: int, t: int, d: int, window: int) -> tuple:
    """(FLOPs, bytes) of one block backward of a sequence's own keys: 10·D
    per kept pair, the bytes of ``counts.b4_f32_work``."""
    _, nbytes = counts.b4_f32_work(bh, t, t, d, 0, 0)
    return 10.0 * d * bh * window_pairs(t, t, 0, 0, window), nbytes


def expert_pair_flops(d_model: int, width: int) -> float:
    """FLOPs of one (token, expert) pair through a SwiGLU expert, forward
    and backward: three products of 2·d·f forward, twice that backward."""
    return 3.0 * 3 * 2 * d_model * width


def step_model_flops(config: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step over ``batch`` sequences of ``seq``
    tokens: 3 × the forward (the backward twice it).  The forward: 2 FLOPs
    a token per weight of every product (Q/K/V/O, the dense SwiGLU, the
    router, the shared expert, the head), the held experts' pairs at their
    expectation (tokens × k × held / experts, three products each), and 4·D
    per kept (query, key) pair and query head for the scores and P·V
    (window-aware: the pairs the mask keeps, ``window_pairs``)."""
    n = config["num_hidden_layers"]
    d, hd, f_e = config["hidden_size"], config["head_dim"], config["moe_intermediate_size"]
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    experts = config["num_experts"] * config.get("expert_parallel", 1)
    window = config.get("sliding_window") or 0
    tokens = batch * seq
    weights = 0.0  # per token, of the products every token goes through
    attn = 0.0     # the scores and P·V over the batch
    for kind, ffn in zip(config["layer_types"][:n], config["mlp_layer_types"][:n]):
        weights += 2 * d * heads * hd + 2 * d * kv * hd
        pairs = window_pairs(seq, seq, 0, 0, window if kind == "sliding_attention" else 0)
        attn += 4.0 * hd * heads * pairs * batch
        if ffn == "dense":
            weights += 3 * d * config["intermediate_size"]
        else:
            weights += d * experts + 3 * d * f_e * config["num_shared_experts"]
            weights += 3 * d * f_e * config["num_experts_per_tok"] * config["num_experts"] / experts
    weights += d * config["vocab_size"]
    return 3.0 * (2.0 * tokens * weights + attn)
