"""Operations and bytes of the work, from shapes alone: what the training
layer's step needs (a copy of the port's ``train_bench.step_model_flops``)
and what one ring hop of the attention kernels needs (the arithmetic of
``chip_smoke.py``'s bounds for B3 f32 and B4).  They count what the inputs
need, whatever an implementation does, so a change to a kernel cannot
change them."""

from __future__ import annotations


def step_model_flops(batch: int, seq: int, d_model: int, d_hidden: int) -> float:
    """Model FLOPs of one train step of the layer over the global batch:
    3 x the forward; the forward 8·b·s·d² (Q, K, V, O), 4·b·s·d·d_hidden
    (the two MLP products) and 4·b·s²·d (scores and P·V, causal masking not
    discounted, as the program's probe counts them)."""
    fwd_proj = 8.0 * batch * seq * d_model * d_model
    fwd_mlp = 4.0 * batch * seq * d_model * d_hidden
    fwd_attn = 4.0 * batch * seq * seq * d_model
    return 3.0 * (fwd_proj + fwd_mlp + fwd_attn)


def causal_pairs(tq: int, tk: int, q_off: int, k_off: int) -> int:
    """(query, key) pairs a causal mask keeps between a query block at
    global offset ``q_off`` and a key block at ``k_off``: key position <=
    query position."""
    total = 0
    a = q_off - k_off + 1  # keys visible to the block's first query
    # query i sees clamp(a + i, 0, tk) keys: zero, then a ramp, then tk
    first_ramp = max(0, -a + 1)              # first i with a + i >= 1
    first_full = max(0, tk - a)              # first i with a + i >= tk
    lo, hi = min(first_ramp, tq), min(first_full, tq)
    if hi > lo:  # the ramp a + i for i in [lo, hi)
        total += (hi - lo) * a + (lo + hi - 1) * (hi - lo) // 2
    total += (tq - max(hi, lo)) * tk
    return total


def ring_hops(mp: int, j: int, block: int) -> list:
    """(q_off, k_off) of every hop of mp rank ``j``'s ring: at hop s it
    holds the key block of rank (j - s) mod mp."""
    return [(j * block, ((j - s) % mp) * block) for s in range(mp)]


def b3_f32_work(bh: int, tq: int, tk: int, d: int, q_off: int, k_off: int) -> tuple:
    """(FLOPs, bytes) of one causal fold of a key block into the online-
    softmax state: 4·D per kept pair; q, k and v read, m, l and o read and
    written, all f32."""
    flops = 4.0 * d * bh * causal_pairs(tq, tk, q_off, k_off)
    nbytes = 4 * (bh * tq * d + 2 * bh * tk * d + 2 * (2 * bh * tq + bh * tq * d))
    return flops, nbytes


def b4_f32_work(bh: int, tq: int, tk: int, d: int, q_off: int, k_off: int) -> tuple:
    """(FLOPs, bytes) of one causal block backward: 10·D per kept pair; q,
    dO, k and v read, lse and dsum read, dq, dk and dv read and written, all
    f32."""
    flops = 10.0 * d * bh * causal_pairs(tq, tk, q_off, k_off)
    nbytes = 4 * (2 * bh * tq * d + 2 * bh * tk * d + 2 * bh * tq
                  + 2 * bh * tq * d + 4 * bh * tk * d)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the card could take: the larger of operations over
    their peak and bytes over the memory rate."""
    return max(flops / peak_flops, nbytes / peak_bytes)
