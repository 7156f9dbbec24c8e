"""Long-context prefill and decode attention on one card.  Port of
``tpu_operator/workloads/longctx.py`` (``:25-413``).

Full causal attention over a long local sequence with K/V streamed through
the flash kernel B5 (``kernels/flash_attention.py``) one tile at a time:
peak memory is O(T·D) plus the kernel's tiles, never the [T, T] score
matrix.  Exactness at scales where the full reference is impossible (32k²
f32 scores per head are 4 GB) comes from spot tiles: one q tile's reference
needs only a [tile, T] score slab, so the first and the last tiles (the
diagonal edge and the full-context row) are checked exactly.

The decode probe calls the same function with an 8-row query tail at the
end of a long cache: the byte-bound half of serving.  On a card the
function's plan runs the prefill on B5's ``wgmma`` kernel and the decode on
its split over the keys (``_forward_plan``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from tpu_operator_torch.kernels.flash_attention import (  # noqa: F401  (re-exported)
    NEG_INF,
    _block_div,
    flash_attention_local,
)
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import profile as obs_profile
from tpu_operator_torch.workloads import resolve_device, timing
from tpu_operator_torch.workloads.ring_attention import merge_heads as _merge  # noqa: F401


def _tile_reference(q_tile, k, v, tile_off, causal):
    """Exact attention for one merged-layout q tile against the full
    sequence: [tile, T] scores only, feasible at any T."""
    s = torch.einsum("btd,bkd->btk", q_tile.float(), k.float()) / math.sqrt(q_tile.shape[-1])
    if causal:
        t = k.shape[1]
        q_pos = tile_off + torch.arange(q_tile.shape[1], device=q_tile.device)
        s = torch.where(q_pos[:, None] >= torch.arange(t, device=q_tile.device)[None, :],
                        s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("btk,bkd->btd", w.to(v.dtype), v)


def _amortized_time(chain_call, null_call, iters: int, best_of: int, name: str = "",
                    device=None):
    """The timing harness both probes run: settle the chain, measure the
    launch + readback floor with the null program, wall-clock ``best_of``
    chained runs, floor-subtract per iteration (``timing`` rules).
    Returns (per_iter_times_sorted, overhead_dominated, last_chain_value).
    ``name`` tags each repetition (and the first run) in the flight
    record."""
    t_first = time.perf_counter()
    last = chain_call()  # first use + settle
    if name:
        flight.record(name, "compile", compile_s=time.perf_counter() - t_first)
    null_call()
    overhead = min(timing.timed(null_call, device) for _ in range(3))
    raw = []
    for rep in range(best_of):
        t0 = time.perf_counter()
        last = chain_call()  # ends in a readback: the card is done
        raw.append(time.perf_counter() - t0)
        if name:
            flight.record(name, "step", step=rep, step_s=raw[-1])
            flight.record_step(
                name, step_seq=rep, wall_s=raw[-1],
                phases={obs_profile.PHASE_COMPUTE: raw[-1]},
            )
    times, dominated = timing.subtract_floor(raw, overhead, per=iters)
    return times, dominated, last


def _randn(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


def prefill_benchmark(
    seq: int = 32768,
    heads: int = 8,
    head_dim: int = 128,
    batch: int = 1,
    block_k: int = 1024,
    tile: int = 128,
    causal: bool = True,
    best_of: int = 3,
    iters: int = 8,
    device=None,
) -> dict:
    """Long-context prefill attention on one card: throughput + spot-tile
    exactness.  Returns the check-result dict (run_validation shape).

    Timing: ``iters`` prefills chained back to back, each output the next
    query (data-dependent, nothing is dead), ending in one scalar readback,
    so the launch and readback floor amortizes."""
    device = resolve_device(device)
    bh = batch * heads
    gen = torch.Generator(device=device).manual_seed(11)
    q, k, v = (_randn(gen, (bh, seq, head_dim), device) for _ in range(3))

    def chain() -> float:
        x = q
        for _ in range(iters):
            x, _ = flash_attention_local(x, k, v, causal, block_k)
        return float(x[0, 0].float().sum())

    def null() -> float:
        return float(q[0, 0].float().sum())

    out, _ = flash_attention_local(q, k, v, causal, block_k)  # the exactness subject
    timing.sync(device)
    times, overhead_dominated, _ = _amortized_time(chain, null, iters, best_of,
                                                   name="longctx", device=device)
    dt = times[0]

    # exactness: first tile (diagonal edge) and last tile (attends to the
    # whole context) against the per-tile reference
    errs = []
    for off in (0, seq - tile):
        ref = _tile_reference(q[:, off:off + tile], k, v, off, causal)
        errs.append(float((out[:, off:off + tile].float() - ref.float()).abs().max()))
    max_err = max(errs)
    # attention FLOPs (causal: half the score/PV work is masked out)
    flops = 4.0 * bh * seq * seq * head_dim * (0.5 if causal else 1.0)
    return {
        "ok": bool(np.isfinite(max_err) and max_err < 2e-2),
        "seq": seq,
        "heads": heads,
        "head_dim": head_dim,
        "block_k": block_k,
        "causal": causal,
        "time_s": dt,
        "overhead_dominated": overhead_dominated,
        "tokens_per_sec": batch * seq / dt,
        "attn_tflops": flops / dt / 1e12,
        "attn_tflops_spread": {
            "min": flops / times[-1] / 1e12,
            "median": flops / times[len(times) // 2] / 1e12,
            "max": flops / dt / 1e12,
        },
        "max_error": max_err,
        "spot_tiles": [0, seq - tile],
        "backend": device.type,
    }


def decode_benchmark(
    seq: int = 32768,
    heads: int = 8,
    head_dim: int = 128,
    batch: int = 1,
    block_k: int = 1024,
    iters: int = 1024,
    best_of: int = 3,
    device=None,
) -> dict:
    """Decode-attention throughput: an 8-row query tail (the last row is
    the decode position) against a long KV cache, the byte-bound half of
    serving (each decoded token reads the whole cache).  Chained
    data-dependently, each decode's output the next one's query, ending in
    one readback.  Reports per-token latency and the achieved cache-read
    rate against the card's data-sheet memory rate."""
    from tpu_operator_torch.k8s.nodeinfo import detect_generation, generation_info

    device = resolve_device(device)
    bh = batch * heads
    tail = 8
    gen = torch.Generator(device=device).manual_seed(13)
    q = _randn(gen, (bh, tail, head_dim), device)
    k = _randn(gen, (bh, seq, head_dim), device)
    v = _randn(gen, (bh, seq, head_dim), device)

    def chain() -> float:
        x = q
        for _ in range(iters):
            # the next decode's query depends on this one's output
            x, _ = flash_attention_local(x, k, v, causal=True, block_k=block_k,
                                         q_off=seq - tail)
        return float(x[:, -1].float().sum())

    def null() -> float:
        return float(q[:, -1].float().sum())

    times, overhead_dominated, last = _amortized_time(chain, null, iters, best_of,
                                                      name="decode", device=device)
    dt = times[0]

    cache_bytes = 2.0 * bh * seq * head_dim * 2  # K and V, bf16
    generation = detect_generation(device)
    peak = generation_info(generation).hbm_gbps
    result = {
        # the chained decodes' readback is the correctness signal at real
        # shapes (exactness is pinned by the kernel checks): NaN or garbage
        # must fail the check, not just time well
        "ok": bool(np.isfinite(dt) and dt > 0 and np.isfinite(last)),
        "seq": seq,
        "heads": heads,
        "head_dim": head_dim,
        "batch": batch,
        "decode_us": dt * 1e6,
        "decode_us_median": times[len(times) // 2] * 1e6,
        "decode_us_max": times[-1] * 1e6,
        "decodes_per_sec": batch / dt,
        "cache_gbps": cache_bytes / dt / 1e9,
        "cache_gbps_min": cache_bytes / times[-1] / 1e9,
        "overhead_dominated": overhead_dominated,
        "backend": device.type,
        "generation": generation,
    }
    if peak > 0:
        result["cache_fraction_of_peak"] = round(result["cache_gbps"] / peak, 4)
    return result


def quick_check(device=None) -> dict:
    """The validator's probe: 32k tokens on a card; tiny shapes on the
    CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return prefill_benchmark(device=device)
    return prefill_benchmark(seq=256, heads=2, head_dim=8, block_k=64, tile=32, best_of=2,
                             device=device)


def decode_quick_check(device=None) -> dict:
    """The decode probe: a 32k cache on a card; tiny shapes on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return decode_benchmark(device=device)
    return decode_benchmark(seq=128, heads=2, head_dim=8, block_k=32, iters=2, best_of=2,
                            device=device)


def main() -> int:
    import json

    from tpu_operator_torch.validator import status as vstatus

    with flight.activate(flight.recorder_for(vstatus.flight_record_path())):
        result = quick_check()
        flight.record_result("longctx", result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
