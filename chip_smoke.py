#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on an NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths, the node readiness gate, the long-context
attention checks, the post-ready perf probes and training, the way the
validator runs them, and holds every kernel on those paths against its
plain PyTorch version.  Phases, each fatal on failure:

1. device    — a CUDA card must be visible (no CPU fallback); prints its
   name and power limit as nvidia-smi reports them
2. build     — compiles every source in ``tpu_operator_torch/csrc`` with
   nvcc, one process per source, all started together
3. gate      — ``run_validation.main()`` with vector-add, allreduce and
   burn-in at their shipping sizes and EXPECTED_DEVICES set: exit 0, one
   JSON line per check, a drop-box holding all of them, finite outputs that
   agree with a float64 reference, and the vector_add launch count above 0
4. attention — ``run_validation.main()`` with longctx (32k prefill), decode
   (32k cache, 1024 chained decodes) and ring-attention (512 tokens, 4
   heads, head dim 128 per card): exit 0, one JSON line per check, the
   drop-box, longctx spot tiles and ring within 2e-2 of their references,
   finite decode output, and both flash kernels' launch counts above 0
5. probes    — ``run_validation.main()`` with matmul, hbm, hbm-dma (and
   ring on more than one card) at their shipping sizes under
   RESULTS_SCOPE=perf: exit 0, one JSON line per check, the perf drop-box
   and flight record, the DMA-pipeline kernel's launch count above 0 and
   hbm-dma on it, matmul finite with 0 < MFU <= 1, hbm and hbm-dma at
   0 < share of the memory rate <= 1.05 (above that is L2 reuse or a
   mis-count, not a fast card), ring max_error exactly 0
6. training  — ``run_validation.main()`` with transformer (3 steps, head dim
   32, 16 tokens per card) and train (the reference's full width: batch 4,
   2048 tokens, d_model 4096, d_hidden 16384, 32 heads, per card; 4 steps
   x (first use + best of 3)): exit 0, one JSON line per check, the
   drop-box, transformer losses finite and strictly falling, train ok with
   a finite loss, tokens/s > 0 and attention on ``cuda-flash-fwd-bwd``,
   and the launch counts of B3's f32 entry and of B4 above 0; prints every
   step time
7. kernel    — each kernel against its plain version on the card: the f32
   add bit-identical (tolerance 0) at the gate's shape, a ragged shape and
   a view one element off 16-byte alignment; the flash kernels at the main
   paths' shapes, ragged serving shapes and a fully masked block: per case,
   max |out - plain| within 1e-2 of max |plain| (one bf16 step at the
   largest output is at most 2^-7 = 7.8e-3 of it), and m, l, lse within
   1e-5 relative (f32 sums in another order); the fully masked block leaves
   the state bit-identical; the DMA copy bit-identical (as int32 or int16
   views, tolerance 0) on random bit patterns with NaN payloads, at the toy
   shapes, the probe shape and in bf16, and the wrapper's alignment
   rejections; B4 (f32 and bf16) and B3's f32 entry at the train hop
   (128, 2048, 128) causal, the transformer check's (16, 16, 32), ragged
   shapes and a fully masked block, which must leave the accumulators or
   the state bit-identical: per output, max |kernel - plain| within 1e-4 of
   max |plain| in f32 and 1e-2 in bf16 (B4: this hop's contribution, on
   top of non-zero accumulators)
8. timing    — CUDA-event medians of each kernel, its plain version and the
   library call where one exists, beside the least time the card allows
   (the larger of bytes over its memory rate and operations over its peak
   for their type, from ``tpu_operator_torch/k8s/nodeinfo.py``); the DMA
   copy at the probe's shape at 1 and 16 passes per launch; B4 and B3's
   f32 entry at the train hop, B4's library call the backward alone of
   ``scaled_dot_product_attention`` (its backend named)

Launch counts are set to 0 just before each main path runs and read just
after it; the kernel and timing phases' launches are not counted.  Prints
the ``kernels`` JSON line, then, last, ``{"ok": true, "device": ...}``.
Needs one card; uses every visible card for the gate's collectives and the
ring.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

GATE_SHAPE = (2048, 512)  # vector_add's default n = 1 << 20
BIG_SHAPE = (65536, 512)  # 128 MiB per operand: past the 50 MB L2
GATE_CHECKS = ("vector-add", "allreduce", "burn-in")
ATTENTION_CHECKS = ("longctx", "decode", "ring-attention")
PROBE_CHECKS = ("matmul", "hbm", "hbm-dma")  # + ring on more than one card
TRAIN_CHECKS = ("transformer", "train")
DMA_PROBE = ((131072, 512), 2048, 4)  # hbm-dma's shipping (shape, chunk_rows, slots): 256 MiB f32
MAX_SHARE = 1.05           # of the memory rate: above it is L2 reuse or a mis-count
PREFILL = (8, 32768, 128)  # longctx's shipping shape, [BH, T, D]
DECODE_TAIL = 8            # decode's query rows at the end of the cache
RING_HOP = (4, 512, 128)   # one ring hop per card: 4 heads, 512 tokens
TRAIN_HOP = (128, 2048, 128)      # train's hop per card: batch 4 x 32 heads, 2048 tokens
TRANSFORMER_HOP = (16, 16, 32)    # the transformer check's: batch 4 x 4 heads, 16 tokens
TRAIN_WIDTH = (4096, 16384)       # train's d_model, d_hidden: the reference's TPU shapes
OUT_TOL = 2e-2             # the checks' max_error: bf16 output, the reference's bound
KERNEL_OUT_RTOL = 1e-2     # kernel vs plain: max|out - plain| / max|plain|, per case
STATE_RTOL = 1e-5          # m, l, lse: f32 sums in another order
F32_RTOL = 1e-4            # f32 kernels vs plain: max|out - plain| / max|plain|, per output


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def peaks(name: str) -> tuple:
    """(memory bytes/s, bf16 FLOP/s, f32 CUDA-core FLOP/s) of the card, from
    the data sheets."""
    from tpu_operator_torch.k8s import nodeinfo

    info = nodeinfo.generation_info(nodeinfo.generation_of(name))
    require(info.hbm_gbps > 0 and info.peak_fp32_tflops > 0,
            f"no memory rate or f32 peak on record for {name!r}")
    return info.hbm_gbps * 1e9, info.peak_bf16_tflops * 1e12, info.peak_fp32_tflops * 1e12


def device_phase():
    import torch

    require(torch.cuda.is_available(), "no CUDA device visible: chip_smoke needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    return torch.cuda.get_device_name(0), torch.cuda.device_count()


def build_phase() -> None:
    from tpu_operator_torch.kernels import _build

    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(_build.build, sources)))
    wall = time.perf_counter() - t0
    for name in sources:
        _build.library(name)
        print(f"build: {name} {built[name].seconds:.2f}s -> {built[name].path}", flush=True)
        if built[name].log.strip():
            print(built[name].log.strip(), flush=True)
    print(f"build: {len(sources)} sources in {wall:.2f}s wall", flush=True)


def run_checks(checks: tuple, n_cards: int, counters, scope: str = "") -> tuple:
    """``run_validation.main()`` with ``checks``, EXPECTED_DEVICES and
    RESULTS_SCOPE=``scope`` set, its stdout captured; ``counters()`` is read
    just after the run.  Returns (lines by check, counters read); fails
    unless rc is 0, the JSON lines and the scope's drop-box hold exactly the
    device check and ``checks``, and the scope's flight record exists."""
    from tpu_operator_torch.validator import status
    from tpu_operator_torch.workloads import run_validation

    label = ",".join(checks)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
        os.environ.update({
            "WORKLOAD_CHECKS": label,
            "EXPECTED_DEVICES": str(n_cards),
            "DEVICE_COUNT_GATE_BACKENDS": "cuda",
            "TPU_VALIDATION_ROOT": root,
            "RESULTS_SCOPE": scope,
        })
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run_validation.main()
        seconds = time.perf_counter() - t0
        counts = counters()
        lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
        for line in lines:
            print(json.dumps(line), flush=True)
        print(f"{label}: rc={rc} in {seconds:.2f}s, launches={counts}", flush=True)
        require(rc == 0, f"run_validation ({label}) exited {rc}")
        names = [line["check"] for line in lines]
        require(names == ["devices", *checks], f"JSON lines for {names}")
        dropbox = status.read_workload_results(scope)
        require(dropbox is not None, f"no drop-box written (scope {scope!r})")
        require(set(dropbox["checks"]) == {"devices", *checks},
                f"drop-box holds {sorted(dropbox['checks'])}")
        require(os.path.exists(status.flight_record_path(scope)),
                f"no flight record written (scope {scope!r})")
    return {line["check"]: line for line in lines}, counts


def gate_phase(n_cards: int) -> int:
    """Run the gate through its entry point; returns the kernel's launches."""
    import numpy as np
    import torch

    from tpu_operator_torch.kernels import vector_add as va
    from tpu_operator_torch.workloads import collectives

    va.launches = 0
    by, launches = run_checks(GATE_CHECKS, n_cards, lambda: va.launches)
    require(launches > 0, "the gate ran without launching the vector_add kernel")

    require(by["vector-add"]["max_error"] == 0.0, "vector-add disagrees with x + y")
    require(by["allreduce"]["max_error"] == 0.0, "allreduce chain lost its ones")
    require(math.isfinite(by["allreduce"]["busbw_gbps"]), "allreduce rate not finite")
    losses = by["burn-in"]["losses"]
    require(len(losses) == 3 and all(math.isfinite(v) for v in losses), f"losses {losses}")
    # first-step loss against float64 on the host, same weights and batch:
    # the card computes it in full f32 (TF32 off), so 1e-4 relative is ample
    w1, w2 = collectives._burn_in_weights(512, 2048, 0)
    x = np.random.default_rng(1).standard_normal((64, 512), dtype=np.float32)
    x = torch.tensor(x).bfloat16().double().numpy()
    ref = float(np.mean(np.square(np.maximum(x @ w1, 0) @ w2)))
    rel = abs(losses[0] - ref) / ref
    print(f"burn-in: first loss {losses[0]!r} vs float64 {ref!r} (rel {rel:.2e}, tol 1e-4)", flush=True)
    require(rel < 1e-4, "burn-in loss disagrees with the float64 reference")
    return launches


def attention_phase(n_cards: int) -> tuple:
    """Run the long-context checks through the entry point; returns the
    launches of the flash forward and of the block update."""
    from tpu_operator_torch.kernels import flash_attention as fa

    fa.forward_launches = 0
    fa.block_update_launches = 0
    by, (forward, update) = run_checks(
        ATTENTION_CHECKS, n_cards, lambda: (fa.forward_launches, fa.block_update_launches))
    ring = by["ring-attention"]
    if ring["devices"] > 1:
        # the ring ran in one process per card: rank 0 counted its own
        update += ring["launches"]
    require(forward > 0, "longctx and decode ran without launching the flash forward kernel")
    require(update > 0, "ring-attention ran without launching the flash block update kernel")
    lc, dec = by["longctx"], by["decode"]
    require(lc["max_error"] < OUT_TOL, f"longctx spot tiles off by {lc['max_error']}")
    require(dec["ok"] and math.isfinite(dec["decode_us"]), "decode output not finite")
    require(ring["max_error"] < OUT_TOL, f"ring-attention off by {ring['max_error']}")
    require(ring["kernel"] == "cuda-flash", f"ring-attention folded with {ring['kernel']}")
    print(f"attention: longctx {lc['attn_tflops']!r} attn-TFLOP/s, decode "
          f"{dec['decode_us']!r} us/token ({dec['cache_gbps']!r} GB/s), ring max_error "
          f"{ring['max_error']!r} over {ring['devices']} card(s)", flush=True)
    return forward, update


def probes_phase(n_cards: int) -> int:
    """Run the post-ready perf probes through the entry point, as the
    validator's perf-probes pod does (RESULTS_SCOPE=perf); returns the
    DMA-pipeline kernel's launches."""
    from tpu_operator_torch.kernels import dma_pipeline as dp

    checks = PROBE_CHECKS + (("ring",) if n_cards > 1 else ())
    dp.launches = 0
    by, launches = run_checks(checks, n_cards, lambda: dp.launches, scope="perf")
    require(launches > 0, "hbm-dma ran without launching the DMA-pipeline kernel")
    mm, hbm, dma = by["matmul"], by["hbm"], by["hbm-dma"]
    require(dma["kernel"] == "cuda-dma", f"hbm-dma copied with {dma['kernel']}")
    require(all(r["finite"] for r in mm["results"]), "matmul chain not finite")
    require(mm["mfu"] is not None and 0 < mm["mfu"] <= 1.0, f"matmul MFU {mm['mfu']}")
    for label, r in (("hbm", hbm), ("hbm-dma", dma)):
        share = r["fraction_of_peak"]
        require(share is not None and 0 < share <= MAX_SHARE,
                f"{label} at {share} of the memory rate")
    per_size = ", ".join(f"{r['size']}: {r['tflops']!r}" for r in mm["results"])
    ring = ""
    if n_cards > 1:
        rr = by["ring"]
        require("skipped" not in rr and rr["max_error"] == 0.0,
                f"ring max_error {rr.get('max_error')}")
        ring = f", ring {rr['link_gbps']!r} GB/s per link over {rr['devices']} cards"
    print(f"probes: matmul {mm['tflops']!r} TFLOP/s (MFU {mm['mfu']!r}; by size {per_size}), "
          f"hbm {hbm['gbps']!r} GB/s ({hbm['fraction_of_peak']!r}), hbm-dma {dma['gbps']!r} "
          f"GB/s ({dma['fraction_of_peak']!r}){ring}", flush=True)
    return launches


def training_phase(n_cards: int) -> tuple:
    """Run transformer and train through the entry point; returns the
    launches of B3's f32 entry and of B4, and train's result."""
    from tpu_operator_torch.kernels import flash_attention as fa
    from tpu_operator_torch.kernels import flash_backward as fb

    fa.block_update_f32_launches = 0
    fb.backward_launches = 0
    by, (forward, backward) = run_checks(
        TRAIN_CHECKS, n_cards, lambda: (fa.block_update_f32_launches, fb.backward_launches))
    tr, train = by["transformer"], by["train"]
    if n_cards > 1:
        # the checks ran in one process per card: rank 0 counted its own
        for r in (tr, train):
            forward += r["launches"]["flash_block_update_f32"]
            backward += r["launches"]["flash_block_backward"]
    require(forward > 0, "training ran without launching the f32 flash block update kernel")
    require(backward > 0, "training ran without launching the flash block backward kernel")
    losses = tr["losses"]
    require(len(losses) == 3 and all(math.isfinite(v) for v in losses)
            and all(b < a for a, b in zip(losses, losses[1:])), f"transformer losses {losses}")
    for label, r in (("transformer", tr), ("train", train)):
        require(r["attention_kernel"] == "cuda-flash-fwd-bwd",
                f"{label} ran attention on {r['attention_kernel']}")
    require(train["ok"] and math.isfinite(train["loss"]) and math.isfinite(train["loss_last"]),
            f"train loss {train['loss']}, {train['loss_last']}")
    require(train["tokens_per_sec"] > 0, f"train at {train['tokens_per_sec']} tokens/s")
    require((train["d_model"], train["d_hidden"]) == TRAIN_WIDTH
            and train["seq"] == TRAIN_HOP[1] * train["mesh"]["mp"],
            f"train ran at d_model {train['d_model']}, seq {train['seq']}")
    print(f"transformer: losses {losses}, step times (s) {tr['step_s']} over "
          f"{tr['devices']} card(s)", flush=True)
    print(f"train: step times (ms, floor subtracted) {train['step_times_ms']}; best "
          f"{train['step_time_ms']!r} ms, {train['tokens_per_sec']!r} tokens/s, "
          f"{train['model_tflops']!r} model TFLOP/s, MFU {train.get('train_mfu')!r} (against "
          f"the bf16 peak; the step is f32), launches on rank 0 {train['launches']}",
          flush=True)
    return forward, backward, train


def kernel_phase() -> float:
    """Bit-for-bit parity of the kernel with its plain version."""
    import torch

    from tpu_operator_torch.kernels import vector_add as va

    gen = torch.Generator(device="cuda").manual_seed(0)

    def pair(shape, offset=0):
        n = math.prod(shape) + offset
        x = torch.randn(n, generator=gen, device="cuda")[offset:].view(shape)
        y = torch.randn(n, generator=gen, device="cuda")[offset:].view(shape)
        return x, y

    cases = {
        "gate (2048, 512)": pair(GATE_SHAPE),
        "ragged (1000, 509)": pair((1000, 509)),
        "unaligned (2048, 512) + 1 element": pair(GATE_SHAPE, offset=1),
    }
    require(cases["unaligned (2048, 512) + 1 element"][0].data_ptr() % 16 != 0,
            "unaligned case is aligned")
    worst = 0.0
    for label, (x, y) in cases.items():
        out = va.vector_add_kernel(x, y)
        torch.cuda.synchronize()
        ref = va.vector_add_reference(x, y)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        same_bits = bool(torch.equal(out.view(torch.int32), ref.view(torch.int32)))
        print(f"kernel vector_add {label}: max_abs_err={err!r} bit_identical={same_bits}", flush=True)
        require(same_bits, f"vector_add differs from x + y at {label}")
        worst = max(worst, err)
    return worst


def _abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _scaled_err(a, b) -> float:
    """max |a - b| over max |b|: the error against the output's own scale,
    which at 32k keys is about 0.02, not 1."""
    return _abs_err(a, b) / float(b.float().abs().max())


def _rel_err(a, b) -> float:
    """max |a - b| / max(|b|, 1): relative where |b| >= 1 (lse and m cross
    zero, where a relative error means nothing)."""
    b = b.float()
    return float(((a.float() - b).abs() / b.abs().clamp_min(1.0)).max())


def flash_kernel_phase() -> dict:
    """Each flash kernel against its plain version on the card; returns the
    worst out error of each."""
    import torch

    from tpu_operator_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    worst = {"flash_attention_local": 0.0, "flash_block_update": 0.0}
    bh, t, d = PREFILL
    forward_cases = [
        # label, bh, tq, tk, d, causal, q_off, block_q, block_k
        (f"prefill {PREFILL} causal", bh, t, t, d, True, 0, 1024, 1024),
        (f"({bh}, 4096, {d}) causal", bh, 4096, 4096, d, True, 0, 1024, 1024),
        (f"({bh}, 4096, {d}) non-causal", bh, 4096, 4096, d, False, 0, 1024, 1024),
        (f"decode tail {DECODE_TAIL} x {t}", bh, DECODE_TAIL, t, d, True, t - DECODE_TAIL,
         1024, 1024),
    ]
    for tt in (40, 136):
        for dd in (8, 16):
            forward_cases.append((f"serving T={tt} D={dd} block_q=8", 4, tt, tt, dd, True, 0,
                                  8, 16))
    forward_cases.append(("serving T=136 D=16 non-causal", 4, 136, 136, 16, False, 0, 8, 16))
    for label, bh_, tq, tk, dd, causal, q_off, block_q, block_k in forward_cases:
        q, k, v = randn(bh_, tq, dd), randn(bh_, tk, dd), randn(bh_, tk, dd)
        out, lse = fa.flash_attention_local(q, k, v, causal, block_k, block_q, q_off)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_local_reference(q, k, v, causal, block_k, block_q,
                                                          q_off)
        err, scaled, lse_err = _abs_err(out, ref), _scaled_err(out, ref), _rel_err(lse, ref_lse)
        print(f"kernel flash_attention_local {label}: out max_abs_err={err!r} "
              f"(/max|plain| {scaled!r}) lse max_rel_err={lse_err!r}", flush=True)
        require(scaled <= KERNEL_OUT_RTOL and lse_err <= STATE_RTOL,
                f"flash_attention_local differs from its plain version at {label}")
        worst["flash_attention_local"] = max(worst["flash_attention_local"], err)
        del q, k, v, out, lse, ref, ref_lse

    bh, t, d = RING_HOP
    q = randn(bh, t, d)
    k1, v1, k2, v2 = (randn(bh, t, d) for _ in range(4))

    def fresh():
        return (torch.full((bh, t), fa.NEG_INF, device="cuda"),
                torch.zeros((bh, t), device="cuda"), torch.zeros((bh, t, d), device="cuda"))

    q_off = 2 * t
    # a carried state: an earlier, fully visible block already folded in
    carried = fa.flash_block_update_reference(q, k1, v1, q_off, q_off - t, *fresh(), True)
    update_cases = [
        # label, state, k_off, causal
        ("hop diagonal, carried state, causal", carried, q_off, True),
        ("hop half visible, fresh state, causal", fresh(), q_off - t // 2, True),
        ("hop, carried state, non-causal", carried, 5 * t, False),
        ("fully masked block (k_off > q_off + Tq), carried state", carried, q_off + t + 64, True),
        ("fully masked block, fresh state", fresh(), q_off + t + 64, True),
    ]
    for label, state, k_off, causal in update_cases:
        m, l, o = (x.clone() for x in state)
        fa.flash_block_update(q, k2, v2, q_off, k_off, m, l, o, causal)
        torch.cuda.synchronize()
        rm, rl, ro = fa.flash_block_update_reference(q, k2, v2, q_off, k_off, *state, causal)
        if "fully masked" in label:
            same = all(torch.equal(a, b) for a, b in zip((m, l, o), state))
            print(f"kernel flash_block_update {label}: state unchanged={same}", flush=True)
            require(same, f"flash_block_update changed the state at {label}")
            continue

        def normalized(o_, l_):
            return o_ / torch.where(l_ > 0, l_, 1.0)[..., None]

        out, ref = normalized(o, l), normalized(ro, rl)
        err, scaled = _abs_err(out, ref), _scaled_err(out, ref)
        m_err, l_err = _rel_err(m, rm), _rel_err(l, rl)
        print(f"kernel flash_block_update {label}: out max_abs_err={err!r} "
              f"(/max|plain| {scaled!r}) m max_rel_err={m_err!r} l max_rel_err={l_err!r}",
              flush=True)
        require(scaled <= KERNEL_OUT_RTOL and m_err <= STATE_RTOL and l_err <= STATE_RTOL,
                f"flash_block_update differs from its plain version at {label}")
        worst["flash_block_update"] = max(worst["flash_block_update"], err)
    return worst


def _hop_inputs(gen, dtype, bh, tq, tk, d, q_off, k_off, causal) -> tuple:
    """One ring hop as the remat backward sees it: q, k, v, dO in ``dtype``,
    the forward's lse and dsum = rowsum(dO * O) (from the plain f32 fold),
    and non-zero incoming accumulators dq, dk, dv."""
    import torch

    from tpu_operator_torch.kernels import flash_attention as fa

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, do = randn(bh, tq, d).to(dtype), randn(bh, tq, d).to(dtype)
    k, v = randn(bh, tk, d).to(dtype), randn(bh, tk, d).to(dtype)
    fresh = (torch.full((bh, tq), fa.NEG_INF, device="cuda"),
             torch.zeros((bh, tq), device="cuda"), torch.zeros((bh, tq, d), device="cuda"))
    m, l, o = fa.flash_block_update_reference(q.float(), k.float(), v.float(), q_off, k_off,
                                              *fresh, causal)
    denom = torch.where(l > 0, l, 1.0)
    dsum = (do.float() * (o / denom[..., None])).sum(-1)
    return (q, k, v, do, m + torch.log(denom), dsum), (randn(bh, tq, d), randn(bh, tk, d),
                                                      randn(bh, tk, d))


def train_kernel_phase() -> dict:
    """B4 (f32 and bf16) and B3's f32 entry against their plain versions on
    the card; returns the worst absolute error of each."""
    import torch

    from tpu_operator_torch.kernels import flash_attention as fa
    from tpu_operator_torch.kernels import flash_backward as fb

    gen = torch.Generator(device="cuda").manual_seed(6)
    (bh, t, d), (tb, tt, td) = TRAIN_HOP, TRANSFORMER_HOP
    cases = [
        # label, bh, tq, tk, d, q_off, k_off, causal
        (f"train hop {TRAIN_HOP} causal", bh, t, t, d, 0, 0, True),
        (f"transformer {TRANSFORMER_HOP} causal", tb, tt, tt, td, 0, 0, True),
        ("ragged (4, 136 x 200, 16) causal, partly visible", 4, 136, 200, 16, 200, 100, True),
        ("ragged (2, 200 x 136, 64) causal, rows with no key", 2, 200, 136, 64, 0, 16, True),
        ("ragged (3, 40 x 72, 8) non-causal", 3, 40, 72, 8, 0, 0, False),
        ("fully masked (4, 136 x 200, 16)", 4, 136, 200, 16, 0, 200, True),
    ]
    worst = {"flash_block_backward": 0.0, "flash_block_update_f32": 0.0}
    for dtype, tol in ((torch.float32, F32_RTOL), (torch.bfloat16, KERNEL_OUT_RTOL)):
        for label, bh_, tq, tk, dd, q_off, k_off, causal in cases:
            args, acc = _hop_inputs(gen, dtype, bh_, tq, tk, dd, q_off, k_off, causal)
            mine = tuple(a.clone() for a in acc)
            fb.flash_block_backward(*args, *mine, q_off, k_off, causal)
            torch.cuda.synchronize()
            label = f"{label} {str(dtype)[6:]}"
            if "fully masked" in label:
                same = all(torch.equal(a, b) for a, b in zip(mine, acc))
                print(f"kernel flash_block_backward {label}: dq/dk/dv unchanged={same}",
                      flush=True)
                require(same, f"flash_block_backward changed the accumulators at {label}")
                continue
            ref = fb.flash_block_backward_reference(*args, *acc, q_off, k_off, causal)
            # this hop's contribution, on top of the incoming accumulators
            errs = {name: (_abs_err(a - x, b - x), _scaled_err(a - x, b - x))
                    for name, a, b, x in zip(("dq", "dk", "dv"), mine, ref, acc)}
            print(f"kernel flash_block_backward {label}: " + ", ".join(
                f"{name} max_abs_err={e!r} (/max|plain| {r!r})" for name, (e, r) in errs.items()),
                flush=True)
            require(all(r <= tol for _, r in errs.values()),
                    f"flash_block_backward differs from its plain version at {label}")
            worst["flash_block_backward"] = max(worst["flash_block_backward"],
                                                *(e for e, _ in errs.values()))
            del args, acc, mine, ref

    def fresh(bh_, tq, dd):
        return (torch.full((bh_, tq), fa.NEG_INF, device="cuda"),
                torch.zeros((bh_, tq), device="cuda"), torch.zeros((bh_, tq, dd), device="cuda"))

    for label, bh_, tq, tk, dd, q_off, k_off, causal in cases:
        q, k, v, k0, v0 = (torch.randn((bh_, n, dd), generator=gen, device="cuda")
                           for n in (tq, tk, tk, tk, tk))
        # the diagonal hops from a fresh state, as the ring's first hop; the
        # others on a carried state (an earlier, fully visible block)
        state = fresh(bh_, tq, dd)
        if (q_off, k_off) != (0, 0):
            state = fa.flash_block_update_reference(q, k0, v0, q_off, k_off, *state, False)
        m, l, o = (x.clone() for x in state)
        fa.flash_block_update(q, k, v, q_off, k_off, m, l, o, causal)
        torch.cuda.synchronize()
        if "fully masked" in label:
            same = all(torch.equal(a, b) for a, b in zip((m, l, o), state))
            print(f"kernel flash_block_update f32 {label}: state unchanged={same}", flush=True)
            require(same, f"f32 flash_block_update changed the state at {label}")
            continue
        rm, rl, ro = fa.flash_block_update_reference(q, k, v, q_off, k_off, *state, causal)
        out, ref = o / l[..., None], ro / rl[..., None]
        errs = {"out": (_abs_err(out, ref), _scaled_err(out, ref)),
                "l": (_abs_err(l, rl), _scaled_err(l, rl)), "m": (_abs_err(m, rm), _rel_err(m, rm))}
        print(f"kernel flash_block_update f32 {label}: " + ", ".join(
            f"{name} max_abs_err={e!r} (rel {r!r})" for name, (e, r) in errs.items()), flush=True)
        require(errs["out"][1] <= F32_RTOL and errs["l"][1] <= F32_RTOL
                and errs["m"][1] <= STATE_RTOL,
                f"f32 flash_block_update differs from its plain version at {label}")
        worst["flash_block_update_f32"] = max(worst["flash_block_update_f32"], errs["out"][0])
    return worst


def _random_bits(gen, shape, dtype):
    """Random bit patterns of ``dtype`` (f32 or bf16), a few NaN payloads
    (quiet and signalling, both signs) and infinities among them."""
    import torch

    ints = torch.int32 if dtype == torch.float32 else torch.int16
    info = torch.iinfo(ints)
    n = math.prod(shape)
    bits = torch.randint(info.min, info.max, (n,), generator=gen, device="cuda", dtype=ints)
    if dtype == torch.float32:
        special = [0x7FC00001, 0x7FA00000, -0x003FFFFF, 0x7F800000, -0x00800000]
    else:
        special = [0x7FC1, 0x7FA0, -0x003F, 0x7F80, -0x0080]
    bits[:len(special)] = torch.tensor(special, dtype=ints, device="cuda")
    return bits.view(dtype).view(shape)


def dma_kernel_phase() -> float:
    """Bit-for-bit parity of the DMA-pipeline kernel with its plain version;
    returns max |out - plain| over the finite elements (0.0 when every case
    is bit-identical)."""
    import torch

    from tpu_operator_torch.kernels import dma_pipeline as dp

    gen = torch.Generator(device="cuda").manual_seed(4)
    (rows, cols), chunk, slots = DMA_PROBE
    cases = [
        # label, shape, dtype, iters, chunk_rows, slots
        *((f"toy (32, 512) iters={i} chunk={c} slots={s}", (32, 512), torch.float32, i, c, s)
          for i, c, s in ((2, 8, 2), (1, 8, 1), (1, 8, 4), (3, 16, 2))),
        (f"probe ({rows}, {cols}) iters=1", (rows, cols), torch.float32, 1, chunk, slots),
        (f"probe ({rows}, {cols}) iters=2, 64 slots", (rows, cols), torch.float32, 2, chunk, 64),
        ("bf16 (256, 512) iters=2", (256, 512), torch.bfloat16, 2, 64, 2),
    ]
    worst = 0.0
    for label, shape, dtype, iters, chunk_rows, n_slots in cases:
        x = _random_bits(gen, shape, dtype)
        out = dp.dma_pipeline_copy(x, iters, chunk_rows, n_slots)
        torch.cuda.synchronize()
        ref = dp.dma_pipeline_copy_reference(x, iters)
        ints = torch.int32 if dtype == torch.float32 else torch.int16
        same = bool(torch.equal(out.view(ints), ref.view(ints)))
        finite = ref.isfinite()
        err = _abs_err(out[finite], ref[finite])
        print(f"kernel dma_pipeline_copy {label}: tile {dp.tile_bytes(x, chunk_rows, n_slots)} "
              f"bytes, max_abs_err={err!r} bit_identical={same}", flush=True)
        require(same, f"dma_pipeline_copy differs from its plain version at {label}")
        worst = max(worst, err)
        del x, out, ref
    # what a bulk copy does not take is refused before any launch
    base = torch.zeros(64 * 512 + 1, device="cuda")
    for label, x in (("a view one element off 16-byte alignment", base[1:].view(64, 512)),
                     ("12-byte rows", torch.zeros((64, 3), device="cuda")),
                     ("a transposed view", torch.zeros((512, 64), device="cuda").t())):
        try:
            dp.dma_pipeline_copy(x, 1, 8, 1)
        except ValueError as e:
            print(f"kernel dma_pipeline_copy rejects {label}: {e}", flush=True)
        else:
            raise RuntimeError(f"dma_pipeline_copy took {label}")
    return worst


def time_ms(fn, reps: int = 25, per: int = 20) -> float:
    """Median over ``reps`` runs of the per-launch time of ``per`` launches
    back to back, by CUDA events.  A sleep kernel holds the stream while the
    host enqueues the run, so host launch overhead stays out of it."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per)
    return statistics.median(samples)


def timing_phase(name: str) -> dict:
    import torch

    from tpu_operator_torch.kernels import vector_add as va

    rate = peaks(name)[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for shape in (GATE_SHAPE, BIG_SHAPE):
        x = torch.randn(shape, generator=gen, device="cuda")
        y = torch.randn(shape, generator=gen, device="cuda")
        nbytes = 3 * x.numel() * 4  # read x and y once, write out once
        row = {
            "shape": list(shape),
            "ms": time_ms(lambda: va.vector_add_kernel(x, y)),
            "plain_ms": time_ms(lambda: va.vector_add_reference(x, y)),
            "library_ms": time_ms(lambda: torch.add(x, y)),
            "bound_ms": nbytes / rate * 1e3,
            "bytes": nbytes,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if nbytes < 50e6:
            row["note"] = ("working set fits in the 50 MB L2: back-to-back runs read "
                           "it from L2, so a bound share above 1 is expected")
        print(json.dumps({"timing": "vector_add", **row}), flush=True)
        rows[tuple(shape)] = row
        del x, y
    return rows[GATE_SHAPE]


def _bound(flops: float, nbytes: float, rates: tuple) -> dict:
    """The least time the card could take: the larger of bytes over its
    memory rate (``rates[0]``) and operations over the peak for their type
    (``rates[1]``)."""
    by_bytes, by_ops = nbytes / rates[0] * 1e3, flops / rates[1] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def flash_timing_phase(name: str) -> dict:
    """The flash kernels, their plain versions and the library call at the
    main paths' shapes: prefill, decode and one ring hop."""
    import torch
    import torch.nn.functional as F

    from tpu_operator_torch.kernels import flash_attention as fa

    rates = peaks(name)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = {}
    bh, t, d = PREFILL
    q, k, v = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
    pairs = bh * t * (t + 1) // 2  # (query, key) pairs the causal mask keeps
    rows["prefill"] = {
        "shape": [bh, t, d], "causal": True,
        "ms": time_ms(lambda: fa.flash_attention_local(q, k, v, True), reps=5, per=3),
        "plain_ms": time_ms(lambda: fa.flash_attention_local_reference(q, k, v, True),
                            reps=3, per=1),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), reps=5, per=3),
        # q, k, v read, out written (bf16); lse written (f32)
        **_bound(4.0 * d * pairs, 4 * bh * t * d * 2 + bh * t * 4, rates),
    }
    q = randn(bh, DECODE_TAIL, d)
    q_off = t - DECODE_TAIL
    rows_pos = q_off + torch.arange(DECODE_TAIL, device="cuda")
    # is_causal aligns top-left when Tq != Tk: the decode mask is explicit
    mask = torch.arange(t, device="cuda")[None, :] <= rows_pos[:, None]
    pairs = bh * sum(q_off + i + 1 for i in range(DECODE_TAIL))
    rows["decode"] = {
        "shape": [bh, DECODE_TAIL, t, d], "causal": True, "q_off": q_off,
        "ms": time_ms(lambda: fa.flash_attention_local(q, k, v, True, q_off=q_off)),
        "plain_ms": time_ms(lambda: fa.flash_attention_local_reference(q, k, v, True,
                                                                       q_off=q_off),
                            reps=5, per=5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask)),
        **_bound(4.0 * d * pairs, (2 * bh * t * d + 2 * bh * DECODE_TAIL * d) * 2
                 + bh * DECODE_TAIL * 4, rates),
    }
    del q, k, v
    bh, t, d = RING_HOP
    q, k, v = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
    m = torch.full((bh, t), fa.NEG_INF, device="cuda")
    l = torch.zeros((bh, t), device="cuda")
    o = torch.zeros((bh, t, d), device="cuda")
    # one card's hop: its own (diagonal) block, causal; each timed launch
    # folds the block into the same state again, which costs the same
    rows["ring_hop"] = {
        "shape": [bh, t, d], "causal": True,
        "ms": time_ms(lambda: fa.flash_block_update(q, k, v, 0, 0, m, l, o, True)),
        "plain_ms": time_ms(lambda: fa.flash_block_update_reference(q, k, v, 0, 0, m, l, o,
                                                                    True)),
        "library_ms": None,
        "library_note": "no single PyTorch call folds a block into (m, l, o)",
        # q, k, v read (bf16); m, l, o read and written (f32)
        **_bound(4.0 * d * (bh * t * (t + 1) // 2),
                 3 * bh * t * d * 2 + 2 * (2 * bh * t * 4 + bh * t * d * 4), rates),
        "note": ("launch-bound: the bound is far below one kernel launch, and the "
                 "working set stays in the 50 MB L2 between launches"),
    }
    for key, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps({"timing": key, **row}), flush=True)
    return rows


def dma_timing_phase(name: str) -> dict:
    """The DMA-pipeline kernel, its plain version and the library copy at
    the probe's shape, at 1 and 16 passes per launch."""
    import torch

    from tpu_operator_torch.kernels import dma_pipeline as dp

    rates = peaks(name)
    (rows, cols), chunk, slots = DMA_PROBE
    x = torch.randn((rows, cols), generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda")
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    library_ms = time_ms(lambda: out.copy_(x))
    result = {}
    for iters, reps, per in ((1, 25, 20), (16, 10, 5)):
        row = {
            "shape": [rows, cols], "iters": iters, "chunk_rows": chunk, "slots": slots,
            "tile_bytes": dp.tile_bytes(x, chunk, slots),
            "ms": time_ms(lambda: dp.dma_pipeline_copy(x, iters, chunk, slots), reps, per),
            "plain_ms": time_ms(lambda: dp.dma_pipeline_copy_reference(x, iters), reps, per),
            "library_ms": library_ms,
            "library_note": ("one out.copy_(x): the same output as any number of passes; at "
                             "iters = 1 it is also the plain version"),
            # every pass reads x once and writes out once: 256 MiB, five times the L2
            **_bound(0.0, 2.0 * nbytes * iters, rates),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps({"timing": f"dma_pipeline_copy iters={iters}", **row}), flush=True)
        result[iters] = row
    return result


def _sdpa_backward_ms(q, k, v, do) -> tuple:
    """The backward alone of one causal ``scaled_dot_product_attention`` on
    [1, BH, T, D], the forward outside the timed region; returns (ms, the
    backward node that ran, which names the backend)."""
    import torch
    import torch.nn.functional as F

    qq, kk, vv = (x.detach()[None].clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    go = do[None].to(out.dtype)
    ms = time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), go, retain_graph=True),
                 reps=5, per=3)
    return ms, out.grad_fn.name()


def train_timing_phase(name: str) -> dict:
    """B4 (f32 and bf16) and B3's f32 entry at the train hop, their plain
    versions and the library calls."""
    import torch
    import torch.nn.functional as F

    from tpu_operator_torch.kernels import flash_attention as fa
    from tpu_operator_torch.kernels import flash_backward as fb

    mem, bf16_peak, f32_peak = peaks(name)
    gen = torch.Generator(device="cuda").manual_seed(7)
    bh, t, d = TRAIN_HOP
    pairs = bh * t * (t + 1) // 2  # (query, key) pairs the causal mask keeps
    rows = {}
    for dtype, peak in ((torch.float32, f32_peak), (torch.bfloat16, bf16_peak)):
        (q, k, v, do, lse, dsum), acc = _hop_inputs(gen, dtype, bh, t, t, d, 0, 0, True)
        dq, dk, dv = acc
        library_ms, backend = _sdpa_backward_ms(q, k, v, do)
        row = {
            "shape": [bh, t, d], "dtype": str(dtype)[6:], "causal": True,
            "ms": time_ms(lambda: fb.flash_block_backward(q, k, v, do, lse, dsum, dq, dk, dv,
                                                          0, 0, True), reps=5, per=3),
            "plain_ms": time_ms(lambda: fb.flash_block_backward_reference(
                q, k, v, do, lse, dsum, dq, dk, dv, 0, 0, True), reps=3, per=1),
            "library_ms": library_ms,
            "library_backend": backend,
            "library_note": ("backward alone of scaled_dot_product_attention(is_causal=True): "
                             "fresh dq/dk/dv, no accumulators"),
            # q, k, v, dO read; lse, dsum read (f32); dq, dk, dv read and written (f32)
            **_bound(10.0 * d * pairs, 4 * bh * t * d * q.element_size() + 2 * bh * t * 4
                     + 6 * bh * t * d * 4, (mem, peak)),
        }
        rows[f"backward_{row['dtype']}"] = row
        del q, k, v, do, lse, dsum, dq, dk, dv, acc
    q, k, v = (torch.randn((bh, t, d), generator=gen, device="cuda") for _ in range(3))
    m = torch.full((bh, t), fa.NEG_INF, device="cuda")
    l = torch.zeros((bh, t), device="cuda")
    o = torch.zeros((bh, t, d), device="cuda")
    # the train hop on one card: its own (diagonal) block, causal; each timed
    # launch folds it into the same state again, which costs the same
    rows["update_f32"] = {
        "shape": [bh, t, d], "dtype": "float32", "causal": True,
        "ms": time_ms(lambda: fa.flash_block_update(q, k, v, 0, 0, m, l, o, True), reps=5, per=3),
        "plain_ms": time_ms(lambda: fa.flash_block_update_reference(q, k, v, 0, 0, m, l, o,
                                                                     True), reps=3, per=1),
        "library_ms": None,
        "library_note": ("no single PyTorch call folds a block into (m, l, o); "
                         "nearest_library_ms is scaled_dot_product_attention's f32 causal "
                         "forward at this shape"),
        "nearest_library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), reps=5, per=3),
        # q, k, v read; m, l, o read and written (all f32)
        **_bound(4.0 * d * pairs, 3 * bh * t * d * 4 + 2 * (2 * bh * t * 4 + bh * t * d * 4),
                 (mem, f32_peak)),
    }
    for key, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps({"timing": f"train hop {key}", **row}), flush=True)
    return rows


def main() -> int:
    import torch

    # the plain versions' f32 products in full f32, not TF32 (the default,
    # stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    name, count = device_phase()
    build_phase()
    launches = gate_phase(count)
    forward_launches, update_launches = attention_phase(count)
    dma_launches = probes_phase(count)
    train_fwd_launches, train_bwd_launches, _ = training_phase(count)
    max_err = kernel_phase()
    flash_err = flash_kernel_phase()
    dma_err = dma_kernel_phase()
    train_err = train_kernel_phase()
    t = timing_phase(name)
    ft = flash_timing_phase(name)
    dt = dma_timing_phase(name)
    tt = train_timing_phase(name)
    source = "tpu_operator_torch/csrc/flash_attention.cu"
    train_source = "tpu_operator_torch/csrc/flash_backward.cu"

    def entry(row: dict) -> dict:
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {key: row[key] for key in keys}

    print(json.dumps({"kernels": [{
        "name": "vector_add",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/vector_add.cu",
        "replaces": "tpu_operator/workloads/collectives.py:96",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
    }, {
        "name": "flash_attention_local",
        "route": "cuda",
        "source": source,
        "replaces": "tpu_operator/workloads/longctx.py:47",
        "launches": forward_launches,
        "max_abs_err": flash_err["flash_attention_local"],
        **entry(ft["prefill"]),
        "shapes": {"prefill": entry(ft["prefill"]), "decode": entry(ft["decode"])},
    }, {
        "name": "flash_block_update",
        "route": "cuda",
        "source": source,
        "replaces": "tpu_operator/workloads/ring_attention.py:118",
        "launches": update_launches,
        "max_abs_err": flash_err["flash_block_update"],
        **entry(ft["ring_hop"]),
        "library_note": ft["ring_hop"]["library_note"],
    }, {
        "name": "dma_pipeline_copy",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/dma_pipeline.cu",
        "replaces": "tpu_operator/workloads/hbm_pallas.py:48",
        "launches": dma_launches,
        "max_abs_err": dma_err,
        **entry(dt[1]),
        "library_note": dt[1]["library_note"],
        "shapes": {"iters=1": entry(dt[1]), "iters=16": entry(dt[16])},
    }, {
        "name": "flash_block_update_f32",
        "route": "cuda",
        "source": train_source,
        "replaces": "tpu_operator/workloads/ring_attention.py:118",
        "launches": train_fwd_launches,
        "max_abs_err": train_err["flash_block_update_f32"],
        **entry(tt["update_f32"]),
        "library_note": tt["update_f32"]["library_note"],
        "nearest_library_ms": tt["update_f32"]["nearest_library_ms"],
    }, {
        "name": "flash_block_backward",
        "route": "cuda",
        "source": train_source,
        "replaces": "tpu_operator/workloads/ring_attention.py:577",
        "launches": train_bwd_launches,
        "max_abs_err": train_err["flash_block_backward"],
        **entry(tt["backward_float32"]),
        "library_backend": tt["backward_float32"]["library_backend"],
        "dtypes": {"float32": entry(tt["backward_float32"]),
                   "bfloat16": {**entry(tt["backward_bfloat16"]),
                                "library_backend": tt["backward_bfloat16"]["library_backend"]}},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
