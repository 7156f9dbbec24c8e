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
   nvcc, one process per source, all started together; prints ptxas's
   registers and spills of the wgmma kernel and fails if it spills at D
   128; prints the training kernels' registers, spills and shared memory
3. gate      — ``run_validation.main()`` with vector-add, allreduce and
   burn-in at their shipping sizes and EXPECTED_DEVICES set: exit 0, one
   JSON line per check, a drop-box holding all of them, finite outputs that
   agree with a float64 reference, and the vector_add launch count above 0
4. attention — ``run_validation.main()`` with longctx (32k prefill), decode
   (32k cache, 1024 chained decodes) and ring-attention (512 tokens, 4
   heads, head dim 128 per card), one check per run: exit 0, one JSON line
   per check, the drop-box, longctx spot tiles and ring within 2e-2 of
   their references, finite decode output; longctx launched the flash
   forward only on its ``wgmma`` path and decode only on its ``split``
   path, each count above 0, and ring-attention the block update
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
7. kernel    — each kernel against its plain version on the card: the add
   bit-identical (tolerance 0, as int32 or int16 views) in f32, bf16 and
   f16 at the gate's shape, a ragged shape and a view one element off
   16-byte alignment, and at sizes that end mid-vector and mid-block; the
   flash kernels at the main paths' shapes (the forward through its plan,
   the path printed), ragged serving shapes, each forward path at the
   shapes that stress it (Tq not
   a multiple of 128, diagonals off the tile grid, every row masked: out
   exactly 0 and lse exactly -1e30; a one-row tail, a ragged cache, BH 1,
   non-causal); the block update at the ring hop (diagonal, half visible,
   fully visible, non-causal, first q tiles seeing no key, fully masked),
   ragged Tq = Tk = 200 at D 64, Tq 136 x Tk 200 at D 16 partly visible,
   BH 1 and D 8, each launched twice and bit-identical: per case,
   max |out - plain| within 1e-2 of max |plain| (one bf16 step at the
   largest output is at most 2^-7 = 7.8e-3 of it), and m, l, lse within
   1e-5 relative (f32 sums in another order); the fully masked blocks leave
   the state bit-identical; the DMA copy bit-identical (as int32 or int16
   views, tolerance 0) on random bit patterns with NaN payloads, at the toy
   shapes, the probe shape at 1, 2 and 16 passes, in bf16, with pieces
   that are not whole tiles, one slot, more slots than a block's pieces
   and fewer tiles than SMs, and the wrapper's alignment rejections; B4
   (f32 and bf16) and B3's f32 entry at the train hop
   (128, 2048, 128) causal, a fully visible hop at its width (q_off 2048),
   the transformer check's (16, 16, 32), ragged shapes, head dims 40 and 72,
   Tq and Tk off the 64 grid at D 128, and a fully masked block, which must
   leave the accumulators or the state bit-identical: per output, max
   |kernel - plain| within 1e-4 of max |plain| in f32 and 1e-2 in bf16 (B4:
   this hop's contribution, on top of non-zero accumulators); every case
   launched twice on the same inputs, bit-identical
8. timing    — CUDA-event medians of each kernel, its plain version and the
   library call where one exists, beside the least time the card allows
   (the larger of bytes over its memory rate and operations over its peak
   for their type, from ``tpu_operator_torch/k8s/nodeinfo.py``); the flash
   forward's planned path at the prefill and decode shapes beside its
   ``mma.sync`` kernel at the same shape (``mma_ms``); the block update at
   the ring hop's diagonal, fully visible and fully masked hops, beside
   ``scaled_dot_product_attention``'s causal forward, the nearest call
   (``nearest_library_ms``); the add at the gate's shape and at 128 MiB
   per operand in f32 and at the gate's shape in bf16 (``shapes``); the
   DMA copy at the probe's shape at 1 and 16 passes per launch, and at 1
   pass by ring depth (``ms_by_slots``, 2, 4 and 8) and by tile
   (``ms_by_tile``, 8, 16 and 32 KiB); B4 and B3's f32 entry at the train
   hop (B4 f32 also at the fully visible hop), B4's library call the
   backward alone of ``scaled_dot_product_attention`` (its backend named);
   the f32 rows bound by 3xTF32 (three passes over the
   TF32 peak), the CUDA-core bound beside it as ``bound_simt_ms``

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
ATTENTION_PATHS = ("wgmma", "split", None)  # B5's planned path in each check
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
    """(memory bytes/s, bf16 FLOP/s, f32 CUDA-core FLOP/s, TF32 FLOP/s) of
    the card, from the data sheets."""
    from tpu_operator_torch.k8s import nodeinfo

    info = nodeinfo.generation_info(nodeinfo.generation_of(name))
    require(info.hbm_gbps > 0 and info.peak_fp32_tflops > 0 and info.peak_tf32_tflops > 0,
            f"no memory rate or f32 peaks on record for {name!r}")
    return (info.hbm_gbps * 1e9, info.peak_bf16_tflops * 1e12, info.peak_fp32_tflops * 1e12,
            info.peak_tf32_tflops * 1e12)


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
    # the wgmma kernel's registers and spills (D 128 and 64), from ptxas -v
    lines = built["flash_forward_sm90"].log.splitlines()
    if not lines:
        print("build: flash_forward_sm90 was already built: no ptxas lines", flush=True)
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "flash_wgmma_kernel" in line:
            d = 128 if "ILi128E" in line else 64
            usage = " | ".join(x.strip() for x in lines[i + 2:i + 4])
            print(f"build: wgmma kernel D {d}: {usage}", flush=True)
            require(d != 128 or "0 bytes spill stores, 0 bytes spill loads" in usage,
                    "the wgmma kernel spills at D 128")
    # the training kernels' registers and spills, and the shared memory a
    # block takes (dynamic, so not in ptxas's lines)
    lib, _ = _build.library("flash_backward")
    names = {"dkdv_kernel": 0, "dq_kernel": 1, "fold_f32_kernel": 2}
    lines = built["flash_backward"].log.splitlines()
    for i, line in enumerate(lines):
        kernel = next((k for k in names if k in line), None)
        if "Compiling entry function" not in line or kernel is None:
            continue
        dp = next(d for d in (128, 64, 32, 16) if f"Li{d}E" in line)
        dtype = "bf16" if "nv_bfloat16" in line else "f32"
        usage = " | ".join(x.strip() for x in lines[i + 2:i + 4])
        smem = lib.tpu_flash_train_smem_bytes(names[kernel], dp, int(dtype == "bf16"))
        print(f"build: {kernel} {dtype} D {dp}: {usage} | {smem} bytes of shared memory",
              flush=True)


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
    """Run the long-context checks through the entry point, one check per
    run so that each path's launches are its own; returns the launches of
    the flash forward, of each of its paths, and of the block update."""
    from tpu_operator_torch.kernels import flash_attention as fa

    def counts():
        return fa.forward_launches, dict(fa.forward_path_launches), fa.block_update_launches

    by, forward, paths, update = {}, 0, dict.fromkeys(fa.forward_path_launches, 0), 0
    for check, path in zip(ATTENTION_CHECKS, ATTENTION_PATHS):
        fa.forward_launches = fa.block_update_launches = 0
        fa.forward_path_launches.update(dict.fromkeys(fa.forward_path_launches, 0))
        lines, (n, by_path, n_update) = run_checks((check,), n_cards, counts)
        by.update(lines)
        if path is not None:
            # B5 on its planned path, and on no other
            require(by_path[path] > 0 and by_path[path] == n,
                    f"{check} launched the flash forward {by_path} (expected only {path!r})")
        forward += n
        update += n_update
        paths = {key: paths[key] + by_path[key] for key in paths}
    ring = by["ring-attention"]
    if ring["devices"] > 1:
        # the ring ran in one process per card: rank 0 counted its own
        update += ring["launches"]
    require(update > 0, "ring-attention ran without launching the flash block update kernel")
    lc, dec = by["longctx"], by["decode"]
    require(lc["max_error"] < OUT_TOL, f"longctx spot tiles off by {lc['max_error']}")
    require(dec["ok"] and math.isfinite(dec["decode_us"]), "decode output not finite")
    require(ring["max_error"] < OUT_TOL, f"ring-attention off by {ring['max_error']}")
    require(ring["kernel"] == "cuda-flash", f"ring-attention folded with {ring['kernel']}")
    print(f"attention: longctx {lc['attn_tflops']!r} attn-TFLOP/s, decode "
          f"{dec['decode_us']!r} us/token ({dec['cache_gbps']!r} GB/s), ring max_error "
          f"{ring['max_error']!r} over {ring['devices']} card(s); flash forward launches by "
          f"path {paths}", flush=True)
    return forward, paths, update


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
    gap = dma["fraction_of_peak"] - hbm["fraction_of_peak"]
    print(f"probes: hbm-dma minus hbm {gap!r} of the memory rate (aim: within 0.03)", flush=True)
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
    """Bit-for-bit parity of the vector add with its plain version, in f32,
    bf16 and f16 (compared as int32 or int16 views, tolerance 0)."""
    import torch

    from tpu_operator_torch.kernels import vector_add as va

    gen = torch.Generator(device="cuda").manual_seed(0)

    def pair(shape, offset=0, dtype=torch.float32):
        n = math.prod(shape) + offset
        x = torch.randn(n, generator=gen, device="cuda").to(dtype)[offset:].view(shape)
        y = torch.randn(n, generator=gen, device="cuda").to(dtype)[offset:].view(shape)
        return x, y

    # 256 threads of one 16-byte vector each: a block covers 1024 f32 or
    # 2048 bf16/f16 elements
    cases = {
        "gate (2048, 512)": pair(GATE_SHAPE),
        "ragged (1000, 509)": pair((1000, 509)),
        "unaligned (2048, 512) + 1 element": pair(GATE_SHAPE, offset=1),
        "mid-vector (4099,)": pair((4099,)),
        "mid-block (3, 1000)": pair((3, 1000)),
        "one block and a tail (1027,)": pair((1027,)),
    }
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype)[6:]
        cases.update({
            f"{name} gate (2048, 512)": pair(GATE_SHAPE, dtype=dtype),
            f"{name} ragged (1000, 509)": pair((1000, 509), dtype=dtype),
            f"{name} unaligned (2048, 512) + 1 element": pair(GATE_SHAPE, 1, dtype),
            f"{name} mid-block (4103,)": pair((4103,), dtype=dtype),
        })
    for label, (x, y) in cases.items():
        if "unaligned" in label:
            require(x.data_ptr() % 16 != 0, f"{label} is aligned")
    worst = 0.0
    for label, (x, y) in cases.items():
        out = va.vector_add_kernel(x, y)
        torch.cuda.synchronize()
        ref = va.vector_add_reference(x, y)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ints = torch.int32 if x.dtype == torch.float32 else torch.int16
        same_bits = bool(torch.equal(out.view(ints), ref.view(ints)))
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
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bh, t, d = PREFILL
    dec_off = t - DECODE_TAIL
    forward_cases = [
        # label, path (None: the plan's), bh, tq, tk, d, causal, q_off, k_off, block_q, block_k
        (f"prefill {PREFILL} causal", None, bh, t, t, d, True, 0, 0, 1024, 1024),
        (f"({bh}, 4096, {d}) causal", None, bh, 4096, 4096, d, True, 0, 0, 1024, 1024),
        (f"({bh}, 4096, {d}) non-causal", None, bh, 4096, 4096, d, False, 0, 0, 1024, 1024),
        (f"decode tail {DECODE_TAIL} x {t}", None, bh, DECODE_TAIL, t, d, True, dec_off, 0,
         1024, 1024),
    ]
    for tt in (40, 136):
        for dd in (8, 16):
            forward_cases.append((f"serving T={tt} D={dd} block_q=8", None, 4, tt, tt, dd, True,
                                  0, 0, 8, 16))
    forward_cases += [
        ("serving T=136 D=16 non-causal", None, 4, 136, 136, 16, False, 0, 0, 8, 16),
        # each path at the shapes that stress it
        ("(2, 200, 64) causal, Tq not a multiple of 128", "wgmma", 2, 200, 200, 64, True, 0, 0,
         1024, 1024),
        ("(4, 1024, 128) q_off 64: the diagonal half a tile off", "wgmma", 4, 1024, 1024, d,
         True, 64, 0, 1024, 1024),
        ("(4, 1024, 128) q_off 1024: every key visible", "wgmma", 4, 1024, 1024, d, True, 1024,
         0, 1024, 1024),
        ("(4, 1024, 128) k_off = q_off + Tq + 64: every row masked", "wgmma", 4, 1024, 1024, d,
         True, 0, 1088, 1024, 1024),
        (f"Tq 1 at q_off {t - 1}", "split", bh, 1, t, d, True, t - 1, 0, 1024, 1024),
        (f"ragged Tk {t} + 40", "split", bh, DECODE_TAIL, t + 40, d, True, t + 40 - DECODE_TAIL,
         0, 1024, 1024),
        ("BH 1", "split", 1, DECODE_TAIL, t, d, True, dec_off, 0, 1024, 1024),
        ("non-causal", "split", bh, DECODE_TAIL, t, d, False, 0, 0, 1024, 1024),
    ]
    for label, path, bh_, tq, tk, dd, causal, q_off, k_off, block_q, block_k in forward_cases:
        q, k, v = randn(bh_, tq, dd), randn(bh_, tk, dd), randn(bh_, tk, dd)
        if path is None:
            path = fa._forward_plan(bh_, tq, tk, dd, causal, q_off, k_off, n_sm)[0]
            out, lse = fa.flash_attention_local(q, k, v, causal, block_k, block_q, q_off, k_off)
            label = f"{label} (planned)"
        else:
            out, lse = fa._flash_forward_on(path, q, k, v, causal, q_off, k_off)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_local_reference(q, k, v, causal, block_k, block_q,
                                                          q_off, k_off)
        if not ref.float().any():
            # every row masked: out exactly 0 and lse exactly the sentinel
            exact = not out.float().any() and bool((lse == fa.NEG_INF).all())
            print(f"kernel flash_attention_local [{path}] {label}: out all 0 and lse all "
                  f"NEG_INF={exact}", flush=True)
            require(exact, f"flash_attention_local [{path}] gave a masked row a value at {label}")
            continue
        err, scaled, lse_err = _abs_err(out, ref), _scaled_err(out, ref), _rel_err(lse, ref_lse)
        print(f"kernel flash_attention_local [{path}] {label}: out max_abs_err={err!r} "
              f"(/max|plain| {scaled!r}) lse max_rel_err={lse_err!r}", flush=True)
        require(scaled <= KERNEL_OUT_RTOL and lse_err <= STATE_RTOL,
                f"flash_attention_local [{path}] differs from its plain version at {label}")
        worst["flash_attention_local"] = max(worst["flash_attention_local"], err)
        del q, k, v, out, lse, ref, ref_lse

    bh, t, d = RING_HOP
    q_off = 2 * t
    update_cases = [
        # label, bh, tq, tk, d, q_off, k_off, causal, carried state
        (f"ring hop {RING_HOP} diagonal, carried state", bh, t, t, d, q_off, q_off, True, True),
        ("hop half visible, fresh state", bh, t, t, d, q_off, q_off - t // 2, True, False),
        ("fully visible hop (k_off = q_off - Tq), carried state", bh, t, t, d, q_off,
         q_off - t, True, True),
        ("hop, carried state, non-causal", bh, t, t, d, q_off, 5 * t, False, True),
        ("hop whose first 16-row q tiles see no key (k_off = q_off + Tq/2)", bh, t, t, d, q_off,
         q_off + t // 2, True, True),
        ("fully masked block (k_off > q_off + Tq), carried state", bh, t, t, d, q_off,
         q_off + t + 64, True, True),
        ("fully masked block, fresh state", bh, t, t, d, q_off, q_off + t + 64, True, False),
        ("ragged Tq = Tk = 200, D 64", 3, 200, 200, 64, 0, 0, True, False),
        ("Tq 136 x Tk 200, D 16, q_off - k_off = 100", 4, 136, 200, 16, 200, 100, True, True),
        ("BH 1", 1, t, t, d, q_off, q_off, True, True),
        ("D 8 (4, 40 x 72)", 4, 40, 72, 8, 64, 48, True, True),
    ]
    twice = 0  # launches of a case twice on the same inputs, bit-identical
    for label, bh_, tq, tk, dd, q_off_, k_off, causal, carried in update_cases:
        q, k, v, k1, v1 = (randn(bh_, n, dd) for n in (tq, tk, tk, tk, tk))
        state = (torch.full((bh_, tq), fa.NEG_INF, device="cuda"),
                 torch.zeros((bh_, tq), device="cuda"), torch.zeros((bh_, tq, dd), device="cuda"))
        if carried:  # an earlier, fully visible block already folded in
            state = fa.flash_block_update_reference(q, k1, v1, q_off_, k_off, *state, False)
        masked = causal and k_off > q_off_ + tq
        if not masked:
            rm, rl, ro = fa.flash_block_update_reference(q, k, v, q_off_, k_off, *state, causal)
        m, l, o = (x.clone() for x in state)
        fa.flash_block_update(q, k, v, q_off_, k_off, m, l, o, causal)
        again = tuple(x.clone() for x in state)
        fa.flash_block_update(q, k, v, q_off_, k_off, *again, causal)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip((m, l, o), again)),
                f"flash_block_update is not deterministic at {label}")
        twice += 1
        if masked:
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
    print(f"kernel flash_block_update: two launches bit-identical in all {twice} cases",
          flush=True)
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
        (f"fully visible hop (8, {t}, {d}) q_off {t}", 8, t, t, d, t, 0, True),
        (f"transformer {TRANSFORMER_HOP} causal", tb, tt, tt, td, 0, 0, True),
        ("ragged (4, 136 x 200, 16) causal, partly visible", 4, 136, 200, 16, 200, 100, True),
        ("ragged (2, 200 x 136, 64) causal, rows with no key", 2, 200, 136, 64, 0, 16, True),
        ("ragged (3, 40 x 72, 8) non-causal", 3, 40, 72, 8, 0, 0, False),
        ("head dim 40 (3, 200, 40) causal", 3, 200, 200, 40, 0, 0, True),
        ("head dim 72 (3, 200 x 264, 72) causal", 3, 200, 264, 72, 64, 0, True),
        ("ragged (2, 300 x 420, 128) causal, Tq and Tk off 64", 2, 300, 420, 128, 120, 0, True),
        ("fully masked (4, 136 x 200, 16)", 4, 136, 200, 16, 0, 200, True),
    ]
    twice = 0  # cases launched twice on the same inputs, bit-identical
    worst = {"flash_block_backward": 0.0, "flash_block_update_f32": 0.0}
    for dtype, tol in ((torch.float32, F32_RTOL), (torch.bfloat16, KERNEL_OUT_RTOL)):
        for label, bh_, tq, tk, dd, q_off, k_off, causal in cases:
            args, acc = _hop_inputs(gen, dtype, bh_, tq, tk, dd, q_off, k_off, causal)
            mine = tuple(a.clone() for a in acc)
            fb.flash_block_backward(*args, *mine, q_off, k_off, causal)
            again = tuple(a.clone() for a in acc)
            fb.flash_block_backward(*args, *again, q_off, k_off, causal)
            torch.cuda.synchronize()
            label = f"{label} {str(dtype)[6:]}"
            require(all(torch.equal(a, b) for a, b in zip(mine, again)),
                    f"flash_block_backward is not deterministic at {label}")
            twice += 1
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
        again = tuple(x.clone() for x in state)
        fa.flash_block_update(q, k, v, q_off, k_off, *again, causal)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip((m, l, o), again)),
                f"f32 flash_block_update is not deterministic at {label}")
        twice += 1
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
    print(f"kernel training: two launches bit-identical in all {twice} cases", flush=True)
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
        (f"probe ({rows}, {cols}) iters=16", (rows, cols), torch.float32, 16, chunk, slots),
        ("bf16 (256, 512) iters=2", (256, 512), torch.bfloat16, 2, 64, 2),
        # 80000-byte chunks in 32 KiB tiles: the rest of the last round is
        # split into pieces that are not whole tiles
        ("partial tiles (5000, 500) iters=3", (5000, 500), torch.float32, 3, 40, 4),
        ("one slot (65536, 512) iters=2", (65536, 512), torch.float32, 2, 2048, 1),
        # 2 KiB tiles, one per block: a ring deeper than a block's pieces
        ("more slots than pieces (64, 512) iters=2", (64, 512), torch.float32, 2, 1, 64),
        # 16 tiles for 132 SMs
        ("smaller than a tile per SM (1024, 128) iters=2", (1024, 128), torch.float32, 2, 64, 4),
    ]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for label, shape, dtype, iters, chunk_rows, n_slots in cases:
        x = _random_bits(gen, shape, dtype)
        tile = dp.tile_bytes(x, chunk_rows, n_slots)
        nbytes = x.numel() * x.element_size()
        out = dp.dma_pipeline_copy(x, iters, chunk_rows, n_slots)
        torch.cuda.synchronize()
        ref = dp.dma_pipeline_copy_reference(x, iters)
        ints = torch.int32 if dtype == torch.float32 else torch.int16
        same = bool(torch.equal(out.view(ints), ref.view(ints)))
        finite = ref.isfinite()
        err = _abs_err(out[finite], ref[finite])
        print(f"kernel dma_pipeline_copy {label}: tile {tile} bytes, "
              f"{dp.grid_blocks(nbytes, tile, n_slots, n_sm)} blocks, "
              f"max_abs_err={err!r} bit_identical={same}", flush=True)
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
    """The vector add, its plain version and ``torch.add`` at the gate's
    shape and at 128 MiB per operand in f32, and at the gate's shape in
    bf16; returns the rows by label."""
    import torch

    from tpu_operator_torch.kernels import vector_add as va

    rate = peaks(name)[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for shape, dtype in ((GATE_SHAPE, torch.float32), (BIG_SHAPE, torch.float32),
                         (GATE_SHAPE, torch.bfloat16)):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        y = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        nbytes = 3 * x.numel() * x.element_size()  # read x and y once, write out once
        row = {
            "shape": list(shape),
            "dtype": str(dtype)[6:],
            "ms": time_ms(lambda: va.vector_add_kernel(x, y)),
            "plain_ms": time_ms(lambda: va.vector_add_reference(x, y)),
            "library_ms": time_ms(lambda: torch.add(x, y)),
            "bound_ms": nbytes / rate * 1e3,
            "bound_by": "bytes",
            "bytes": nbytes,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["library_bound_share"] = row["bound_ms"] / row["library_ms"]
        if nbytes < 50e6:
            row["note"] = ("working set fits in the 50 MB L2: back-to-back runs read "
                           "it from L2, so a bound share above 1 is expected")
        print(json.dumps({"timing": "vector_add", **row}), flush=True)
        rows[f"({shape[0]}, {shape[1]}) {row['dtype']}"] = row
        del x, y
    return rows


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
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows["prefill"] = {
        "shape": [bh, t, d], "causal": True,
        "path": fa._forward_plan(bh, t, t, d, True, 0, 0, n_sm)[0],
        "ms": time_ms(lambda: fa.flash_attention_local(q, k, v, True), reps=5, per=3),
        # the mma.sync kernel at the same shape, in the same run
        "mma_ms": time_ms(lambda: fa._flash_forward_on("mma", q, k, v, True), reps=5, per=3),
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
    path, n_splits = fa._forward_plan(bh, DECODE_TAIL, t, d, True, q_off, 0, n_sm)
    rows["decode"] = {
        "shape": [bh, DECODE_TAIL, t, d], "causal": True, "q_off": q_off,
        "path": path, "n_splits": n_splits,
        "ms": time_ms(lambda: fa.flash_attention_local(q, k, v, True, q_off=q_off)),
        "mma_ms": time_ms(lambda: fa._flash_forward_on("mma", q, k, v, True, q_off)),
        "plain_ms": time_ms(lambda: fa.flash_attention_local_reference(q, k, v, True,
                                                                       q_off=q_off),
                            reps=5, per=5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask)),
        **_bound(4.0 * d * pairs, (2 * bh * t * d + 2 * bh * DECODE_TAIL * d) * 2
                 + bh * DECODE_TAIL * 4, rates),
        # the split count against the plan's: one wave of blocks to four
        "split_ms_by_n_splits": {n: time_ms(lambda: fa._flash_forward_on(
            "split", q, k, v, True, q_off, 0, n)) for n in (16, 33, 66, 132)},
    }
    del q, k, v
    bh, t, d = RING_HOP
    q, k, v = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
    m = torch.full((bh, t), fa.NEG_INF, device="cuda")
    l = torch.zeros((bh, t), device="cuda")
    o = torch.zeros((bh, t, d), device="cuda")
    q_off = t
    # one card's hops: its own block (diagonal), one before it (every key
    # visible) and one after it (every key masked); each timed launch folds
    # the block into the same state again, which costs the same
    hops = {}
    for hop, k_off, pairs in (("diagonal", q_off, bh * t * (t + 1) // 2),
                              ("visible", q_off - t, bh * t * t), ("masked", q_off + t, 0)):
        hops[hop] = {
            "k_off": k_off,
            "ms": time_ms(lambda: fa.flash_block_update(q, k, v, q_off, k_off, m, l, o, True)),
        }
        if pairs:
            # q, k, v read (bf16); m, l, o read and written (f32)
            hops[hop].update(_bound(4.0 * d * pairs, 3 * bh * t * d * 2
                                    + 2 * (2 * bh * t * 4 + bh * t * d * 4), rates))
            hops[hop]["bound_share"] = hops[hop]["bound_ms"] / hops[hop]["ms"]
    diagonal = hops["diagonal"]
    rows["ring_hop"] = {
        "shape": [bh, t, d], "causal": True,
        "ms": diagonal["ms"],
        "plain_ms": time_ms(lambda: fa.flash_block_update_reference(q, k, v, q_off, q_off, m, l,
                                                                    o, True)),
        "library_ms": None,
        "library_note": ("no single PyTorch call folds a block into (m, l, o); "
                         "nearest_library_ms is scaled_dot_product_attention's bf16 causal "
                         "forward at this shape: the diagonal hop from a fresh state, "
                         "normalized and rounded to bf16, with no carried state to merge"),
        "nearest_library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True)),
        **{key: diagonal[key] for key in ("bound_ms", "bound_by", "bytes", "flops")},
        "hops": hops,
        "note": (f"the fully masked hop, {hops['masked']['ms']!r} ms, is the measured floor "
                 "of one launch here: its blocks return before they touch the state"),
    }
    del q, k, v, m, l, o
    for key, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if "mma_ms" in row:
            row["mma_bound_share"] = row["bound_ms"] / row["mma_ms"]
            row["speedup_vs_mma"] = row["mma_ms"] / row["ms"]
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
    # at 1 pass: the ring's depth (the function's own parameter; the tile
    # shrinks to fit 8 slots), and the tile at the probe's 4 slots, which
    # sets how many rings share an SM (1 at 32 KiB, 3 at 16 KiB, 6 at 8 KiB)
    result[1]["ms_by_slots"] = {
        n: time_ms(lambda: dp.dma_pipeline_copy(x, 1, chunk, n)) for n in (2, 4, 8)}
    result[1]["ms_by_tile"] = {
        tile: time_ms(lambda: dp._copy_on(x, 1, tile, slots)) for tile in (8192, 16384, 32768)}
    print(json.dumps({"timing": "dma_pipeline_copy iters=1 by ring",
                      "ms_by_slots": result[1]["ms_by_slots"],
                      "ms_by_tile": result[1]["ms_by_tile"],
                      "library_ms": time_ms(lambda: out.copy_(x))}), flush=True)
    return result


def _sdpa_backward_ms(q, k, v, do, causal=True) -> tuple:
    """The backward alone of one ``scaled_dot_product_attention`` on [1, BH,
    T, D], the forward outside the timed region; returns (ms, the backward
    node that ran, which names the backend)."""
    import torch
    import torch.nn.functional as F

    qq, kk, vv = (x.detach()[None].clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)
    go = do[None].to(out.dtype)
    ms = time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), go, retain_graph=True),
                 reps=5, per=3)
    return ms, out.grad_fn.name()


def _f32_bounds(flops: float, nbytes: float, mem: float, tf32: float, f32: float) -> dict:
    """The f32 kernels' bound on the route they take, 3xTF32 on the tensor
    cores (three TF32 passes per product), with the CUDA-core bound beside
    it for continuity."""
    return {**_bound(3.0 * flops, nbytes, (mem, tf32)), "flops": flops,
            "bound_simt_ms": _bound(flops, nbytes, (mem, f32))["bound_ms"]}


def train_timing_phase(name: str) -> dict:
    """B4 (f32 and bf16) and B3's f32 entry at the train hop, B4 f32 at the
    fully visible hop as well, their plain versions and the library calls."""
    import torch
    import torch.nn.functional as F

    from tpu_operator_torch.kernels import flash_attention as fa
    from tpu_operator_torch.kernels import flash_backward as fb

    mem, bf16_peak, f32_peak, tf32_peak = peaks(name)
    gen = torch.Generator(device="cuda").manual_seed(7)
    bh, t, d = TRAIN_HOP
    rows = {}
    # dtype, q_off: the diagonal hop (causal), and one card's hop of the
    # four-card training in which every key is visible
    for dtype, q_off in ((torch.float32, 0), (torch.bfloat16, 0), (torch.float32, t)):
        pairs = bh * t * t if q_off else bh * t * (t + 1) // 2  # pairs the mask keeps
        (q, k, v, do, lse, dsum), acc = _hop_inputs(gen, dtype, bh, t, t, d, q_off, 0, True)
        dq, dk, dv = acc
        library_ms, backend = _sdpa_backward_ms(q, k, v, do, causal=not q_off)
        # q, k, v, dO read; lse, dsum read (f32); dq, dk, dv read and written (f32)
        nbytes = 4 * bh * t * d * q.element_size() + 2 * bh * t * 4 + 6 * bh * t * d * 4
        row = {
            "shape": [bh, t, d], "dtype": str(dtype)[6:], "causal": True, "q_off": q_off,
            "ms": time_ms(lambda: fb.flash_block_backward(q, k, v, do, lse, dsum, dq, dk, dv,
                                                          q_off, 0, True), reps=5, per=3),
            "plain_ms": time_ms(lambda: fb.flash_block_backward_reference(
                q, k, v, do, lse, dsum, dq, dk, dv, q_off, 0, True), reps=3, per=1),
            "library_ms": library_ms,
            "library_backend": backend,
            "library_note": (f"backward alone of scaled_dot_product_attention(is_causal="
                             f"{not q_off}): fresh dq/dk/dv, no accumulators"),
            **(_f32_bounds(10.0 * d * pairs, nbytes, mem, tf32_peak, f32_peak)
               if dtype == torch.float32 else _bound(10.0 * d * pairs, nbytes, (mem, bf16_peak))),
        }
        key = f"backward_{row['dtype']}" + ("_visible" if q_off else "")
        rows[key] = row
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
        **_f32_bounds(4.0 * d * (bh * t * (t + 1) // 2),
                      3 * bh * t * d * 4 + 2 * (2 * bh * t * 4 + bh * t * d * 4),
                      mem, tf32_peak, f32_peak),
    }
    for key, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if "bound_simt_ms" in row:
            row["bound_simt_share"] = row["bound_simt_ms"] / row["ms"]
        print(json.dumps({"timing": f"train hop {key}", **row}), flush=True)
    return rows


def main() -> int:
    import torch

    # the plain versions' f32 products in full f32, not TF32 (the default,
    # stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    name, count = device_phase()
    build_phase()
    launches = gate_phase(count)
    forward_launches, forward_paths, update_launches = attention_phase(count)
    dma_launches = probes_phase(count)
    train_fwd_launches, train_bwd_launches, _ = training_phase(count)
    max_err = kernel_phase()
    flash_err = flash_kernel_phase()
    dma_err = dma_kernel_phase()
    train_err = train_kernel_phase()
    vt = timing_phase(name)
    t = vt["(2048, 512) float32"]
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
        "shapes": {key: {**entry(row), "bound_share": row["bound_share"]}
                   for key, row in vt.items()},
    }, {
        "name": "flash_attention_local",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/flash_forward_sm90.cu",
        "sources": ["tpu_operator_torch/csrc/flash_forward_sm90.cu", source],
        "replaces": "tpu_operator/workloads/longctx.py:47",
        "launches": forward_launches,
        "paths": forward_paths,
        "max_abs_err": flash_err["flash_attention_local"],
        **entry(ft["prefill"]),
        "shapes": {key: {**entry(ft[key]), "path": ft[key]["path"], "mma_ms": ft[key]["mma_ms"],
                         "bound_share": ft[key]["bound_share"]}
                   for key in ("prefill", "decode")},
    }, {
        "name": "flash_block_update",
        "route": "cuda",
        "source": source,
        "replaces": "tpu_operator/workloads/ring_attention.py:118",
        "launches": update_launches,
        "max_abs_err": flash_err["flash_block_update"],
        **entry(ft["ring_hop"]),
        "nearest_library_ms": ft["ring_hop"]["nearest_library_ms"],
        "library_note": ft["ring_hop"]["library_note"],
        "hops": {key: {k: hop[k] for k in ("ms", "bound_ms") if k in hop}
                 for key, hop in ft["ring_hop"]["hops"].items()},
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
        "ms_by_slots": dt[1]["ms_by_slots"],
        "ms_by_tile": dt[1]["ms_by_tile"],
    }, {
        "name": "flash_block_update_f32",
        "route": "cuda",
        "source": train_source,
        "replaces": "tpu_operator/workloads/ring_attention.py:118",
        "launches": train_fwd_launches,
        "max_abs_err": train_err["flash_block_update_f32"],
        **entry(tt["update_f32"]),
        "bound_simt_ms": tt["update_f32"]["bound_simt_ms"],
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
        "bound_simt_ms": tt["backward_float32"]["bound_simt_ms"],
        "library_backend": tt["backward_float32"]["library_backend"],
        "dtypes": {"float32": entry(tt["backward_float32"]),
                   "float32 fully visible hop": entry(tt["backward_float32_visible"]),
                   "bfloat16": {**entry(tt["backward_bfloat16"]),
                                "library_backend": tt["backward_bfloat16"]["library_backend"]}},
    }]}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s wall, the build included", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
