#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on an NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --serving-steps [DIR]

The second form runs only quick_check's A/B in both attends with the
engine's attend call timed, on the package of the checkout in DIR (another
commit's tree) or of this one: two trees compare on one card in one call.

The first drives the port's main paths, the node readiness gate, the long-context
attention checks, the post-ready perf probes, training, the parallelism
census, the multi-host program, the serving engine, the migratable
training job, the warm pool of kernel libraries, the node's card-facing
agents (device plugin, feature discovery, metrics agent, health), the node
validator, the partition acceptance, partitions of whole cards and the
operand agents, and the validator's multi-host branch, the way the
validator and the migration drain run them, and holds every kernel on those
paths
against its plain PyTorch version.  Phases, each fatal on failure:

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
   32, 16 tokens per card), train (the reference's full width: batch 4,
   2048 tokens, d_model 4096, d_hidden 16384, 32 heads, per card; 4 steps
   x (first use + best of 3)) and transformer-pp (the GPipe stack over the
   (pp, dp, mp) mesh at the reference's sizes: 4 microbatches of 2
   sequences, 16 tokens per card, d_model 64, 4 heads of 16; 3 steps):
   exit 0, one JSON line per check, the drop-box, transformer and
   transformer-pp losses finite and strictly falling, train ok with a
   finite loss, tokens/s > 0, attention on ``cuda-flash-fwd-bwd`` in all
   three, transformer-pp's own launches of B3's f32 entry and of B4 above
   0 and ``pp_degenerate`` below 4 cards, and the launch counts above 0;
   on 4 or more cards transformer-pp's first loss within 1e-3 relative of
   the same run on as many gloo ranks on the host; prints every step time
7. census    — ``run_validation.main()`` with ulysses, moe and pipeline at
   the reference's shipping sizes under RESULTS_SCOPE=perf, as the
   perf-probes pod runs them on every card of a node: exit 0, one JSON line
   and one drop-box entry each, max_error under each module's own bound
   (2e-2, 1e-4, 1e-3), ``devices`` the card count; prints each duration_s
8. multihost — the multi-host program (``workloads/distributed.py``) through
   ``spawn_local_workers_outcomes``: 2 hosts of half the cards each
   (CUDA_VISIBLE_DEVICES) on 2 or more cards, else 1 host; every host rc 0
   and ok, psum ok, ``visible_global`` and dp x mp the card count, losses
   finite and falling; then, on 2 or more cards, FAULT_INJECT=psum:1 with
   WATCHDOG_TIMEOUT_S=5: host 1 killed, every survivor failed by itself
   within 90 s, host 0 ended by its watchdog (rc 3) naming member 1 (NCCL
   hangs in the collective whose peer died, so only the watchdog ends it)
9. serving   — ``run_validation.main()`` with serving under RESULTS_SCOPE=perf:
   exit 0, one JSON line, the drop-box, identical_outputs; then
   quick_check's A/B (8 requests, 24 prompt and 12 new tokens, max_batch 8)
   in the dense and the flash attend: identical outputs in each, every
   stream the same in both, the flash run one launch of B5's paged f32
   entry per attend call with a context at or past the 8-row tail and no
   other path (the contiguous f32 entry's count 0) and no gather of pages,
   the dense run on none; prints each run's tokens_per_sec, speedup and
   tpot_p50_s and its attend call's time per batched step (CUDA events
   around each call, median); then the replica
   ``python -m tpu_operator_torch.workloads.serving`` (6 s of service at 4
   requests/s, 48-64 new tokens): the migrate signal written mid-run while
   a batch is live, exit 0 after a checkpoint holding in-flight requests;
   a second process restores them (``restored``, resumed_requests > 0) and
   ends with an ok result
10. migration — ``python -m tpu_operator_torch.workloads.checkpoint`` (20
   steps, a snapshot every 5) at topology 1x1 on one card, 2x2 on 4 or
   more; the migrate signal at step 10 or later; the restart at 1x1 (one
   card visible) resumes from the signal's step with finite losses; on one
   card its final weights are bit-identical to an uninterrupted run's
11. warm-pool — ``python -m tpu_operator_torch.workloads.run_validation``
   with warm-pool, twice, each in a fresh process on a fresh copy of the
   package with no ``_build/``, sharing one TPU_COMPILE_CACHE_ARTIFACTS:
   the cold run builds every library (misses = sources, hits 0, compile_s
   > 0), the warm one installs them from the store without nvcc (hits =
   sources, misses 0, compile_s 0, fetch_s under a tenth of the cold
   compile_s); in both the build dir holds every library and vector-add
   ran on B1, equal to its plain version; prints both runs and the
   libraries' sizes
12. agents   — the node's card-facing agents in-process, no gRPC, aiohttp
   or prometheus_client: NVML's inventory (its count that of nvidia-smi -L
   and of CUDA, every UUID CUDA's; prints the /dev nodes and the minors);
   the device plugin (every card Healthy; the gate child, ``run_validation``
   with vector-add under exactly one card's allocation env: rc 0, B1
   launched, max_error 0.0; a child under that env sees one card, the
   allocated UUID, and on 2 or more cards one under the last card's sees
   only it); feature discovery (product, chips per host, 80 GB on an H100
   80GB, the driver's version); the metrics agent's ``card_counters`` while
   B2 copies a 1 GiB buffer for at least 2 s (duty cycle above 50 %, memory
   in use up by at least the buffers, no scrape error, one series per
   card), and on 2 or more cards the NVLink counters across an NCCL
   allreduce (or a line that the card does not support them); the health
   assessor ``ok`` and the validator's metrics mode counting every card;
   prints the phase's wall time and the child gate's
13. validator — the node validator (``tpu_operator_torch/validator``) on the
   card in-process, under a fresh TPU_VALIDATION_ROOT: libtpu (the driver
   library found, ``chips`` the card count), pjrt (the CUDA runtime's count
   equal to the host's), plugin-ready from the count the port's device
   plugin advertises (no apiserver), jax
   (in-process: B1 launched, vector-add's max_error 0) and perf (every
   probe ok and run, one card's ring skip the reference's own; B2 launched,
   B3 on more than one card); then the gate pod's contract without an
   apiserver: the pod the validator builds (``nvidia.com/gpu`` limits, no
   TORCH_DEVICE, the cache-key fields) run as the kubelet would, rc 0, the
   drop-box holding the allreduce figures, and on more than one card the
   busbw floor armed from the NVLink catalogue and cleared; prints the card
   counts of nvidia-smi -L, /dev and CUDA, and each component's wall time
14. partition — the partition acceptance on the cards: two units of one
   card each (CUDA_VISIBLE_DEVICES), each burn-in exactly equal to its solo
   run, the trajectories independent, each unit seeing its own cards; on
   one card one unit, solo against the barrier run (two-card units run in
   the slices phase, under the plugin's allocations)
15. slices   — partitions of whole cards, on the card machine's NVML, the
   slice manager and the plugin driven against the stand-in apiserver (2x2
   with 4 cards, 1x1 with one): ``all-disabled`` gives the flat plugin over
   every card; a profile (two 1x2 on four cards, ``all-isolated`` on one)
   goes pending then success, evicts the pod asking for a card and keeps
   the DaemonSet's, and a second pass does nothing; ``mixed`` serves
   ``nvidia.com/gpu-<shape>`` with units of NVML's UUIDs, all Healthy, two
   in one container refused; a child under each unit's allocation env
   (all at once) sees exactly the unit's UUIDs and passes vector-add (and
   allreduce on two cards) with max_error 0, B1 launched; on four cards
   both units' burn-in at once under the allocations, each equal to its
   solo run, trajectories distinct, and the reference's ``all-isolated``
   on 2x2 failed with the layout and plugin set unchanged; a two-host 2x4
   layout's units on this host's cards under worker id 1, the flat plugin
   without one; then on synthetic trees under the phase's root only (the
   cards' PCI addresses from NVML and vendor and class from the real
   sysfs where the machine gives them, else synthesized and said so, and
   an NVSwitch decoy): the vfio manager binds exactly the cards,
   ``validator.cli --component vfio-pci`` passes, ``--mode vfio``
   advertises every card and maps the groups; runtime prep, the runtime
   container's marker (the ``libtpu`` component passes on it, the payload
   the machine's libcuda), the VM runtime drop-in and the config manager's
   pick; ``nvidia-smi -q``'s bus ids and MIG lines unchanged; prints the
   phase's wall time and each child's
16. slice    — the validator's multi-host branch: on 2 or more cards the
   validators of a two-host slice (worker 0 and 1, half the cards each by
   CUDA_VISIBLE_DEVICES) run jax, then perf, at once in one event loop
   against a dict-backed stand-in apiserver whose kubelet runs each
   rendezvous pod's own command (``workloads.distributed``) with its env,
   the coordinator at a localhost port: jax-ready ``multi-host`` with
   workers 2 and each host's worker id, every pod's NCCL allreduce gated at
   the floor derived from the NIC rate and cleared, the pods collected,
   the Service's tombstone the payload's epoch, perf's slice-member skip;
   on 4 or more cards also a multislice of two slices of two one-card
   hosts (the cross-slice payload with workers 4, its ``multislice``
   drop-box, its pods at the cross-slice floor); on one card one line says
   why nothing runs (NCCL refuses two ranks on one card); prints each
   validator's wall and each pod's elapsed_s
17. kernel   — each kernel against its plain version on the card: the add
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
   the transformer check's (16, 16, 32), a transformer-pp stage's
   (8, 16, 16) diagonal and fully visible, ragged shapes, head dims 40 and 72,
   Tq and Tk off the 64 grid at D 128, and a fully masked block, which must
   leave the accumulators or the state bit-identical: per output, max
   |kernel - plain| within 1e-4 of max |plain| in f32 and 1e-2 in bf16 (B4:
   this hop's contribution, on top of non-zero accumulators); every case
   launched twice on the same inputs, bit-identical; B5's contiguous f32
   entry at the old serving shapes (BH 2, an 8-row tail at q_off = length - 8 against 24, 40
   and 136 keys padded to a 16-token page, D 8 and 16), ragged non-causal
   Tq 136 x Tk 200 at D 64, rows that see no key and BH 1: out within 1e-4
   of max |plain|, lse within 1e-5, blind rows exactly 0 and -1e30, each
   case launched twice and bit-identical; B5's paged f32 entry at the
   engine's step (8 requests at contexts 24-35, 2 heads, D 16), page edges
   (1 to 128 tokens, reversed tables, D 8), rows of length 0, split edges
   (511 to 2048 tokens at D 64; 8-token pages at D 128), D 40 and the long
   shape (8 requests x 8 heads, D 128, 3585-4096 tokens in a 2048-page
   pool in random order): the same tolerances, each case launched twice
   and bit-identical, and its first and last request alone the same bits
   as their rows in the batch
18. timing   — CUDA-event medians of each kernel, its plain version and the
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
   TF32 peak), the CUDA-core bound beside it as ``bound_simt_ms``; B5's f32
   contiguous entry at (2, 8, 128, 16) causal, q_off 120, and its paged
   entry at the engine's step (8 requests at context 35) and at the long
   shape, beside the plain versions and ``scaled_dot_product_attention`` on
   f32 with a boolean mask (the paged rows on the pages gathered
   beforehand), bound by the bytes (each live K/V row read once)

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
TRAIN_CHECKS = ("transformer", "train", "transformer-pp")
LM_MODEL, LM_LAYERS = "k-exaone-236b-a23b-ep16", 5  # the train check's model by name
CENSUS_BOUNDS = {"ulysses": 2e-2, "moe": 1e-4, "pipeline": 1e-3}  # each module's own
MULTIHOST_BUDGET_S = 90    # a survivor of a dead host must fail by itself within it
SERVING_SHAPE = (2, 8, 128, 16)  # B5 f32 timing: heads, the 8-row tail, 128 keys, head dim
REPLICA_ENV = {"TPU_SERVE_SECONDS": "6", "TPU_SERVE_RATE": "4",
               # long answers keep requests in flight when the signal lands
               "TPU_SERVE_NEW_TOKENS": "48,64"}
MIGRATE_STEPS, MIGRATE_EVERY, MIGRATE_AT = 20, 5, 10  # the signal at step 10 or later
DMA_PROBE = ((131072, 512), 2048, 4)  # hbm-dma's shipping (shape, chunk_rows, slots): 256 MiB f32
MAX_SHARE = 1.05           # of the memory rate: above it is L2 reuse or a mis-count
PREFILL = (8, 32768, 128)  # longctx's shipping shape, [BH, T, D]
DECODE_TAIL = 8            # decode's query rows at the end of the cache
RING_HOP = (4, 512, 128)   # one ring hop per card: 4 heads, 512 tokens
TRAIN_HOP = (128, 2048, 128)      # train's hop per card: batch 4 x 32 heads, 2048 tokens
LONG_HOP = (32, 32768, 128)       # the long-context stage's: batch 1 x 32 heads, 32768 tokens
WINDOW_HOP = (256, 4096, 128)     # k-exaone's sliding layers: batch 4 x 64 heads, 4096 tokens
WINDOW = 128                      # their window
TRANSFORMER_HOP = (16, 16, 32)    # the transformer check's: batch 4 x 4 heads, 16 tokens
STAGE_HOP = (8, 16, 16)           # a transformer-pp stage's: batch 2 x 4 heads, 16 tokens, D 16
PP_LOSS_RTOL = 1e-3               # transformer-pp's first loss on the cards vs gloo ranks
TRAIN_WIDTH = (4096, 16384)       # train's d_model, d_hidden: the reference's TPU shapes
OUT_TOL = 2e-2             # the checks' max_error: bf16 output, the reference's bound
KERNEL_OUT_RTOL = 1e-2     # kernel vs plain: max|out - plain| / max|plain|, per case
STATE_RTOL = 1e-5          # m, l, lse: f32 sums in another order
F32_RTOL = 1e-4            # f32 kernels vs plain: max|out - plain| / max|plain|, per output
AGENTS_BUFFER = (524288, 512)  # 1 GiB of f32: B2's load under the metrics agent's sample
AGENTS_LOAD_S = 3.0        # the load queued; NVML's utilization covers up to its last second
AGENTS_MIN_LOAD_S = 2.0
AGENTS_MIN_DUTY = 50.0     # percent, on the loaded card


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def launches_since(before: dict) -> dict:
    """Each C entry's launches in this process since ``before``, a
    ``_build.launches()``."""
    from tpu_operator_torch.kernels import _build

    return {entry: n - before[entry] for entry, n in _build.launches().items()}


def forward_paths_since(before: dict) -> dict:
    """B5's launches since ``before`` by path: the forward's paths and the
    serving engine's paged entry."""
    from tpu_operator_torch.kernels import flash_attention as fa

    n = launches_since(before)
    entries = {**fa.FORWARD_ENTRIES, "paged_f32": "tpu_flash_paged_f32"}
    return {path: n[entry] for path, entry in entries.items()}


def remat_since(before: dict) -> tuple:
    """(B3 f32, B4) launches since ``before``, a
    ``ring_attention.remat_launches()``."""
    from tpu_operator_torch.workloads import ring_attention

    return tuple(n - before[key] for key, n in ring_attention.remat_launches().items())


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
    from tpu_operator_torch.workloads import warmpool

    sources = warmpool.libraries()
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
    smem_bytes = _build.bind("tpu_flash_train_smem_bytes")
    names = {"dkdv_kernel": 0, "dq_kernel": 1, "fold_f32_kernel": 2, "dkdv_band_kernel": 0,
             "dq_band_kernel": 1, "fold_band_kernel": 2}
    lines = built["flash_backward"].log.splitlines()
    for i, line in enumerate(lines):
        kernel = next((k for k in names if k in line), None)
        if "Compiling entry function" not in line or kernel is None:
            continue
        dp = next(d for d in (128, 64) if f"Li{d}E" in line)
        usage = " | ".join(x.strip() for x in lines[i + 2:i + 4])
        # ptxas counts the launch's 384 threads; setmaxnreg then gives the
        # two product warpgroups 232 and the producer 40
        print(f"build: {kernel} f32 D {dp}: {usage} (setmaxnreg: 232 a product thread, 40 a "
              f"producer thread) | {smem_bytes(names[kernel], dp)} bytes of shared memory",
              flush=True)
        require("0 bytes spill stores, 0 bytes spill loads" in usage,
                f"{kernel} f32 spills at D {dp}")


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

    from tpu_operator_torch.kernels import _build
    from tpu_operator_torch.workloads import collectives

    before = _build.launches()
    by, launches = run_checks(GATE_CHECKS, n_cards,
                              lambda: launches_since(before)["tpu_vector_add"])
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
    from tpu_operator_torch.kernels import _build

    def counts(before):
        by_path = forward_paths_since(before)
        return (sum(by_path.values()), by_path,
                launches_since(before)["tpu_flash_block_update_bf16"])

    by, forward, paths, update = {}, 0, {}, 0
    for check, path in zip(ATTENTION_CHECKS, ATTENTION_PATHS):
        before = _build.launches()
        lines, (n, by_path, n_update) = run_checks((check,), n_cards, lambda: counts(before))
        by.update(lines)
        if path is not None:
            # B5 on its planned path, and on no other
            require(by_path[path] > 0 and by_path[path] == n,
                    f"{check} launched the flash forward {by_path} (expected only {path!r})")
        forward += n
        update += n_update
        paths = {key: paths.get(key, 0) + n for key, n in by_path.items()}
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
    from tpu_operator_torch.kernels import _build

    checks = PROBE_CHECKS + (("ring",) if n_cards > 1 else ())
    before = _build.launches()
    by, launches = run_checks(checks, n_cards,
                              lambda: launches_since(before)["tpu_dma_pipeline_copy"],
                              scope="perf")
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
    """Run transformer, train and transformer-pp through the entry point;
    returns the launches of B3's f32 entry and of B4, and train's result.
    On 4 or more cards transformer-pp's first loss is held against the same
    run on as many gloo ranks on the host (the plain path)."""
    from tpu_operator_torch.workloads import ring_attention

    before = ring_attention.remat_launches()
    by, (forward, backward) = run_checks(TRAIN_CHECKS, n_cards, lambda: remat_since(before))
    tr, train, pp = by["transformer"], by["train"], by["transformer-pp"]
    if n_cards > 1:
        # the checks ran in one process per card: rank 0 counted its own
        for r in (tr, train, pp):
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
    check_pp(pp, n_cards)
    return forward, backward, train


def lm_training_phase(n_cards: int) -> tuple:
    """Run the ``train`` check on ``LM_MODEL`` (``TRAIN_MODEL`` set): the
    language model's train step at its published widths, four of its five
    layers on the windowed B3 f32 and B4 f32.  Returns the launches of
    each; fails unless both launched, the same number of times in every
    layer, and the losses are finite."""
    from tpu_operator_torch.workloads import ring_attention, train_bench

    os.environ[train_bench.MODEL_ENV] = LM_MODEL
    try:
        before = ring_attention.remat_launches()
        by, (forward, backward) = run_checks(("train",), n_cards, lambda: remat_since(before))
    finally:
        del os.environ[train_bench.MODEL_ENV]
    train = by["train"]
    if n_cards > 1:
        forward += train["launches"]["flash_block_update_f32"]
        backward += train["launches"]["flash_block_backward"]
    require(train["model"] == LM_MODEL and train["attention_kernel"] == "cuda-flash-fwd-bwd",
            f"train ran {train['model']} with attention on {train['attention_kernel']}")
    require(forward > 0 and forward % LM_LAYERS == 0 and backward > 0
            and backward % LM_LAYERS == 0,
            f"{LM_MODEL} launched B3 f32 {forward} and B4 f32 {backward} times, not the same "
            f"number in each of its {LM_LAYERS} layers")
    require(train["ok"] and math.isfinite(train["loss"]) and math.isfinite(train["loss_last"]),
            f"{LM_MODEL} train loss {train['loss']}, {train['loss_last']}")
    print(f"train {LM_MODEL}: step times (ms) {train['step_times_ms']}, "
          f"{train['tokens_per_sec']!r} tokens/s, B3 f32 launched {forward}, B4 f32 {backward}",
          flush=True)
    return forward, backward


def check_pp(pp: dict, n_cards: int) -> None:
    """transformer-pp's line: three finite, strictly falling losses, its
    own launches of B3 f32 and B4 above 0, ``pp_degenerate`` exactly below
    4 cards; on 4 or more cards its first loss within 1e-3 relative of the
    same run on as many gloo ranks on the host (the plain path, the same
    weights).  On four cards alone: ``python -c "import chip_smoke as c;
    n = c.device_phase()[1]; c.build_phase(); c.check_pp(c.run_checks(
    ('transformer-pp',), n, lambda: None)[0]['transformer-pp'], n)"``."""
    from tpu_operator_torch.workloads import collectives

    losses = pp["losses"]
    require(len(losses) == 3 and all(math.isfinite(v) for v in losses)
            and all(b < a for a, b in zip(losses, losses[1:])),
            f"transformer-pp losses {losses}")
    require(pp["attention_kernel"] == "cuda-flash-fwd-bwd"
            and all(n > 0 for n in pp["launches"].values()),
            f"transformer-pp on {pp['attention_kernel']}, launched {pp['launches']} in rank "
            f"0's process")
    require(pp.get("pp_degenerate", False) == (n_cards < 4) and pp["devices"] == n_cards,
            f"transformer-pp on mesh {pp['mesh']}, pp_degenerate {pp.get('pp_degenerate')}")
    print(f"transformer-pp: mesh {pp['mesh']}, losses {losses}, step times (s) "
          f"{pp['step_s']}, duration_s {pp['duration_s']!r}, launches on rank 0 "
          f"{pp['launches']}", flush=True)
    if n_cards < 4:
        return
    t0 = time.perf_counter()
    gloo = collectives.transformer_pipeline_burn_in(world_size=n_cards, device="cpu")
    rel = abs(losses[0] - gloo["losses"][0]) / abs(gloo["losses"][0])
    print(f"transformer-pp: first loss {losses[0]!r} on {n_cards} cards vs "
          f"{gloo['losses'][0]!r} on {n_cards} gloo ranks, mesh {gloo['mesh']} (rel "
          f"{rel:.2e}, tol {PP_LOSS_RTOL}; {time.perf_counter() - t0:.2f}s)", flush=True)
    require(gloo["mesh"] == pp["mesh"] and rel <= PP_LOSS_RTOL,
            "transformer-pp's first loss on the cards disagrees with the gloo run's")


def census_phase(n_cards: int) -> dict:
    """Run the parallelism census through the entry point, as the perf pod
    runs it on every card of a node (RESULTS_SCOPE=perf); no kernel lies on
    this path.  Returns the checks' lines."""
    by, _ = run_checks(tuple(CENSUS_BOUNDS), n_cards, lambda: None, scope="perf")
    for check, bound in CENSUS_BOUNDS.items():
        r = by[check]
        require(r["ok"] and r["max_error"] < bound,
                f"{check} off by {r['max_error']} (bound {bound})")
        require(r["devices"] == n_cards and r["backend"] == "cuda",
                f"{check} ran on {r['devices']} {r['backend']} device(s)")
    uly, ep, pp = by["ulysses"], by["moe"], by["pipeline"]
    require((uly["seq_per_chip"], uly["head_dim"]) == (512, 128)
            and ep["tokens"] == 1024 * n_cards and ep["experts"] == 2 * n_cards
            and pp["microbatches"] == 16, "the census ran below its shipping sizes")
    for check in CENSUS_BOUNDS:
        r = by[check]
        print(f"census: {check} duration_s {r['duration_s']!r} (time_s {r['time_s']!r}), "
              f"max_error {r['max_error']!r} over {r['devices']} card(s)", flush=True)
    return by


def multihost_phase(n_cards: int) -> dict:
    """Run the multi-host program as 2 hosts of half the cards each (1 host
    on one card or an odd count), then, on 2 or more cards, kill host 1 at
    the psum phase and require host 0's watchdog to end it.  Returns the
    healthy run's durations."""
    from tpu_operator_torch.workloads import distributed, watchdog

    hosts = 2 if n_cards >= 2 and n_cards % 2 == 0 else 1
    per = n_cards // hosts
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mh-") as root:
        env = {"EXPECTED_DEVICES": str(per), "DEVICE_COUNT_GATE_BACKENDS": "cuda",
               "TPU_VALIDATION_ROOT": root, "RESULTS_SCOPE": ""}
        t0 = time.perf_counter()
        outcomes = distributed.spawn_local_workers_outcomes(
            hosts, per, steps=3, timeout=300, device="cuda", extra_env=env)
        wall = time.perf_counter() - t0
        for o in outcomes:
            r = o["result"] or {}
            print(f"multihost: host {o['process_id']} rc={o['returncode']} in "
                  f"{o['elapsed_s']!r}s: {json.dumps(r)}", flush=True)
            require(o["returncode"] == 0 and r.get("ok"),
                    f"host {o['process_id']} failed: {o['stderr_tail'][-1500:]}")
            require(r["psum"]["ok"], f"psum {r['psum']}")
            require(r["devices_check"]["visible_global"] == n_cards,
                    f"visible_global {r['devices_check']['visible_global']}")
            require(r["mesh"]["dp"] * r["mesh"]["mp"] == n_cards, f"mesh {r['mesh']}")
            losses = r["losses"]
            require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
                    f"losses {losses}")
        print(f"multihost: {hosts} host(s) x {per} card(s) in {wall:.2f}s wall, "
              f"host time_s {[o['result']['time_s'] for o in outcomes]}", flush=True)
        if hosts < 2:
            print("multihost: the fault run skipped: it needs 2 hosts, so 2 cards",
                  flush=True)
            return {"hosts": hosts, "wall_s": wall}
        t0 = time.perf_counter()
        outcomes = distributed.spawn_local_workers_outcomes(
            hosts, per, steps=3, timeout=180, device="cuda",
            extra_env={**env, "FAULT_INJECT": "psum:1", "WATCHDOG_TIMEOUT_S": "5"})
        pm = distributed.rendezvous_post_mortem(outcomes)
        print(f"multihost: fault psum:1 in {time.perf_counter() - t0:.2f}s: "
              f"{json.dumps(pm)}", flush=True)
        by_id = {w["process_id"]: w for w in pm["workers"]}
        require(not pm["ok"] and 1 in pm["dead_members"], f"dead members {pm['dead_members']}")
        require(pm["survivors_failed_bounded"]
                and pm["max_survivor_elapsed_s"] < MULTIHOST_BUDGET_S,
                f"survivors not bounded: {pm['workers']}")
        require(by_id[1]["outcome"] == "killed", f"host 1 {by_id[1]}")
        require(by_id[0]["outcome"] == "watchdog-peer-death"
                and by_id[0]["returncode"] == watchdog.WATCHDOG_EXIT_CODE
                and by_id[0]["dead_members"] == [1],
                f"host 0 {by_id[0]}: {outcomes[0]['stderr_tail'][-1500:]}")
    return {"hosts": hosts, "wall_s": wall}


def _stream_events(cmd: list, env: dict, on_event, timeout: float) -> tuple:
    """Run ``cmd`` with ``env``, calling ``on_event`` on each JSON line of its
    stdout as it comes; killed at ``timeout``.  Returns (rc, events, stderr
    tail)."""
    import threading

    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    err = []
    reader = threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True)
    reader.start()
    events = []
    try:
        for line in proc.stdout:
            if line.startswith("{"):
                event = json.loads(line)
                events.append(event)
                on_event(event)
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(5.0)
    return rc, events, "".join(err)[-3000:]


def _subprocess_env(root: str, **extra) -> dict:
    from tpu_operator_torch.workloads import subprocess_pythonpath

    env = {k: v for k, v in os.environ.items() if k not in ("WORKLOAD_CHECKS", "RESULTS_SCOPE")}
    env.update(PYTHONPATH=subprocess_pythonpath(), TPU_VALIDATION_ROOT=root, **extra)
    return env


def _signal(path: str) -> None:
    from tpu_operator_torch import consts

    with open(path, "w") as f:
        f.write(f'{consts.MIGRATE_ANNOTATION}="{consts.MIGRATE_REQUESTED}"\n')


def serving_ab(attend: str) -> dict:
    """quick_check's A/B in one attend, with the engine's attend call timed
    by CUDA events around every call, the pool's gathers and B5's launches by
    path counted over the whole check.  Returns quick_check's result with
    ``paths`` (B5's launches by path), ``gathers``, ``attend_calls`` and
    ``tail_calls`` (calls with a context at or past the 8-row tail) over the
    three runs, ``step_ms`` (each attend call of the batched run, the last)
    and ``streams``.  Reads only names that this tree and the trees since
    the launches were counted by C entry share, so it times either."""
    import torch

    from tpu_operator_torch.kernels import _build
    from tpu_operator_torch.workloads import serving

    method = "_attend_flash" if attend == "flash" else "_attend_dense"
    inner, gather = getattr(serving.ServingEngine, method), serving.PagedKVCache.gather
    calls, gathers = [], [0]

    def timed(self, reqs, qs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(self, reqs, qs)
        end.record()
        tail = any(len(req.tokens) >= serving.FLASH_TAIL for req in reqs)
        calls.append((self, tail, start, end))
        return out

    def counted(self, *args, **kwargs):
        gathers[0] += 1
        return gather(self, *args, **kwargs)

    before = _build.launches()
    streams = {}
    setattr(serving.ServingEngine, method, timed)
    serving.PagedKVCache.gather = counted
    try:
        t0 = time.perf_counter()
        r = serving.quick_check(attend=attend, streams=streams)
        seconds = time.perf_counter() - t0
    finally:
        setattr(serving.ServingEngine, method, inner)
        serving.PagedKVCache.gather = gather
    torch.cuda.synchronize()
    batched = [start.elapsed_time(end) for engine, _, start, end in calls
               if engine is calls[-1][0]]
    r.update(paths=forward_paths_since(before), gathers=gathers[0], attend_calls=len(calls),
             tail_calls=sum(tail for _, tail, _, _ in calls), step_ms=batched,
             step_ms_median=statistics.median(batched), streams=streams, seconds=seconds)
    print(f"serving [{attend}]: identical_outputs {r['identical_outputs']}, tokens_per_sec "
          f"sequential {r['sequential']['tokens_per_sec']!r} batched "
          f"{r['batched']['tokens_per_sec']!r}, speedup {r['speedup']!r}, tpot_p50_s "
          f"sequential {r['sequential']['tpot_p50_s']!r} batched "
          f"{r['batched']['tpot_p50_s']!r}; {method} per batched step (CUDA events, "
          f"{len(batched)} steps) median {r['step_ms_median']!r} ms, min {min(batched)!r}, max "
          f"{max(batched)!r}; {len(calls)} attend calls ({r['tail_calls']} at or past the tail), "
          f"{gathers[0]} gathers, forward launches by path {r['paths']} ({seconds:.2f}s)",
          flush=True)
    return r


def serving_phase(n_cards: int) -> dict:
    """The serving check through the entry point (RESULTS_SCOPE=perf, as the
    perf pod asks for it), quick_check's A/B in both attends on the card,
    and the replica's migrate-and-restore round trip.  Returns the paged
    kernel's launches in the flash run and both runs' results."""
    from tpu_operator_torch.kernels import _build

    before = _build.launches()
    by, paths = run_checks(("serving",), n_cards, lambda: forward_paths_since(before),
                           scope="perf")
    check = by["serving"]
    require(check["ok"] and check["identical_outputs"] and check["backend"] == "cuda",
            f"serving check: {check}")
    runs = {}
    for attend in ("dense", "flash"):
        runs[attend] = r = serving_ab(attend)
        require(r["ok"] and r["identical_outputs"], f"serving [{attend}] changed outputs")
    flash = runs["flash"]
    # one paged launch per flash step that had a context at or past the tail,
    # no other path (the contiguous f32 entry among them), no gather
    require(flash["paths"]["paged_f32"] == flash["tail_calls"] > 0
            and all(n == 0 for p, n in flash["paths"].items() if p != "paged_f32"),
            f"the flash attend launched {flash['paths']} over {flash['tail_calls']} steps at or "
            "past the tail (expected one paged launch each, nothing else)")
    require(flash["gathers"] == 0, f"the flash attend gathered pages {flash['gathers']} times")
    require(all(n == 0 for n in runs["dense"]["paths"].values()), "the dense attend launched B5")
    require(runs["dense"]["streams"] == flash["streams"] and len(flash["streams"]) == 8,
            "dense and flash attends gave different token streams")
    replica_phase()
    return {"paged_launches": flash["paths"]["paged_f32"], "runs": runs}


def replica_phase() -> None:
    """``python -m tpu_operator_torch.workloads.serving`` serves, takes the
    migrate signal mid-run, checkpoints and exits 0; a second process
    restores the in-flight requests and finishes the service."""
    with tempfile.TemporaryDirectory(prefix="chip-smoke-serve-") as root:
        sig = os.path.join(root, "annotations")
        env = _subprocess_env(root, TPU_CKPT_DIR=os.path.join(root, "ckpt"),
                              TPU_MIGRATE_SIGNAL_FILE=sig, **REPLICA_ENV)
        cmd = [sys.executable, "-m", "tpu_operator_torch.workloads.serving"]

        def on_event(event):
            if (event.get("event") == "serving" and event["batch"] > 0
                    and event["elapsed_s"] >= 2 and not os.path.exists(sig)):
                _signal(sig)

        t0 = time.perf_counter()
        rc, events, err = _stream_events(cmd, env, on_event, 180)
        done = next((e for e in events if e.get("event") == "checkpointed"), None)
        first = events[-1] if events else {}
        print(f"replica: migrate run rc={rc} in {time.perf_counter() - t0:.2f}s; checkpointed "
              f"{json.dumps(done)}; result {json.dumps(first)}", flush=True)
        require(rc == 0 and done is not None and done["in_flight"] > 0
                and first.get("event") == "result" and first["checkpointed"],
                f"the replica did not checkpoint on the signal: {err}")
        os.remove(sig)
        t0 = time.perf_counter()
        rc, events, err = _stream_events(cmd, env, lambda e: None, 180)
        restored, final = (events[0], events[-1]) if events else ({}, {})
        print(f"replica: restore run rc={rc} in {time.perf_counter() - t0:.2f}s; "
              f"{json.dumps(restored)}; result {json.dumps(final)}", flush=True)
        require(rc == 0 and restored.get("event") == "restored"
                and restored["resumed_requests"] > 0, f"the replica did not restore: {err}")
        require(final.get("event") == "result" and final["ok"] and final["resumed"]
                and final["tokens_total"] >= first["tokens_total"],
                f"the restored replica's result: {final}")


def migration_phase(n_cards: int) -> dict:
    """``python -m tpu_operator_torch.workloads.checkpoint`` (20 steps, a
    snapshot every 5) at topology 1x1 on one card, 2x2 on 4 or more; the
    migrate signal at step 10 or later; the restart at 1x1 (one card) resumes
    from the signal's snapshot with finite losses, and on one card its final
    weights are bit-identical to an uninterrupted 20-step run's."""
    topology = "2x2" if n_cards >= 4 else "1x1"
    with tempfile.TemporaryDirectory(prefix="chip-smoke-migrate-") as root:
        sig = os.path.join(root, "annotations")
        cmd = [sys.executable, "-m", "tpu_operator_torch.workloads.checkpoint"]
        base = dict(TRAIN_STEPS=str(MIGRATE_STEPS), TPU_CKPT_EVERY=str(MIGRATE_EVERY),
                    TPU_MIGRATE_SIGNAL_FILE=sig)

        def run(label, ckpt, topo, on_event=lambda e: None, **extra):
            t0 = time.perf_counter()
            rc, events, err = _stream_events(
                cmd, _subprocess_env(root, TPU_CKPT_DIR=os.path.join(root, ckpt),
                                     TPU_JOB_TOPOLOGY=topo, **base, **extra), on_event, 300)
            result = events[-1] if events else {}
            print(f"migration: {label} rc={rc} in {time.perf_counter() - t0:.2f}s: "
                  f"{json.dumps(result)}", flush=True)
            require(rc == 0 and result.get("event") == "result" and result["ok"]
                    and result["backend"] == "cuda", f"{label} failed: {err}")
            return result

        def on_event(event):
            if event.get("event") == "progress" and event["step"] >= MIGRATE_AT:
                _signal(sig)

        # a step slow enough that the signal lands before the run ends
        first = run(f"{topology} with the signal", "ckpt", topology, on_event,
                    TRAIN_STEP_SLEEP_S="0.2")
        require(first["migrated_out"] and first["checkpointed_step"] == first["step"]
                >= MIGRATE_AT and first["mesh"] == [int(x) for x in topology.split("x")],
                f"the signal run: {first}")
        os.remove(sig)
        one = {"CUDA_VISIBLE_DEVICES": "0"} if n_cards > 1 else {}
        resumed = run("restart at 1x1", "ckpt", "1x1", **one)
        require(resumed["resumed_from_step"] == first["checkpointed_step"]
                and resumed["step"] == MIGRATE_STEPS and resumed["losses_finite"]
                and all(math.isfinite(v) for v in resumed["losses"]),
                f"the restart: {resumed}")
        if topology == "1x1":
            whole = run("uninterrupted 1x1", "whole", "1x1")
            require(whole["weights_sha256"] == resumed["weights_sha256"],
                    "the resumed run's final weights differ from an uninterrupted run's")
            print("migration: resumed final weights bit-identical to the uninterrupted run's",
                  flush=True)
    return {"signal_step": first["checkpointed_step"], "topology": topology}


def warmpool_phase(n_cards: int) -> dict:
    """The warm-pool check through ``python -m tpu_operator_torch.workloads.
    run_validation``, twice, each in a fresh process on a fresh copy of the
    package with no ``_build/``, the two sharing one artifact store: the
    cold run builds every library (misses = libraries, hits 0, compile_s >
    0), the warm one installs them from the store without nvcc (hits =
    libraries, misses 0, compile_s 0, fetch_s far below the cold build);
    both run vector-add on B1 equal to its plain version.  Returns both
    results and B1's launches in them."""
    import shutil

    from tpu_operator_torch.kernels import _build
    from tpu_operator_torch.workloads import warmpool

    n_libs = len(warmpool.libraries())
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-warm-") as root:
        for label in ("cold", "warm"):
            tree = os.path.join(root, label)
            shutil.copytree(os.path.dirname(_build.CSRC_DIR),
                            os.path.join(tree, "tpu_operator_torch"),
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            env = _subprocess_env(os.path.join(root, f"{label}-validation"))
            env.update(PYTHONPATH=tree, WORKLOAD_CHECKS="warm-pool",
                       EXPECTED_DEVICES=str(n_cards), DEVICE_COUNT_GATE_BACKENDS="cuda",
                       TPU_COMPILE_CACHE_ARTIFACTS=os.path.join(root, "artifacts"))
            env.pop("TPU_FLEET_CACHE_URL", None)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_operator_torch.workloads.run_validation"],
                cwd=tree, env=env, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            lines = {line["check"]: line for line in map(json.loads, (
                x for x in proc.stdout.splitlines() if x.startswith("{")))}
            r = lines.get("warm-pool", {})
            print(f"warm-pool [{label}]: rc={proc.returncode} in {wall:.2f}s wall: "
                  f"{json.dumps(r)}", flush=True)
            require(proc.returncode == 0 and r.get("ok") and r["backend"] == "cuda",
                    f"warm-pool [{label}] failed: {proc.stderr[-3000:]}")
            built = sorted(f for f in os.listdir(os.path.join(tree, "tpu_operator_torch",
                                                             "_build")) if f.endswith(".so"))
            require(len(built) == n_libs and set(r["libraries"]) == set(warmpool.libraries()),
                    f"warm-pool [{label}] left {built} in its build dir")
            va = r["results"]["vector-add"]
            require(va["finite"] and va["value"] == va["plain_value"]
                    and r["launches"]["vector_add"] > 0,
                    f"warm-pool [{label}] vector-add {va}, launches {r['launches']}")
            r["wall_s"] = wall
            runs[label] = r
    cold, warm = runs["cold"], runs["warm"]
    require((cold["misses"], cold["hits"]) == (n_libs, 0) and cold["compile_s"] > 0,
            f"the cold run: misses {cold['misses']}, hits {cold['hits']}")
    require((warm["hits"], warm["misses"], warm["corrupt"]) == (n_libs, 0, 0)
            and warm["compile_s"] == 0 and warm["fetch_s"] < 0.1 * cold["compile_s"],
            f"the warm run: hits {warm['hits']}, misses {warm['misses']}, compile_s "
            f"{warm['compile_s']}, fetch_s {warm['fetch_s']}")
    sizes = {name: lib["bytes"] for name, lib in warm["libraries"].items()}
    print(f"warm-pool: cold {cold['duration_s']!r} s (compile_s {cold['compile_s']!r}, the "
          f"libraries' build seconds summed; {cold['wall_s']:.2f}s process wall), warm "
          f"{warm['duration_s']!r} s (fetch_s {warm['fetch_s']!r}; {warm['wall_s']:.2f}s "
          f"process wall); library bytes {sizes} ({sum(sizes.values())} in all)", flush=True)
    return {"runs": runs, "launches": sum(r["launches"]["vector_add"] for r in runs.values())}


def _card_lines() -> list:
    return [line for line in subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.splitlines() if line.startswith("GPU ")]


def _uuid(value) -> str:
    """A card's UUID as NVML writes it: CUDA's properties give the hex
    groups without the "GPU-"."""
    text = str(value)
    return text if text.startswith("GPU-") else "GPU-" + text


# the gate child: run_validation's entry point, then B1's launches in it
_GATE_CHILD = """
import json, sys
from tpu_operator_torch.kernels import _build
from tpu_operator_torch.workloads import run_validation
rc = run_validation.main()
print(json.dumps({"vector_add_launches": _build.launches()["tpu_vector_add"]}))
sys.exit(rc)
"""
_SEE_CHILD = """
import json, torch
print(json.dumps({"count": torch.cuda.device_count(),
                  "uuid": str(torch.cuda.get_device_properties(0).uuid)}))
"""


def _allocation_child(code: str, alloc_env: dict, root: str, **extra) -> tuple:
    """``code`` in a fresh process under an allocation's env, as a container
    the kubelet starts with it; returns (process, JSON lines, wall s)."""
    env = _subprocess_env(root, **extra)
    for key in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES", "TORCH_DEVICE",
                "DIST_CPU_RANKS", "TPU_HW_ROOT", "LIBCUDA_PATH"):
        env.pop(key, None)
    env.update(alloc_env)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600)
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    return proc, lines, time.perf_counter() - t0


def agents_phase(n_cards: int, root: str, name: str) -> dict:
    """The node's card-facing agents in-process on the cards, with none of
    gRPC, aiohttp or prometheus_client: NVML's inventory against nvidia-smi
    and CUDA; the device plugin's health, and its allocation of one card
    driving the gate child (B1) and a child that must see exactly that card
    (and the last card's on 2 or more); feature discovery's labels; the
    metrics agent's counters under B2's load, and the NVLink counters across
    an NCCL allreduce on 2 or more cards; the health assessor and the
    validator's metrics mode.  Returns B1's launches (in the gate child) and
    B2's."""
    import torch

    from tpu_operator_torch import consts, hw, nvml
    from tpu_operator_torch.agents import feature_discovery, metrics_agent
    from tpu_operator_torch.agents.node_status_exporter import HealthAssessor
    from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin, PluginConfig
    from tpu_operator_torch.k8s import nodeinfo
    from tpu_operator_torch.kernels import _build
    from tpu_operator_torch.kernels import dma_pipeline as dp
    from tpu_operator_torch.validator import status
    from tpu_operator_torch.validator.metrics import NodeMetrics

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(root, "validations"))
    os.environ["TPU_VALIDATION_ROOT"] = root

    # the inventory
    inv = nvml.inventory()
    smi = _card_lines()
    cuda_uuids = [_uuid(torch.cuda.get_device_properties(i).uuid) for i in range(n_cards)]
    print(f"agents: NVML {len(inv.cards)} card(s), driver {inv.driver_version}, CUDA "
          f"{inv.cuda_version}: " + "; ".join(
              f"index {c.index} {c.uuid} minor {c.minor} {c.name}" for c in inv.cards)
          + f"; CUDA's order {cuda_uuids}; /dev card nodes "
          f"{[os.path.basename(p) for p in hw.card_device_paths()]}", flush=True)
    require(len(inv.cards) == len(smi) == torch.cuda.device_count() == n_cards,
            f"NVML lists {len(inv.cards)} cards, nvidia-smi {len(smi)}, CUDA "
            f"{torch.cuda.device_count()}")
    require(sorted(c.uuid for c in inv.cards) == sorted(cuda_uuids)
            and all(c.uuid in " ".join(smi) for c in inv.cards),
            f"NVML's UUIDs {[c.uuid for c in inv.cards]}, CUDA's {cuda_uuids}, smi {smi}")
    index_of = {c.uuid: c.index for c in inv.cards}

    # the device plugin, in process
    plugin = GPUDevicePlugin(PluginConfig(kubelet_dir=os.path.join(root, "kubelet")))
    plugin.refresh_devices()
    advertised = plugin.snapshot()
    print(f"agents: the plugin advertises {advertised}", flush=True)
    require(len(advertised) == n_cards and all(h == "Healthy" for _, h in advertised),
            f"the plugin advertises {advertised} for {n_cards} cards")
    by_index = sorted((card for (card,) in plugin.devices.values()), key=lambda c: c.index)
    first, last = by_index[0], by_index[-1]
    alloc = plugin.allocate([first.uuid])
    print(f"agents: Allocate([{first.uuid}]) -> {alloc}", flush=True)
    require(alloc["envs"]["CUDA_VISIBLE_DEVICES"] == first.uuid
            and any(host.endswith(f"/nvidia{first.minor}") for _, host, _ in alloc["devices"]),
            f"the allocation of {first.uuid}: {alloc}")
    proc, lines, gate_s = _allocation_child(
        _GATE_CHILD, alloc["envs"], os.path.join(root, "gate"), WORKLOAD_CHECKS="vector-add",
        EXPECTED_DEVICES="1", DEVICE_COUNT_GATE_BACKENDS="cuda")
    by_check = {line.get("check"): line for line in lines}
    b1 = next((line["vector_add_launches"] for line in lines if "vector_add_launches" in line), 0)
    print(f"agents: the gate child under the allocation: rc={proc.returncode} in {gate_s:.2f}s "
          f"wall, {lines}", flush=True)
    require(proc.returncode == 0, f"the gate child failed: {proc.stderr[-3000:]}")
    vector_add = by_check.get("vector-add", {})
    require(vector_add.get("max_error") == 0.0 and vector_add.get("backend") == "cuda" and b1 > 0,
            f"vector-add in the gate child: {vector_add}, B1 launches {b1}")
    seen = {}
    for card in ([first, last] if n_cards > 1 else [first]):
        env = plugin.allocate([card.uuid])["envs"]
        proc, lines, _ = _allocation_child(_SEE_CHILD, env, os.path.join(root, "see"))
        require(proc.returncode == 0 and lines, f"the child under {env}: {proc.stderr[-3000:]}")
        seen[card.uuid] = lines[0]
        require(lines[0]["count"] == 1 and _uuid(lines[0]["uuid"]) == card.uuid,
                f"the child under {card.uuid}'s allocation sees {lines[0]}")
    print(f"agents: children under one card's allocation see {seen}", flush=True)

    if n_cards > 1:
        levels = nvml.topology([c.uuid for c in inv.cards])
        pick = plugin.preferred_allocation([c.uuid for c in inv.cards], [], 2)
        named = {"-".join(str(index_of[u]) for u in sorted(pair, key=index_of.get)):
                 nvml.TOPOLOGY_LEVELS.get(level, level) for pair, level in levels.items()}
        print(f"agents: PCIe common ancestors {named or 'not reported by this driver'}; "
              f"the preferred pair {[index_of[u] for u in pick]}", flush=True)

    # feature discovery
    labels = feature_discovery.discover_features({"metadata": {"labels": {}}})
    print(f"agents: feature labels {labels}", flush=True)
    require(labels[consts.GPU_PRODUCT_LABEL] == name.replace(" ", "-")
            and labels[consts.TFD_CHIPS_PER_HOST_LABEL] == str(n_cards)
            and labels[consts.TFD_CHIP_LABEL] == nodeinfo.generation_of(name)
            and ("H100 80GB" not in name or labels[consts.TFD_HBM_GB_LABEL] == "80")
            and labels[consts.TFD_RUNTIME_VERSION_LABEL].startswith(inv.driver_version + "-"),
            f"feature labels {labels} for {n_cards} x {name}")

    # the metrics agent under B2's load, on CUDA's card 0
    mine = index_of[cuda_uuids[0]]
    errors = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = metrics_agent.card_counters(errors)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(AGENTS_BUFFER, device="cuda", generator=gen)
    _, chunk, slots = DMA_PROBE
    launched = _build.launches()
    out = dp.dma_pipeline_copy(x, 16, chunk, slots)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = dp.dma_pipeline_copy(x, 16, chunk, slots)
    end.record()
    torch.cuda.synchronize()
    launch_ms = start.elapsed_time(end)
    buffers = 2 * x.numel() * x.element_size()
    t0 = time.perf_counter()
    for _ in range(math.ceil(AGENTS_LOAD_S * 1e3 / launch_ms)):
        out = dp.dma_pipeline_copy(x, 16, chunk, slots)
    time.sleep(1.2)  # NVML's utilization: the last sample period, up to a second
    t_sample = time.perf_counter() - t0
    during = metrics_agent.card_counters(errors)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(torch.equal(out, x), "B2's copy under the load differs from its input")
    b2 = launches_since(launched)["tpu_dma_pipeline_copy"]
    del x, out
    duty = during[mine]["tpu_duty_cycle_percent"]
    rise = during[mine]["tpu_hbm_memory_usage_bytes"] - before[mine]["tpu_hbm_memory_usage_bytes"]
    text = metrics_agent.to_prometheus({"chips": during})
    print(f"agents: B2 load {load_s:.2f}s ({b2} launches of {launch_ms:.3f} ms, 16 passes over "
          f"1 GiB each), sampled at {t_sample:.2f}s: card {mine} duty cycle {duty!r} %, memory "
          f"in use {before[mine]['tpu_hbm_memory_usage_bytes']!r} -> "
          f"{during[mine]['tpu_hbm_memory_usage_bytes']!r} bytes (+{rise!r}, buffers {buffers}), "
          f"scrape errors {errors}; counters {during}", flush=True)
    require(load_s >= AGENTS_MIN_LOAD_S and t_sample < load_s,
            f"the load lasted {load_s:.2f}s, sampled at {t_sample:.2f}s")
    require(duty > AGENTS_MIN_DUTY, f"duty cycle {duty} % under B2's load")
    require(rise >= buffers, f"memory in use rose {rise} bytes for {buffers} of buffers")
    require(not errors and all(c["tpu_chip_scrape_errors_total"] == 0.0 for c in during.values()),
            f"scrape errors {errors}")
    require(text.count("tpu_duty_cycle_percent{") == n_cards
            and text.count("tpu_hbm_memory_total_bytes{") == n_cards,
            f"to_prometheus: not one series per card:\n{text}")
    if n_cards > 1:
        supported = ["nvlink_tx_bytes" in nvml.sample(c) for c in inv.cards]
        if not all(supported):
            print(f"agents: NVLink data counters unsupported on this machine ({supported})",
                  flush=True)
        else:
            import torch.cuda.nccl

            tensors = [torch.ones(64 << 20, device=f"cuda:{i}") for i in range(n_cards)]
            nv0 = metrics_agent.card_counters(errors)
            for _ in range(5):
                torch.cuda.nccl.all_reduce(tensors)
            for i in range(n_cards):
                torch.cuda.synchronize(i)
            nv1 = metrics_agent.card_counters(errors)
            moved = {i: (nv1[i]["tpu_ici_transmitted_bytes_total"]
                         - nv0[i]["tpu_ici_transmitted_bytes_total"],
                         nv1[i]["tpu_ici_received_bytes_total"]
                         - nv0[i]["tpu_ici_received_bytes_total"]) for i in nv1}
            print(f"agents: NVLink data bytes (TX, RX) across 5 NCCL allreduces of 256 MiB "
                  f"per card: {moved}", flush=True)
            require(all(tx > 0 and rx > 0 for tx, rx in moved.values()),
                    f"NVLink counters did not rise across the allreduce: {moved}")
            del tensors

    # the health assessor and the validator's metrics mode
    status.write_ready("plugin", {"allocatable": len(advertised)})
    verdict = HealthAssessor().assess({"chips": during})
    metrics = NodeMetrics(node_name="chip-smoke")
    metrics.scrape()
    print(f"agents: health {verdict}; metrics mode device_count {metrics.device_count}, "
          f"status {metrics.validation_status}", flush=True)
    require(verdict == (consts.HEALTH_OK, ""), f"the health assessor says {verdict}")
    require(metrics.device_count == n_cards, f"metrics mode counts {metrics.device_count}")
    wall = time.perf_counter() - t_phase
    smi_power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"agents: phase wall {wall:.2f}s, gate child {gate_s:.2f}s on {smi_power}", flush=True)
    return {"vector_add": b1, "dma_pipeline_copy": b2}


def validator_phase(n_cards: int, root: str, name: str) -> dict:
    """The node validator (``tpu_operator_torch/validator``) in-process on
    the card, as the validator DaemonSet runs it without a workload pod,
    under a fresh TPU_VALIDATION_ROOT at ``root``: libtpu (the driver
    library, ``chips`` the card count), pjrt (the runtime's count equal to
    the host's), plugin-ready from the count the port's device plugin
    advertises in process (no apiserver here), jax (in-process, B1 launched, vector-add's max_error 0), perf (every probe
    ok and run; one card's ring is the reference's own skip; B2 launched,
    and B3 on more than one card).  Then the gate pod's contract without an
    apiserver: the pod ``_workload_pod`` builds (``nvidia.com/gpu`` in its
    limits, no TORCH_DEVICE, the cache-key fields) run as the kubelet would,
    its command with its env and the hostPath env on temporary directories:
    rc 0 and the drop-box holding the allreduce figures; on more than one
    card the allreduce floor armed from the catalogue and cleared.  Returns
    the launches of B1, B2 and B3 in the in-process components."""
    import asyncio

    import torch

    from tpu_operator_torch import consts, hw, nvml
    from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin, PluginConfig
    from tpu_operator_torch.k8s import nodeinfo
    from tpu_operator_torch.kernels import _build
    from tpu_operator_torch.validator import components, status

    cards = _card_lines()
    nodes = hw.card_device_paths()
    print(f"validator: nvidia-smi -L {len(cards)} card(s) {cards}; /dev card nodes "
          f"{[os.path.basename(p) for p in nodes]}; torch.cuda.device_count() "
          f"{torch.cuda.device_count()}", flush=True)
    require(len(cards) == n_cards, f"nvidia-smi lists {len(cards)} cards, CUDA sees {n_cards}")
    libcuda = hw.libcuda_path()
    print(f"validator: the driver library on this machine: {libcuda!r}", flush=True)
    require(libcuda, "no driver library (libcuda) under the usual host paths")
    os.environ["TPU_VALIDATION_ROOT"] = root
    if len(nodes) != len(cards):
        # this machine's /dev disagrees with the cards it was given: a
        # synthetic /dev of one node per card NVML lists (by its minor
        # number), with the machine's driver library, for this phase only
        dev = os.path.join(root, "hw", "dev")
        os.makedirs(dev)
        for card in nvml.inventory().cards:
            open(os.path.join(dev, f"nvidia{card.minor}"), "w").close()
        os.environ["TPU_HW_ROOT"] = os.path.join(root, "hw")
        os.environ["LIBCUDA_PATH"] = libcuda
        print(f"validator: /dev holds {len(nodes)} card nodes for {len(cards)} cards: "
              f"TPU_HW_ROOT is a synthetic /dev of NVML's minors for this phase", flush=True)
    v = components.Validator(components.ValidatorConfig(
        node_name="", with_workload=False, platform="cuda", sleep_interval=0.1,
        resource_retries=3, workload_retries=3))
    times = {}

    def run(component: str) -> dict:
        t0 = time.perf_counter()
        asyncio.run(v.run(component))
        times[component] = time.perf_counter() - t0
        return status.read_status(component)

    try:
        lib = run("libtpu")
        require(lib["libtpu_path"] and lib["chips"] == n_cards, f"libtpu-ready {lib}")
        pjrt = run("pjrt")
        require(pjrt["device_count"] == pjrt["host_chips"] == n_cards
                and pjrt["device_kind"] == name, f"pjrt-ready {pjrt}")
        plugin = GPUDevicePlugin(PluginConfig(kubelet_dir=os.path.join(root, "kubelet")))
        plugin.refresh_devices()
        allocatable = sum(health == "Healthy" for _, health in plugin.snapshot())
        require(allocatable == n_cards, f"the device plugin advertises {plugin.snapshot()}")
        status.write_ready("plugin", {"allocatable": allocatable})
        before = _build.launches()
        gate = run("jax")
        b1 = launches_since(before)["tpu_vector_add"]
        vector_add = [s for s in status.read_flight_record()
                      if s.get("check") == "vector-add" and s.get("phase") == "result"]
        require(gate["mode"] == "in-process" and gate["devices"] == n_cards, f"jax-ready {gate}")
        require(b1 > 0, "the validator's gate ran without launching the vector_add kernel")
        require(len(vector_add) == 1 and vector_add[0]["metrics"]["max_error"] == 0.0,
                f"vector-add in the gate: {vector_add}")
        before = _build.launches()
        perf = run("perf")
        n = launches_since(before)
        b2, b3 = n["tpu_dma_pipeline_copy"], n["tpu_flash_block_update_bf16"]
        probes = perf["checks"]
        if n_cards > 1:
            b3 += probes["ring-attention"]["launches"]  # rank 0's, in its own process
        print(f"validator: perf-ready {json.dumps(perf)[:4000]}", flush=True)
        require(perf["ok"] and all(r.get("ok") for r in probes.values()), f"perf: {perf}")
        expected = {"matmul", "hbm", "hbm-dma", "ring"} | (
            {"ring-attention"} if n_cards > 1 else {"burn-in"})
        require(set(probes) == expected, f"perf ran {sorted(probes)}")
        for probe, r in probes.items():
            # one card has no ring: the reference's own skip, the only one
            allowed = probe == "ring" and n_cards == 1 and r.get("skipped") == "single card: no ring"
            require("skipped" not in r or allowed, f"perf probe {probe} skipped: {r}")
        require(b2 > 0, "the validator's perf ran without launching the DMA-pipeline kernel")
        require(n_cards == 1 or b3 > 0, "ring-attention in perf did not launch the block update")

        # the gate pod's contract, with no apiserver
        label = name.replace(" ", "-")  # the product label NVIDIA's feature discovery sets
        require(nodeinfo.generation_of_node({"metadata": {"labels": {
            consts.GPU_PRODUCT_LABEL: label}}}) == nodeinfo.generation_of(name),
            f"the product label {label!r} reads as another card")
        min_gbps = (components._allreduce_min_gbps(nodeinfo.generation_of(name), n_cards)
                    if n_cards > 1 else 0.0)
        key_env = {**asyncio.run(v._cache_key_env()), "TPU_CACHE_GENERATION": label}
        pod = v._workload_pod("tpu-jax-workload-validation", checks="vector-add,allreduce",
                              tpu_request=n_cards, owner=None, min_gbps=min_gbps,
                              cache_key_env=key_env)
        ctr = pod["spec"]["containers"][0]
        env = {e["name"]: e["value"] for e in ctr["env"]}
        require(ctr["resources"]["limits"] == {consts.GPU_RESOURCE: str(n_cards)}
                and "TORCH_DEVICE" not in env and ctr["command"] == components.WORKLOAD_COMMAND
                and env["TPU_LIBTPU_VERSION"] == torch.version.cuda, f"the gate pod {pod}")
        # the kubelet's hostPaths: the cache beside this root, the drop-box
        # this root's own (the validator reads what the pod writes)
        cache = os.path.join(root, "compile_cache")
        env = {k: val.replace(consts.COMPILE_CACHE_DIR, cache) for k, val in env.items()}
        proc_env = _subprocess_env(root, **env)
        for key in ("TORCH_DEVICE", "DIST_CPU_RANKS", "TPU_HW_ROOT", "LIBCUDA_PATH"):
            proc_env.pop(key, None)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *ctr["command"][1:]], env=proc_env,
                              capture_output=True, text=True, timeout=600)
        times["gate pod"] = time.perf_counter() - t0
        dropbox = status.read_workload_results() or {"checks": {}}
        print(f"validator: gate pod rc={proc.returncode} env {env}; stdout "
              f"{proc.stdout.strip()}", flush=True)
        require(proc.returncode == 0, f"the gate pod failed: {proc.stderr[-3000:]}")
        measured = components._measured_from_results(dropbox)
        allreduce = dropbox["checks"].get("allreduce", {})
        require(measured.get("allreduce_min_gbps") == min_gbps
                and ("algbw_gbps" in measured or allreduce["overhead_dominated"]),
                f"the drop-box's allreduce {allreduce} reads as {measured}")
        if n_cards > 1:
            require(allreduce["gated"] and allreduce["busbw_gbps"] >= min_gbps,
                    f"allreduce {allreduce['busbw_gbps']} GB/s against the floor {min_gbps}")
        print(f"validator: the gate pod's allreduce busbw {allreduce['busbw_gbps']!r} GB/s "
              f"over {allreduce['devices']} card(s), floor {min_gbps!r} (gated "
              f"{allreduce['gated']}); measured {measured}", flush=True)
    finally:
        for key in ("TPU_HW_ROOT", "LIBCUDA_PATH"):
            os.environ.pop(key, None)
    print("validator: wall seconds " + ", ".join(f"{k} {t:.2f}" for k, t in times.items())
          + f"; launches B1 {b1}, B2 {b2}, B3 {b3}", flush=True)
    return {"vector_add": b1, "dma_pipeline_copy": b2, "flash_block_update": b3}


def partition_phase(n_cards: int, root: str) -> dict:
    """The partition acceptance on the cards (``simulate_cpu=False``): two
    units of one card each, masked by CUDA_VISIBLE_DEVICES, each burn-in
    exactly equal to its solo run, the trajectories independent and each
    unit seeing its own cards; on one card, one unit, solo against the
    barrier run.  Units of two cards, each two NCCL ranks, run in the
    slices phase under the device plugin's allocations."""
    from tpu_operator_torch.workloads import partition_acceptance as pa

    units = {"a": [0], "b": [1]} if n_cards > 1 else {"a": [0]}
    os.environ["TPU_VALIDATION_ROOT"] = root
    t0 = time.perf_counter()
    r = pa.concurrent_acceptance(units, "1x1", steps=3, timeout=300, simulate_cpu=False)
    wall = time.perf_counter() - t0
    print(f"partition: {json.dumps(r)[:4000]} in {wall:.2f}s wall", flush=True)
    require(r["ok"] and r["independent_trajectories"], f"partition acceptance failed: {r}")
    for unit, chips in units.items():
        u = r["units"][unit]
        require(u["matches_solo"] and u["devices"] == len(chips),
                f"unit {unit} on {chips}: {u}")
    if n_cards == 1:
        print("partition: one card: disjoint partitions cannot be shown, only a unit's "
              "solo run against its barrier run", flush=True)
    return r


# the child under one partition unit's allocation: the cards it sees, then
# run_validation's gate and B1's launches in it
_UNIT_CHILD = """
import json, sys, torch
from tpu_operator_torch.kernels import _build
from tpu_operator_torch.workloads import run_validation
print(json.dumps({"uuids": [str(torch.cuda.get_device_properties(i).uuid)
                            for i in range(torch.cuda.device_count())]}))
rc = run_validation.main()
print(json.dumps({"vector_add_launches": _build.launches()["tpu_vector_add"]}))
sys.exit(rc)
"""
SLICE_PROFILES = {"version": "v1", "slice-configs": {
    "all-disabled": [{"accelerators": ["*"], "partitions": []}],
    # the reference's default, which tiles only a 1x1 mesh
    "all-isolated": [{"accelerators": ["*"], "partitions": ["1x1"]}],
    "halves": [{"accelerators": ["*"], "topology": "2x2", "partitions": ["1x2", "1x2"]}],
    "two-host": [{"accelerators": ["*"], "topology": "2x4", "partitions": ["2x2", "2x2"]}],
}}


def _bus_and_mig() -> list:
    """``nvidia-smi -q`` lines naming each card's bus id and MIG mode."""
    out = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return [line.strip() for line in out.splitlines()
            if "bus id" in line.lower() or "mig" in line.lower()]


def _synthetic_vfio_host(root: str, cards: list) -> tuple:
    """A sysfs and /dev under ``root`` holding the cards (NVML's order) as
    PCI functions bound to the NVIDIA driver, IOMMU group i each, and an
    NVSwitch bridge as a decoy.  The addresses are NVML's where it reports
    them; vendor and class are read from the real sysfs where it has the
    function, nothing else is done there.  Returns (card addresses, decoy
    address, what was synthesized)."""
    from tpu_operator_torch import nvml

    addresses = nvml.pci_addresses([c.uuid for c in cards])
    made = set()
    devices = os.path.join(root, "sys", "bus", "pci", "devices")
    out = []
    for i, c in enumerate(cards):
        addr = addresses.get(c.uuid)
        if addr is None:
            addr = f"0000:{0x18 + i:02x}:00.0"
            made.add("address")
        ids = []
        for name, fallback in (("vendor", "0x10de"), ("class", "0x030200")):
            try:
                with open(os.path.join("/sys/bus/pci/devices", addr, name)) as f:
                    ids.append(f.read().strip())
            except OSError:
                ids.append(fallback)
                made.add(name)
        out.append((addr, *ids, str(i)))
    decoy = "0000:05:00.0"  # an HGX host's NVSwitch: vendor 0x10de, a bridge
    for addr, vendor, cls, group in out + [(decoy, "0x10de", "0x068000", "99")]:
        d = os.path.join(devices, addr)
        os.makedirs(d)
        for name, value in (("vendor", vendor), ("class", cls)):
            with open(os.path.join(d, name), "w") as f:
                f.write(value + "\n")
        os.symlink("../../../bus/pci/drivers/nvidia", os.path.join(d, "driver"))
        os.symlink(f"../../../kernel/iommu_groups/{group}", os.path.join(d, "iommu_group"))
    open(os.path.join(root, "sys", "bus", "pci", "drivers_probe"), "w").close()
    os.makedirs(os.path.join(root, "dev", "vfio"))
    open(os.path.join(root, "dev", "vfio", "vfio"), "w").close()
    return [a for a, *_ in out], decoy, made


def slices_phase(n_cards: int, root: str, name: str) -> dict:
    """Partitions of whole cards on the cards, the slice manager and the
    plugin's mixed strategy against the stand-in apiserver, with the card
    machine's NVML: ``all-disabled`` (the flat plugin); a profile that
    tiles the node's mesh (two 1x2 on four cards, ``all-isolated`` on one)
    pending then success, the card pod evicted and the DaemonSet's kept,
    idempotent; the units Healthy, two refused; a child under each unit's
    allocation seeing exactly its UUIDs and passing its gate (B1); on four
    cards both units' burn-in at once under the allocations, each equal to
    its solo run, and the reference's ``all-isolated`` failed, nothing
    changed; a two-host layout's units on this host (worker id 1), the
    flat plugin without an id; then on synthetic trees under ``root`` only
    the vfio manager (the cards bound, the NVSwitch decoy not), the
    ``vfio-pci`` component, ``--mode vfio``, runtime prep, the runtime
    container's marker (the ``libtpu`` component passes on it), the VM
    runtime manager and the config manager.  Returns B1's launches."""
    import asyncio

    from tpu_operator_torch import consts, hw, nvml
    from tpu_operator_torch.agents import (config_manager, feature_discovery, libtpu_installer,
                                           runtime_prep, slice_manager, vfio_manager,
                                           vm_runtime_manager)
    from tpu_operator_torch.deviceplugin import sliceconfig
    from tpu_operator_torch.deviceplugin.plugin import (AllocationRefused, GPUDevicePlugin,
                                                       PluginConfig)
    from tpu_operator_torch.validator import components, status
    from tpu_operator_torch.workloads import partition_acceptance as pa

    t_phase = time.perf_counter()
    before = _bus_and_mig()
    run_dir = os.path.join(root, "run")
    os.makedirs(os.path.join(run_dir, "validations"))
    os.environ["TPU_VALIDATION_ROOT"] = run_dir
    os.environ.pop("TPU_WORKER_ID", None)
    inv = nvml.inventory()
    cards = sorted(inv.cards, key=lambda c: c.index)
    libcuda = hw.libcuda_path()  # the installer's payload, from the real host
    topology = {1: "1x1", 4: "2x2"}.get(n_cards, f"1x{n_cards}")
    profile = "halves" if n_cards == 4 else "all-isolated" if n_cards == 1 else ""
    if not profile:
        print(f"slices: {n_cards} cards: the phase runs on 1 or 4", flush=True)
        return {"vector_add": 0}
    config_file = os.path.join(root, "config.yaml")
    with open(config_file, "w") as f:
        json.dump(SLICE_PROFILES, f)  # a JSON document is YAML
    api = _StandInApi(None)
    api.put({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "h100-0", "labels": {
        consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
        consts.GKE_TPU_TOPOLOGY_LABEL: topology, consts.TPU_COUNT_LABEL: str(n_cards),
        consts.SLICE_CONFIG_LABEL: "all-disabled"}}})
    states = []
    patch = api.patch

    async def recording_patch(group, kind, obj_name, change, namespace=None):
        states.append(change["metadata"]["labels"][consts.SLICE_CONFIG_STATE_LABEL])
        return await patch(group, kind, obj_name, change, namespace)

    api.patch = recording_patch
    mgr = slice_manager.SliceManager(api, "h100-0", config_file)

    def relabel(**labels):
        api.objects[("Node", "", "h100-0")]["metadata"]["labels"].update(labels)

    def plugin_set() -> list:
        base = PluginConfig(kubelet_dir=os.path.join(root, "kubelet"))
        return [(c.resource_name, c.device_sets)
                for c in sliceconfig.build_plugin_configs("mixed", base)]

    # 1. the whole slice
    require(asyncio.run(mgr.sync_once()) == "success" and states == ["pending", "success"],
            f"all-disabled: states {states}")
    layout = slice_manager.read_applied()
    require(layout["partitions"] == [] and plugin_set() == [(consts.GPU_RESOURCE, None)],
            f"all-disabled: layout {layout}, plugins {plugin_set()}")
    flat = GPUDevicePlugin(PluginConfig(kubelet_dir=os.path.join(root, "kubelet")))
    flat.refresh_devices()
    require(len(flat.snapshot()) == n_cards and {h for _, h in flat.snapshot()} == {"Healthy"},
            f"the flat plugin under all-disabled: {flat.snapshot()}")

    # 2. the profile, with a card pod and an operand's pod on the node
    for pod_name, owner in (("train", None), ("operand", "DaemonSet")):
        meta = {"name": pod_name, "namespace": "default", "uid": f"uid-{pod_name}"}
        if owner:
            meta["ownerReferences"] = [{"kind": owner, "name": "operand"}]
        api.put({"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": {
            "nodeName": "h100-0", "containers": [{"name": "c", "resources": {
                "limits": {consts.GPU_RESOURCE: "1"}}}]}})
    relabel(**{consts.SLICE_CONFIG_LABEL: profile})
    states.clear()
    state = asyncio.run(mgr.sync_once())
    pods = sorted(k[2] for k in api.objects if k[0] == "Pod")
    again = asyncio.run(mgr.sync_once())
    layout = slice_manager.read_applied()
    print(f"slices: {profile} on {topology}: states {states}, pods left {pods}, second pass "
          f"{again!r}, layout {layout}", flush=True)
    require(state == "success" and states == ["pending", "success"] and again is None,
            f"{profile}: {state}, states {states}, second pass {again}")
    require(pods == ["operand"], f"{profile}: the pods left are {pods}")

    # 3. the units
    (config,) = sliceconfig.build_plugin_configs("mixed", PluginConfig(
        kubelet_dir=os.path.join(root, "kubelet")))
    shape = "1x2" if n_cards == 4 else "1x1"
    want_sets = ({"gpu-1x2-0": [0, 1], "gpu-1x2-1": [2, 3]} if n_cards == 4
                 else {"gpu-1x1-0": [0]})
    require(config.resource_name == f"{consts.GPU_RESOURCE}-{shape}"
            and config.device_sets == want_sets, f"the mixed plugin set {config}")
    plugin = GPUDevicePlugin(config)
    plugin.refresh_devices()
    units = {did: [m.uuid for m in members] for did, members in plugin.devices.items()}
    print(f"slices: {config.resource_name} advertises {plugin.snapshot()}; units {units}",
          flush=True)
    require({h for _, h in plugin.snapshot()} == {"Healthy"}
            and units == {did: [cards[i].uuid for i in ix] for did, ix in want_sets.items()},
            f"the units {units} against NVML's order {[c.uuid for c in cards]}")
    try:
        plugin.allocate(sorted(units) if len(units) > 1 else sorted(units) * 2)
        require(False, "two units in one container were allocated")
    except AllocationRefused as e:
        print(f"slices: two units refused: {e}", flush=True)
    allocs = {did: plugin.allocate([did]) for did in sorted(units)}

    # 4. a child under each unit's allocation, all at once
    def child(did: str) -> tuple:
        checks = "vector-add,allreduce" if len(units[did]) > 1 else "vector-add"
        return _allocation_child(
            _UNIT_CHILD, allocs[did]["envs"], os.path.join(root, "unit-" + did),
            WORKLOAD_CHECKS=checks, EXPECTED_DEVICES=str(len(units[did])),
            DEVICE_COUNT_GATE_BACKENDS="cuda")

    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        runs = dict(zip(sorted(units), pool.map(child, sorted(units))))
    b1, child_s = 0, {}
    for did, (proc, lines, wall) in runs.items():
        child_s[did] = wall
        seen = next((line["uuids"] for line in lines if "uuids" in line), [])
        by_check = {line.get("check"): line for line in lines}
        launches = next((line["vector_add_launches"] for line in lines
                         if "vector_add_launches" in line), 0)
        print(f"slices: unit {did} child rc={proc.returncode} in {wall:.2f}s wall, sees "
              f"{seen}, {[by_check.get(c) for c in ('vector-add', 'allreduce')]}, B1 "
              f"{launches}", flush=True)
        require(proc.returncode == 0, f"unit {did}'s child failed: {proc.stderr[-3000:]}")
        require(sorted(map(_uuid, seen)) == sorted(units[did]),
                f"unit {did}'s child sees {seen}, the unit is {units[did]}")
        require(by_check.get("vector-add", {}).get("max_error") == 0.0 and launches > 0,
                f"unit {did}'s vector-add {by_check.get('vector-add')}, B1 {launches}")
        if len(units[did]) > 1:
            ar = by_check.get("allreduce", {})
            require(ar.get("ok") and ar.get("max_error") == 0.0, f"unit {did}'s allreduce {ar}")
        b1 += launches

    # 5. both units' burn-in at once under the plugin's allocations
    result = {"vector_add": b1, "child_s": child_s}
    if n_cards == 4:
        t0 = time.perf_counter()
        r = pa.concurrent_acceptance(units, shape, steps=3, timeout=300, simulate_cpu=False,
                                     allocations={d: a["envs"] for d, a in allocs.items()})
        result["burn_in_s"] = time.perf_counter() - t0
        print(f"slices: burn-in of both units at once under their allocations in "
              f"{result['burn_in_s']:.2f}s: {json.dumps(r)[:3000]}", flush=True)
        require(r["ok"] and r["independent_trajectories"]
                and all(u["matches_solo"] and u["devices"] == 2 for u in r["units"].values()),
                f"the units' burn-in: {r}")

        # 6. the reference's all-isolated on 2x2 fails and changes nothing
        with open(status.slice_config_path(), "rb") as f:
            applied = f.read()
        sets = plugin_set()
        relabel(**{consts.SLICE_CONFIG_LABEL: "all-isolated"})
        states.clear()
        state = asyncio.run(mgr.sync_once())
        with open(status.slice_config_path(), "rb") as f:
            unchanged = f.read() == applied
        print(f"slices: all-isolated on 2x2: {state}, states {states}, layout unchanged "
              f"{unchanged}", flush=True)
        require(state == "failed" and states == ["failed"] and unchanged
                and plugin_set() == sets, f"all-isolated on 2x2: {state}, {states}")

    # 7. a layout of two hosts: this host's units under worker id 1
    relabel(**{consts.SLICE_CONFIG_LABEL: "two-host", consts.GKE_TPU_TOPOLOGY_LABEL: "2x4"})
    require(asyncio.run(mgr.sync_once()) == "success", "the two-host layout failed")
    no_id = plugin_set()
    os.environ["TPU_WORKER_ID"] = "1"
    try:
        worker_1 = plugin_set()
    finally:
        os.environ.pop("TPU_WORKER_ID")
    mine = sliceconfig.host_units(slice_manager.read_applied(), 1, n_cards)
    print(f"slices: two-host 2x4 layout: no worker id {no_id}; worker 1 {worker_1}",
          flush=True)
    require(no_id == [(consts.GPU_RESOURCE, None)], f"no worker id: {no_id}")
    require(worker_1 == [(f"{consts.GPU_RESOURCE}-2x2", {
        f"gpu-2x2-{k}": unit for k, unit in enumerate(mine["2x2"])})]
        and all(0 <= i < n_cards for u in mine["2x2"] for i in u), f"worker 1: {worker_1}")

    # 8. passthrough, on a synthetic tree only
    vroot = os.path.join(root, "vfio-host")
    addrs, decoy, made = _synthetic_vfio_host(vroot, cards)
    if made:
        print(f"slices: this machine gives no card's {', '.join(sorted(made))} (NVML's PCI "
              f"query or /sys/bus/pci/devices): synthesized on the tree", flush=True)
    os.environ["TPU_HW_ROOT"] = vroot
    try:
        require(hw.hw_root() == vroot, "the vfio manager would run on the real host")
        found = vfio_manager.gpu_pci_addresses()
        bound = [a for a in found if vfio_manager.bind_to_vfio(a)]
        pci = os.path.join(vroot, "sys", "bus", "pci", "devices")
        overrides = {a: open(os.path.join(pci, a, "driver_override")).read()
                     for a in sorted(os.listdir(pci))
                     if os.path.exists(os.path.join(pci, a, "driver_override"))}
        require(found == bound == addrs and overrides == dict.fromkeys(addrs, "vfio-pci")
                and os.path.basename(os.readlink(os.path.join(pci, decoy, "driver"))) == "nvidia",
                f"the vfio manager bound {bound} of {found}, overrides {overrides}")
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_operator_torch.validator.cli", "--component",
             "vfio-pci"], env=_subprocess_env(os.path.join(root, "vfio-run")),
            capture_output=True, text=True, timeout=120)
        require(proc.returncode == 0, f"validator.cli --component vfio-pci: {proc.stderr[-2000:]}")
        vplugin = GPUDevicePlugin(PluginConfig(mode="vfio"))
        vplugin.refresh_devices()
        valloc = vplugin.allocate(sorted(vplugin.devices))
        print(f"slices: vfio: bound {bound}, decoy {decoy} left alone; --mode vfio advertises "
              f"{vplugin.snapshot()}; allocation {valloc}", flush=True)
        require(len(vplugin.snapshot()) == n_cards
                and {h for _, h in vplugin.snapshot()} == {"Healthy"}
                and [host for _, host, _ in valloc["devices"]]
                == [hw.vfio_group_path(str(i)) for i in range(n_cards)]
                + [hw.vfio_group_path("vfio")]
                and valloc["envs"] == {"PCI_RESOURCE_NVIDIA_COM_GPU": ",".join(addrs)},
                f"vfio mode: {vplugin.snapshot()}, {valloc}")

        # 9. runtime prep, the marker, the VM runtime and the config manager
        proot = os.path.join(root, "prep-host")
        os.makedirs(os.path.join(proot, "dev", "vfio"))
        for node in [f"nvidia{c.minor}" for c in cards] + ["nvidiactl", "vfio/0"]:
            open(os.path.join(proot, "dev", node), "w").close()
        os.environ["TPU_HW_ROOT"] = proot
        require(hw.hw_root() == proot, "runtime prep would run on the real host")
        os.environ["HUGEPAGES_GB"] = "1"
        try:
            prep = runtime_prep.prep()
        finally:
            os.environ.pop("HUGEPAGES_GB")
        want = [os.path.join(proot, "dev", n) for n in
                [f"nvidia{c.minor}" for c in cards] + ["nvidiactl", "vfio/0"]]
        require(prep["devices"] == want
                and all(os.stat(p).st_mode & 0o777 == 0o666 for p in want),
                f"runtime prep: {prep}")
        os.environ["LIBTPU_SRC"] = libcuda
        try:
            inst = libtpu_installer.install()
        finally:
            os.environ.pop("LIBTPU_SRC")
        require(inst["installed"] and inst["chips"] == n_cards
                and inst["version"] == feature_discovery.runtime_version(inv),
                f"the installer: {inst}")

        async def marker_run() -> dict:
            task = asyncio.create_task(libtpu_installer.run())
            await asyncio.sleep(0.2)
            written = status.marker_exists(consts.LIBTPU_CTR_MARKER)
            v = components.Validator(components.ValidatorConfig(
                node_name="", sleep_interval=0.1, resource_retries=3, platform="cuda"))
            await v.run("libtpu")
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            return {"written": written, "libtpu": status.read_status("libtpu"),
                    "removed": not status.marker_exists(consts.LIBTPU_CTR_MARKER)}

        marker = asyncio.run(marker_run())
        staged = vm_runtime_manager.stage([("kata-tpu", "kata-tpu")], "/etc/containerd/conf.d")
        with open(vm_runtime_manager.config_path("/etc/containerd/conf.d", "kata-tpu")) as f:
            dropin = f.read()
        api.put({"apiVersion": "v1", "kind": "ConfigMap", "metadata": {
            "name": "plugin-config", "namespace": "tpu-operator"},
            "data": {"default": "mode: default\n", "perf": "mode: perf\n"}})
        relabel(**{consts.DEVICE_PLUGIN_CONFIG_LABEL: "perf"})
        target = os.path.join(proot, "config", "config.yaml")
        picked = asyncio.run(config_manager.sync_once(api, "h100-0", "plugin-config",
                                                      "tpu-operator", "default", target))
        with open(target) as f:
            picked_text = f.read()
    finally:
        os.environ.pop("TPU_HW_ROOT", None)
    print(f"slices: runtime prep {prep}; installer {inst}; marker {marker}; VM runtime drop-ins "
          f"changed {staged}; config manager picked {picked!r}", flush=True)
    require(marker["written"] and marker["removed"] and marker["libtpu"]["chips"] == n_cards
            and not marker["libtpu"]["host_managed"], f"the marker: {marker}")
    require(staged == 1 and dropin == vm_runtime_manager.handler_config("kata-tpu"),
            f"the VM runtime drop-in: {dropin!r}")
    require(picked == "perf" and picked_text == "mode: perf\n", f"config manager: {picked}")

    after = _bus_and_mig()
    print(f"slices: nvidia-smi -q bus ids and MIG before {before}, after {after}", flush=True)
    require(before == after, "a card's bus id or MIG mode changed during the phase")
    result["wall_s"] = time.perf_counter() - t_phase
    smi_power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print("slices: phase wall {:.2f}s, unit children {}{} on {}".format(
        result["wall_s"], ", ".join(f"{d} {t:.2f}s" for d, t in child_s.items()),
        f", burn-in {result['burn_in_s']:.2f}s" if "burn_in_s" in result else "", smi_power),
        flush=True)
    return result


class _StandInApi:
    """A dict-backed stand-in for the port's ``ApiClient`` (no apiserver on
    the card's machine): get, list_items (``k=v`` label selectors, the
    ``spec.nodeName`` field selector), create, a merge patch and delete on
    Pods, Services, Nodes and ConfigMaps, with the port's ``ApiError`` for
    not-found and already-exists.  A created Pod goes to ``kubelet``; a
    deleted one's process is killed (``kubelet`` None: pods are data)."""

    def __init__(self, kubelet):
        self.objects: dict = {}  # (kind, namespace, name) -> object
        self.kubelet = kubelet
        self._uids = 0

    @staticmethod
    def _key(kind: str, name: str, namespace) -> tuple:
        return kind, namespace or "", name

    def _missing(self, kind: str, name: str):
        from tpu_operator_torch.k8s.client import ApiError

        return ApiError(404, "NotFound", {"message": f"{kind} {name} not found"})

    def put(self, obj: dict) -> None:
        meta = obj["metadata"]
        self.objects[self._key(obj["kind"], meta["name"], meta.get("namespace"))] = obj

    async def get(self, group: str, kind: str, name: str, namespace=None) -> dict:
        import copy

        try:
            return copy.deepcopy(self.objects[self._key(kind, name, namespace)])
        except KeyError:
            raise self._missing(kind, name) from None

    async def list_items(self, group: str, kind: str, namespace=None,
                         label_selector=None, field_selector=None) -> list:
        import copy

        want = dict(kv.split("=", 1) for kv in label_selector.split(",")) if label_selector \
            else {}
        node = field_selector.split("=", 1)[1] if field_selector else None  # spec.nodeName=
        out = []
        for (k, ns, _), obj in sorted(self.objects.items()):
            labels = obj["metadata"].get("labels") or {}
            if (k == kind and (namespace is None or ns == namespace)
                    and all(labels.get(a) == b for a, b in want.items())
                    and (node is None or (obj.get("spec") or {}).get("nodeName") == node)):
                out.append(copy.deepcopy(obj))
        return out

    async def create(self, obj: dict) -> dict:
        import copy

        from tpu_operator_torch.k8s.client import ApiError

        meta = obj["metadata"]
        key = self._key(obj["kind"], meta["name"], meta.get("namespace"))
        if key in self.objects:
            raise ApiError(409, "AlreadyExists", {"message": f"{meta['name']} exists"})
        obj = copy.deepcopy(obj)
        self._uids += 1
        obj["metadata"]["uid"] = f"uid-{self._uids}"
        self.objects[key] = obj
        if obj["kind"] == "Pod":
            obj["status"] = {"phase": "Pending"}
            self.kubelet.start(self, key, copy.deepcopy(obj))
        return copy.deepcopy(obj)

    async def patch(self, group: str, kind: str, name: str, patch: dict, namespace=None):
        import copy

        def merge(into: dict, change: dict) -> None:
            for k, v in change.items():
                if v is None:
                    into.pop(k, None)
                elif isinstance(v, dict) and isinstance(into.get(k), dict):
                    merge(into[k], v)
                else:
                    into[k] = copy.deepcopy(v)

        obj = self.objects.get(self._key(kind, name, namespace))
        if obj is None:
            raise self._missing(kind, name)
        merge(obj, patch)
        return copy.deepcopy(obj)

    async def delete(self, group: str, kind: str, name: str, namespace=None,
                     ignore_not_found: bool = True):
        obj = self.objects.pop(self._key(kind, name, namespace), None)
        if obj is None:
            if ignore_not_found:
                return None
            raise self._missing(kind, name)
        if kind == "Pod" and self.kubelet is not None:
            self.kubelet.stop(obj["metadata"]["uid"])
        return obj


class _StandInKubelet:
    """Runs each created pod's own command with its own env, as a kubelet
    would: the coordinator's DNS name rewritten to a localhost port per pod
    ``subdomain`` (one per rendezvous), the node's cards visible through
    CUDA_VISIBLE_DEVICES, the hostPaths under ``root``; the pod's phase
    from the exit code.  ``runs`` keeps (pod, node, rc, elapsed_s, result)."""

    def __init__(self, root: str, cards_of: dict, timeout: float = 400.0):
        self.root, self.cards_of, self.timeout = root, cards_of, timeout
        self.ports: dict = {}
        self.procs: dict = {}
        self.tasks: set = set()
        self.runs: list = []

    def _port(self, subdomain: str) -> int:
        from tpu_operator_torch.workloads.distributed import free_ports

        if subdomain not in self.ports:
            port = free_ports(1)[0]
            while port in self.ports.values():
                port = free_ports(1)[0]
            self.ports[subdomain] = port
        return self.ports[subdomain]

    def start(self, api: _StandInApi, key: tuple, pod: dict) -> None:
        import asyncio

        task = asyncio.get_running_loop().create_task(self._run(api, key, pod))
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    def stop(self, uid: str) -> None:
        proc = self.procs.get(uid)
        if proc is not None and proc.poll() is None:
            proc.kill()

    async def _run(self, api: _StandInApi, key: tuple, pod: dict) -> None:
        import asyncio

        uid = pod["metadata"]["uid"]
        api.objects[key]["status"] = {"phase": "Running"}
        # the port is taken here, on the loop's thread; the pod runs on a
        # thread of its own, as a kubelet's container runs apart from it
        port = self._port(pod["spec"]["subdomain"])
        run = await asyncio.get_running_loop().run_in_executor(None, self._exec, pod, port)
        self.runs.append(run)
        r = run["result"]
        print(f"slice: pod {run['pod']} on {run['node']} rc={run['rc']} elapsed_s "
              f"{run['elapsed_s']!r} time_s {r.get('time_s')!r} allreduce "
              f"{json.dumps(r.get('allreduce'))}", flush=True)
        if run["rc"] != 0:
            print(f"slice: pod {run['pod']} stdout {run['stdout_tail']} stderr "
                  f"{run['stderr_tail']}", flush=True)
        live = api.objects.get(key)
        if live is not None and live["metadata"]["uid"] == uid:
            live["status"] = {"phase": "Succeeded" if run["rc"] == 0 else "Failed"}

    def _exec(self, pod: dict, port: int) -> dict:
        from tpu_operator_torch import consts

        name, node = pod["metadata"]["name"], pod["spec"]["nodeName"]
        ctr = pod["spec"]["containers"][0]
        cache = os.path.join(self.root, "compile_cache")
        env = {e["name"]: e["value"].replace(consts.COMPILE_CACHE_DIR, cache)
               for e in ctr["env"]}
        env["COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        proc_env = _subprocess_env(self.root, **env, CUDA_VISIBLE_DEVICES=",".join(
            str(c) for c in self.cards_of[node]))
        for var in ("TORCH_DEVICE", "DIST_CPU_RANKS", "TPU_HW_ROOT", "LIBCUDA_PATH"):
            proc_env.pop(var, None)
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, *ctr["command"][1:]], env=proc_env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.procs[pod["metadata"]["uid"]] = proc
        try:
            out, err = proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = [line for line in out.splitlines() if line.startswith("{")]
        return {"pod": name, "node": node, "rc": proc.returncode,
                "elapsed_s": time.perf_counter() - t0,
                "result": json.loads(lines[-1]) if lines else {},
                "stdout_tail": out[-1500:], "stderr_tail": err[-1500:]}

    async def close(self) -> None:
        import asyncio

        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        if self.tasks:
            await asyncio.gather(*self.tasks, return_exceptions=True)


def _slice_node(name: str, pool: str, wid: int, cards: int, product: str, group: str = "",
                slices: int = 0) -> dict:
    """A host of a 2-host slice in the reference's identity (a v5e podslice
    2x4: 4 chips a host, 2 hosts), the card's product label and ``cards``
    of nvidia.com/gpu."""
    from tpu_operator_torch import consts

    labels = {consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
              consts.GKE_TPU_TOPOLOGY_LABEL: "2x4", consts.GKE_NODEPOOL_LABEL: pool,
              consts.GKE_TPU_WORKER_ID_LABEL: str(wid), consts.GPU_PRODUCT_LABEL: product}
    if group:
        labels.update({consts.MULTISLICE_GROUP_LABEL: group,
                       consts.MULTISLICE_SLICES_LABEL: str(slices)})
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels},
            "status": {"allocatable": {consts.GPU_RESOURCE: str(cards)}}}


def _run_slice(root: str, hosts: dict, name: str, multislice: bool) -> dict:
    """Validators of every host in ``hosts`` ({node: (pool, worker id,
    cards)}) run ``jax`` and then ``perf`` at once in one event loop against
    the stand-in apiserver and kubelet.  Returns the jax-ready payloads,
    the pods' runs, the walls and the stand-in's objects."""
    import asyncio

    from tpu_operator_torch.validator import components, status

    product = name.replace(" ", "-")
    kubelet = _StandInKubelet(root, {n: cards for n, (_, _, cards) in hosts.items()})
    api = _StandInApi(kubelet)
    for node, (pool, wid, cards) in hosts.items():
        api.put(_slice_node(node, pool, wid, len(cards), product,
                            group="h100-multislice" if multislice else "", slices=2))
    written = {"jax": [], "perf": []}
    write = status.write_ready

    def record(component, payload=None):
        if component in written:
            written[component].append(dict(payload or {}))
        return write(component, payload)

    validators = [components.Validator(components.ValidatorConfig(
        node_name=node, namespace="tpu-operator", with_workload=True, platform="cuda",
        sleep_interval=0.2, workload_retries=2000, resource_retries=5), client=api)
        for node in hosts]
    walls = {}

    async def timed(v, component):
        t0 = time.perf_counter()
        await v.run(component)
        walls[(v.config.node_name, component)] = time.perf_counter() - t0

    async def drive():
        try:
            await asyncio.wait_for(asyncio.gather(*(timed(v, "jax") for v in validators)), 900)
            await asyncio.gather(*(timed(v, "perf") for v in validators))
        finally:
            await kubelet.close()

    os.environ["TPU_VALIDATION_ROOT"] = root
    # written by hand: the stand-in apiserver's kubelet runs no device plugin
    status.write_ready("plugin")
    status.write_ready = record
    try:
        asyncio.run(drive())
    finally:
        status.write_ready = write
    for (node, component), wall in sorted(walls.items()):
        print(f"slice: validator {node} {component} wall {wall:.2f}s", flush=True)
    return {"jax": written["jax"], "perf": written["perf"], "runs": kubelet.runs,
            "walls": walls, "objects": api.objects}


def _check_slice_run(out: dict, hosts: dict, floors: dict) -> None:
    """Every pod succeeded with its NCCL allreduce gated and at or above
    its rendezvous' floor ({pod name prefix: floor}); the pods are collected
    and each Service holds its tombstone."""
    from tpu_operator_torch.validator import components

    require(out["runs"] and all(run["rc"] == 0 for run in out["runs"]),
            f"a rendezvous pod failed: {[(r['pod'], r['rc']) for r in out['runs']]}")
    for run in out["runs"]:
        r = run["result"]
        floor = next(f for prefix, f in floors.items() if run["pod"].startswith(prefix))
        allreduce = r.get("allreduce") or {}
        require(r.get("ok") and r["psum"]["ok"] and r["backend"] == "cuda",
                f"pod {run['pod']}: {r}")
        require(allreduce.get("gated") and allreduce["min_gbps"] == floor
                and allreduce["busbw_gbps"] >= floor,
                f"pod {run['pod']}: allreduce {allreduce} against the floor {floor}")
    pods = [key for key in out["objects"] if key[0] == "Pod"]
    require(not pods, f"rendezvous pods left after the proof: {pods}")
    services = {key[2]: obj for key, obj in out["objects"].items() if key[0] == "Service"}
    for svc, obj in services.items():
        require(obj["spec"]["clusterIP"] == "None"
                and obj["metadata"]["annotations"].get(components.VALIDATED_EPOCH_ANNOTATION),
                f"Service {svc} without its tombstone: {obj}")
    pools = {pool for pool, _, _ in hosts.values()}
    for payload in out["perf"]:
        require(payload["ok"] is True and payload["slice"] in pools and "skipped" in payload,
                f"perf on a slice member: {payload}")
    require(len(out["perf"]) == len(hosts), f"perf-ready written {len(out['perf'])} times")


def slice_phase(n_cards: int, root: str, name: str) -> dict:
    """The validator's multi-host branch on the cards: the validators of a
    two-host slice (worker 0 and 1, each host half the cards) run at once
    against the stand-in apiserver and kubelet, then ``perf`` on each; on 4
    or more cards also a multislice of two slices of two one-card hosts.
    Requires jax-ready ``multi-host`` with ``workers`` 2 and each host's
    worker id, every pod's NCCL allreduce gated at the floor derived from the
    NIC rate and cleared, the pods collected, each Service's tombstone the
    payload's epoch, and perf's slice-member skip; the multislice adds the
    cross-slice payload (``workers`` 4) and its ``multislice`` drop-box.
    One card cannot place two hosts (NCCL refuses two ranks on one card)."""
    from tpu_operator_torch.k8s import nodeinfo
    from tpu_operator_torch.validator import components, status

    if n_cards < 2:
        print("slice: one card: a two-host slice cannot be placed (NCCL refuses two "
              "ranks on one card); the phase runs on 2 or more cards", flush=True)
        return {}
    generation = nodeinfo.generation_of(name)
    per = n_cards // 2
    hosts = {f"h100-{w}": ("h100-slice", w, list(range(w * per, (w + 1) * per)))
             for w in range(2)}
    floor = components._slice_min_gbps(generation, 2 * per)
    os.makedirs(os.path.join(root, "slice"))
    t0 = time.perf_counter()
    out = _run_slice(os.path.join(root, "slice"), hosts, name, multislice=False)
    wall = time.perf_counter() - t0
    require(sorted(p["worker_id"] for p in out["jax"]) == [0, 1],
            f"jax-ready payloads {out['jax']}")
    for payload in out["jax"]:
        require(payload["mode"] == "multi-host" and payload["workers"] == 2
                and payload["group"] == "h100-slice", f"jax-ready {payload}")
    svc = out["objects"][("Service", "tpu-operator", "tpu-jax-validation-h100-slice")]
    require(svc["metadata"]["annotations"][components.VALIDATED_EPOCH_ANNOTATION]
            == out["jax"][0]["epoch"], f"tombstone {svc['metadata']}")
    _check_slice_run(out, hosts, {"tpu-jax-validation": floor})
    print(f"slice: 2 hosts x {per} card(s) validated in {wall:.2f}s wall, floor {floor!r} "
          f"GB/s from the NIC rate ({generation})", flush=True)
    result = {"wall_s": wall, "floor": floor}
    if n_cards < 4:
        print("slice: the multislice needs 4 cards (two slices of two one-card hosts)",
              flush=True)
        return result
    hosts = {f"h100-{pool[-1]}{w}": (pool, w, [2 * i + w])
             for i, pool in enumerate(("h100-slice-a", "h100-slice-b")) for w in range(2)}
    ms_floor = components._multislice_min_gbps(generation)
    slice_floor = components._slice_min_gbps(generation, 2)
    os.makedirs(os.path.join(root, "multislice"))
    t0 = time.perf_counter()
    out = _run_slice(os.path.join(root, "multislice"), hosts, name, multislice=True)
    ms_wall = time.perf_counter() - t0
    require(len(out["jax"]) == 4, f"jax-ready written {len(out['jax'])} times")
    for payload in out["jax"]:
        ms = payload.get("multislice") or {}
        require(payload["mode"] == "multi-host" and payload["workers"] == 2
                and ms.get("workers") == 4 and ms.get("group") == "h100-multislice",
                f"jax-ready {payload}")
    require(sorted(p["multislice"]["worker_id"] for p in out["jax"]) == [0, 1, 2, 3],
            f"global ids {[p['multislice'] for p in out['jax']]}")
    ms_dropbox = (status.read_workload_results(scope="multislice") or {}).get("distributed") or {}
    require(ms_dropbox.get("ok") and ms_dropbox["num_processes"] == 4,
            f"the multislice drop-box {ms_dropbox}")
    _check_slice_run(out, hosts, {"tpu-jax-validation": slice_floor,
                                  components.MULTISLICE_BASE: ms_floor})
    print(f"slice: multislice of 2 slices x 2 one-card hosts validated in {ms_wall:.2f}s "
          f"wall, slice floor {slice_floor!r}, cross-slice floor {ms_floor!r} GB/s", flush=True)
    return {**result, "multislice_wall_s": ms_wall}


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


# the paged entry's cases: label, lengths, heads, D, block_tokens, pool
# blocks, table width (pages), table order
PAGED_CASES = [
    ("engine step: quick_check's contexts", [24, 26, 28, 30, 32, 33, 34, 35], 2, 16, 16, 96, 8,
     "random"),
    ("page edges, reversed tables", [1, 8, 15, 16, 17, 31, 32, 33], 2, 16, 16, 96, 8, "reverse"),
    ("page edges at D 8", [8, 16, 17, 31, 32, 33, 64, 128], 2, 8, 16, 96, 8, "random"),
    ("blind rows (length 0) beside live ones", [0, 40, 0, 128], 2, 16, 16, 96, 8, "random"),
    ("split edges at D 64", [511, 512, 513, 1024, 1025, 2048], 4, 64, 16, 1024, 128, "random"),
    ("8-token pages, D 128", [255, 256, 257, 1000], 3, 128, 8, 512, 128, "reverse"),
    ("D 40 (a row of 10 lanes)", [9, 100, 300], 2, 40, 16, 64, 32, "random"),
    ("long: 8 requests x 8 heads, D 128", "long", 8, 128, 16, 2048, 256, "random"),
]


def long_lengths() -> list:
    """The long paged shape's 8 ragged lengths, 3585 to 4096, one of them
    exactly 4096, from a fixed seed."""
    import torch

    lengths = torch.randint(3585, 4097, (8,), generator=torch.Generator().manual_seed(14))
    lengths[3] = 4096
    return lengths.tolist()


def paged_inputs(gen, lengths, heads, d, bt, num_blocks, width, order) -> tuple:
    """q [R, H, D] and pools [num_blocks, bt, H, D] of randoms on the card,
    and each request's pages taken from a seeded permutation of the pool
    (``order`` random) or from a run of it, reversed; table entries past a
    request's live pages are -1 (never read)."""
    import torch

    perm = torch.randperm(num_blocks, generator=torch.Generator().manual_seed(num_blocks))
    tables = torch.full((len(lengths), width), -1, dtype=torch.int32)
    taken = 0
    for r, n in enumerate(lengths):
        pages = -(-n // bt)
        blocks = perm[taken:taken + pages] if order == "random" else \
            torch.arange(taken, taken + pages).flip(0)
        tables[r, :pages] = blocks.to(torch.int32)
        taken += pages
    require(taken <= num_blocks, f"{taken} pages from a pool of {num_blocks}")
    q = torch.randn((len(lengths), heads, d), generator=gen, device="cuda")
    kp, vp = (torch.randn((num_blocks, bt, heads, d), generator=gen, device="cuda")
              for _ in range(2))
    return (q, kp, vp, tables.cuda(), torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def paged_kernel_phase() -> float:
    """The paged entry at ``PAGED_CASES`` against its plain version: out
    within F32_RTOL of max |plain|, lse within STATE_RTOL, blind rows exactly
    0 and NEG_INF, two launches bit-identical, and the first and the last
    request alone bit-identical to their rows in the batch.  Returns the
    worst out error."""
    import torch

    from tpu_operator_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = 0.0
    for label, lengths, heads, d, bt, num_blocks, width, order in PAGED_CASES:
        lengths = long_lengths() if lengths == "long" else lengths
        q, kp, vp, tables, lens = paged_inputs(gen, lengths, heads, d, bt, num_blocks, width,
                                               order)
        out, lse = fa.flash_attention_paged(q, kp, vp, tables, lens)
        again = fa.flash_attention_paged(q, kp, vp, tables, lens)
        alone = [fa.flash_attention_paged(q[i:i + 1], kp, vp, tables[i:i + 1], lens[i:i + 1])
                 for i in (0, len(lengths) - 1)]
        torch.cuda.synchronize()
        require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                f"the paged forward is not deterministic at {label}")
        for i, (o, s) in zip((0, len(lengths) - 1), alone):
            require(torch.equal(o[0], out[i]) and torch.equal(s[0], lse[i]),
                    f"the paged forward's row {i} depends on the batch at {label}")
        ref, ref_lse = fa.flash_attention_paged_reference(q, kp, vp, tables, lens)
        blind = lens == 0
        require(not out[blind].any() and bool((lse[blind] == fa.NEG_INF).all()),
                f"the paged forward gave a request of length 0 a value at {label}")
        seen = ~blind
        err = _abs_err(out[seen], ref[seen])
        scaled = err / float(ref[seen].abs().max())
        lse_err = _rel_err(lse[seen], ref_lse[seen])
        splits = sorted({fa._paged_split_count(n, bt) for n in lengths})
        print(f"kernel flash_attention_paged [f32] {label} (lengths {min(lengths)}-"
              f"{max(lengths)}, splits {splits}): out max_abs_err={err!r} (/max|plain| "
              f"{scaled!r}) lse max_rel_err={lse_err!r}, {int(blind.sum())} blind rows exact, "
              "two launches and the rows alone bit-identical", flush=True)
        require(scaled <= F32_RTOL and lse_err <= STATE_RTOL,
                f"the paged forward differs from its plain version at {label}")
        worst = max(worst, err)
        del q, kp, vp
    return worst


def f32_kernel_phase() -> dict:
    """Kernel B5's f32 entries against their plain versions on the card.
    The contiguous entry: the old serving shapes (BH 2, an 8-row tail at
    q_off = length - 8, keys padded to a 16-token page, D 8 and 16), a
    ragged non-causal Tq 136 x Tk 200 at D 64, rows that see no key, BH 1.
    The paged entry: ``PAGED_CASES``.  Out within F32_RTOL of max |plain|,
    lse within STATE_RTOL, rows that see no key exactly 0 and NEG_INF, each
    case launched twice and bit-identical.  Returns the worst out error of
    each entry."""
    import torch

    from tpu_operator_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(f"serving length {n} D {d}", 2, 8, 16 * -(-n // 16), d, True, n - 8, 0)
             for n in (24, 40, 136) for d in (8, 16)]
    cases += [
        # label, bh, tq, tk, d, causal, q_off, k_off
        ("ragged Tq 136 x Tk 200 D 64 non-causal", 2, 136, 200, 64, False, 0, 0),
        ("rows 0-3 see no key (k_off 4)", 2, 8, 64, 16, True, 0, 4),
        ("every row masked", 2, 8, 64, 16, True, 0, 100),
        ("BH 1", 1, 8, 48, 16, True, 40, 0),
    ]
    worst = 0.0
    for label, bh, tq, tk, d, causal, q_off, k_off in cases:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda") for n in (tq, tk, tk))
        require(fa._forward_plan(bh, tq, tk, d, causal, q_off, k_off, n_sm, q.dtype)[0] == "f32",
                f"{label}: f32 inputs planned off the f32 path")
        out, lse = fa.flash_attention_local(q, k, v, causal, 16, 8, q_off, k_off)
        again = fa.flash_attention_local(q, k, v, causal, 16, 8, q_off, k_off)
        torch.cuda.synchronize()
        require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                f"the f32 forward is not deterministic at {label}")
        ref, ref_lse = fa.flash_attention_local_reference(q, k, v, causal, 16, 8, q_off, k_off)
        blind = ~ref.any(dim=-1)  # rows that see no key
        exact = (not out[blind].any()) and bool((lse[blind] == fa.NEG_INF).all())
        require(exact, f"the f32 forward gave a row that sees no key a value at {label}")
        if bool(blind.all()):
            print(f"kernel flash_attention_local [f32] {label}: out all 0 and lse all NEG_INF",
                  flush=True)
            continue
        seen = ~blind
        err = _abs_err(out[seen], ref[seen])
        scaled = err / float(ref.abs().max())
        lse_err = _rel_err(lse[seen], ref_lse[seen])
        print(f"kernel flash_attention_local [f32] {label}: out max_abs_err={err!r} "
              f"(/max|plain| {scaled!r}) lse max_rel_err={lse_err!r}, {int(blind.sum())} "
              f"blind rows exact, two launches bit-identical", flush=True)
        require(scaled <= F32_RTOL and lse_err <= STATE_RTOL,
                f"the f32 forward differs from its plain version at {label}")
        worst = max(worst, err)
    return {"contiguous": worst, "paged": paged_kernel_phase()}


def _hop_inputs(gen, dtype, bh, tq, tk, d, q_off, k_off, causal, window=0) -> tuple:
    """One ring hop as the remat backward sees it: q, k, v, dO in ``dtype``,
    the forward's lse and dsum = rowsum(dO * O) (from the plain f32 fold,
    under the sliding ``window`` when one is given), and non-zero incoming
    accumulators dq, dk, dv."""
    import torch

    from tpu_operator_torch.kernels import flash_attention as fa

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, do = randn(bh, tq, d).to(dtype), randn(bh, tq, d).to(dtype)
    k, v = randn(bh, tk, d).to(dtype), randn(bh, tk, d).to(dtype)
    fresh = (torch.full((bh, tq), fa.NEG_INF, device="cuda"),
             torch.zeros((bh, tq), device="cuda"), torch.zeros((bh, tq, d), device="cuda"))
    m, l, o = fa.flash_block_update_reference(q.float(), k.float(), v.float(), q_off, k_off,
                                              *fresh, causal, window)
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
    (bh, t, d), (tb, tt, td), (sb, st, sd) = TRAIN_HOP, TRANSFORMER_HOP, STAGE_HOP
    cases = [
        # label, bh, tq, tk, d, q_off, k_off, causal
        (f"train hop {TRAIN_HOP} causal", bh, t, t, d, 0, 0, True),
        (f"fully visible hop (8, {t}, {d}) q_off {t}", 8, t, t, d, t, 0, True),
        (f"transformer {TRANSFORMER_HOP} causal", tb, tt, tt, td, 0, 0, True),
        (f"transformer-pp stage {STAGE_HOP} causal", sb, st, st, sd, 0, 0, True),
        (f"transformer-pp stage {STAGE_HOP} fully visible", sb, st, st, sd, st, 0, True),
        ("ragged (4, 136 x 200, 16) causal, partly visible", 4, 136, 200, 16, 200, 100, True),
        ("ragged (2, 200 x 136, 64) causal, rows with no key", 2, 200, 136, 64, 0, 16, True),
        ("ragged (3, 40 x 72, 8) non-causal", 3, 40, 72, 8, 0, 0, False),
        ("head dim 40 (3, 200, 40) causal", 3, 200, 200, 40, 0, 0, True),
        ("head dim 72 (3, 200 x 264, 72) causal", 3, 200, 264, 72, 64, 0, True),
        ("ragged (2, 300 x 420, 128) causal, Tq and Tk off 64", 2, 300, 420, 128, 120, 0, True),
        ("fully masked (4, 136 x 200, 16)", 4, 136, 200, 16, 0, 200, True),
    ]
    # the long-context stage's diagonal hop at 4 of its heads: a dk/dv block
    # walks 1,024 query tiles there, 16 times the train hop's, and the
    # fold's last q tile 1,024 key tiles, so their sums are the longest any
    # cell asks of them
    lt, ld = LONG_HOP[1:]
    long_cases = [(f"long hop (4, {lt}, {ld}) causal", 4, lt, lt, ld, 0, 0, True)]
    twice = 0  # cases launched twice on the same inputs, bit-identical
    worst = {"flash_block_backward": 0.0, "flash_block_update_f32": 0.0}
    for dtype, tol, extra in ((torch.float32, F32_RTOL, long_cases),
                              (torch.bfloat16, KERNEL_OUT_RTOL, [])):
        for label, bh_, tq, tk, dd, q_off, k_off, causal in cases + extra:
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

    for label, bh_, tq, tk, dd, q_off, k_off, causal in cases + long_cases:
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
    # f32 with a sliding window (k-exaone's sliding layers): their hop at its
    # full shape, and a wider window on a hop whose keys start 1024 before
    # its queries
    wb, wt, wd = WINDOW_HOP
    window_cases = [(f"windowed hop ({wb}, {wt}, {wd}) W {WINDOW}", wb, wt, wd, 0, WINDOW),
                    (f"windowed (8, 2048, {wd}) W 1024, q_off 1024", 8, 2048, wd, 1024, 1024)]
    for label, bh_, tt_, dd, q_off, window in window_cases:
        args, acc = _hop_inputs(gen, torch.float32, bh_, tt_, tt_, dd, q_off, 0, True, window)
        runs = []
        for _ in range(2):
            runs.append(tuple(a.clone() for a in acc))
            fb.flash_block_backward(*args, *runs[-1], q_off, 0, True, window)
        folds = []
        for _ in range(2):
            folds.append(fresh(bh_, tt_, dd))
            fa.flash_block_update(*args[:3], q_off, 0, *folds[-1], True, window)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(*runs))
                and all(torch.equal(a, b) for a, b in zip(*folds)),
                f"the windowed f32 kernels are not deterministic at {label}")
        twice += 2
        ref = fb.flash_block_backward_reference(*args, *acc, q_off, 0, True, window)
        rm, rl, ro = fa.flash_block_update_reference(*args[:3], q_off, 0, *fresh(bh_, tt_, dd),
                                                     True, window)
        m, l, o = folds[0]
        # rows whose band holds no key of this block keep l = 0 on both sides
        seen = rl > 0
        require(torch.equal(seen, l > 0), f"the windowed fold's rows with no key differ at {label}")
        errs = {name: _scaled_err(a - x, b - x)
                for name, a, b, x in zip(("dq", "dk", "dv"), runs[0], ref, acc)}
        errs["out"] = _scaled_err((o / l.clamp_min(1e-30)[..., None])[seen],
                                  (ro / rl.clamp_min(1e-30)[..., None])[seen])
        errs["m"] = _rel_err(m[seen], rm[seen])
        print(f"kernel windowed f32 {label}: " + ", ".join(
            f"{name} (/max|plain|) {e!r}" for name, e in errs.items()), flush=True)
        require(all(v <= F32_RTOL for k, v in errs.items() if k != "m")
                and errs["m"] <= STATE_RTOL,
                f"the windowed f32 kernels differ from their plain versions at {label}")
        del args, acc, runs, folds, ref
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


def f32_timing_phase(name: str) -> dict:
    """Kernel B5's f32 entries, their plain versions and
    ``scaled_dot_product_attention`` on f32 with an explicit boolean mask
    (the nearest library call): the contiguous entry at the old serving
    page, (2, 8, 128, 16) causal at q_off 120; the paged entry at the
    engine's decode step (quick_check's 8 requests at its longest context,
    35, 2 heads, D 16, 16-token pages) and at the long shape (8 requests x 8
    heads, D 128, lengths 3585-4096, a 2048-block pool in random order).
    Returns the rows by label."""
    import torch
    import torch.nn.functional as F

    from tpu_operator_torch.kernels import flash_attention as fa

    mem, _, f32_peak, _ = peaks(name)
    bh, tq, tk, d = SERVING_SHAPE
    q_off = tk - tq
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda") for n in (tq, tk, tk))
    # is_causal aligns top-left when Tq != Tk: the tail's mask is explicit
    mask = torch.arange(tk, device="cuda")[None, :] <= (q_off + torch.arange(tq, device="cuda"))[:, None]
    pairs = bh * sum(q_off + i + 1 for i in range(tq))
    rows = {"contiguous": {
        "shape": [bh, tq, tk, d], "causal": True, "q_off": q_off, "dtype": "float32",
        "ms": time_ms(lambda: fa.flash_attention_local(q, k, v, True, q_off=q_off)),
        "plain_ms": time_ms(lambda: fa.flash_attention_local_reference(q, k, v, True,
                                                                       q_off=q_off)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask)),
        "library_note": "scaled_dot_product_attention, f32, explicit boolean mask",
        # q, k, v read, out written, lse written (all f32); 4 D FLOP per
        # unmasked (query, key) pair on the CUDA cores
        **_bound(4.0 * d * pairs, 4 * (2 * bh * tq * d + 2 * bh * tk * d + bh * tq), (mem, f32_peak)),
        "note": ("the bound is about ten nanoseconds, far below one launch (a few "
                 "microseconds): at this shape every time here is launch latency"),
    }}
    for label, lengths, heads, d, bt, num_blocks, width in (
            ("engine", [35] * 8, 2, 16, 16, 96, 8),
            ("long", long_lengths(), 8, 128, 16, 2048, 256)):
        q, kp, vp, tables, lens = paged_inputs(gen, lengths, heads, d, bt, num_blocks, width,
                                               "random")
        # SDPA's inputs: each request's pages gathered contiguous [R, H, T, D]
        # (the gather outside the timing), the keys past its length masked
        page_ids = tables.clamp_min(0).long()
        gk, gv = (pool[page_ids].flatten(1, 2).transpose(1, 2).contiguous() for pool in (kp, vp))
        keep = (torch.arange(width * bt, device="cuda")[None, :] < lens[:, None])[:, None, None]
        keys = sum(lengths)
        row = {
            "requests": len(lengths), "heads": heads, "head_dim": d, "block_tokens": bt,
            "lengths": lengths, "pool_blocks": num_blocks, "dtype": "float32",
            "splits": [fa._paged_split_count(n, bt) for n in lengths],
            "ms": time_ms(lambda: fa.flash_attention_paged(q, kp, vp, tables, lens)),
            "plain_ms": time_ms(lambda: fa.flash_attention_paged_reference(q, kp, vp, tables,
                                                                           lens), reps=5, per=2),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], gk, gv, attn_mask=keep)),
            "library_note": ("scaled_dot_product_attention, f32, boolean length mask, on the "
                             f"pages gathered contiguous [R, H, {width * bt}, D] beforehand "
                             "(the gather not timed)"),
            # each live K and V row read once, q read, out and lse written, the
            # live table entries and the lengths read; 4 D FLOP per (row, key)
            **_bound(4.0 * d * heads * keys,
                     4 * (2 * keys * heads * d + 2 * len(lengths) * heads * d
                          + len(lengths) * heads + sum(-(-n // bt) for n in lengths)
                          + len(lengths)),
                     (mem, f32_peak)),
        }
        rows[label] = row
        del q, kp, vp, gk, gv
    for label, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["library_bound_share"] = row["bound_ms"] / row["library_ms"]
        print(json.dumps({"timing": f"flash f32 ({label})", **row}), flush=True)
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


def _sdpa_backward_ms(q, k, v, do, causal=True, reps=5, per=3) -> tuple:
    """The backward alone of one ``scaled_dot_product_attention`` on [1, BH,
    T, D], the forward outside the timed region; returns (ms, the backward
    node that ran, which names the backend)."""
    import torch
    import torch.nn.functional as F

    qq, kk, vv = (x.detach()[None].clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)
    go = do[None].to(out.dtype)
    ms = time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), go, retain_graph=True),
                 reps=reps, per=per)
    return ms, out.grad_fn.name()


def _f32_bounds(flops: float, nbytes: float, mem: float, tf32: float, f32: float) -> dict:
    """The f32 kernels' bound on the route they take, 3xTF32 on the tensor
    cores (three TF32 passes per product), with the CUDA-core bound beside
    it for continuity."""
    return {**_bound(3.0 * flops, nbytes, (mem, tf32)), "flops": flops,
            "bound_simt_ms": _bound(flops, nbytes, (mem, f32))["bound_ms"]}


def train_timing_phase(name: str) -> dict:
    """B4 (f32 and bf16) and B3's f32 entry at the train hop, B4 f32 at the
    fully visible hop, both f32 kernels at the long-context hop and at the
    windowed hop as well, their plain versions and the library calls."""
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
    # the long-context stage's hop (the benchmark's train.s32768.x1): B4 f32
    # alone, its lse and dsum from B3's f32 kernel.  The plain version is
    # checked at 4 of these heads (train_kernel_phase) but not timed: at Tk
    # 32768 its q tiles are 8 rows, and each of the 4,096 adds into the whole
    # of dk and dv, so its time would be that traffic, not its work
    lb, lt, ld = LONG_HOP
    q, k, v, do = (torch.randn((lb, lt, ld), generator=gen, device="cuda") for _ in range(4))
    m = torch.full((lb, lt), fa.NEG_INF, device="cuda")
    l = torch.zeros((lb, lt), device="cuda")
    o = torch.zeros((lb, lt, ld), device="cuda")
    fa.flash_block_update(q, k, v, 0, 0, m, l, o, True)
    lse = m + torch.log(l)
    dsum = (do * (o / l[..., None])).sum(-1)
    # B3 f32 at the same hop, folding into the same state again, which costs
    # the same
    flops = 4.0 * ld * (lb * lt * (lt + 1) // 2)
    nbytes = 3 * lb * lt * ld * 4 + 2 * (2 * lb * lt * 4 + lb * lt * ld * 4)
    rows["update_f32_long"] = {
        "shape": [lb, lt, ld], "dtype": "float32", "causal": True,
        "ms": time_ms(lambda: fa.flash_block_update(q, k, v, 0, 0, m, l, o, True), reps=3, per=2),
        "plain_ms": None, "library_ms": None,
        "library_note": ("no single PyTorch call folds a block into (m, l, o); the plain version "
                         "is checked at 4 of these heads (train_kernel_phase), not timed"),
        **_f32_bounds(flops, nbytes, mem, tf32_peak, f32_peak),
        "bound_one_pass_ms": _bound(flops, nbytes, (mem, tf32_peak))["bound_ms"],
    }
    del m, l, o
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    flops = 10.0 * ld * (lb * lt * (lt + 1) // 2)
    nbytes = 4 * lb * lt * ld * 4 + 2 * lb * lt * 4 + 6 * lb * lt * ld * 4
    ms = time_ms(lambda: fb.flash_block_backward(q, k, v, do, lse, dsum, dq, dk, dv, 0, 0, True),
                 reps=3, per=2)
    del dq, dk, dv
    library_ms, backend = _sdpa_backward_ms(q, k, v, do, causal=True, reps=3, per=1)
    rows["backward_float32_long"] = {
        "shape": [lb, lt, ld], "dtype": "float32", "causal": True, "q_off": 0,
        "ms": ms,
        "plain_ms": None,
        "library_ms": library_ms,
        "library_backend": backend,
        "library_note": ("backward alone of scaled_dot_product_attention(is_causal=True), f32: "
                         "fresh dq/dk/dv, no accumulators; the plain version is not timed here "
                         "(each of its 8-row q tiles adds into the whole of dk and dv)"),
        **_f32_bounds(flops, nbytes, mem, tf32_peak, f32_peak),
        "bound_one_pass_ms": _bound(flops, nbytes, (mem, tf32_peak))["bound_ms"],
    }
    del q, k, v, do, lse, dsum
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
    del q, k, v, m, l, o
    # k-exaone's sliding layers' hop, W 128: B4 f32 and B3 f32, bounds from
    # the window's pairs (benchmark/counts_lm.py)
    from benchmark import counts_lm

    wb, wt, wd = WINDOW_HOP
    (q, k, v, do, lse, dsum), (dq, dk, dv) = _hop_inputs(gen, torch.float32, wb, wt, wt, wd, 0,
                                                         0, True, WINDOW)
    m = torch.full((wb, wt), fa.NEG_INF, device="cuda")
    l, o = torch.zeros((wb, wt), device="cuda"), torch.zeros((wb, wt, wd), device="cuda")
    for key, work, fn in (
            ("backward_float32_window", counts_lm.b4_f32_work,
             lambda: fb.flash_block_backward(q, k, v, do, lse, dsum, dq, dk, dv, 0, 0, True,
                                             WINDOW)),
            ("update_f32_window", counts_lm.b3_f32_work,
             lambda: fa.flash_block_update(q, k, v, 0, 0, m, l, o, True, WINDOW))):
        flops, nbytes = work(wb, wt, wd, WINDOW)
        rows[key] = {"shape": [wb, wt, wd], "dtype": "float32", "causal": True,
                     "window": WINDOW, "ms": time_ms(fn, reps=5, per=3), "plain_ms": None,
                     "library_ms": None, **_f32_bounds(flops, nbytes, mem, tf32_peak, f32_peak),
                     "bound_one_pass_ms": _bound(flops, nbytes, (mem, tf32_peak))["bound_ms"]}
    del q, k, v, do, lse, dsum, dq, dk, dv, m, l, o
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
    lm_fwd_launches, lm_bwd_launches = lm_training_phase(count)
    census_phase(count)
    multihost_phase(count)
    serving = serving_phase(count)
    migration_phase(count)
    warm = warmpool_phase(count)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-validator-") as root:
        agents = agents_phase(count, os.path.join(root, "agents"), name)
        validator = validator_phase(count, os.path.join(root, "validator"), name)
        partition_phase(count, os.path.join(root, "partition"))
        slices = slices_phase(count, os.path.join(root, "slices"), name)
        slice_phase(count, root, name)
    max_err = kernel_phase()
    flash_err = flash_kernel_phase()
    f32_err = f32_kernel_phase()
    dma_err = dma_kernel_phase()
    train_err = train_kernel_phase()
    vt = timing_phase(name)
    t = vt["(2048, 512) float32"]
    ft = flash_timing_phase(name)
    dt = dma_timing_phase(name)
    tt = train_timing_phase(name)
    st = f32_timing_phase(name)
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
        "launches": launches + warm["launches"] + validator["vector_add"] + agents["vector_add"]
        + slices["vector_add"],
        "launches_by_check": {"vector-add": launches, "warm-pool": warm["launches"],
                              "validator": validator["vector_add"],
                              "agents": agents["vector_add"], "slices": slices["vector_add"]},
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
        "launches": update_launches + validator["flash_block_update"],
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
        "launches": dma_launches + validator["dma_pipeline_copy"] + agents["dma_pipeline_copy"],
        "launches_by_check": {"hbm-dma": dma_launches, "validator": validator["dma_pipeline_copy"],
                              "agents": agents["dma_pipeline_copy"]},
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
        "launches": train_fwd_launches + lm_fwd_launches,
        "launches_by_check": {",".join(TRAIN_CHECKS): train_fwd_launches,
                              LM_MODEL: lm_fwd_launches},
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
        "launches": train_bwd_launches + lm_bwd_launches,
        "launches_by_check": {",".join(TRAIN_CHECKS): train_bwd_launches,
                              LM_MODEL: lm_bwd_launches},
        "max_abs_err": train_err["flash_block_backward"],
        **entry(tt["backward_float32"]),
        "bound_simt_ms": tt["backward_float32"]["bound_simt_ms"],
        "library_backend": tt["backward_float32"]["library_backend"],
        "dtypes": {"float32": entry(tt["backward_float32"]),
                   "float32 fully visible hop": entry(tt["backward_float32_visible"]),
                   "float32 long-context hop": {
                       **entry(tt["backward_float32_long"]),
                       "bound_one_pass_ms": tt["backward_float32_long"]["bound_one_pass_ms"]},
                   "bfloat16": {**entry(tt["backward_bfloat16"]),
                                "library_backend": tt["backward_bfloat16"]["library_backend"]}},
    }, {
        "name": "flash_attention_paged_f32",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/flash_forward_f32.cu",
        "replaces": "tpu_operator/workloads/longctx.py:47",
        "launches": serving["paged_launches"],
        "max_abs_err": f32_err["paged"],
        **entry(st["engine"]),
        "shape": {key: st["engine"][key] for key in ("requests", "heads", "head_dim", "lengths")},
        "library_note": st["engine"]["library_note"],
        "step_ms": {attend: serving["runs"][attend]["step_ms_median"]
                    for attend in ("flash", "dense")},
        "shapes": {"long": {**entry(st["long"]), "bound_share": st["long"]["bound_share"],
                            "splits": st["long"]["splits"]},
                   # the same fold behind flash_attention_local's f32 entry,
                   # which the engine no longer calls
                   "contiguous (2, 8, 128, 16)": {**entry(st["contiguous"]),
                                                  "max_abs_err": f32_err["contiguous"]}},
    }]}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s wall, the build included", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


def serving_steps(tree: str = "") -> int:
    """``python3 chip_smoke.py --serving-steps [DIR]``: quick_check's A/B in
    both attends with each attend call timed (``serving_ab``), on the
    package of the checkout in DIR (another commit's tree, unpacked by ``git
    archive``) or of this one; one JSON line per attend.  Two trees compare
    on one card in one call, in turns (parent, change, change, parent)."""
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    name, _ = device_phase()
    import tpu_operator_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(tpu_operator_torch.__file__)))
    for attend in ("dense", "flash"):
        r = serving_ab(attend)
        require(r["ok"] and r["identical_outputs"], f"serving [{attend}] changed outputs")
        keys = ("paths", "gathers", "attend_calls", "tail_calls", "step_ms_median", "step_ms",
                "speedup", "seconds")
        print(json.dumps({"serving_steps": attend, "tree": root, "device": name,
                          **{key: r[key] for key in keys},
                          **{f"{run}_{key}": r[run][key] for run in ("sequential", "batched")
                             for key in ("tokens_per_sec", "tpot_p50_s", "steps")}}),
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serving-steps"]:
        sys.exit(serving_steps(*sys.argv[2:3]))
    sys.exit(main())
