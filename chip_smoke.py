#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on an NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, the node readiness gate, the way the validator
runs it, and holds every kernel on that path against its plain PyTorch
version.  Phases, each fatal on failure:

1. device  — a CUDA card must be visible (no CPU fallback); prints its name
   and power limit as nvidia-smi reports them
2. build   — compiles the kernels from ``tpu_operator_torch/csrc`` with nvcc
3. gate    — ``run_validation.main()`` with vector-add, allreduce and burn-in
   at their shipping sizes and EXPECTED_DEVICES set: exit 0, one JSON line
   per check, a drop-box holding all of them, finite outputs that agree
   with a float64 reference, and every kernel's launch count above 0
4. kernel  — each kernel against its plain version on the card: the f32 add
   must be bit-identical (tolerance 0) at the gate's shape, a ragged shape
   and a view one element off 16-byte alignment
5. timing  — CUDA-event medians of the kernel, its plain version and the
   library call, beside the least time the card's memory rate allows

Prints the ``kernels`` JSON line, then, last, ``{"ok": true, "device":
...}``.  Needs one card; uses every visible card for the gate's collectives.
"""

from __future__ import annotations

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

# HBM rate by card name (NVIDIA data sheets), most specific first
HBM_BYTES_PER_S = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),  # SXM
)
GATE_SHAPE = (2048, 512)  # vector_add's default n = 1 << 20
BIG_SHAPE = (65536, 512)  # 128 MiB per operand: past the 50 MB L2
GATE_CHECKS = ("vector-add", "allreduce", "burn-in")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


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

    built = _build.build("vector_add")
    _build.library("vector_add")
    print(f"build: vector_add {built.seconds:.2f}s -> {built.path}", flush=True)
    if built.log.strip():
        print(built.log.strip(), flush=True)


def gate_phase(n_cards: int) -> int:
    """Run the gate through its entry point; returns the kernel's launches."""
    import numpy as np
    import torch

    from tpu_operator_torch.kernels import vector_add as va
    from tpu_operator_torch.validator import status
    from tpu_operator_torch.workloads import collectives, run_validation

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
        os.environ.update({
            "WORKLOAD_CHECKS": ",".join(GATE_CHECKS),
            "EXPECTED_DEVICES": str(n_cards),
            "DEVICE_COUNT_GATE_BACKENDS": "cuda",
            "TPU_VALIDATION_ROOT": root,
        })
        out = io.StringIO()
        va.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run_validation.main()
        gate_s = time.perf_counter() - t0
        launches = va.launches
        lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
        for line in lines:
            print(json.dumps(line), flush=True)
        print(f"gate: rc={rc} in {gate_s:.2f}s, vector_add launches={launches}", flush=True)
        require(rc == 0, f"run_validation exited {rc}")
        checks = [line["check"] for line in lines]
        require(checks == ["devices", *GATE_CHECKS], f"JSON lines for {checks}")
        dropbox = status.read_workload_results()
        require(dropbox is not None, "no drop-box written")
        require(set(dropbox["checks"]) == {"devices", *GATE_CHECKS},
                f"drop-box holds {sorted(dropbox['checks'])}")
    require(launches > 0, "the gate ran without launching the vector_add kernel")

    by = {line["check"]: line for line in lines}
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

    rate = hbm_rate(name)
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


def main() -> int:
    name, count = device_phase()
    build_phase()
    launches = gate_phase(count)
    max_err = kernel_phase()
    t = timing_phase(name)
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
