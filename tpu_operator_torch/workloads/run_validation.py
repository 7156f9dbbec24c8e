"""Workload-pod entry point of the readiness gate on PyTorch/CUDA:
``python -m tpu_operator_torch.workloads.run_validation``.

Same contract as ``tpu_operator/workloads/run_validation.py``: exits 0 iff
every requested check passes, prints one JSON line per check, records the
flight samples and writes the drop-box the validator reads back.

Env (as the reference, plus ``TORCH_DEVICE``):
- ``WORKLOAD_CHECKS``: comma list of check names (default
  ``vector-add,allreduce,burn-in``); the names are the reference's 18:
  ``vector-add``, ``allreduce``, ``burn-in``, ``ring-attention``,
  ``longctx``, ``decode``, the post-ready perf probes ``matmul``, ``hbm``,
  ``hbm-dma`` (kernel B2, report-only) and ``ring`` (the per-link
  diagnostic), and training: ``transformer`` (the flagship layer's dp +
  ring-attention sp + Megatron-SP step, kernels B3 and B4 on a card) and
  ``train`` (its tokens/s and MFU at the reference's full width on a card),
  and the parallelism census the perf pod runs on a node of several cards:
  ``ulysses`` (all-to-all sequence parallel attention), ``moe`` (expert
  parallel, two all-to-alls) and ``pipeline`` (GPipe over a chain of
  cards), and ``serving`` (the continuous-batching engine over the paged KV
  cache: sequential vs batched scheduling, identical outputs),
  ``transformer-pp`` (the GPipe stack of transformer stages over the (pp,
  dp, mp) mesh, kernels B3 and B4 on a card) and ``warm-pool`` (the kernel
  libraries through the fleet artifact cache, then the canonical programs,
  vector-add on kernel B1; env ``TPU_COMPILE_CACHE_ARTIFACTS``,
  ``TPU_COMPILE_CACHE_MAX_BYTES``, ``TPU_FLEET_CACHE_URL``,
  ``TPU_CACHE_GENERATION``, ``TPU_CACHE_TOPOLOGY``)
- ``TORCH_DEVICE``: ``cpu`` runs the checks on the CPU on purpose; unset,
  the gate needs a card and fails without one
- ``EXPECTED_DEVICES``: promised card count, checked first; a mismatch
  short-circuits the remaining checks
- ``ALLREDUCE_SIZE_MB`` / ``ALLREDUCE_MIN_GBPS``, ``BURN_IN_STEPS`` /
  ``BURN_IN_SEED``: check knobs
- ``MATMUL_MIN_MFU``, ``HBM_MIN_GBPS``, ``RING_SIZE_MB`` / ``RING_ITERS``
  / ``RING_MIN_GBPS``: probe knobs; ``HBM_SIZE_MB`` / ``HBM_ITERS`` /
  ``HBM_BEST_OF`` (and ``HBM_DMA_CHUNK_MB`` / ``HBM_DMA_SLOTS``) size hbm
  and hbm-dma on a card, while the CPU runs their toy shapes
- ``WORKLOAD_BUDGET_S``: stop STARTING new checks past this many seconds
  (skipped checks are recorded as skipped, not failed)
- ``WORKLOAD_START_BARRIER`` / ``WORKLOAD_BARRIER_COUNT`` /
  ``WORKLOAD_BARRIER_TIMEOUT_S``: rendezvous dir + member count for
  concurrent runs
- ``RESULTS_SCOPE``: drop-box scope
"""

from __future__ import annotations

import json
import os
import sys
import time

def check_runners() -> dict:
    """Check name → zero-arg runner, the one source of truth for the
    dispatch AND the valid-name set (the same 18 names as the reference)."""
    from tpu_operator_torch.workloads import collectives, resolve_device

    def allreduce():
        return collectives.apply_allreduce_gate(
            collectives.allreduce_benchmark(
                size_mb=float(os.environ.get("ALLREDUCE_SIZE_MB", "64"))
            ),
            float(os.environ.get("ALLREDUCE_MIN_GBPS", "0")),
        )

    def burn_in():
        return collectives.burn_in(
            steps=int(os.environ.get("BURN_IN_STEPS", "3") or 3),
            seed=int(os.environ.get("BURN_IN_SEED", "0") or 0),
        )

    def train():
        # end-to-end training throughput: tokens/sec + training MFU of the
        # flagship step at the reference's full width on a card
        from tpu_operator_torch.workloads import train_bench

        return train_bench.quick_check()

    def ring_attention():
        # sequence-parallel exact attention over the local cards, one rank
        # each (long-context acceptance; correctness-or-fail)
        from tpu_operator_torch.workloads import ring_attention as ra

        return ra.quick_check()

    def longctx():
        # long-context prefill: K/V-streamed flash attention (32k tokens
        # on one card), spot-tile exactness + throughput
        from tpu_operator_torch.workloads import longctx as lc

        return lc.quick_check()

    def decode():
        # decode attention against a long KV cache: per-token latency +
        # cache-read rate (the byte-bound half of serving)
        from tpu_operator_torch.workloads import longctx as lc

        return lc.decode_quick_check()

    def matmul():
        from tpu_operator_torch.workloads import matmul_bench

        return matmul_bench.apply_mfu_gate(
            matmul_bench.quick_benchmark(),
            float(os.environ.get("MATMUL_MIN_MFU", "0")),
        )

    def ring():
        return collectives.apply_ring_gate(
            collectives.ring_benchmark(
                size_mb=float(os.environ.get("RING_SIZE_MB", "16")),
                iters=int(os.environ.get("RING_ITERS", "4")),
            ),
            float(os.environ.get("RING_MIN_GBPS", "0") or 0),
        )

    def hbm():
        # env-sized on a card; the reference's toy stream on the CPU (256
        # MiB x 1024 passes there take minutes and measure the host)
        from tpu_operator_torch.workloads import hbm_bench

        if resolve_device().type == "cuda":
            result = hbm_bench.hbm_benchmark(
                size_mb=float(os.environ.get("HBM_SIZE_MB", "256")),
                iters=int(os.environ.get("HBM_ITERS", "1024")),
                best_of=int(os.environ.get("HBM_BEST_OF", "3")),
            )
        else:
            result = hbm_bench.quick_benchmark()
        return hbm_bench.apply_hbm_gate(result, float(os.environ.get("HBM_MIN_GBPS", "0") or 0))

    def hbm_dma():
        # DMA-pipeline cross-check (report-only by design): same units AND
        # same env-driven working set as hbm on a card; the reference's toy
        # shapes through the plain version on the CPU
        from tpu_operator_torch.workloads import hbm_dma as hd

        if resolve_device().type == "cuda":
            return hd.dma_stream_benchmark(
                size_mb=float(os.environ.get("HBM_SIZE_MB", "256")),
                iters=int(os.environ.get("HBM_ITERS", "1024")),
                chunk_mb=float(os.environ.get("HBM_DMA_CHUNK_MB", "4")),
                slots=int(os.environ.get("HBM_DMA_SLOTS", "4")),
                best_of=int(os.environ.get("HBM_BEST_OF", "3")),
            )
        return hd.quick_benchmark()

    # the parallelism census: each module's acceptance over every card at
    # the reference's shipping size (its CPU size on the CPU)
    def ulysses():
        from tpu_operator_torch.workloads import ulysses as uly

        return uly.quick_check()

    def moe():
        from tpu_operator_torch.workloads import moe as ep

        return ep.quick_check()

    def pipeline():
        from tpu_operator_torch.workloads import pipeline as pp

        return pp.quick_check()

    def warm_pool():
        # the kernel libraries through the fleet artifact cache: prewarm →
        # compile-or-fetch → execute → publish (workloads/warmpool.py)
        from tpu_operator_torch.workloads import warmpool

        return warmpool.quick_check()

    def serving():
        # continuous-batching serving engine over the paged KV cache: a
        # small closed-loop A/B; batching must keep every request's tokens
        # identical to sequential scheduling
        from tpu_operator_torch.workloads import serving as srv

        return srv.quick_check()

    return {
        "vector-add": collectives.vector_add,
        "allreduce": allreduce,
        "burn-in": burn_in,
        # the flagship layer: dp batch + mp ring-attention sequence
        # parallelism + Megatron-SP MLP in one train step
        "transformer": collectives.transformer_burn_in,
        # the full composition: GPipe microbatch pipeline of transformer
        # stages, each internally the dp + sp + tp layer
        "transformer-pp": collectives.transformer_pipeline_burn_in,
        "train": train,
        "matmul": matmul,
        "ring-attention": ring_attention,
        "longctx": longctx,
        "decode": decode,
        "ring": ring,
        "hbm": hbm,
        "hbm-dma": hbm_dma,
        "ulysses": ulysses,
        "moe": moe,
        "pipeline": pipeline,
        "warm-pool": warm_pool,
        "serving": serving,
    }


def known_checks() -> set:
    """Valid check names (derived from the dispatch — cannot drift)."""
    return set(check_runners())


def _start_barrier() -> bool:
    """Announce this process in WORKLOAD_START_BARRIER and hold until every
    member is present; False (after printing why) on timeout."""
    barrier_dir = os.environ.get("WORKLOAD_START_BARRIER", "")
    if not barrier_dir:
        return True
    count = int(os.environ.get("WORKLOAD_BARRIER_COUNT", "1") or 1)
    budget = float(os.environ.get("WORKLOAD_BARRIER_TIMEOUT_S", "120") or 120)
    os.makedirs(barrier_dir, exist_ok=True)
    # tmp+replace: a member crashing mid-announce must not leave a torn
    # .ready file the barrier count would trust
    marker = os.path.join(barrier_dir, f"{os.getpid()}.ready")
    with open(marker + ".tmp", "w") as f:
        f.write(str(os.getpid()))
    os.replace(marker + ".tmp", marker)
    deadline = time.monotonic() + budget
    while True:
        present = [n for n in os.listdir(barrier_dir) if n.endswith(".ready")]
        if len(present) >= count:
            return True
        if time.monotonic() > deadline:
            print(json.dumps({
                "check": "start-barrier", "ok": False,
                "error": f"only {len(present)}/{count} members after {budget}s",
            }), flush=True)
            return False
        time.sleep(0.05)


def main() -> int:
    from tpu_operator_torch.obs import flight, trace
    from tpu_operator_torch.validator import status as vstatus
    from tpu_operator_torch.workloads import collectives, resolve_device

    # no card and no TORCH_DEVICE=cpu request: raise, never measure the CPU
    resolve_device()

    checks = [
        c.strip()
        for c in os.environ.get("WORKLOAD_CHECKS", "vector-add,allreduce,burn-in").split(",")
        if c.strip()
    ]
    ok = True
    results: dict[str, dict] = {}

    if not _start_barrier():
        return 1

    # device-count truth FIRST: a node with dead cards must fail here with
    # the counts, not pass every check on the surviving subset
    expected = os.environ.get("EXPECTED_DEVICES", "")
    if expected:
        try:
            result = collectives.device_count_check(int(expected))
        except ValueError:
            result = {"ok": False, "error": f"malformed EXPECTED_DEVICES={expected!r}"}
        print(json.dumps({"check": "devices", **result}), flush=True)
        results["devices"] = result
        if not result["ok"]:
            # the remaining checks would measure the wrong topology
            checks = []
            ok = False

    try:
        budget = float(os.environ.get("WORKLOAD_BUDGET_S", "0") or 0)
    except ValueError:
        budget = 0.0
    t_start = time.monotonic()

    scope = os.environ.get("RESULTS_SCOPE", "")
    recorder = flight.recorder_for(vstatus.flight_record_path(scope))
    # adopt the propagated trace context (TPU_TRACEPARENT): the check spans
    # and flight samples join the operator's rollout trace
    tracer = trace.Tracer()
    runners = check_runners()
    with tracer.adopt(trace.TraceContext.from_env()), flight.activate(recorder):
        for check in checks:
            runner = runners.get(check)
            if runner is None:
                # validate the NAME even past the budget: a typo'd check must
                # fail the pod, never be masked as a benign budget skip
                result = {"ok": False, "error": f"unknown check {check}"}
            elif budget and time.monotonic() - t_start > budget:
                result = {"ok": True, "skipped": f"budget ({budget}s) exhausted"}
            else:
                with trace.span(f"check/{check}", kind=trace.KIND_PHASE, phase=check):
                    t0 = time.monotonic()
                    result = runner()
                    result.setdefault("duration_s", round(time.monotonic() - t0, 6))
                    flight.record_result(check, result)
            print(json.dumps({"check": check, **result}), flush=True)
            results[check] = result
            ok = ok and bool(result.get("ok"))

    # node-local drop-box: the validator merges the measured numbers into
    # its payloads; best-effort, never a gate
    vstatus.write_workload_results({"checks": results}, scope=scope)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
