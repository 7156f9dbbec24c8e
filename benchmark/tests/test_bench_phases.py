"""The step's device time by block (``phases.py``) on a hand-written trace,
and the program's spans on tiny CPU runs of the training cells under a
caller's tracer."""

import time

import pytest

from benchmark import phases
from benchmark import trace as btrace
from benchmark.harness import execute
from tpu_operator_torch.obs import trace

MAIN, AUTOGRAD = 1, 2  # the step's thread and the autograd engine's


def _x(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid,
            "args": args}


def _launch(corr, ts, tid=MAIN):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid, correlation=corr)


def _kernel(name, corr, ts, dur):
    return _x(name, "kernel", ts, dur, tid=99, correlation=corr)


def _trace():
    """One step in a window of 1000 µs.  Device time: attention 50 forward
    + 50 backward, the MLP 100 + 20 (NCCL all-gather) forward + 100
    backward, the loss 5 forward and 5 backward and the gradient all-reduce
    20 (NCCL) in the gradients, 4 in the step's own time and 10 outside
    every span, and a kernel after the window."""
    return [
        _x(btrace.WINDOW, "user_annotation", 0, 1000),
        _x("train.step", "user_annotation", 0, 900),
        # an op that makes no node carries the number of the next node made
        _x("aten::detach", "cpu_op", 2, 3, **{"Sequence number": 5, "Fwd thread id": 0}),
        _x("train.attn", "user_annotation", 10, 190),
        _x("aten::to", "cpu_op", 12, 3, **{"Sequence number": 5, "Fwd thread id": 0}),
        _x("aten::mm", "cpu_op", 20, 40, **{"Sequence number": 5, "Fwd thread id": 0}),
        _launch(1, 30),
        _kernel("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 1, 100, 50),
        _x("train.mlp", "user_annotation", 210, 190),
        _x("aten::mm", "cpu_op", 220, 40, **{"Sequence number": 7, "Fwd thread id": 0}),
        _launch(2, 230),
        _kernel("cutlass_80_simt_sgemm_128x256_8x4_nt_align1", 2, 300, 100),
        _x("_GatherSeq", "cpu_op", 270, 30, **{"Sequence number": 8}),
        _launch(3, 280),
        _kernel("ncclDevKernel_AllGather_RING_LL(x)", 3, 400, 20),
        _x("train.grads", "user_annotation", 402, 488),
        # the loss
        _x("aten::square", "cpu_op", 405, 10, **{"Sequence number": 9, "Fwd thread id": 0}),
        _launch(4, 410),
        _kernel("vectorized_elementwise_kernel", 4, 420, 5),
        # the autograd engine's thread: each node names its forward
        _x("autograd::engine::evaluate_function: PowBackward0", "cpu_op", 440, 10, AUTOGRAD,
           **{"Sequence number": 9, "Fwd thread id": 1}),
        _launch(5, 444, AUTOGRAD),
        _kernel("elementwise_kernel", 5, 450, 5),
        _x("autograd::engine::evaluate_function: MmBackward0", "cpu_op", 460, 40, AUTOGRAD,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("MmBackward0", "cpu_op", 461, 38, AUTOGRAD,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("aten::mm", "cpu_op", 470, 20, AUTOGRAD),
        _launch(6, 475, AUTOGRAD),
        _kernel("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 6, 500, 100),
        _x("autograd::engine::evaluate_function: MmBackward0", "cpu_op", 510, 10, AUTOGRAD,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        _launch(7, 512, AUTOGRAD),
        _kernel("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n", 7, 600, 50),
        # a node made inside a backward (a recompute) counts on the engine's thread
        _x("aten::mm", "cpu_op", 530, 5, AUTOGRAD, **{"Sequence number": 7, "Fwd thread id": 0}),
        _launch(8, 812),
        _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 8, 815, 20),
        # the step's own time, in no block
        _launch(11, 893),
        _kernel("vectorized_elementwise_kernel", 11, 970, 4),
        _launch(9, 950),
        _kernel("vectorized_elementwise_kernel", 9, 955, 10),
        _launch(10, 960),
        _kernel("late", 10, 1100, 10),
    ]


def test_device_time_goes_to_the_block_of_its_forward():
    got = phases.attribute(_trace())
    want = {"train.attn": [100e-6, 0.0], "train.mlp": [220e-6, 20e-6],
            "train.grads": [30e-6, 20e-6], "unattributed": [14e-6, 0.0]}
    assert got.keys() == want.keys()
    for name, (seconds, nccl) in want.items():
        assert got[name] == [pytest.approx(seconds), pytest.approx(nccl)], name
    # the phases add up to the window's device time
    total = sum(s for s, _ in got.values())
    assert total == pytest.approx(btrace.summarize(_trace())["device_s"])
    # the MLP's rate leaves its NCCL kernels out
    assert got["train.mlp"][0] - got["train.mlp"][1] == pytest.approx(200e-6)


def test_a_program_without_the_spans_has_no_phases():
    events = [e for e in _trace() if not e["name"].startswith("train.")]
    assert phases.attribute(events) == {}
    assert phases.attribute([e for e in _trace() if e["name"] != btrace.WINDOW]) == {}


def _named(spans: list, name: str) -> list:
    return sorted((s for s in spans if s["name"] == name), key=lambda s: s["start"])


@pytest.mark.parametrize("cell", ["train.s2048.x1", "train.s2048.x4"])
def test_a_traced_cpu_run_under_a_tracer_splits_its_start_up(spec, tiny, cell):
    """The runner activates no tracer; under the caller's, every rank's
    start, rendezvous and steps come back, and the parts of the start-up
    fit in ``setup_s``."""
    config, traffic = tiny(cell)
    tracer = trace.Tracer()
    with tracer.adopt(None):
        out = execute(spec, cell, 2**31 + 11, 0.3, True, time.monotonic(), device="cpu",
                      config=config, traffic=traffic)
    assert out["correct"], out["compared"]
    spans, layer = tracer.spans(), out["layer"]
    dp, mp = traffic["mesh"]
    steps = _named(spans, "train.step")
    per_rank = traffic["checked_steps"] + layer["steps"] + layer["traced_steps"]
    for rank in range(dp * mp):
        assert sum(s["attrs"]["rank"] == rank for s in steps) == per_rank
    for block in ("train.attn", "train.mlp", "train.grads"):
        assert len(_named(spans, block)) == len(steps)
    first_step = next(s for s in steps if s["attrs"]["rank"] == 0)
    starts, meets = _named(spans, "ranks.rank_start"), _named(spans, "ranks.rendezvous")
    if dp * mp == 1:
        assert starts == meets == []
        parts = [first_step["end"] - first_step["start"]]
    else:
        assert sorted(s["attrs"]["rank"] for s in starts) == list(range(dp * mp))
        assert sorted(s["attrs"]["rank"] for s in meets) == list(range(dp * mp))
        last_start = max(s["end"] for s in starts)
        parts = [max(s["end"] - s["start"] for s in starts),
                 max(s["end"] for s in meets) - last_start,
                 first_step["end"] - first_step["start"]]
    assert all(p > 0 for p in parts)
    assert sum(parts) <= out["end_to_end"]["setup_s"]
