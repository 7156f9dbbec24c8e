"""The yardstick's arithmetic against hand-worked numbers: the step's
model FLOPs, the kept pairs of a causal hop, the kernels' operations and
bytes, the reading of a profiler trace and the readers built on it."""

import itertools

import pytest

from benchmark import counts, peaks, readings
from benchmark import trace as btrace


def test_step_flops_of_the_shipped_probe():
    # forward: 8·4·2048·4096² = 1.0995e12, 4·4·2048·4096·16384 = 2.1990e12,
    # 4·4·2048²·4096 = 2.7488e11; three times their sum
    flops = counts.step_model_flops(4, 2048, 4096, 16384)
    assert flops == pytest.approx(1.0720e13, rel=1e-4)
    assert flops == 3 * (8 * 4 * 2048 * 4096**2 + 4 * 4 * 2048 * 4096 * 16384
                         + 4 * 4 * 2048**2 * 4096)
    # four cards, dp 2 x mp 2: the global batch 8 x 4096
    assert counts.step_model_flops(8, 4096, 4096, 16384) == pytest.approx(4.6179e13, rel=1e-4)


@pytest.mark.parametrize("tq,tk,q_off,k_off", [
    (8, 8, 0, 0), (8, 8, 8, 0), (8, 8, 0, 8), (5, 7, 3, 0), (7, 5, 0, 3), (6, 6, 2, 5),
    (1, 9, 4, 0), (9, 1, 0, 4)])
def test_causal_pairs_against_counting(tq, tk, q_off, k_off):
    brute = sum(1 for i, j in itertools.product(range(tq), range(tk)) if q_off + i >= k_off + j)
    assert counts.causal_pairs(tq, tk, q_off, k_off) == brute


def test_hop_work_is_chip_smokes_at_the_train_hop():
    bh, t, d = 128, 2048, 128
    pairs = bh * t * (t + 1) // 2
    flops, nbytes = counts.b3_f32_work(bh, t, t, d, 0, 0)
    assert flops == 4.0 * d * pairs
    assert nbytes == 3 * bh * t * d * 4 + 2 * (2 * bh * t * 4 + bh * t * d * 4)
    flops, nbytes = counts.b4_f32_work(bh, t, t, d, 0, 0)
    assert flops == 10.0 * d * pairs
    assert nbytes == 4 * bh * t * d * 4 + 2 * bh * t * 4 + 6 * bh * t * d * 4
    # a fully visible hop counts every pair, a fully masked one none
    assert counts.b4_f32_work(bh, t, t, d, t, 0)[0] == 10.0 * d * bh * t * t
    assert counts.b4_f32_work(bh, t, t, d, 0, t)[0] == 0.0


def test_ring_hops_and_bound():
    assert counts.ring_hops(1, 0, 2048) == [(0, 0)]
    assert counts.ring_hops(2, 0, 2048) == [(0, 0), (0, 2048)]
    assert counts.ring_hops(2, 1, 2048) == [(2048, 2048), (2048, 0)]
    assert counts.bound_s(494.5e12, 1.0, 494.5e12, 3350e9) == 1.0
    assert counts.bound_s(1.0, 3350e9, 494.5e12, 3350e9) == 1.0


def test_peaks_by_card_name():
    assert peaks.for_card("NVIDIA H100 80GB HBM3")["tf32_flops"] == 494.5e12
    assert peaks.for_card("NVIDIA H100 PCIe") is None
    assert peaks.for_card("cpu") is None


def _event(name, cat, ts, dur, **extra):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **extra}


def _trace():
    """A window of 100 µs: two kernels (10–30, 25–45 overlapping), a copy
    (60–70) and a kernel outside the window; host ops around them."""
    return [
        _event(btrace.WINDOW, "user_annotation", 0, 100),
        _event("void (anonymous namespace)::dq_kernel<float, 128>(P)", "kernel", 10, 20),
        _event("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", "kernel", 25, 20),
        _event("Memcpy DtoD", "gpu_memcpy", 60, 10),
        _event("outside", "kernel", 150, 10),
        _event("aten::mm", "cpu_op", 0, 50),
        _event("cudaDeviceSynchronize", "cuda_runtime", 50, 50),
    ]


def test_trace_summary_of_a_window():
    s = btrace.summarize(_trace())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)  # 10–45 and 60–70
    assert s["device_s"] == pytest.approx(50e-6)
    assert "outside" not in s["ops"]
    # gaps 0–10 and 45–60 begin in aten::mm, 70–100 in the synchronize
    assert s["gaps"]["aten::mm"] == pytest.approx(25e-6)
    assert s["gaps"]["cudaDeviceSynchronize"] == pytest.approx(30e-6)
    assert btrace.matching(s, readings.NCCL) == (pytest.approx(20e-6), 1)
    assert btrace.short_name("void (anonymous namespace)::dq_kernel<float, 128>(P)") == (
        "dq_kernel<float, 128>")
    assert btrace.summarize([_event("x", "kernel", 0, 1)]) == {}


def test_readers_on_a_summary():
    s = btrace.summarize(_trace())
    assert readings.idle_share(s) == pytest.approx(55.0)
    assert readings.device_share(s, readings.NCCL) == pytest.approx(40.0)
    assert readings.idle_share({}) is None


def test_attention_share_counts_each_launch_against_its_hop():
    """One step on one card: B3 f32 once, B4 f32's two kernels once; the
    share is the least time over the kernels' time."""
    bh, t, d = 4, 256, 128
    card = peaks.for_card("NVIDIA H100 80GB HBM3")
    b3 = counts.bound_s(*counts.b3_f32_work(bh, t, t, d, 0, 0), card["tf32_flops"],
                        card["hbm_bytes_per_s"])
    b4 = counts.bound_s(*counts.b4_f32_work(bh, t, t, d, 0, 0), card["tf32_flops"],
                        card["hbm_bytes_per_s"])
    summary = {"ops": {"fold_f32_kernel<128>": [4 * b3, 1], "dkdv_kernel<float, 128>": [b4, 1],
                       "dq_kernel<float, 128>": [b4, 1]}, "device_s": 1.0}
    ctx = {"trace": [summary], "traced_steps": 1, "device_kind": "NVIDIA H100 80GB HBM3",
           "attn": {"bh": bh, "block": t, "d_head": d, "hops": [[(0, 0)]]}}
    assert readings.attention_share(ctx, "b3") == pytest.approx(25.0)
    assert readings.attention_share(ctx, "b4") == pytest.approx(50.0)
    both = 100 * (b3 + b4) / (4 * b3 + 2 * b4)
    assert readings.attention_share(ctx, "both") == pytest.approx(both)
    ctx["traced_steps"] = 2  # launches no longer one a hop a step: nothing to read
    assert readings.attention_share(ctx, "both") is None
