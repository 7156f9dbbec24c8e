"""Parity of the port's matmul and hbm probes (``tpu_operator_torch.
workloads.matmul_bench`` and ``hbm_bench``) with the JAX reference, on
identical numpy inputs, on the CPU."""

import json

import jax
import jax.extend as jex
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator.workloads import hbm_bench as jhbm  # noqa: E402
from tpu_operator.workloads import matmul_bench as jmm  # noqa: E402
from tpu_operator_torch.workloads import hbm_bench as thbm  # noqa: E402
from tpu_operator_torch.workloads import matmul_bench as tmm  # noqa: E402

# matmul chain: max |port - reference| over max |reference| on the final
# bf16 matrix.  Both sides take exact bf16 products summed in f32 (in other
# orders), scale in f32 and round to bf16 once per step, so they part only
# where an f32 sum lands on a bf16 rounding boundary: one bf16 step, in a
# few elements per step.  The chain is a power iteration: such differences
# contract instead of growing.  Measured on these inputs: 1.53e-3 at
# (128, 8 iters), in 99 of 16384 elements (one bf16 step, 2^-7, of a value
# in [1, 2), against a largest value of 5.09); 0 in the other three cases.
# The limit, 2^-8 = 3.9e-3, is 2.5 times that.
CHAIN_RTOL = 2.0**-8


def _reference_chain_matrix(size, iters, a, b):
    """The reference's chain program, cut before its final sum: the bf16
    matrix its ``_chain_fn(size, iters)`` reduces to the checksum."""
    chain = jmm._chain_fn(size, iters)
    inner = jax.make_jaxpr(chain)(a, b).jaxpr.eqns[0].params["jaxpr"]
    to_f32, total = inner.jaxpr.eqns[-2:]
    assert (to_f32.primitive.name, total.primitive.name) == ("convert_element_type",
                                                               "reduce_sum")
    cut = inner.jaxpr.replace(outvars=[to_f32.invars[0]])
    (c,) = jex.core.jaxpr_as_fun(jex.core.ClosedJaxpr(cut, inner.consts))(a, b)
    return np.asarray(c, np.float32), float(chain(a, b))


@pytest.mark.parametrize("size", [128, 256])
@pytest.mark.parametrize("bursts", [1, 2])
def test_matmul_chain_matches_reference(size, bursts):
    iters = bursts * tmm.NORM_PERIOD
    rng = np.random.default_rng(size + bursts)
    ta, tb = (torch.from_numpy(rng.standard_normal((size, size), dtype=np.float32)).bfloat16()
              for _ in range(2))
    ja, jb = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (ta, tb))
    ref, ref_sum = _reference_chain_matrix(size, iters, ja, jb)
    checksum, c = tmm._chain_fn(size, iters)(ta, tb)
    assert c.dtype == torch.bfloat16 and c.shape == (size, size)
    mine = c.float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(mine - ref).max() <= CHAIN_RTOL * scale
    # the checksum is the f32 sum of that matrix: off by at most the
    # elementwise limit times the element count, far less in practice
    assert abs(float(checksum) - ref_sum) <= CHAIN_RTOL * np.abs(ref).sum()
    assert float(checksum) == pytest.approx(float(c.float().sum()))


@pytest.mark.parametrize("size", [128, 256, 1024, 2048, 4096, 8192, 1 << 20])
@pytest.mark.parametrize("budget", [jmm._FLOP_BUDGET, 1e10])
def test_chain_iters_matches_reference(size, budget):
    assert tmm.chain_iters(size, budget) == jmm.chain_iters(size, budget)
    assert (tmm.NORM_PERIOD, tmm._MAX_CHAIN_ITERS, tmm._FLOP_BUDGET) == (
        jmm.NORM_PERIOD, jmm._MAX_CHAIN_ITERS, jmm._FLOP_BUDGET)


@pytest.mark.parametrize("mfu", [None, 0.3, 0.9])
@pytest.mark.parametrize("dominated", [False, True])
@pytest.mark.parametrize("min_mfu", [0.0, 0.5])
def test_mfu_gate_matches_reference(mfu, dominated, min_mfu):
    result = {"ok": True, "mfu": mfu, "overhead_dominated": dominated}
    assert tmm.apply_mfu_gate(dict(result), min_mfu) == jmm.apply_mfu_gate(dict(result), min_mfu)


def test_matmul_quick_benchmark_cpu():
    r = tmm.quick_benchmark(device="cpu")
    assert r["ok"] and r["backend"] == "cpu" and r["device_kind"] == "cpu"
    assert r["mfu"] is None and r["peak_bf16_tflops"] is None  # no peak for the CPU
    assert [x["size"] for x in r["results"]] == [256]
    assert r["results"][0]["iters"] == tmm.NORM_PERIOD and r["results"][0]["finite"]
    ref = jmm.matmul_benchmark(sizes=(128,), iters=jmm.NORM_PERIOD, best_of=2)
    assert set(r) == set(ref)
    assert set(r["results"][0]) == set(ref["results"][0])


def test_peaks_from_the_card_catalogue():
    assert tmm.peak_bf16_tflops("h100-sxm") == 989.0
    assert tmm.peak_bf16_tflops("unknown") == 0.0
    assert tmm.detect_generation("cpu") == "cpu"
    assert thbm._peak_hbm_gbps("h100-sxm") == 3350.0
    assert thbm._peak_hbm_gbps("cpu") == 0.0


@pytest.mark.parametrize("values", ["ones", "normal"])
def test_hbm_chain_bit_exact(values):
    """4 MB, 8 passes: each pass one f32 multiply by 1.0000001 rounded to
    f32, which is what XLA computes for the reference's loop."""
    n = 4 * 1024 * 1024 // 4
    rng = np.random.default_rng(7)
    x = np.ones(n, np.float32) if values == "ones" else rng.standard_normal(n, dtype=np.float32)
    expected = x.copy()
    for _ in range(8):
        expected = expected * np.float32(1.0000001)
    tx = torch.from_numpy(x.copy())
    y = thbm.scale_chain(tx, 8)
    np.testing.assert_array_equal(y.numpy().view(np.int32), expected.view(np.int32))
    np.testing.assert_array_equal(tx.numpy(), x)  # the input stays as it was
    ref = np.asarray(jax.jit(lambda v: jax.lax.fori_loop(0, 8, lambda i, s: s * 1.0000001, v))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(ref.view(np.int32), expected.view(np.int32))


def test_hbm_result_keys_match_reference():
    r = thbm.hbm_benchmark(size_mb=4, iters=8, best_of=2, device="cpu")
    ref = jhbm.hbm_benchmark(size_mb=4, iters=8, best_of=2)
    assert set(r) == set(ref)
    assert r["ok"] and r["gbps"] > 0 and r["backend"] == "cpu"
    for key in ("size_mb", "iters", "best_of", "fraction_of_peak"):
        assert r[key] == ref[key], key
    assert r["fraction_of_peak"] is None


def test_hbm_quick_benchmark_cpu_is_the_toy():
    r = thbm.quick_benchmark(device="cpu")
    assert r["ok"] and r["size_mb"] == 8 * 1024 * 1024 / 1e6 and r["iters"] == 4
    assert r["best_of"] == 2


@pytest.mark.parametrize(
    "widen, gbps, dominated, minimum",
    [(False, 100.0, False, 1000.0), (True, 100.0, False, 1000.0), (True, 100.0, False, 50.0),
     (True, 100.0, True, 1000.0), (True, 0.0, False, 10.0), (True, 100.0, False, 0.0)],
)
def test_hbm_gate_matches_reference(monkeypatch, widen, gbps, dominated, minimum):
    if widen:
        monkeypatch.setenv("HBM_GATE_BACKENDS", "cpu")
    else:
        monkeypatch.delenv("HBM_GATE_BACKENDS", raising=False)
    result = {"ok": True, "gbps": gbps, "backend": "cpu", "overhead_dominated": dominated}
    mine = thbm.apply_hbm_gate(dict(result), minimum)
    assert mine == jhbm.apply_hbm_gate(dict(result), minimum)
    assert mine["gated"] is (widen and not dominated and minimum > 0)


@pytest.mark.parametrize(
    "module, env",
    [("matmul_bench", {"MATMUL_SIZES": "128", "MATMUL_ITERS": "8", "MATMUL_MIN_MFU": "0.99"}),
     ("hbm_bench", {"HBM_SIZE_MB": "2", "HBM_ITERS": "4", "HBM_BEST_OF": "2"}),
     ("hbm_dma", {"HBM_SIZE_MB": "0.5", "HBM_ITERS": "2", "HBM_DMA_CHUNK_MB": "0.125",
                  "HBM_DMA_SLOTS": "2", "HBM_BEST_OF": "2"})],
)
def test_probe_main_prints_one_json_line(validation_root, monkeypatch, capsys, module, env):
    """Each probe's CLI on the CPU: one JSON line, exit 0 (the MFU gate
    cannot trip without a peak)."""
    import importlib

    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    mod = importlib.import_module(f"tpu_operator_torch.workloads.{module}")
    assert mod.main() == 0
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert line["ok"] and line["backend"] == "cpu"
