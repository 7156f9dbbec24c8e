"""Parity of the port's long-context attention (``tpu_operator_torch.
workloads.longctx``: the flash forward, kernel B5's plain version, and the
prefill and decode checks) with the JAX reference, on the CPU.

Inputs are made with numpy from a seed, rounded to bf16 once and handed to
both sides; the reference's Pallas kernel runs in interpret mode, as its own
tests run it.  Shapes are the reference tests' (``test_workloads.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator.workloads import longctx as jlc  # noqa: E402
from tpu_operator_torch.kernels import _build  # noqa: E402
from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402
from tpu_operator_torch.workloads import longctx as tlc  # noqa: E402

OUT_TOL = 2e-2     # bf16 outputs
STATE_RTOL = 1e-3  # lse: f32, sums in another order


def _merged(rng, b, t, h, d):
    """(torch, jax) merged-layout [B*H, T, D] bf16 tensors with the same
    values."""
    x = torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32)).bfloat16()
    mine = tlc._merge(x)
    return mine, jlc._merge(jnp.asarray(x.float().numpy(), jnp.bfloat16))


def _compare(mine, ref):
    out, lse = mine
    ref_out, ref_lse = (np.asarray(r, np.float32) for r in ref)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert out.shape == ref_out.shape and lse.shape == ref_lse.shape
    assert np.max(np.abs(out.float().numpy() - ref_out)) <= OUT_TOL
    rel = np.abs(lse.numpy() - ref_lse) / np.maximum(np.abs(ref_lse), 1.0)
    assert np.max(rel) <= STATE_RTOL


@pytest.mark.parametrize("t, want, expected", [
    (64, 1024, 64), (4096, 1024, 1024), (136, 32, 8), (48, 32, 24), (20, 16, 20), (1000, 1024, 1000),
])
def test_block_div_matches_reference(t, want, expected):
    assert tlc._block_div(t, want) == expected == jlc._block_div(t, want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_local_matches_pallas(causal):
    rng = np.random.default_rng(4)
    (tq, jq), (tk, jk), (tv, jv) = (_merged(rng, 2, 128, 2, 8) for _ in range(3))
    ref = jlc.flash_attention_local(jq, jk, jv, causal, block_k=32, block_q=32)
    _compare(tlc.flash_attention_local(tq, tk, tv, causal, block_k=32, block_q=32), ref)


def test_decode_tail_matches_pallas():
    """The decode shape: an 8-row query tail at q_off = t - 8."""
    rng = np.random.default_rng(6)
    (tq, jq), (tk, jk), (tv, jv) = (_merged(rng, 1, 128, 2, 8) for _ in range(3))
    ref = jlc.flash_attention_local(jq[:, -8:], jk, jv, causal=True, block_k=32, q_off=120)
    mine = tlc.flash_attention_local(tq[:, -8:].contiguous(), tk, tv, causal=True, block_k=32,
                                     q_off=120)
    _compare(mine, ref)


@pytest.mark.parametrize("t, block_k, block_q", [(40, 32, 16), (136, 16, 8)])
def test_ragged_sequence_matches_pallas(t, block_k, block_q):
    """Sequences the requested blocks do not divide (``_block_div`` clamps
    both axes): the serving engine's page shapes."""
    rng = np.random.default_rng(9)
    (tq, jq), (tk, jk), (tv, jv) = (_merged(rng, 1, t, 2, 8) for _ in range(3))
    ref = jlc.flash_attention_local(jq, jk, jv, causal=True, block_k=block_k, block_q=block_q)
    _compare(tlc.flash_attention_local(tq, tk, tv, causal=True, block_k=block_k,
                                       block_q=block_q), ref)


def test_fully_masked_rows_give_zero_and_neg_inf():
    """Queries before every key (k_off past q_off + Tq): out 0, lse NEG_INF,
    as the reference's guard gives."""
    rng = np.random.default_rng(7)
    (tq, jq), (tk, jk), (tv, jv) = (_merged(rng, 1, 16, 2, 8) for _ in range(3))
    out, lse = tlc.flash_attention_local(tq, tk, tv, causal=True, k_off=64)
    ref_out, ref_lse = jlc.flash_attention_local(jq, jk, jv, causal=True, k_off=64)
    assert not out.float().any() and not np.asarray(ref_out, np.float32).any()
    assert (lse == fa.NEG_INF).all() and bool(jnp.all(ref_lse == jlc.NEG_INF))


@pytest.mark.parametrize("off", [0, 96])
def test_tile_reference_matches_jax(off):
    rng = np.random.default_rng(8)
    (tq, jq), (tk, jk), (tv, jv) = (_merged(rng, 1, 128, 2, 8) for _ in range(3))
    ref = jlc._tile_reference(jq[:, off:off + 32], jk, jv, off, True)
    mine = tlc._tile_reference(tq[:, off:off + 32], tk, tv, off, True)
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32), atol=OUT_TOL)


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(10)
    (tq, _), (tk, _), (tv, _) = (_merged(rng, 1, 64, 2, 8) for _ in range(3))
    before = _build.launches()
    out, lse = tlc.flash_attention_local(tq, tk, tv, True, block_k=16, block_q=16)
    ref = fa.flash_attention_local_reference(tq, tk, tv, True, 16, 16)
    assert torch.equal(out, ref[0]) and torch.equal(lse, ref[1])
    assert _build.launches() == before


# the reference's result keys (prefill_benchmark / decode_benchmark)
PREFILL_KEYS = {"ok", "seq", "heads", "head_dim", "block_k", "causal", "time_s",
                "overhead_dominated", "tokens_per_sec", "attn_tflops", "attn_tflops_spread",
                "max_error", "spot_tiles", "backend"}
DECODE_KEYS = {"ok", "seq", "heads", "head_dim", "batch", "decode_us", "decode_us_median",
               "decode_us_max", "decodes_per_sec", "cache_gbps", "cache_gbps_min",
               "overhead_dominated", "backend", "generation"}


def test_prefill_check_cpu():
    r = tlc.quick_check(device="cpu")
    assert r["ok"], r
    assert set(r) == PREFILL_KEYS
    assert r["seq"] == 256 and r["tokens_per_sec"] > 0 and r["max_error"] < OUT_TOL
    assert r["spot_tiles"] == [0, 224] and r["backend"] == "cpu"


def test_decode_check_cpu():
    r = tlc.decode_quick_check(device="cpu")
    assert r["ok"], r
    assert set(r) == DECODE_KEYS  # no peak on record for the CPU: no fraction
    assert r["decode_us"] > 0 and r["cache_gbps"] > 0 and r["generation"] == "cpu"


def test_decode_benchmark_nondivisible_cache():
    """A cache length that block_k does not divide, batch 1 spelled out; the
    cache bytes are K and V in bf16 over batch x heads rows."""
    r = tlc.decode_benchmark(seq=136, heads=2, head_dim=8, batch=1, block_k=32, iters=2,
                             best_of=2, device="cpu")
    assert r["ok"], r
    expected = 2.0 * (1 * 2) * 136 * 8 * 2
    assert r["cache_gbps"] * (r["decode_us"] / 1e6) * 1e9 == pytest.approx(expected, rel=1e-6)


def test_decode_benchmark_batched():
    r = tlc.decode_benchmark(seq=64, heads=2, head_dim=8, batch=2, block_k=32, iters=2,
                             best_of=2, device="cpu")
    assert r["ok"] and r["batch"] == 2
    assert r["decodes_per_sec"] * (r["decode_us"] / 1e6) == pytest.approx(2)
