"""Parity of the port's Ulysses attention (``tpu_operator_torch.workloads.
ulysses``) with the JAX reference on identical inputs, on the CPU, at 1 and
4 ranks (gloo ranks against a JAX mesh cut to as many of the conftest's CPU
devices).  The four-rank cases are what pin the tiled all-to-all's layout:
a head group or a sequence block sent to the wrong rank breaks them.

Inputs are bf16 values drawn with numpy from a seed, the same on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from tpu_operator.workloads import ulysses as july  # noqa: E402
from tpu_operator_torch.workloads import ring_attention as tra  # noqa: E402
from tpu_operator_torch.workloads import ulysses as tuly  # noqa: E402

OUT_TOL = 2e-2  # bf16 outputs, the check's own bound


def _qkv(seed, shape):
    """Three bf16 draws as f32 numpy (exact bf16 values)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 .bfloat16().float().numpy() for _ in range(3))


def _jax_ulysses(q, k, v, p, causal):
    mesh = Mesh(np.array(jax.devices()[:p]), ("x",))
    sharding = NamedSharding(mesh, P(None, "x"))
    args = (jax.device_put(jnp.asarray(a, jnp.bfloat16), sharding) for a in (q, k, v))
    out = jax.jit(lambda *a: july.ulysses_attention(*a, mesh, causal=causal))(*args)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ulysses_matches_jax(p, causal):
    """The gathered output at p ranks against the reference's at p devices:
    2 x 16 tokens per rank, 8 heads of 8."""
    q, k, v = _qkv(p, (2, 16 * p, 8, 8))
    ref = _jax_ulysses(q, k, v, p, causal)
    mine = tuly.ulysses_attention(q, k, v, causal=causal, world_size=p, device="cpu")
    assert mine.shape == ref.shape
    assert float(np.max(np.abs(mine - ref))) < OUT_TOL


def test_ulysses_agrees_with_ring():
    """Both sequence-parallel strategies of the port compute the same exact
    attention: at 4 ranks their outputs agree within the bf16 bound (the
    reference's test_ulysses_agrees_with_ring)."""
    q, k, v = _qkv(1, (2, 64, 8, 16))
    ring = tra.ring_attention(q, k, v, causal=True, world_size=4, device="cpu")
    uly = tuly.ulysses_attention(q, k, v, causal=True, world_size=4, device="cpu")
    assert float(np.max(np.abs(ring - uly))) < OUT_TOL


def test_ulysses_rejects_indivisible_heads():
    """3 heads over 2 ranks: the reference's ValueError, raised in a rank."""
    q, k, v = _qkv(2, (1, 8, 3, 8))
    with pytest.raises(RuntimeError, match="divisible"):
        tuly.ulysses_attention(q, k, v, world_size=2, device="cpu")


def test_ulysses_acceptance_rounds_heads_up():
    """The check over 4 ranks with 6 heads runs 8, as the reference rounds
    them up, and passes within its own 2e-2."""
    r = tuly.acceptance(seq_per_chip=16, heads=6, head_dim=8, world_size=4, device="cpu")
    assert r["ok"], r
    assert r["devices"] == 4 and r["heads"] == 8 and r["seq"] == 64
    assert r["strategy"] == "ulysses-all-to-all" and r["max_error"] < OUT_TOL


def test_quick_check_needs_a_card_or_the_cpu_asked_for(monkeypatch):
    monkeypatch.delenv("TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuly.quick_check()
