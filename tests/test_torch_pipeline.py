"""Parity of the port's GPipe pipe (``tpu_operator_torch.workloads.
pipeline``) with the JAX reference on identical inputs, on the CPU, at 1 and
4 ranks (gloo ranks against a JAX mesh cut to as many of the conftest's CPU
devices): the forward, and the stage-weight gradients through the hops and
the replicating sum (a p-fold gradient, from summing the replicated
output's cotangent again, would miss by far).

Weights and microbatches come from numpy with a seed, the same on both
sides; the weights are f32 as the reference's ``pipeline_params`` makes
them, and bf16 in one case to run the bf16 products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from tpu_operator.workloads import pipeline as jpipe  # noqa: E402
from tpu_operator_torch.workloads import _ranks  # noqa: E402
from tpu_operator_torch.workloads import pipeline as tpipe  # noqa: E402

FWD_RTOL = 1e-2   # forward, of max |reference|
GRAD_RTOL = 1e-4  # weight gradients, of max |reference|


def _inputs(p, dtype="float32", m=6, mb=4, d=16, h=32):
    w1, w2 = tpipe.pipeline_params(p, d, h, seed=p)
    if dtype == "bfloat16":
        w1, w2 = (np.asarray(jnp.asarray(w, jnp.bfloat16)) for w in (w1, w2))
    x = np.random.default_rng(9).standard_normal((m, mb, d), dtype=np.float32)
    return x, w1, w2


def _jax_pipe(x, w1, w2, p):
    """The reference's pipe on a p-device mesh: output, and the gradients
    of mean(out^2) with respect to every stage's weights."""
    mesh = Mesh(np.array(jax.devices()[:p]), ("pp",))
    spec = NamedSharding(mesh, P("pp", None, None))
    jw1, jw2 = (jax.device_put(jnp.asarray(w), spec) for w in (w1, w2))
    jx = jnp.asarray(x)

    def loss(w1, w2):
        out = jpipe.pipeline_apply(jx, w1, w2, mesh)
        return jnp.mean(jnp.square(out)), out

    (g1, g2), out = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(jw1, jw2)
    return (np.asarray(out),
            *(np.asarray(g.astype(jnp.float32)) for g in (g1, g2)))


def _pipe_rank(rank, n, device, x, w1, w2):
    """The port's pipe on one stage; rank 0 returns the output and every
    stage's weight gradients (of mean(out^2) on the replicated output)."""
    import torch.distributed as dist

    sw1, sw2 = (w.requires_grad_() for w in tpipe.pipeline_params_from_jax(w1, w2, rank))
    out = tpipe.pipeline_sharded(torch.from_numpy(x), sw1, sw2)
    out.square().mean().backward()

    def gather(t):
        t = t.detach().float()
        if n == 1:
            return t[None]
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous())
        return torch.stack(parts)

    return {"out": out.detach().tolist(), "g1": gather(sw1.grad).tolist(),
            "g2": gather(sw2.grad).tolist()}


def _torch_pipe(x, w1, w2, p):
    kwargs = dict(x=x, w1=w1, w2=w2)
    if p == 1:
        r = _pipe_rank(0, 1, torch.device("cpu"), **kwargs)
    else:
        r = _ranks.run(_pipe_rank, p, "cpu", timeout_s=120, **kwargs)
    return tuple(np.asarray(r[k], np.float32) for k in ("out", "g1", "g2"))


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_fn_matches_reference(dtype):
    x, w1, w2 = _inputs(1, dtype)
    ref = jpipe.stage_fn(jnp.asarray(x[0]), jnp.asarray(w1[0]), jnp.asarray(w2[0]))
    sw1, sw2 = tpipe.pipeline_params_from_jax(w1, w2, 0)
    assert sw1.dtype == getattr(torch, dtype)
    mine = tpipe.stage_fn(torch.from_numpy(x[0]), sw1, sw2)
    assert mine.dtype == torch.float32
    assert _rel(mine.numpy(), np.asarray(ref)) <= FWD_RTOL


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_matches_jax(p, dtype):
    """The forward within 1e-2 of max |reference| and, with the reference's
    f32 weights, the stage-weight gradients within 1e-4 of the largest.
    bf16 weights get bf16 gradients, which both frameworks sum over the
    ticks in bf16 in their own order: only their forward is held."""
    x, w1, w2 = _inputs(p, dtype)
    j_out, j_g1, j_g2 = _jax_pipe(x, w1, w2, p)
    t_out, t_g1, t_g2 = _torch_pipe(x, w1, w2, p)
    assert t_out.shape == j_out.shape == x.shape
    assert _rel(t_out, j_out) <= FWD_RTOL
    if dtype == "float32":
        assert _rel(t_g1, j_g1) <= GRAD_RTOL
        assert _rel(t_g2, j_g2) <= GRAD_RTOL


def test_pipeline_acceptance_four_ranks():
    """The check at 4 gloo ranks (the reference's test_pipeline_matches_
    sequential_reference): ok within its own 1e-3, M + p - 1 ticks."""
    r = tpipe.acceptance(world_size=4, device="cpu")
    assert r["ok"], r
    assert r["devices"] == 4 and r["stages"] == 4 and r["ticks"] == 11
    assert r["bubble_fraction"] == round(3 / 11, 4) and r["max_error"] < 1e-3
    assert r["strategy"] == "pp-gpipe-microbatch"


def test_params_from_jax_takes_the_stage():
    w1, w2 = tpipe.pipeline_params(4, 8, 16)
    s1, s2 = tpipe.pipeline_params_from_jax(w1, w2, 2)
    np.testing.assert_array_equal(s1.numpy(), w1[2])
    np.testing.assert_array_equal(s2.numpy(), w2[2])
    mesh = Mesh(np.array(jax.devices()[:4]), ("pp",))
    j1, _ = jpipe.pipeline_params(mesh, 8, 16)
    assert np.asarray(j1).dtype == w1.dtype == np.float32


def test_quick_check_needs_a_card_or_the_cpu_asked_for(monkeypatch):
    monkeypatch.delenv("TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.quick_check()
