"""Parity of the port's MoE layer (``tpu_operator_torch.workloads.moe``)
with the JAX reference on identical inputs, on the CPU: routing, the
sharded layer's output and routing statistics, and the expert and router
weight gradients through both all-to-alls, at 1 and 4 ranks (gloo ranks
against a JAX mesh cut to as many of the conftest's CPU devices).

Inputs come from numpy with a seed; tokens on the 1/8 grid and the router
on the 1/128 grid, as the check quantizes them, so routing is exact on
both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from tpu_operator.workloads import moe as jmoe  # noqa: E402
from tpu_operator_torch.workloads import _ranks  # noqa: E402
from tpu_operator_torch.workloads import moe as tmoe  # noqa: E402

OUT_TOL = 1e-5    # f32 layer output, absolute
GRAD_RTOL = 1e-4  # weight gradients, relative to max |reference|


def _inputs(p, tokens_per_shard=16, d_model=16, d_hidden=32, experts_per_shard=1):
    return tmoe.acceptance_inputs(tokens_per_shard * p, d_model, d_hidden,
                                  p * experts_per_shard)


def _jax_layer(x, wr, w1, w2, p, capacity_factor):
    """The reference's layer on a p-device mesh: output, aux and the
    gradients of sum(out^2) with respect to wr, w1 and w2."""
    mesh = Mesh(np.array(jax.devices()[:p]), ("ep",))

    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    xs = put(x, P("ep", None))
    params = {"wr": put(wr, P(None, None)), "w1": put(w1, P("ep", None, None)),
              "w2": put(w2, P("ep", None, None))}

    def loss(params):
        out, aux = jmoe.moe_layer(xs, params, mesh, capacity_factor)
        return jnp.sum(jnp.square(out)), (out, aux)

    grads, (out, aux) = jax.jit(jax.grad(loss, has_aux=True))(params)
    return np.asarray(out), {k: float(v) for k, v in aux.items()}, \
        {k: np.asarray(v) for k, v in grads.items()}


def _layer_rank(rank, n, device, x, wr, w1, w2, capacity_factor):
    """The port's layer on one rank: its tokens and experts, the gradients
    of its share of sum(out^2); the router's gradient summed over the ranks
    (it is replicated).  Rank 0 returns the gathered output and gradients."""
    import torch.distributed as dist

    params = tmoe.moe_params_from_jax(wr, w1, w2, rank, n)
    for v in params.values():
        v.requires_grad_()
    n_loc = x.shape[0] // n
    xs = torch.from_numpy(x[rank * n_loc:(rank + 1) * n_loc])
    out, aux = tmoe.moe_layer_sharded(xs, params["wr"], params["w1"], params["w2"],
                                      capacity_factor)
    out.square().sum().backward()
    gwr = params["wr"].grad
    if n > 1:
        dist.all_reduce(gwr)

    def gather(t):
        if n == 1:
            return t.detach()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.detach().contiguous())
        return torch.cat(parts)

    return {"out": gather(out).tolist(), "aux": {k: float(v) for k, v in aux.items()},
            "grads": {"wr": gwr.tolist(), "w1": gather(params["w1"].grad).tolist(),
                      "w2": gather(params["w2"].grad).tolist()}}


def _torch_layer(x, wr, w1, w2, p, capacity_factor):
    kwargs = dict(x=x, wr=wr, w1=w1, w2=w2, capacity_factor=capacity_factor)
    if p == 1:
        r = _layer_rank(0, 1, torch.device("cpu"), **kwargs)
    else:
        r = _ranks.run(_layer_rank, p, "cpu", timeout_s=120, **kwargs)
    return np.asarray(r["out"], np.float32), r["aux"], \
        {k: np.asarray(v, np.float32) for k, v in r["grads"].items()}


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("capacity_factor", [2.0, 0.25], ids=["roomy", "starved"])
def test_route_top1_matches_reference(capacity_factor):
    """Dispatch bit for bit, the combine weights (softmax probabilities,
    another exp) within 1e-6, and the routing statistics, on exact logits;
    the starved capacity drops tokens on both sides alike."""
    x, wr, _, _ = _inputs(1, tokens_per_shard=64, experts_per_shard=8)
    logits = x @ wr
    c = tmoe._capacity(64, 8, capacity_factor)
    ref = jmoe.route_top1(jnp.asarray(logits), c)
    mine = tmoe.route_top1(torch.from_numpy(logits), c)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(mine[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=0)
    assert float(mine[2]["dropped_fraction"]) == float(ref[2]["dropped_fraction"])
    np.testing.assert_allclose(float(mine[2]["aux_loss"]), float(ref[2]["aux_loss"]),
                               rtol=1e-6)
    if capacity_factor < 1:
        assert float(mine[2]["dropped_fraction"]) > 0.25


def test_route_top1_takes_the_first_maximum():
    """Tied logits route to the lowest expert index, as jnp.argmax does."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0], [0.0, 0.0, 5.0, 5.0]],
                      np.float32)
    ref = jmoe.route_top1(jnp.asarray(logits), 2)[0]
    mine = tmoe.route_top1(torch.from_numpy(logits), 2)[0]
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert mine.sum(-1).argmax(-1).tolist() == [1, 0, 2]


def test_dense_reference_matches_reference():
    """The port's dense truth against the reference's, four shards, two
    experts each: the same per-shard capacity accounting."""
    x, wr, w1, w2 = _inputs(4, experts_per_shard=2)
    ref = jmoe.dense_reference(*map(jnp.asarray, (x, wr, w1, w2)), 4, 0.5)
    mine = tmoe.dense_reference(*map(torch.from_numpy, (x, wr, w1, w2)), 4, 0.5)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("capacity_factor", [2.0, 0.25], ids=["roomy", "starved"])
def test_moe_layer_and_gradients_match_jax(p, capacity_factor):
    """The sharded layer at p ranks against the reference on a p-device
    mesh: output within 1e-5, the same dropped fraction, and the weight
    gradients within 1e-4 of the largest (a p-fold gradient would miss by
    far).  The reference's own check: the gradient reaches the experts."""
    x, wr, w1, w2 = _inputs(p, experts_per_shard=2)
    j_out, j_aux, j_grads = _jax_layer(x, wr, w1, w2, p, capacity_factor)
    t_out, t_aux, t_grads = _torch_layer(x, wr, w1, w2, p, capacity_factor)
    np.testing.assert_allclose(t_out, j_out, atol=OUT_TOL, rtol=0)
    assert t_aux["dropped_fraction"] == j_aux["dropped_fraction"]
    assert abs(t_aux["aux_loss"] - j_aux["aux_loss"]) <= 1e-6 * abs(j_aux["aux_loss"])
    for name in ("wr", "w1", "w2"):
        assert _rel(t_grads[name], j_grads[name]) <= GRAD_RTOL, name
    norms = np.linalg.norm(t_grads["w1"].reshape(2 * p, -1), axis=-1)
    assert np.all(np.isfinite(norms)) and int(np.sum(norms > 0)) >= p


def test_params_from_jax_slices_the_experts():
    wr, w1, w2 = tmoe.moe_weights(8, 16, 8)
    mine = tmoe.moe_params_from_jax(wr, w1, w2, 2, 4)
    np.testing.assert_array_equal(mine["wr"].numpy(), wr)
    np.testing.assert_array_equal(mine["w1"].numpy(), w1[4:6])
    np.testing.assert_array_equal(mine["w2"].numpy(), w2[4:6])
    with pytest.raises(ValueError, match="split"):
        tmoe.moe_params_from_jax(wr, w1, w2, 0, 3)


@pytest.mark.parametrize("experts_per_shard", [1, 2])
def test_moe_acceptance_four_ranks(experts_per_shard):
    """The check at 4 gloo ranks, the reference's test_moe_matches_dense_
    reference: ok within its own 1e-4, and the roomy capacity drops little."""
    r = tmoe.acceptance(experts_per_shard=experts_per_shard, world_size=4, device="cpu")
    assert r["ok"], r
    assert r["devices"] == 4 and r["experts"] == 4 * experts_per_shard
    assert r["max_error"] < 1e-4 and r["dropped_fraction"] < 0.05
    assert r["strategy"] == "ep-all-to-all-top1"


def test_moe_capacity_drops_four_ranks():
    """Starved capacity (the reference's test_moe_capacity_drops_match_
    reference): tokens are dropped, and the sharded path drops exactly the
    ones the dense reference drops."""
    r = tmoe.acceptance(capacity_factor=0.25, world_size=4, device="cpu")
    assert r["ok"], r
    assert r["dropped_fraction"] > 0.0


def test_quick_check_needs_a_card_or_the_cpu_asked_for(monkeypatch):
    monkeypatch.delenv("TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmoe.quick_check()
