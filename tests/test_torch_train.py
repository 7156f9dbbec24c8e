"""Parity of the port's training path (``collectives.transformer_step``,
``transformer_burn_in`` and ``train_bench``) with the JAX reference on the
CPU.

The reference's own weights and batch are carried across (``np.asarray``
of its arrays, then ``transformer_params_from_jax``).  The JAX step runs
with its default ``check_vma=True`` on the jnp path: ``check_vma=False``
changes the MLP's gradient transposes (``collectives.py:717-722``), so it
is no oracle.  Four-rank cases run four gloo ranks against a four-device
JAX mesh, which is (dp 2, mp 2) on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from tpu_operator.workloads import collectives as jc  # noqa: E402
from tpu_operator.workloads import train_bench as jtb  # noqa: E402
from tpu_operator_torch.workloads import collectives as tc  # noqa: E402
from tpu_operator_torch.workloads import train_bench as ttb  # noqa: E402

D_MODEL, D_HIDDEN, HEADS = 64, 128, 4
X_SHAPE = (4, 32, D_MODEL)  # 2 sequences and 16 tokens per rank on (2, 2)
LOSS_RTOL = 2e-3    # the reference's own 1-vs-8-device pin allows 2e-2
WEIGHT_ATOL = 2e-2  # updated weights, max abs (the reference's pin)
# the update itself, lr * gradient, about 1e-3 here: max |mine - ref| over
# max |ref|.  Both sides are f32, so 1e-3 leaves room for summation order
# only; a gradient scaled by dp, or by an mp transpose, is off by 1 or more
UPDATE_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def _jax_step(n: int):
    """(weights, x, loss, new weights) of one reference step on ``n``
    devices: full host arrays, f32."""
    mesh = jc.make_mesh(n_devices=n)
    params = jc.transformer_params(mesh, d_model=D_MODEL, d_hidden=D_HIDDEN)
    x = jax.device_put(jax.random.normal(jax.random.PRNGKey(7), X_SHAPE, jnp.bfloat16),
                       NamedSharding(mesh, P("dp", "mp", None)))
    loss, new = jax.jit(functools.partial(jc.transformer_step, mesh, HEADS))(params, x)

    def host(tree):
        return {k: np.asarray(v, np.float32) for k, v in tree.items()}

    return host(params), np.asarray(x, np.float32), float(loss), host(new)


@functools.lru_cache(maxsize=None)
def _port_step(n: int, use_kernel: bool, tmp: str):
    weights, x, _, _ = _jax_step(1)
    path = f"{tmp}/new-{n}-{use_kernel}.npz"
    r = tc.transformer_run(weights, x, HEADS, steps=1, world_size=n, use_kernel=use_kernel,
                           device="cpu", out_path=path)
    return r, dict(np.load(path))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("train"))


def _update_err(new, ref, old) -> float:
    upd, ref_upd = new - old, ref - old
    return float(np.abs(upd - ref_upd).max() / np.abs(ref_upd).max())


def test_reference_weights_are_f32_and_equal_across_meshes():
    """Fact 1 of the port: the reference's transformer weights are f32 (bf16
    draws times a float64 scale), so q/k/v and attention are f32."""
    w1, _, _, _ = _jax_step(1)
    w4, _, _, _ = _jax_step(4)
    for name in tc.TRANSFORMER_WEIGHTS:
        assert w1[name].dtype == np.float32
        np.testing.assert_array_equal(w1[name], w4[name])


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("n", [1, 4])
def test_transformer_step_matches_jax(tmp, n, use_kernel):
    """Loss and updated weights after one step, against the reference's
    step on an n-device mesh.  The kernel path runs B3 and B4's plain
    versions here."""
    weights, _, ref_loss, ref_new = _jax_step(n)
    r, new = _port_step(n, use_kernel, tmp)
    assert r["ok"] and r["devices"] == n
    assert r["mesh"] == dict(zip(("dp", "mp"), tc._split_dp_mp(n)))
    assert r["attention_kernel"] == ("plain-flash-fwd-bwd" if use_kernel else "plain")
    assert r["losses"][0] == pytest.approx(ref_loss, rel=LOSS_RTOL)
    weight_err = {name: float(np.abs(new[name] - ref_new[name]).max())
                  for name in tc.TRANSFORMER_WEIGHTS}
    update_err = {name: _update_err(new[name], ref_new[name], weights[name])
                  for name in tc.TRANSFORMER_WEIGHTS}
    # the measured differences (shown by ``pytest -rP``)
    print(f"{n} rank(s), {r['attention_kernel']}: loss rel "
          f"{abs(r['losses'][0] - ref_loss) / ref_loss:.3g}, weights max abs "
          f"{max(weight_err.values()):.3g}, updates max rel {max(update_err.values()):.3g}")
    for name in tc.TRANSFORMER_WEIGHTS:
        assert weight_err[name] <= WEIGHT_ATOL, name
        assert update_err[name] <= UPDATE_RTOL, name


def test_four_rank_update_equals_one_rank_update(tmp):
    """Fact 2 of the port: the step follows the exact gradient of the
    global mean loss, with no dp scaling, so four ranks update every weight
    as one rank does."""
    weights = _jax_step(1)[0]
    _, one = _port_step(1, False, tmp)
    _, four = _port_step(4, False, tmp)
    errs = {name: _update_err(four[name], one[name], weights[name])
            for name in tc.TRANSFORMER_WEIGHTS}
    print(f"4 vs 1 rank(s): updates max rel {max(errs.values()):.3g}")
    for name, err in errs.items():
        assert err <= UPDATE_RTOL, name


def test_params_from_jax_shard_like_the_reference():
    """Rank r of a dp2 x mp2 mesh holds the reference's shard on device r."""
    jmesh = jc.make_mesh(n_devices=4)
    params = jc.transformer_params(jmesh, d_model=D_MODEL, d_hidden=D_HIDDEN)
    full = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for rank, dev in enumerate(jmesh.devices.flat):
        mesh = tc.Mesh(dp=2, mp=2, rank=rank, device=torch.device("cpu"))
        mine = tc.transformer_params_from_jax(full, mesh)
        for key in tc.TRANSFORMER_WEIGHTS:
            (shard,) = [s for s in params[key].addressable_shards if s.device == dev]
            np.testing.assert_array_equal(mine[key].numpy(), np.asarray(shard.data))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    x = np.random.default_rng(4).standard_normal((2, 8, 32), dtype=np.float32)
    ref = jc._rmsnorm(jnp.asarray(x, dtype))
    mine = tc._rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(mine.dtype).endswith(dtype)
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-6 if dtype == "float32" else 1e-2)


def test_transformer_weights_from_seed():
    w = tc.transformer_weights(32, 48, seed=3)
    assert list(w) == list(tc.TRANSFORMER_WEIGHTS)
    assert w["w1"].shape == (32, 48) and w["w2"].shape == (48, 32)
    assert all(a.dtype == np.float32 for a in w.values())
    np.testing.assert_array_equal(w["wq"], tc.transformer_weights(32, 48, seed=3)["wq"])


def test_transformer_burn_in_four_ranks():
    """The check's defaults on four gloo ranks: the reference's (2, 2)
    mesh, and a loss that falls at every step."""
    r = tc.transformer_burn_in(world_size=4, device="cpu")
    assert r["ok"] and r["mesh"] == {"dp": 2, "mp": 2} and r["devices"] == 4
    losses = r["losses"]
    assert len(losses) == 3 and all(b < a for a, b in zip(losses, losses[1:])), losses
    assert len(r["step_s"]) == 3 and r["backend"] == "cpu"
    assert r["launches"] == {"flash_block_update_f32": 0, "flash_block_backward": 0}


@pytest.mark.parametrize("shape", [(4, 2048, 4096, 16384), (2, 32, 64, 128), (8, 4096, 512, 2048)])
def test_step_model_flops_matches_reference(shape):
    assert ttb.step_model_flops(*shape) == jtb.step_model_flops(*shape)


# train_bench.py:132-162, the keys of the reference's result (train_mfu*
# only where the chip's peak is known)
REFERENCE_KEYS = {
    "ok", "devices", "mesh", "batch", "seq", "d_model", "d_hidden", "steps_per_run",
    "overhead_ms", "overhead_dominated", "step_time_ms", "step_time_ms_median",
    "step_time_ms_max", "tokens_per_sec", "tokens_per_sec_spread", "model_tflops", "backend",
    "generation", "attention_kernel",
}


def test_train_quick_check_on_cpu():
    """The reference's tiny CPU shapes on the plain path; no peak on the
    CPU, so no MFU."""
    r = ttb.quick_check(device="cpu")
    assert r["ok"] and np.isfinite(r["loss"]) and r["tokens_per_sec"] > 0
    assert REFERENCE_KEYS <= set(r) and "train_mfu" not in r
    assert (r["batch"], r["seq"], r["d_model"], r["d_hidden"]) == (2, 32, 64, 128)
    assert r["attention_kernel"] == "plain" and r["generation"] == "cpu"
    assert len(r["step_times_ms"]) == 2 and r["steps_per_run"] == 2


def test_train_benchmark_four_ranks():
    """The benchmark's multi-rank path on four gloo ranks, through the
    kernels' plain versions: (2, 2) mesh, the global batch and sequence."""
    r = ttb.train_benchmark(batch_per_dp=2, seq_per_mp=16, d_model=32, d_hidden=64, heads=2,
                            steps=2, best_of=2, world_size=4, use_kernel=True, device="cpu")
    assert r["ok"] and r["devices"] == 4 and r["mesh"] == {"dp": 2, "mp": 2}
    assert (r["batch"], r["seq"]) == (4, 32) and r["attention_kernel"] == "plain-flash-fwd-bwd"
    assert np.isfinite(r["loss_last"]) and r["loss_last"] < r["loss"]
