"""Parity of the port's gate checks (``tpu_operator_torch.workloads.
collectives``) with the JAX reference, on identical numpy inputs, on the CPU.

Multi-rank cases run four gloo ranks, the counterpart of the reference
tests' virtual CPU devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from tpu_operator.workloads import collectives as jc  # noqa: E402
from tpu_operator_torch.kernels import vector_add as va  # noqa: E402
from tpu_operator_torch.obs import flight  # noqa: E402
from tpu_operator_torch.workloads import collectives as tc  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(64, 512), (300, 600)])
def test_vector_add_plain_version_matches_pallas(shape, dtype):
    """(300, 600) has partial edge blocks in both dimensions of the Pallas
    grid.  One add rounded once to the dtype either way: exact equality
    (bf16 and f16 compared after an exact widening to f32)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, dtype=np.float32)
    y = rng.standard_normal(shape, dtype=np.float32)
    tx, ty = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, y))
    # the same rounded inputs on both sides
    jx, jy = (jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)) for t in (tx, ty))
    ref = jc.pallas_vector_add(jx, jy)
    assert ref.dtype == jnp.dtype(dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    plain = va.vector_add_reference(tx, ty)
    assert plain.dtype == tx.dtype
    np.testing.assert_array_equal(plain.float().numpy(), ref)
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(va.vector_add_kernel(tx, ty).float().numpy(), ref)


def test_vector_add_check():
    r = tc.vector_add(1 << 14, device="cpu")
    assert r["ok"] and r["max_error"] == 0.0
    assert r["n"] == 1 << 14 and r["backend"] == "cpu"
    assert set(r) == set(jc.vector_add(1 << 14))


def _jax_burn_in(n: int, steps: int = 3):
    mesh = jc.make_mesh(n_devices=n)
    params = jc.burn_in_params(mesh, d_model=128, d_hidden=256)
    x = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(1), (16, 128), jnp.bfloat16),
        NamedSharding(mesh, P("dp", None)),
    )
    w1, w2, xs = (np.asarray(a, np.float32) for a in (params["w1"], params["w2"], x))
    step = jax.jit(functools.partial(jc.burn_in_step, mesh))
    losses = []
    for _ in range(steps):
        loss, params = step(params, x)
        losses.append(float(loss))
    return mesh, w1, w2, xs, losses


@pytest.mark.parametrize("world_size", [1, 4])
def test_burn_in_trajectory_matches_jax(world_size):
    """The reference's weights carried across by params_from_jax, the same
    batch, three SGD steps.  Both sides compute in f32 (the reference's
    burn-in weights promote to f32), so 1e-4 relative leaves room for
    summation order only; at dp2 x mp2 a wrong transpose of the mp sum, or a
    dp mean where the reference sums, would move the second loss by far
    more."""
    mesh, w1, w2, xs, jax_losses = _jax_burn_in(world_size)
    r = tc.burn_in_run(w1, w2, xs, steps=3, world_size=world_size, device="cpu")
    assert r["ok"] and r["devices"] == world_size
    assert r["mesh"] == dict(zip(mesh.axis_names, mesh.devices.shape))
    assert r["losses"] == pytest.approx(jax_losses, rel=1e-4)
    losses = r["losses"]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factorization_matches_reference(n):
    assert tc._split_dp_mp(n) == jc.make_mesh(n_devices=n).devices.shape


def test_params_from_jax_shards_like_the_reference():
    """Rank r of a dp2 x mp2 mesh holds the reference's shard on device r."""
    jmesh = jc.make_mesh(n_devices=4)
    params = jc.burn_in_params(jmesh, d_model=128, d_hidden=256)
    w1, w2 = (np.asarray(params[k], np.float32) for k in ("w1", "w2"))
    for rank, dev in enumerate(jmesh.devices.flat):
        mesh = tc.Mesh(dp=2, mp=2, rank=rank, device=torch.device("cpu"))
        mine = tc.params_from_jax(w1, w2, mesh)
        for key in ("w1", "w2"):
            (shard,) = [s for s in params[key].addressable_shards if s.device == dev]
            np.testing.assert_array_equal(mine[key].numpy(), np.asarray(shard.data))


def test_burn_in_params_from_seed():
    mesh = tc.make_mesh(1, device="cpu")
    p = tc.burn_in_params(mesh, d_model=128, d_hidden=256, seed=3)
    assert p["w1"].shape == (128, 256) and p["w2"].shape == (256, 128)
    assert p["w1"].dtype == torch.float32
    r = tc.burn_in(steps=3, batch=16, d_model=128, d_hidden=256, device="cpu")
    assert r["ok"] and r["mesh"] == {"dp": 1, "mp": 1} and r["backend"] == "cpu"


def test_allreduce_four_ranks_and_their_flight_samples():
    recorder = flight.FlightRecorder()
    with flight.activate(recorder):
        r = tc.allreduce_benchmark(size_mb=2, iters=3, warmup=1, world_size=4, device="cpu")
    assert r["ok"] and r["devices"] == 4 and r["max_error"] == 0.0
    assert r["transport"] == "nvlink" and r["backend"] == "cpu"
    # busbw = algbw * 2(n-1)/n, the NCCL-tests convention
    assert r["busbw_gbps"] == pytest.approx(r["algbw_gbps"] * 2 * 3 / 4)
    assert set(r) == set(jc.allreduce_benchmark(size_mb=0.5, iters=2, warmup=1))
    # rank 0's samples came back and were replayed here
    phases = [s["phase"] for s in recorder.samples if s["check"] == "allreduce"]
    assert phases.count("compile") == 1
    assert phases.count("step") == 3 and phases.count("step-window") == 3


def test_allreduce_single_rank_is_hbm_local():
    r = tc.allreduce_benchmark(size_mb=1, iters=3, warmup=1, world_size=1, device="cpu")
    assert r["ok"] and r["devices"] == 1 and r["transport"] == "hbm-local"
    assert r["busbw_gbps"] == r["algbw_gbps"]


@pytest.mark.parametrize(
    "transport, backend, dominated, gated",
    [
        ("nvlink", "cpu", False, True),
        ("hbm-local", "cpu", False, False),  # one card is never a link rate
        ("nvlink", "cuda", False, False),  # backend not in the widened list
        ("nvlink", "cpu", True, False),  # an overhead-dominated number can't gate
    ],
)
def test_allreduce_gate_rule(monkeypatch, transport, backend, dominated, gated):
    monkeypatch.setenv("ALLREDUCE_GATE_BACKENDS", "cpu")
    result = {"ok": True, "busbw_gbps": 1.0, "transport": transport,
              "backend": backend, "overhead_dominated": dominated}
    out = tc.apply_allreduce_gate(result, min_gbps=100.0)
    assert out["gated"] is gated and out["ok"] is (not gated)
    assert out["min_gbps"] == 100.0


@pytest.mark.parametrize(
    "expected, processes, widen",
    [(8, 1, False), (4, 1, False), (8, 1, True), (4, 1, True), (8, 2, True)],
)
def test_device_count_check_matches_reference(monkeypatch, expected, processes, widen):
    """Eight CPU ranks against the reference's eight virtual devices: the
    same keys and the same verdict under the same gating rule."""
    if widen:
        monkeypatch.setenv("DEVICE_COUNT_GATE_BACKENDS", "cpu")
    ref = jc.device_count_check(expected, num_processes=processes)
    r = tc.device_count_check(expected, num_processes=processes, world_size=8, device="cpu")
    assert set(r) == set(ref)
    for key in ("ok", "gated", "visible", "expected", "visible_global", "expected_global"):
        assert r[key] == ref[key], key
    if "error" in r:
        assert "8 local" in r["error"] and f"{expected} local" in r["error"]


# ---------------------------------------------------------------------------
# ring exchange (per-link diagnostic)


def test_ring_four_ranks_matches_reference():
    """Four gloo ranks against the reference's ring on four virtual
    devices: every hop verified exactly, the same hop count and size."""
    ref = jc.ring_benchmark(size_mb=2, iters=2, best_of=2, devices=jax.devices()[:4])
    recorder = flight.FlightRecorder()
    with flight.activate(recorder):
        r = tc.ring_benchmark(size_mb=2, iters=2, best_of=2, world_size=4, device="cpu")
    assert r["ok"] and ref["ok"]
    assert r["max_error"] == ref["max_error"] == 0.0
    for key in ("hops", "devices", "size_mb"):
        assert r[key] == ref[key], key
    assert r["hops"] == 8 and r["devices"] == 4
    assert set(r) == set(ref)
    assert r["transport"] == "nvlink" and r["backend"] == "cpu" and r["link_gbps"] > 0
    phases = [s["phase"] for s in recorder.samples if s["check"] == "ring"]
    assert phases.count("compile") == 1 and phases.count("step") == 2


def test_ring_single_rank_skips_like_reference():
    ref = jc.ring_benchmark(devices=jax.devices()[:1])
    r = tc.ring_benchmark(world_size=1, device="cpu")
    assert r["ok"] and r["transport"] == "hbm-local" and "skipped" in r
    assert set(r) == set(ref)


def test_ring_payload_is_bf16_rounded():
    assert tc.ring_payload(4) == [1.0, 2.0, 3.0, 4.0]
    # 257 is not a bf16 value: it rides the ring as 256, and the expected
    # sums follow the rounded payload as the reference's do
    assert tc.ring_payload(300)[256] == 256.0


def test_ring_corrupted_payload_fails():
    """Rank 2 sends 4 where every rank's expected sum counts 3: each
    accumulator that saw it is off by one, and the check fails."""
    from tpu_operator_torch.workloads import _ranks

    values = tc.ring_payload(4)
    corrupted = list(values)
    corrupted[2] += 1.0
    r = _ranks.run(tc._ring_rank, 4, "cpu", size_mb=0.25, iters=1, best_of=1,
                   values=corrupted, distinct_total=float(sum(values)))
    assert not r["ok"] and r["max_error"] == 1.0


@pytest.mark.parametrize(
    "transport, backend, dominated, gated",
    [
        ("nvlink", "cpu", False, True),
        ("hbm-local", "cpu", False, False),  # a skipped single card is never gated
        ("nvlink", "cuda", False, False),  # backend not in the widened list
        ("nvlink", "cpu", True, False),  # an overhead-dominated number can't gate
    ],
)
def test_ring_gate_matches_reference(monkeypatch, transport, backend, dominated, gated):
    monkeypatch.setenv("RING_GATE_BACKENDS", "cpu")
    result = {"ok": True, "link_gbps": 1.0, "transport": transport, "backend": backend,
              "overhead_dominated": dominated}
    mine = tc.apply_ring_gate(dict(result), 100.0)
    ref = jc.apply_ring_gate(
        dict(result, transport="ici" if transport == "nvlink" else transport,
             backend="tpu" if backend == "cuda" else backend), 100.0)
    assert mine["gated"] is gated and mine["ok"] is (not gated)
    assert (mine["gated"], mine["ok"], mine.get("error")) == (ref["gated"], ref["ok"],
                                                              ref.get("error"))
