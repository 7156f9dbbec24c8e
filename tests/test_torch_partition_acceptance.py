"""The port's partition acceptance (``tpu_operator_torch.workloads.
partition_acceptance``) against the reference, on the CPU: two disjoint
units of two gloo ranks each run the burn-in at once, each exactly equal to
its solo run and within 1e-4 of the reference's burn-in on two virtual CPU
devices with the unit's seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from tpu_operator.workloads import collectives as jc  # noqa: E402
from tpu_operator.workloads import partition_acceptance as jpa  # noqa: E402
from tpu_operator_torch.workloads import collectives as tc  # noqa: E402
from tpu_operator_torch.workloads import partition_acceptance as pa  # noqa: E402


def test_overlapping_units_raise():
    with pytest.raises(ValueError, match="overlap"):
        pa.concurrent_acceptance({"a": [0, 1], "b": [1, 2]}, "2x2")


def test_unit_env(monkeypatch):
    monkeypatch.setenv("RESULTS_SCOPE", "perf")
    monkeypatch.setenv("EXPECTED_DEVICES", "8")
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    card = pa.unit_env([3, 2], "1x2", seed=2, simulate_cpu=False)
    assert card["CUDA_VISIBLE_DEVICES"] == "2,3"
    assert card["EXPECTED_DEVICES"] == "2" and card["DEVICE_COUNT_GATE_BACKENDS"] == "cuda"
    assert "TORCH_DEVICE" not in card and "DIST_CPU_RANKS" not in card
    cpu = pa.unit_env([0, 1, 2], "1x3", seed=1, barrier_dir="/b", barrier_count=2)
    assert (cpu["TORCH_DEVICE"], cpu["DIST_CPU_RANKS"], cpu["EXPECTED_DEVICES"]) == ("cpu", "3", "3")
    assert "CUDA_VISIBLE_DEVICES" not in cpu
    for env, seed in ((card, "2"), (cpu, "1")):
        assert "RESULTS_SCOPE" not in env
        assert (env["WORKLOAD_CHECKS"], env["BURN_IN_SEED"]) == ("burn-in", seed)
    assert (cpu["WORKLOAD_START_BARRIER"], cpu["WORKLOAD_BARRIER_COUNT"]) == ("/b", "2")


@pytest.mark.parametrize("stdout", [
    "",
    'noise\n{"check": "devices", "ok": true}\n{"check": "burn-in", "ok": true, "losses": [1.5]}\n',
    '{"check": "burn-in", "ok": false}\n{broken json\n{"check": "burn-in", "losses": [2.0]}\n',
    "  {\"check\": \"burn-in\", \"devices\": 2}  \nnot json {",
])
def test_parse_burn_in_matches_reference(stdout):
    assert pa._parse_burn_in(stdout) == jpa._parse_burn_in(stdout)


@pytest.mark.parametrize("ranks, expected", [("3", 3), ("", 1)])
def test_local_world_size_reads_dist_cpu_ranks_on_the_cpu(monkeypatch, ranks, expected):
    monkeypatch.setenv("DIST_CPU_RANKS", ranks)
    assert tc.local_world_size(torch.device("cpu")) == expected


def test_local_world_size_ignores_dist_cpu_ranks_on_cuda(monkeypatch):
    monkeypatch.setenv("DIST_CPU_RANKS", "3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tc.local_world_size(torch.device("cuda")) == 2


def _reference_burn_in(seed: int, steps: int) -> list:
    """The reference's burn-in step over 2 virtual CPU devices (dp x mp as
    its mesh factors them) on the port's seeded numpy inputs."""
    mesh = jc.make_mesh(n_devices=2)
    w1, w2 = tc._burn_in_weights(512, 2048, seed)
    x = np.random.default_rng(seed + 1).standard_normal((64, 512), dtype=np.float32)
    params = {
        "w1": jax.device_put(jnp.asarray(w1), NamedSharding(mesh, P(None, "mp"))),
        "w2": jax.device_put(jnp.asarray(w2), NamedSharding(mesh, P("mp", None))),
    }
    xs = jax.device_put(jnp.asarray(x, jnp.bfloat16), NamedSharding(mesh, P("dp", None)))
    step = jax.jit(functools.partial(jc.burn_in_step, mesh))
    return jc._acceptance_run(mesh, step, params, xs, steps)["losses"]


def test_concurrent_units_match_solo_and_the_reference(validation_root):
    r = pa.concurrent_acceptance({"a": [0, 1], "b": [2, 3]}, "2x2", steps=3)
    assert r["ok"], r
    assert r["independent_trajectories"] and r["concurrent"]
    for seed, name in enumerate(("a", "b"), start=1):
        unit = r["units"][name]
        assert unit["ok"] and unit["matches_solo"] and unit["devices"] == 2
        assert unit["losses"] == unit["solo_losses"]  # exactly
        assert unit["losses"] == pytest.approx(_reference_burn_in(seed, 3), rel=1e-4)
    assert set(r) == {"ok", "units", "independent_trajectories", "concurrent"}
