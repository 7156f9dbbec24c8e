"""The port's node validator (``tpu_operator_torch.validator``, ``hw``,
``k8s.client``, ``obs.events``) against the reference validator on the CPU:
the status files each package writes are the other's, the shared rules give
the same answers on the same inputs, the workload pod is the reference's but
for its command, resource and cache-key values, and every component runs,
the gate's workload pod end to end through the fake apiserver with the
pod's own command."""

import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from tpu_operator.k8s.client import ApiClient as JApiClient  # noqa: E402
from tpu_operator.k8s.client import Config as JConfig  # noqa: E402
from tpu_operator.obs import flight as jflight  # noqa: E402
from tpu_operator.testing import FakeCluster, SimConfig  # noqa: E402
from tpu_operator.validator import components as jcomp  # noqa: E402
from tpu_operator.validator import status as jstatus  # noqa: E402
from tpu_operator_torch import consts, hw  # noqa: E402
from tpu_operator_torch.k8s import nodeinfo  # noqa: E402
from tpu_operator_torch.k8s.client import ApiClient, ApiError, Config  # noqa: E402
from tpu_operator_torch.obs import flight  # noqa: E402
from tpu_operator_torch.validator import cli  # noqa: E402
from tpu_operator_torch.validator import components as comp  # noqa: E402
from tpu_operator_torch.validator import status  # noqa: E402
from tpu_operator_torch.validator.components import (  # noqa: E402
    ValidationError,
    Validator,
    ValidatorConfig,
)
from tpu_operator_torch.workloads import compile_cache, warmpool  # noqa: E402

NS = "tpu-operator"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT = "NVIDIA-H100-80GB-HBM3"


@pytest.fixture
def fake_hw(tmp_path, monkeypatch):
    """Synthetic host: 12 cards' device nodes, the driver's control nodes
    and libcuda.so.1 under TPU_HW_ROOT."""
    dev = tmp_path / "hw" / "dev"
    (dev / "nvidia-caps").mkdir(parents=True)
    for i in range(12):
        (dev / f"nvidia{i}").touch()
    for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset"):
        (dev / name).touch()
    lib = tmp_path / "hw" / "usr" / "lib" / "x86_64-linux-gnu"
    lib.mkdir(parents=True)
    (lib / "libcuda.so.1").touch()
    monkeypatch.setenv("TPU_HW_ROOT", str(tmp_path / "hw"))
    monkeypatch.delenv("LIBCUDA_PATH", raising=False)
    monkeypatch.delenv("TPU_CHIP_COUNT", raising=False)
    return tmp_path / "hw"


def fast_config(**kw) -> ValidatorConfig:
    return ValidatorConfig(
        node_name=kw.pop("node_name", "gpu-node-0"),
        namespace=NS,
        sleep_interval=kw.pop("sleep_interval", 0.01),
        workload_retries=kw.pop("workload_retries", 200),
        resource_retries=kw.pop("resource_retries", 20),
        platform=kw.pop("platform", "cpu"),
        **kw,
    )


def _gpu_node(fc, cards: int = 4, **labels):
    """An NVIDIA node (no GKE TPU labels unless given) with ``cards`` cards."""
    node = fc.add_node("gpu-node-0", labels={consts.GPU_PRODUCT_LABEL: PRODUCT, **labels},
                       tpu=False)
    node["status"]["allocatable"][consts.GPU_RESOURCE] = str(cards)
    return fc.put(node)


# ---------------------------------------------------------------------------
# status files: one format under one TPU_VALIDATION_ROOT


def test_status_files_are_the_references(validation_root, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792000000.25)
    payload = {"mode": "in-process", "devices": 4, "algbw_gbps": 958.0, "checks": {"x": [1]}}
    written = {}
    for name, pkg in (("port", status), ("reference", jstatus)):
        pkg.write_ready("jax", payload)
        pkg.write_marker(consts.LIBTPU_CTR_MARKER)
        with open(status.status_path("jax"), "rb") as f, \
                open(os.path.join(status.validation_dir(), consts.LIBTPU_CTR_MARKER), "rb") as g:
            written[name] = (f.read(), g.read())
        assert jstatus.read_status("jax") == status.read_status("jax")
        assert jstatus.marker_exists(consts.LIBTPU_CTR_MARKER) and status.marker_exists(consts.LIBTPU_CTR_MARKER)
    assert written["port"] == written["reference"]
    for component in ("libtpu", "pjrt", "plugin", "jax", "perf", "runtime-prep", "vfio-pci"):
        assert status.status_path(component) == jstatus.status_path(component)
    for scope in ("", "perf"):
        assert status.workload_results_path(scope) == jstatus.workload_results_path(scope)
        assert status.flight_record_path(scope) == jstatus.flight_record_path(scope)
    # each reads and clears what the other wrote
    status.write_ready("pjrt", {"device_count": 4})
    assert jstatus.is_ready("pjrt") and jstatus.read_status("pjrt")["device_count"] == 4
    jstatus.write_workload_results({"checks": {"a": 1}}, scope="perf")
    assert status.read_workload_results("perf")["checks"] == {"a": 1}
    status.clear_workload_results("perf")
    assert jstatus.read_workload_results("perf") is None
    jstatus.clear("pjrt")
    assert not status.is_ready("pjrt")
    jstatus.write_ready("libtpu")
    ready = [n for n in os.listdir(status.validation_dir()) if n.endswith("-ready")]
    assert len(ready) == 3  # jax, libtpu and the marker
    assert status.cleanup_all() == 3 and jstatus.cleanup_all() == 0


def test_flight_evidence_and_join_phases_are_the_references(validation_root, monkeypatch):
    samples = [
        {"check": "vector-add", "phase": "compile", "span_id": "s1", "metrics": {"compile_s": 1.5}},
        {"check": "vector-add", "phase": "compile", "span_id": "s1", "metrics": {"compile_s": 2.0}},
        {"check": "allreduce", "phase": "step", "span_id": "s2", "metrics": {"gbps": 9.0}},
        {"check": "burn-in", "phase": "compile", "metrics": {"compile_s": 0.5}},
    ]
    os.makedirs(os.path.dirname(status.flight_record_path()), exist_ok=True)
    with open(status.flight_record_path(), "w") as f:
        f.write("\n".join(json.dumps(s) for s in samples) + "\n{torn\n")
    for component, ts in (("libtpu", 100.0), ("pjrt", 103.0), ("plugin", 110.0), ("jax", 121.0)):
        monkeypatch.setattr(time, "time", lambda ts=ts: ts)
        status.write_ready(component)
    for created in (None, 90.0):
        assert status.join_phase_segments(created) == jstatus.join_phase_segments(created)
    # per check the largest compile sample: 2.0 + 0.5
    assert status.join_phase_segments(90.0)["compile"] == 2.5
    assert status.read_flight_record() == jstatus.read_flight_record() == samples
    for tail in (50, 2):
        assert status.flight_evidence(tail=tail) == jstatus.flight_evidence(tail=tail)
    assert status.flight_evidence("perf") is None
    status.clear_flight_record()
    assert jstatus.read_flight_record() == []


# ---------------------------------------------------------------------------
# the shared rules, over the reference's own cases


_MEASURED_CASES = [
    None,
    {},
    # tests/test_validator.py's overhead-dominated case
    {"checks": {
        "allreduce": {"algbw_gbps": 5.0, "min_gbps": 2.0, "overhead_dominated": True},
        "matmul": {"tflops": 70.0, "mfu": 0.37, "overhead_dominated": True},
        "ring": {"link_gbps": 45.0, "min_gbps": 12.5, "overhead_dominated": False},
        "hbm": {"gbps": 600.0, "fraction_of_peak": 0.8},
    }},
    {"checks": {"allreduce": {"busbw_gbps": 0.0}, "hbm-dma": {"gbps": 3.0}}},
    {"checks": {"allreduce": {"algbw_gbps": True, "busbw_gbps": 7.0}}},
    {"distributed": {"allreduce": {"algbw_gbps": 12.5}, "ring": {"link_gbps": 4.0}}},
]

_REGRESSION_CASES = [
    ({"hbm_gbps": 600.0, "mfu": 0.5}, {"hbm_gbps": 700.0, "mfu": 0.5}, ""),
    ({"hbm_gbps": 690.0}, {"hbm_gbps": 700.0}, ""),
    ({"hbm_gbps": 690.0}, {"hbm_gbps": 700.0}, "0"),
    ({"algbw_gbps": 1.0, "ring_link_gbps": 0}, {"algbw_gbps": 2.0, "ring_link_gbps": 5.0}, "junk"),
    ({"matmul_tflops": 10.0, "allreduce_min_gbps": 1.0}, {"allreduce_min_gbps": 5.0}, "0.5"),
]


_RULE_CASES = (
    [("measured", results) for results in _MEASURED_CASES]
    + [("regressions", case) for case in _REGRESSION_CASES]
    + [("env_floor", value) for value in ("", "7", "0", "junk", "-3")]
)


@pytest.mark.parametrize("rule, case", _RULE_CASES)
def test_shared_rules_match_the_reference(rule, case, monkeypatch):
    """``_measured_from_results``, ``_regressions_vs_prior`` and
    ``_env_floor``: the same answer as the reference on the same input."""
    if rule == "measured":
        assert comp._measured_from_results(case) == jcomp._measured_from_results(case)
    elif rule == "regressions":
        payload, prior, threshold = case
        monkeypatch.setenv("PERF_REGRESSION_THRESHOLD", threshold)
        assert comp._regressions_vs_prior(payload, prior) == \
            jcomp._regressions_vs_prior(payload, prior)
    else:
        monkeypatch.setenv("X_FLOOR", case)
        assert comp._env_floor("X_FLOOR", lambda: 12.5) == \
            jcomp._env_floor("X_FLOOR", lambda: 12.5)


def test_measured_from_results_drops_overhead_dominated():
    out = comp._measured_from_results(_MEASURED_CASES[2])
    assert "mfu" not in out and "matmul_tflops" not in out and "algbw_gbps" not in out
    assert out == {"allreduce_min_gbps": 2.0, "ring_link_gbps": 45.0, "ring_min_gbps": 12.5,
                   "hbm_gbps": 600.0, "hbm_fraction_of_peak": 0.8}


def test_floors_from_the_nvlink_catalogue(monkeypatch):
    """The ring floor from the per-link rate (900 GB/s over 18 links); the
    allreduce floor in the port's busbw convention, n x one NVLink
    direction; the inter-host floor from the NIC rate; overrides win,
    an explicit 0 included."""
    for var in ("RING_MIN_GBPS", "ALLREDUCE_MIN_GBPS", "MULTISLICE_MIN_GBPS"):
        monkeypatch.delenv(var, raising=False)
    assert nodeinfo.generation_info("h100-sxm").nvlink_link_gbps == 50.0
    assert comp._ring_min_gbps("h100-sxm") == comp._ring_min_gbps("h100-pcie") == 12.5
    assert comp._allreduce_min_gbps("h100-sxm", 4) == 450.0
    assert comp._allreduce_min_gbps("h100-sxm", 8) == 900.0
    assert comp._allreduce_min_gbps("h100-nvl", 2) == 150.0
    assert comp._multislice_min_gbps("h100-sxm") == 10.0
    assert comp._multislice_min_gbps() == comp._allreduce_min_gbps("unknown", 4) == 0.0
    monkeypatch.setenv("ALLREDUCE_MIN_GBPS", "0")
    assert comp._allreduce_min_gbps("h100-sxm", 4) == 0.0
    monkeypatch.setenv("RING_MIN_GBPS", "junk")
    assert comp._ring_min_gbps("h100-sxm") == 12.5


@pytest.mark.parametrize("label, generation", [
    ("NVIDIA-H100-80GB-HBM3", "h100-sxm"), ("NVIDIA-H100-PCIe", "h100-pcie"),
    ("NVIDIA-H100-NVL", "h100-nvl"), ("NVIDIA-H200", "h200"), ("", "unknown"),
])
def test_generation_from_the_product_label(label, generation):
    node = {"metadata": {"labels": {consts.GPU_PRODUCT_LABEL: label} if label else {}}}
    assert nodeinfo.generation_of_node(node) == generation


def test_slice_member_predicate_is_the_references():
    from tpu_operator.controllers.labels import slice_group_key

    for accel in ("", "tpu-v4-podslice", "tpu-v5-lite-podslice", "tpu-v5-lite-device",
                  "tpu-v6e-device", "tpu-other"):
        for topo in ("", "1x1", "2x2", "2x4", "4x4", "2x2x2", "4x4x4", "bad"):
            for pool in ("", "pool-a"):
                labels = {k: v for k, v in ((consts.GKE_TPU_ACCELERATOR_LABEL, accel),
                                            (consts.GKE_TPU_TOPOLOGY_LABEL, topo),
                                            (consts.GKE_NODEPOOL_LABEL, pool)) if v}
                node = {"metadata": {"name": "n", "labels": labels}}
                assert nodeinfo.slice_group_key(node) == (slice_group_key(node) or "")


# ---------------------------------------------------------------------------
# host truth and the node-local components


def test_card_device_nodes_in_numeric_order(fake_hw, monkeypatch):
    paths = hw.card_device_paths()
    assert [os.path.basename(p) for p in paths] == [f"nvidia{i}" for i in range(12)]
    assert hw.chip_count() == 12
    monkeypatch.setenv("TPU_CHIP_COUNT", "3")
    assert hw.chip_count() == 3
    assert hw.libcuda_path().endswith("usr/lib/x86_64-linux-gnu/libcuda.so.1")
    monkeypatch.setenv("LIBCUDA_PATH", str(fake_hw / "dev" / "nvidia0"))
    assert hw.libcuda_path() == str(fake_hw / "dev" / "nvidia0")
    # a host (or container) with the driver's versioned file but no link
    monkeypatch.delenv("LIBCUDA_PATH")
    lib = fake_hw / "usr" / "lib" / "x86_64-linux-gnu"
    (lib / "libcuda.so.1").unlink()
    (lib / "libcuda.so").touch()  # the development link, not the driver
    assert hw.libcuda_path() == ""
    (lib / "libcuda.so.580.159.03").touch()
    assert hw.libcuda_path() == str(lib / "libcuda.so.580.159.03")


async def test_libtpu_validation(validation_root, fake_hw):
    status.write_marker(consts.LIBTPU_CTR_MARKER)
    await Validator(fast_config()).run("libtpu")
    payload = status.read_status("libtpu")
    assert payload["chips"] == 12 and payload["host_managed"] is False
    assert payload["libtpu_path"] == hw.libcuda_path()
    # the reference's exporter reads it
    assert jstatus.read_status("libtpu")["chips"] == 12


async def test_libtpu_host_managed_and_missing_host(validation_root, fake_hw, tmp_path,
                                                    monkeypatch):
    await Validator(fast_config(resource_retries=2)).run("libtpu")
    assert status.read_status("libtpu")["host_managed"] is True
    monkeypatch.setenv("TPU_HW_ROOT", str(tmp_path / "empty"))
    with pytest.raises(ValidationError, match="driver"):
        await Validator(fast_config(resource_retries=2)).run("libtpu")
    assert not status.is_ready("libtpu")


async def test_pjrt_validation_and_device_count_gate(validation_root, monkeypatch):
    """The runtime seeing fewer devices than the host's device nodes fails
    pjrt (a half-dead host), on the backends the gate names."""
    monkeypatch.setenv("DIST_CPU_RANKS", "8")
    status.write_ready("libtpu")
    v = Validator(fast_config())
    await v.run("pjrt")
    payload = status.read_status("pjrt")
    assert (payload["platform"], payload["device_count"], payload["device_kind"]) == (
        "cpu", 8, "cpu")
    monkeypatch.setenv("DEVICE_COUNT_GATE_BACKENDS", "cpu")
    status.write_ready("libtpu", {"chips": 4})  # the host claims 4, the runtime sees 8
    with pytest.raises(ValidationError, match="8 devices.*4 card"):
        await v.run("pjrt")
    assert not status.is_ready("pjrt")
    status.write_ready("libtpu", {"chips": 8})
    await v.run("pjrt")
    assert status.read_status("pjrt")["host_chips"] == 8


async def test_cuda_platform_without_a_card_raises(validation_root, monkeypatch):
    """No fallback: the validator on cuda with no card fails its component;
    it never measures the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    status.write_ready("libtpu", {"chips": 1})
    status.write_ready("plugin")
    v = Validator(fast_config(platform="cuda"))
    with pytest.raises(ValidationError, match="no cuda devices"):
        await v.run("pjrt")
    with pytest.raises(ValidationError, match="no CUDA device"):
        await v.run("jax")
    assert not status.is_ready("pjrt") and not status.is_ready("jax")


async def test_vfio_validation(validation_root, tmp_path, monkeypatch):
    vfio = tmp_path / "hw" / "dev" / "vfio"
    vfio.mkdir(parents=True)
    (vfio / "vfio").touch()  # the container device, not a group
    monkeypatch.setenv("TPU_HW_ROOT", str(tmp_path / "hw"))
    v = Validator(fast_config())
    with pytest.raises(ValidationError):
        await v.run("vfio-pci")
    for group in ("10", "7"):
        (vfio / group).touch()
    await v.run("vfio-pci")
    assert [os.path.basename(p) for p in status.read_status("vfio-pci")["devices"]] == ["7", "10"]


async def test_wait_only(validation_root):
    v = Validator(fast_config(workload_retries=3))
    with pytest.raises(ValidationError):
        await v.wait_ready("pjrt")
    jstatus.write_ready("pjrt")
    await v.wait_ready("pjrt")


# ---------------------------------------------------------------------------
# the apiserver side


async def test_client_against_the_fake_apiserver():
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        _gpu_node(fc)
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            node = await client.get("", "Node", "gpu-node-0")
            assert node["status"]["allocatable"][consts.GPU_RESOURCE] == "4"
            assert [n["metadata"]["name"] for n in await client.list_items("", "Node")] == [
                "gpu-node-0"]
            pod = {"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": "p", "namespace": NS}, "spec": {"containers": []}}
            await client.create(pod)
            with pytest.raises(ApiError) as err:
                await client.create(pod)
            assert err.value.already_exists
            assert len(await client.list_items("", "Pod", NS)) == 1
            await client.delete("", "Pod", "p", NS)
            assert await client.delete("", "Pod", "p", NS) is None  # not found: ignored
            with pytest.raises(ApiError) as err:
                await client.get("", "Pod", "p", NS)
            assert err.value.not_found


async def test_client_merge_patch_against_the_fake_apiserver():
    """A merge patch adds the keys it names and leaves the rest, as the
    Service's epoch tombstone needs; a patch of a missing object is a 404."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            await client.create({"apiVersion": "v1", "kind": "Service", "metadata": {
                "name": "svc", "namespace": NS, "labels": {"app": "a"},
                "annotations": {"keep": "1"}}, "spec": {"clusterIP": "None"}})
            patched = await client.patch(
                "", "Service", "svc", {"metadata": {"annotations": {"epoch": "e1"}}}, NS)
            assert patched["metadata"]["annotations"] == {"keep": "1", "epoch": "e1"}
            svc = await client.get("", "Service", "svc", NS)
            assert svc["metadata"]["annotations"] == {"keep": "1", "epoch": "e1"}
            assert svc["metadata"]["labels"] == {"app": "a"}
            assert svc["spec"]["clusterIP"] == "None"
            await client.patch("", "Service", "svc",
                               {"metadata": {"annotations": {"keep": None}}}, NS)
            svc = await client.get("", "Service", "svc", NS)
            assert svc["metadata"]["annotations"] == {"epoch": "e1"}
            with pytest.raises(ApiError) as err:
                await client.patch("", "Service", "gone", {"metadata": {}}, NS)
            assert err.value.not_found


async def test_client_lists_by_label_selector():
    """``label_selector`` reaches the apiserver: only the matching pods come
    back, and the reference's client lists the same ones."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        for name, app in (("runtime-a", "tpu-runtime"), ("runtime-b", "tpu-runtime"),
                          ("other", "x")):
            fc.put({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": name, "namespace": NS, "labels": {"app": app}},
                    "spec": {"containers": [{"name": "c"}]}})
        async with ApiClient(Config(base_url=fc.base_url)) as client, \
                JApiClient(JConfig(base_url=fc.base_url)) as jclient:
            mine = await client.list_items("", "Pod", NS, label_selector="app=tpu-runtime")
            ref = await jclient.list_items("", "Pod", NS, label_selector="app=tpu-runtime")
            assert sorted(p["metadata"]["name"] for p in mine) == ["runtime-a", "runtime-b"]
            assert [p["metadata"]["name"] for p in mine] == [p["metadata"]["name"] for p in ref]
            assert len(await client.list_items("", "Pod", NS)) == 3
            assert await client.list_items("", "Pod", NS, label_selector="app=none") == []


async def test_plugin_validation_polls_the_gpu_resource(validation_root):
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        node = fc.add_node("gpu-node-0", tpu=False)
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            v = Validator(fast_config(resource_retries=5), client=client)
            with pytest.raises(ValidationError, match="nvidia.com/gpu"):
                await v.run("plugin")
            # the reference's resource is not this node's
            node["status"]["allocatable"][jcomp.consts.TPU_RESOURCE] = "4"
            fc.put(node)
            with pytest.raises(ValidationError):
                await v.run("plugin")
            node["status"]["allocatable"][consts.GPU_RESOURCE] = "4"
            fc.put(node)
            await v.run("plugin")
            assert jstatus.read_status("plugin")["allocatable"] == 4


def test_workload_pod_is_the_references(monkeypatch):
    """Same arguments, same pod, but for the command, the resource name and
    the cache-key values."""
    monkeypatch.setenv("TPU_METRICS_PUSH_URL", "http://agent:8932/push")
    monkeypatch.setenv("TPU_TRACEPARENT", "abc123-def456")
    monkeypatch.setenv("TPU_FLEET_CACHE_URL", "http://operator/cache")
    owner = {"apiVersion": "apps/v1", "kind": "DaemonSet",
             "metadata": {"name": "tpu-operator-validator", "uid": "u-1"},
             "spec": {"template": {"spec": {"tolerations": [{"operator": "Exists"}]}}}}
    mine = Validator(fast_config())
    ref = jcomp.Validator(jcomp.ValidatorConfig(node_name="gpu-node-0", namespace=NS))
    for kwargs in (
        dict(name="tpu-jax-workload-validation", checks="vector-add,allreduce,burn-in",
             tpu_request=4, owner=owner, min_gbps=450.0),
        dict(name="tpu-perf-probes", checks="matmul,hbm", tpu_request=8, owner=None,
             ring_min_gbps=12.5, results_scope="perf", budget_seconds=30.0),
    ):
        port_pod = mine._workload_pod(**kwargs, cache_key_env={
            "TPU_CACHE_GENERATION": PRODUCT, "TPU_LIBTPU_VERSION": "12.8"})
        ref_pod = ref._workload_pod(**kwargs, cache_key_env={
            "TPU_CACHE_GENERATION": "tpu-v5-lite-podslice", "TPU_LIBTPU_VERSION": "0.1"})
        port_ctr, ref_ctr = port_pod["spec"]["containers"][0], ref_pod["spec"]["containers"][0]
        assert port_ctr["command"] == ["python", "-m", "tpu_operator_torch.workloads.run_validation"]
        assert ref_ctr["command"] == ["python", "-m", "tpu_operator.workloads.run_validation"]
        n = str(kwargs["tpu_request"])
        assert port_ctr["resources"] == {"limits": {consts.GPU_RESOURCE: n},
                                         "requests": {consts.GPU_RESOURCE: n}}
        port_env = {e["name"]: e["value"] for e in port_ctr["env"]}
        assert (port_env["TPU_CACHE_GENERATION"], port_env["TPU_LIBTPU_VERSION"]) == (
            PRODUCT, "12.8")
        assert "TORCH_DEVICE" not in port_env
        # map the three differences onto the reference's and compare all
        port_ctr["command"], port_ctr["resources"] = ref_ctr["command"], ref_ctr["resources"]
        ref_values = {e["name"]: e["value"] for e in ref_ctr["env"]}
        for e in port_ctr["env"]:
            if e["name"] in ("TPU_CACHE_GENERATION", "TPU_LIBTPU_VERSION"):
                e["value"] = ref_values[e["name"]]
        assert port_pod == ref_pod


async def test_cache_key_env_is_what_the_pods_warm_pool_computes(monkeypatch):
    """The pod's cache-key env, put into the pod's process, gives the key
    fields and the warm-pool kind the port computes for itself there."""
    for var in ("TPU_CACHE_GENERATION", "TPU_CACHE_TOPOLOGY", "TPU_LIBTPU_VERSION"):
        monkeypatch.delenv(var, raising=False)
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        _gpu_node(fc)
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            env = await Validator(fast_config(), client=client)._cache_key_env()
    assert env["TPU_CACHE_GENERATION"] == PRODUCT
    pod = Validator(fast_config())._workload_pod("p", "warm-pool", 1, None, cache_key_env=env)
    pod_env = {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}
    for var in ("TPU_CACHE_GENERATION", "TPU_CACHE_TOPOLOGY"):
        monkeypatch.setenv(var, pod_env.get(var, ""))
    # the CUDA version ("" on a CPU build, and then left out of the env)
    cuda = pod_env.get("TPU_LIBTPU_VERSION", "")
    assert compile_cache.current_versions() == (torch.__version__, cuda)
    assert cuda == (torch.version.cuda or "")
    assert warmpool.key_fields() == {"generation": PRODUCT, "topology": "",
                                     "jax_version": torch.__version__, "libtpu_version": cuda}
    assert warmpool.kind_from_env() == compile_cache.kind_fingerprint(
        PRODUCT, "", torch.__version__, cuda)


def _exec_pod_command(pod: dict) -> str:
    """Fake kubelet: the pod's OWN command with the pod's own env, on the
    CPU (the one addition), the interpreter in the place of the image's."""
    spec = pod["spec"]["containers"][0]
    env = {**os.environ, "PYTHONPATH": REPO,
           **{e["name"]: e.get("value", "") for e in spec.get("env", [])},
           "TORCH_DEVICE": "cpu"}
    command = list(spec["command"])
    assert command[0] == "python"
    result = subprocess.run([sys.executable, *command[1:]], env=env, cwd=REPO,
                            capture_output=True, text=True, timeout=300)
    return "Succeeded" if result.returncode == 0 else "Failed"


async def test_jax_validation_spawns_the_ports_workload_pod(validation_root):
    """End to end: jax spawns the gate pod, the fake kubelet runs its own
    command, the pod succeeds, and jax-ready carries the reference's keys
    with the drop-box's figures."""
    sim = SimConfig(pod_ready_delay=0.01, tick=0.01, pod_executor=_exec_pod_command)
    async with FakeCluster(sim) as fc:
        _gpu_node(fc, cards=4)
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            status.write_ready("plugin")
            v = Validator(fast_config(with_workload=True, sleep_interval=0.1,
                                      workload_retries=900), client=client)
            await v.run("jax")
            pod = await client.get("", "Pod", "tpu-jax-workload-validation", NS)
    assert pod["status"]["phase"] == "Succeeded"
    ctr = pod["spec"]["containers"][0]
    assert ctr["command"] == comp.WORKLOAD_COMMAND
    assert ctr["resources"]["limits"] == {consts.GPU_RESOURCE: "4"}
    env = {e["name"]: e["value"] for e in ctr["env"]}
    assert env["WORKLOAD_CHECKS"] == "vector-add,allreduce,burn-in"
    assert env["EXPECTED_DEVICES"] == "4" and float(env["ALLREDUCE_MIN_GBPS"]) == 450.0
    assert {v["name"]: v["hostPath"]["path"] for v in pod["spec"]["volumes"]} == {
        "compile-cache": "/run/tpu/compile_cache",
        "workload-results": "/run/tpu/workload-results",
    }
    payload = jstatus.read_status("jax")
    assert payload["mode"] == "workload-pod" and payload["chips"] == 4
    assert payload["allreduce_min_gbps"] == 450.0
    assert {"component", "ts", "mode", "chips", "allreduce_min_gbps", "flight"} <= set(payload)
    assert set(payload) <= {"component", "ts", "mode", "chips", "allreduce_min_gbps", "flight",
                            "algbw_gbps"}
    assert payload.get("algbw_gbps", 1.0) > 0
    # the port's checks ran in the pod: its transport names, not the ICI
    results = status.read_workload_results()
    assert results["checks"]["allreduce"]["transport"] == "hbm-local"
    assert results["checks"]["vector-add"]["max_error"] == 0.0


async def test_jax_validation_in_process(validation_root, monkeypatch):
    """In-process on two gloo ranks: vector-add, allreduce and the burn-in."""
    monkeypatch.setenv("DIST_CPU_RANKS", "2")
    status.write_ready("plugin")
    await Validator(fast_config(with_workload=False)).run("jax")
    payload = jstatus.read_status("jax")
    assert payload["mode"] == "in-process" and payload["devices"] == 2
    assert payload.get("algbw_gbps", 1.0) > 0
    assert "matmul_tflops" not in payload
    assert set(payload["flight"]["checks"]) >= {"vector-add", "allreduce", "burn-in"}


async def test_perf_probes_in_process(validation_root):
    v = Validator(fast_config(with_workload=False, workload_retries=2))
    with pytest.raises(ValidationError):  # jax-ready is a prerequisite
        await v.run("perf")
    status.write_ready("jax")
    await Validator(fast_config(with_workload=False)).run("perf")
    payload = jstatus.read_status("perf")
    assert payload["ok"] is True
    checks = payload["checks"]
    assert set(checks) == {"matmul", "hbm", "hbm-dma", "ring", "burn-in"}
    assert checks["matmul"]["tflops"] > 0 and checks["hbm"]["gbps"] > 0
    assert checks["hbm-dma"]["gbps"] > 0 and checks["burn-in"]["ok"]
    assert checks["ring"]["skipped"] == "single card: no ring"
    # the CPU has no published peak: no share is made up
    assert checks["matmul"]["mfu"] is None and checks["hbm"]["fraction_of_peak"] is None


async def test_perf_probe_selection_and_budget_in_process(validation_root, monkeypatch):
    """PERF_PROBE_CHECKS narrows the probes, a microscopic PERF_PROBE_BUDGET_S
    skips the later one, a valid pod-only name is skipped evidence and a
    typo fails as the probe pod would fail it."""
    status.write_ready("jax")
    v = Validator(fast_config(with_workload=False))
    monkeypatch.setenv("PERF_PROBE_CHECKS", "matmul,hbm")
    monkeypatch.setenv("PERF_PROBE_BUDGET_S", "0.000001")
    await v.run("perf")
    payload = status.read_status("perf")
    assert payload["ok"] is True and set(payload["checks"]) == {"matmul", "hbm"}
    assert "budget" in payload["checks"]["hbm"]["skipped"]
    monkeypatch.delenv("PERF_PROBE_BUDGET_S")
    monkeypatch.setenv("PERF_PROBE_CHECKS", "longctx,hbmm")
    await v.run("perf")
    payload = status.read_status("perf")
    assert payload["ok"] is False
    assert "not available in-process" in payload["checks"]["longctx"]["skipped"]
    assert "unknown check hbmm" in payload["checks"]["hbmm"]["error"]


async def test_perf_pod_failure_is_report_only(validation_root):
    sim = SimConfig(pod_ready_delay=0.01, tick=0.01, pod_executor=lambda pod: "Failed")
    async with FakeCluster(sim) as fc:
        _gpu_node(fc, cards=4)
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            status.write_ready("jax")
            status.write_workload_results({"checks": {"matmul": {"tflops": 900.0}}}, scope="perf")
            v = Validator(fast_config(with_workload=True, workload_retries=50), client=client)
            await v.run("perf")  # must not raise
    payload = status.read_status("perf")
    assert payload["ok"] is False and "tpu-perf-probes" in payload["error"]
    assert payload["checks"] == {} and status.read_workload_results("perf") is None


async def test_perf_regression_posts_a_warning_event(validation_root):
    """A measured figure below the previous round's by more than the
    threshold is recorded in the payload and posted as a Warning Event."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        _gpu_node(fc)
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            v = Validator(fast_config(), client=client)
            v._prior["perf"] = {"hbm_gbps": 3000.0}
            payload = {"ok": True, "hbm_gbps": 2000.0}
            await v._finish_measured("perf", payload, scope="perf")
            (event,) = await client.list_items("", "Event", NS)
    (regression,) = payload["regressions"]
    assert regression["metric"] == "hbm_gbps" and regression["verdict"] == "regressed"
    assert (event["type"], event["reason"]) == ("Warning", "WorkloadPerfRegressed")
    assert event["involvedObject"]["name"] == "gpu-node-0" and event["involvedObject"]["uid"]


def test_join_phases_push_is_the_references():
    """The same POST body as the reference's push to the metrics agent."""
    import http.server
    import threading

    bodies = []

    class Agent(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Agent)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}/push"
    phases = {"compile": 1.5, "collective": 2, "bad": -1.0, "nan": float("nan"), "b": True}
    try:
        for push in (flight.push_join_phases, jflight.push_join_phases):
            assert push("gpu-node-0", phases, trace_id="abc", url=url)
            assert not push("", phases, url=url)
    finally:
        server.shutdown()
        thread.join(5.0)
    assert len(bodies) == 2 and bodies[0] == bodies[1]


# ---------------------------------------------------------------------------
# the CLI


def _cli(*args, root) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": REPO, "TPU_VALIDATION_ROOT": str(root)}
    return subprocess.run([sys.executable, "-m", "tpu_operator_torch.validator.cli", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_cli_cleanup_and_wait_only(validation_root):
    wait = ("--wait-only", "--sleep-interval-seconds", "0.01", "--workload-retries", "3")
    assert _cli("--component", "libtpu", *wait, root=validation_root).returncode == 1
    jstatus.write_ready("libtpu")
    assert _cli("--component", "libtpu", *wait, root=validation_root).returncode == 0
    done = _cli("--cleanup-all", root=validation_root)
    assert done.returncode == 0 and "removed 1 status files" in done.stderr
    assert not jstatus.is_ready("libtpu")
    metrics = _cli("--component", "metrics", "--oneshot", root=validation_root)
    assert metrics.returncode == 2 and "not ported" in metrics.stderr
    assert _cli(root=validation_root).returncode == 2


def test_cli_import_leaves_torch_out():
    """The control-plane components never pay for torch: importing the CLI,
    the catalogue, and the versions a workload pod's key fields carry."""
    code = ("import sys, tpu_operator_torch.validator.cli, tpu_operator_torch.k8s.nodeinfo; "
            "from tpu_operator_torch.workloads import compile_cache; "
            "compile_cache.current_versions(); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'tpu_operator', 'aiohttp')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


async def test_cli_failure_posts_a_warning_event(validation_root, monkeypatch):
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        fc.add_node("gpu-node-0", tpu=False)  # advertises no card
        monkeypatch.setenv("KUBERNETES_API_URL", fc.base_url)
        args = cli.parse_args(["--component", "plugin", "--node-name", "gpu-node-0",
                               "--namespace", NS, "--resource-retries", "2",
                               "--sleep-interval-seconds", "0.01"])
        assert await cli.run(args) == 1
        async with JApiClient(JConfig(base_url=fc.base_url)) as client:
            (event,) = await client.list_items("", "Event", NS)
    assert (event["type"], event["reason"]) == ("Warning", "ValidationFailed")
    assert "plugin validation failed" in event["message"]
