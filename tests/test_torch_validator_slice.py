"""The port's multi-host and multislice validation
(``tpu_operator_torch.validator.components``: slice identity, worker ids,
validation epochs, the headless Service and the rendezvous pods) against
the reference's on the CPU.

The port's validators run against the reference's fake apiserver; its
kubelet runs each rendezvous pod's own command (``python -m
tpu_operator_torch.workloads.distributed``) with the pod's env on two gloo
ranks, the coordinator's DNS name rewritten to one localhost port per pod
``subdomain`` (one headless Service per rendezvous).  Where the branch is
pure cluster logic (names, worker ids, epochs, the pod spec, the payload's
keys), both packages run on the same Node objects."""

import asyncio
import contextlib
import copy
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from tpu_operator import consts as jconsts  # noqa: E402
from tpu_operator.k8s.client import ApiClient as JApiClient  # noqa: E402
from tpu_operator.k8s.client import Config as JConfig  # noqa: E402
from tpu_operator.state.nodepool import hashed_name as jhashed_name  # noqa: E402
from tpu_operator.testing import FakeCluster, SimConfig  # noqa: E402
from tpu_operator.utils import fnv1a_64 as jfnv1a_64  # noqa: E402
from tpu_operator.validator import components as jcomp  # noqa: E402
from tpu_operator.validator import status as jstatus  # noqa: E402
from tpu_operator_torch import consts, utils  # noqa: E402
from tpu_operator_torch.k8s import nodeinfo  # noqa: E402
from tpu_operator_torch.k8s.client import ApiClient, ApiError, Config  # noqa: E402
from tpu_operator_torch.validator import components as comp  # noqa: E402
from tpu_operator_torch.validator import status  # noqa: E402
from tpu_operator_torch.validator.components import (  # noqa: E402
    ValidationError,
    Validator,
    ValidatorConfig,
)

NS = "tpu-operator"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT = "NVIDIA-H100-80GB-HBM3"
CARDS = 2  # per host: the pods run this many gloo ranks
# the keys of a slice member's jax-ready, besides the measured figures
PAYLOAD_KEYS = {"component", "ts", "mode", "group", "workers", "worker_id", "epoch",
                "proven_by"}
MEASURED_KEYS = {"algbw_gbps", "allreduce_min_gbps", "ring_link_gbps", "ring_min_gbps",
                 "flight"}


def fast_config(**kw) -> ValidatorConfig:
    return ValidatorConfig(
        node_name=kw.pop("node_name", "tpu-0"),
        namespace=NS,
        sleep_interval=kw.pop("sleep_interval", 0.01),
        workload_retries=kw.pop("workload_retries", 200),
        resource_retries=kw.pop("resource_retries", 20),
        platform="cpu",
        **kw,
    )


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _exec_distributed_pod(executed: list, fault=None):
    """Fake kubelet for rendezvous pods: the pod's own command with its own
    env on CARDS gloo ranks, the coordinator at a localhost port per
    rendezvous (``subdomain``), the device count held to EXPECTED_DEVICES.
    ``executed`` collects the pods (the validator deletes them after the
    proof); ``fault(pod)`` may add env to a pod before it runs."""
    ports: dict[str, int] = {}
    lock = threading.Lock()

    def group_port(subdomain: str) -> int:
        with lock:
            if subdomain not in ports:
                ports[subdomain] = _free_port()
            return ports[subdomain]

    def execute(pod: dict) -> str:
        executed.append(pod)
        if fault is not None:
            fault(pod)
        spec = pod["spec"]["containers"][0]
        env = {**os.environ, "PYTHONPATH": REPO,
               **{e["name"]: e.get("value", "") for e in spec.get("env", [])},
               "TORCH_DEVICE": "cpu", "DIST_CPU_RANKS": str(CARDS),
               "DEVICE_COUNT_GATE_BACKENDS": "cpu",
               # the CPU's sizes: the phases' buffers, not the card's
               "ALLREDUCE_SIZE_MB": "1", "RING_SIZE_MB": "1"}
        env["COORDINATOR_ADDRESS"] = f"127.0.0.1:{group_port(pod['spec']['subdomain'])}"
        command = list(spec["command"])
        assert command[0] == "python"
        result = subprocess.run([sys.executable, *command[1:]], env=env, cwd=REPO,
                                capture_output=True, text=True, timeout=300)
        if result.returncode != 0:
            print("distributed pod failed:", pod["metadata"]["name"],
                  result.stdout[-2000:], result.stderr[-2000:])
        return "Succeeded" if result.returncode == 0 else "Failed"

    return execute


def _slice_node(fc, name, wid, pool="pool-a", topology="2x4", cards=CARDS, **labels):
    """A host of a multi-host slice: the reference's GKE identity labels
    (v5e podslice: 4 chips a host, so a 2x4 slice has 2 hosts and 4x4 has
    4), the card's product label and ``cards`` of nvidia.com/gpu."""
    node = fc.add_node(name, topology=topology, labels={
        consts.GPU_PRODUCT_LABEL: PRODUCT,
        consts.GKE_NODEPOOL_LABEL: pool,
        **({consts.GKE_TPU_WORKER_ID_LABEL: wid} if wid is not None else {}),
        **labels,
    })
    node["status"]["allocatable"][consts.GPU_RESOURCE] = str(cards)
    node["status"]["allocatable"][jconsts.TPU_RESOURCE] = "4"
    return fc.put(node)


def _multislice_nodes(fc, group: str, pools=("pool-a", "pool-b"), declared="2") -> list:
    """Two 2-host slices (two nodepools) declared one multislice group."""
    names = []
    for pool in pools:
        for i in range(2):
            names.append(f"tpu-{pool}-{i}")
            _slice_node(fc, names[-1], str(i), pool=pool, **{
                consts.MULTISLICE_GROUP_LABEL: group,
                **({consts.MULTISLICE_SLICES_LABEL: declared} if declared else {})})
    return names


@contextlib.asynccontextmanager
async def _validators(fc, names, retries=1800):
    """One port validator per host, each with its own apiserver client, in
    one event loop, sharing one TPU_VALIDATION_ROOT."""
    async with contextlib.AsyncExitStack() as stack:
        clients = [await stack.enter_async_context(ApiClient(Config(base_url=fc.base_url)))
                   for _ in names]
        yield [Validator(fast_config(node_name=n, with_workload=True, sleep_interval=0.1,
                                     workload_retries=retries), client=c)
               for n, c in zip(names, clients)]


@pytest.fixture
def jax_ready(monkeypatch):
    """Every jax-ready payload the validators write, in order (they share
    one status directory, so the file keeps only the last)."""
    written = []
    write = status.write_ready

    def record(component, payload=None):
        if component == "jax":
            written.append(copy.deepcopy(payload))
        return write(component, payload)

    monkeypatch.setattr(status, "write_ready", record)
    return written


async def _run_with_restarts(v, attempts: int = 10):
    """The DaemonSet's restart: a validator that raced a stale Failed pod
    runs again until the converge loop has swept it."""
    for _ in range(attempts):
        try:
            return await v.run("jax")
        except ValidationError:
            await asyncio.sleep(0.3)
    raise AssertionError("validator never recovered")


def _envs(pod: dict) -> dict:
    return {e["name"]: e.get("value", "") for e in pod["spec"]["containers"][0]["env"]}


async def _tombstone(client, svc: str):
    service = await client.get("", "Service", svc, NS)
    return (service["metadata"].get("annotations") or {}).get(comp.VALIDATED_EPOCH_ANNOTATION)


# ---------------------------------------------------------------------------
# end to end: the rendezvous pods run the port's distributed program


@pytest.mark.parametrize("num_hosts, topology, pool", [(2, "2x4", "pool-a"),
                                                       (4, "4x4", "pool-c")])
async def test_slice_validates_end_to_end(validation_root, jax_ready, num_hosts, topology,
                                          pool, monkeypatch):
    """Every host's validator runs at once; worker 0 converges the headless
    Service and one pinned pod per host, the pods rendezvous on gloo, every
    host's jax-ready lands with the reference's keys, the pods are collected
    and the Service carries the epoch's tombstone."""
    monkeypatch.delenv("ALLREDUCE_MIN_GBPS", raising=False)
    executed: list = []
    sim = SimConfig(pod_ready_delay=0.01, tick=0.01,
                    pod_executor=_exec_distributed_pod(executed))
    names = [f"tpu-{i}" for i in range(num_hosts)]
    async with FakeCluster(sim) as fc:
        for i, name in enumerate(names):
            _slice_node(fc, name, str(i), pool=pool, topology=topology)
        async with _validators(fc, names) as validators:
            status.write_ready("plugin")
            await asyncio.gather(*(v.run("jax") for v in validators))
            client = validators[0].client()
            pods = await client.list_items("", "Pod", NS)
            svc = await client.get("", "Service", f"tpu-jax-validation-{pool}", NS)
    # the slice floor: 0.25 x every host's cards x the H100 SXM NIC rate
    floor = 0.25 * num_hosts * CARDS * 100.0
    assert sorted(p["worker_id"] for p in jax_ready) == list(range(num_hosts))
    epochs = {p["epoch"] for p in jax_ready}
    assert len(epochs) == 1
    for payload in jax_ready:
        assert payload["mode"] == "multi-host" and payload["group"] == pool
        assert payload["workers"] == num_hosts
        assert payload["proven_by"] in ("workload-pod", "service-tombstone")
        assert PAYLOAD_KEYS - {"component", "ts"} <= set(payload)
        assert set(payload) <= PAYLOAD_KEYS | MEASURED_KEYS
        assert payload.get("allreduce_min_gbps", floor) == floor
        assert payload.get("algbw_gbps", 1.0) > 0
    assert jstatus.read_status("jax")["mode"] == "multi-host"
    # every host's pod ran, pinned and numbered by worker id
    by_name = {p["metadata"]["name"]: p for p in executed}
    assert len(by_name) == len(executed) == num_hosts
    for wid in range(num_hosts):
        pod = by_name[f"tpu-jax-validation-{pool}-w{wid}"]
        spec, ctr = pod["spec"], pod["spec"]["containers"][0]
        assert spec["nodeName"] == f"tpu-{wid}"
        assert spec["hostname"] == f"tpu-jax-validation-{pool}-w{wid}"
        assert spec["subdomain"] == f"tpu-jax-validation-{pool}"
        assert ctr["command"] == comp.DISTRIBUTED_COMMAND
        assert ctr["resources"]["limits"] == {consts.GPU_RESOURCE: str(CARDS)}
        envs = _envs(pod)
        assert envs["NUM_PROCESSES"] == str(num_hosts) and envs["PROCESS_ID"] == str(wid)
        assert envs["EXPECTED_DEVICES"] == str(CARDS)
        assert envs["COORDINATOR_ADDRESS"] == (
            f"tpu-jax-validation-{pool}-w0.tpu-jax-validation-{pool}.{NS}.svc:8476")
        assert float(envs["ALLREDUCE_MIN_GBPS"]) == floor
        assert float(envs["RING_MIN_GBPS"]) == 0.0 and "RESULTS_SCOPE" not in envs
        assert pod["metadata"]["labels"][comp.EPOCH_LABEL] in epochs
        assert pod["metadata"]["labels"]["tpu.google.com/slice-group"] == spec["subdomain"]
    # collected after the proof; the headless Service keeps the tombstone
    assert not [p for p in pods if p["metadata"]["name"].startswith("tpu-jax-validation")]
    assert svc["spec"]["clusterIP"] == "None"
    assert svc["metadata"]["annotations"][comp.VALIDATED_EPOCH_ANNOTATION] in epochs
    # the pods' program really ran across the hosts
    dropbox = status.read_workload_results()["distributed"]
    assert dropbox["ok"] and dropbox["num_processes"] == num_hosts
    assert dropbox["global_devices"] == num_hosts * CARDS and dropbox["psum"]["ok"]


async def test_slice_member_death_fails_bounded_then_revalidates(validation_root):
    """Worker 1's pod is SIGKILLed at the psum phase in the first run: every
    host's validation fails in bounded time with no jax-ready anywhere, the
    survivor's evidence in the drop-box.  With the fault cleared, the
    validators run again and the same epoch proves cleanly."""
    executed: list = []
    armed = {"on": True}

    def fault(pod):
        if armed["on"]:
            pod["spec"]["containers"][0]["env"] += [
                {"name": "FAULT_INJECT", "value": "psum:1"},
                {"name": "WATCHDOG_TIMEOUT_S", "value": "4"},
            ]

    sim = SimConfig(pod_ready_delay=0.01, tick=0.01,
                    pod_executor=_exec_distributed_pod(executed, fault))
    async with FakeCluster(sim) as fc:
        for i in range(2):
            _slice_node(fc, f"tpu-{i}", str(i), pool="pool-f")
        async with _validators(fc, ["tpu-0", "tpu-1"]) as validators:
            status.write_ready("plugin")
            t0 = time.monotonic()
            outcomes = await asyncio.gather(*(v.run("jax") for v in validators),
                                            return_exceptions=True)
            elapsed = time.monotonic() - t0
            assert all(isinstance(o, ValidationError) for o in outcomes), outcomes
            assert elapsed < 120, f"failure detection took {elapsed:.0f}s"
            assert not status.is_ready("jax")
            evidence = status.read_workload_results()["distributed"]
            assert evidence["ok"] is False and evidence["phase"] == "psum"
            assert evidence["process_id"] == 0

            armed["on"] = False
            await asyncio.gather(*(_run_with_restarts(v) for v in validators))
            payload = status.read_status("jax")
            assert payload["mode"] == "multi-host" and payload["workers"] == 2
            assert await _tombstone(validators[0].client(),
                                    "tpu-jax-validation-pool-f") == payload["epoch"]
    assert len(executed) == 4  # two failed, two that proved the slice


async def test_multislice_cross_slice_validation(validation_root, jax_ready, monkeypatch):
    """Two 2-host slices declared one multislice group: every host proves its
    own slice's rendezvous and then the cross-slice one over 4 hosts with
    global process ids, at the cross-slice floor, its figures in the
    ``multislice`` drop-box scope."""
    monkeypatch.delenv("ALLREDUCE_MIN_GBPS", raising=False)
    monkeypatch.delenv("MULTISLICE_MIN_GBPS", raising=False)
    executed: list = []
    sim = SimConfig(pod_ready_delay=0.01, tick=0.01,
                    pod_executor=_exec_distributed_pod(executed))
    async with FakeCluster(sim) as fc:
        names = _multislice_nodes(fc, "ms-test")
        async with _validators(fc, names) as validators:
            status.write_ready("plugin")
            await asyncio.gather(*(v.run("jax") for v in validators))
            pods = await validators[0].client().list_items("", "Pod", NS)
    assert len(jax_ready) == 4
    for payload in jax_ready:
        assert payload["mode"] == "multi-host" and payload["workers"] == 2
        ms = payload["multislice"]
        assert ms["group"] == "ms-test" and ms["workers"] == 4
        assert ms["proven_by"] in ("workload-pod", "service-tombstone")
    assert sorted(p["multislice"]["worker_id"] for p in jax_ready) == [0, 1, 2, 3]
    ms_pods = [p for p in executed if p["metadata"]["name"].startswith("tpu-ms-validation")]
    assert len({p["metadata"]["name"] for p in ms_pods}) == 4
    by_id = {}
    for p in ms_pods:
        envs = _envs(p)
        assert envs["NUM_PROCESSES"] == "4" and envs["RESULTS_SCOPE"] == "multislice"
        # the cross-slice floor (0.1 x the NIC rate), not the slice's
        assert float(envs["ALLREDUCE_MIN_GBPS"]) == 10.0
        by_id[envs["PROCESS_ID"]] = p["spec"]["nodeName"]
    # global ids: the slices by key, the hosts by worker id within each
    assert by_id == {"0": "tpu-pool-a-0", "1": "tpu-pool-a-1",
                     "2": "tpu-pool-b-0", "3": "tpu-pool-b-1"}
    slice_pods = [p for p in executed if p["metadata"]["name"].startswith("tpu-jax-validation")]
    assert len(slice_pods) == 4
    assert {float(_envs(p)["ALLREDUCE_MIN_GBPS"]) for p in slice_pods} == {100.0}
    dropbox = status.read_workload_results(scope="multislice")["distributed"]
    assert dropbox["ok"] and dropbox["num_processes"] == 4 and dropbox["global_devices"] == 8
    assert not [p for p in pods if p["metadata"]["name"].startswith(
        ("tpu-jax-validation", "tpu-ms-validation"))]


async def test_multislice_member_death_fails_bounded_then_revalidates(validation_root):
    """A member of the cross-slice rendezvous dies after both slices proved
    themselves: every host fails in bounded time; with the fault cleared the
    slices' tombstones are reused and only the cross-slice run proves
    again."""
    executed: list = []
    armed = {"on": True}

    def fault(pod):
        if armed["on"] and pod["metadata"]["name"].startswith("tpu-ms-validation"):
            pod["spec"]["containers"][0]["env"] += [
                {"name": "FAULT_INJECT", "value": "psum:1"},
                {"name": "WATCHDOG_TIMEOUT_S", "value": "4"},
            ]

    sim = SimConfig(pod_ready_delay=0.01, tick=0.01,
                    pod_executor=_exec_distributed_pod(executed, fault))
    async with FakeCluster(sim) as fc:
        names = _multislice_nodes(fc, "ms-fault")
        async with _validators(fc, names) as validators:
            client = validators[0].client()
            status.write_ready("plugin")
            t0 = time.monotonic()
            outcomes = await asyncio.gather(*(v.run("jax") for v in validators),
                                            return_exceptions=True)
            elapsed = time.monotonic() - t0
            assert all(isinstance(o, ValidationError) for o in outcomes), outcomes
            assert elapsed < 200, f"cross-slice failure took {elapsed:.0f}s"
            assert not status.is_ready("jax")
            for pool in ("pool-a", "pool-b"):
                assert await _tombstone(client, f"tpu-jax-validation-{pool}")
            evidence = status.read_workload_results(scope="multislice")["distributed"]
            assert evidence["ok"] is False and evidence["phase"] == "psum"

            armed["on"] = False
            slice_runs = sum(p["metadata"]["name"].startswith("tpu-jax-validation")
                             for p in executed)
            await asyncio.gather(*(_run_with_restarts(v) for v in validators))
            payload = status.read_status("jax")
            assert payload["multislice"]["workers"] == 4
            assert await _tombstone(client, "tpu-ms-validation-ms-fault") == \
                payload["multislice"]["epoch"]
    assert slice_runs == 4
    assert sum(p["metadata"]["name"].startswith("tpu-jax-validation")
               for p in executed) == slice_runs


async def test_stale_epoch_evidence_is_rejected(validation_root):
    """Succeeded pods of an older epoch do not gate jax-ready: the pod set
    is recreated at the current epoch and the slice proves again."""
    executed: list = []
    sim = SimConfig(pod_ready_delay=0.01, tick=0.01,
                    pod_executor=_exec_distributed_pod(executed))
    async with FakeCluster(sim) as fc:
        _slice_node(fc, "tpu-0", "0")
        _slice_node(fc, "tpu-1", "1")
        for wid in (0, 1):
            fc.put({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {
                    "name": f"tpu-jax-validation-pool-a-w{wid}", "namespace": NS,
                    "labels": {"tpu.google.com/slice-group": "tpu-jax-validation-pool-a",
                               comp.EPOCH_LABEL: "stale-epoch"},
                },
                "spec": {"nodeName": f"tpu-{wid}", "containers": [{"name": "c"}]},
                "status": {"phase": "Succeeded"},
            })
        async with _validators(fc, ["tpu-0", "tpu-1"], retries=900) as validators:
            status.write_ready("plugin")
            await asyncio.gather(*(v.run("jax") for v in validators))
            payload = status.read_status("jax")
            assert payload["mode"] == "multi-host" and payload["epoch"] != "stale-epoch"
            assert await _tombstone(validators[0].client(),
                                    "tpu-jax-validation-pool-a") == payload["epoch"]
    assert len(executed) == 2  # freshly run, not the stale ones


# ---------------------------------------------------------------------------
# the set rules: every host present, every id right, every slice declared


async def test_slice_requires_every_host(validation_root):
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        _slice_node(fc, "tpu-0", "0", pool="pool-b", topology="4x4")  # 1 of 4 hosts
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            status.write_ready("plugin")
            v = Validator(fast_config(with_workload=True), client=client)
            with pytest.raises(ValidationError, match="1/4 hosts"):
                await v.run("jax")
            assert await client.list_items("", "Pod", NS) == []
    assert not status.is_ready("jax")


@pytest.mark.parametrize("ids, match", [
    (("0", "not-a-number"), "non-numeric worker-id"),
    (("1", "1"), "duplicate worker ids"),
    (("0", None), "no worker-id label"),
    (("0", "5"), "do not cover"),
])
async def test_slice_rejects_malformed_worker_ids(validation_root, ids, match):
    """Worker ids are numeric, unique and cover 0..N-1: a host that silently
    became worker 0 would collide with the real one.  Both packages raise
    the same message."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        for i, wid in enumerate(ids):
            _slice_node(fc, f"tpu-{i}", wid)
        async with ApiClient(Config(base_url=fc.base_url)) as client, \
                JApiClient(JConfig(base_url=fc.base_url)) as jclient:
            status.write_ready("plugin")
            v = Validator(fast_config(with_workload=True), client=client)
            with pytest.raises(ValidationError, match=match) as mine:
                await v.run("jax")
            with pytest.raises(jcomp.ValidationError) as ref:
                await jcomp.Validator(jcomp.ValidatorConfig(
                    node_name="tpu-0", namespace=NS, with_workload=True),
                    client=jclient)._slice_group()
    assert str(mine.value) == str(ref.value)


async def test_multislice_missing_slice_fails(validation_root):
    """A declared 2-slice group with one slice visible fails; without the
    declaration the cross-slice run is skipped (None), not failed."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        _multislice_nodes(fc, "ms-x", pools=("pool-a",))
        async with ApiClient(Config(base_url=fc.base_url)) as client:
            v = Validator(fast_config(node_name="tpu-pool-a-0", with_workload=True),
                          client=client)
            with pytest.raises(ValidationError, match="multislice ms-x: 1/2 member slices"):
                await v._multislice_group()
            for i in range(2):
                node = await client.get("", "Node", f"tpu-pool-a-{i}")
                del node["metadata"]["labels"][consts.MULTISLICE_SLICES_LABEL]
                fc.put(node)
            assert await v._multislice_group() is None


async def test_perf_skips_on_a_slice_member(validation_root):
    """perf on a slice member clears its drop-box and flight record and
    writes the reference's skip payload; no probe pod is spawned."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        _slice_node(fc, "tpu-0", "0")
        _slice_node(fc, "tpu-1", "1")
        async with ApiClient(Config(base_url=fc.base_url)) as client, \
                JApiClient(JConfig(base_url=fc.base_url)) as jclient:
            payloads = []
            for validator in (
                Validator(fast_config(with_workload=True, workload_retries=5), client=client),
                jcomp.Validator(jcomp.ValidatorConfig(
                    node_name="tpu-0", namespace=NS, with_workload=True, workload_retries=5,
                    sleep_interval=0.01), client=jclient),
            ):
                status.write_ready("jax")
                status.write_workload_results({"checks": {"matmul": {"tflops": 1.0}}},
                                              scope="perf")
                with open(status.flight_record_path("perf"), "w") as f:
                    f.write('{"check": "matmul"}\n')
                await validator.run("perf")
                payloads.append(status.read_status("perf"))
                assert status.read_workload_results("perf") is None
                assert not os.path.exists(status.flight_record_path("perf"))
            with pytest.raises(ApiError):
                await client.get("", "Pod", "tpu-perf-probes", NS)
    mine, ref = ({k: v for k, v in p.items() if k != "ts"} for p in payloads)
    assert mine == ref
    assert mine["ok"] is True and mine["slice"] == "pool-a" and "skipped" in mine


# ---------------------------------------------------------------------------
# parity with the reference on the same Node objects


async def test_validation_epoch_tracks_runtime_identity(validation_root):
    """The epoch moves when a member's runtime pod is replaced (same name
    and version, new uid) and when the version label moves; both packages
    derive the same value from the same cluster."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        _slice_node(fc, "tpu-0", "0")
        _slice_node(fc, "tpu-1", "1")
        async with ApiClient(Config(base_url=fc.base_url)) as client, \
                JApiClient(JConfig(base_url=fc.base_url)) as jclient:
            v = Validator(fast_config(), client=client)
            ref = jcomp.Validator(jcomp.ValidatorConfig(node_name="tpu-0", namespace=NS),
                                  client=jclient)

            async def epochs():
                members = await client.list_items("", "Node")
                mine = await v._validation_epoch(members)
                assert mine == await ref._validation_epoch(members)
                return mine

            async def swap_runtime_pod():
                await client.delete("", "Pod", "tpu-runtime-x", NS)
                fc.put({
                    "apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": "tpu-runtime-x", "namespace": NS,
                                 "labels": {"app": "tpu-runtime"}},
                    "spec": {"nodeName": "tpu-1", "containers": [{"name": "c"}]},
                    "status": {"phase": "Running"},
                })

            # a pod of another app on the node is no runtime identity
            fc.put({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": "other", "namespace": NS, "labels": {"app": "x"}},
                    "spec": {"nodeName": "tpu-0", "containers": [{"name": "c"}]}})
            e0 = await epochs()
            await swap_runtime_pod()
            e1 = await epochs()
            assert e1 == await epochs() and e1 != e0
            await swap_runtime_pod()
            e2 = await epochs()
            assert e2 not in (e0, e1)
            node = await client.get("", "Node", "tpu-0")
            node["metadata"]["labels"][consts.TFD_RUNTIME_VERSION_LABEL] = "v9"
            fc.put(node)
            assert await epochs() not in (e0, e1, e2)


@pytest.mark.parametrize("key", ["pool-a", "p" * 80])
def test_group_names_are_the_references(key):
    """Pod and Service names byte-identical to the reference's (a mixed
    fleet and the unchanged operator find the same objects), the hashed
    form past 63 characters included."""
    mine = Validator(fast_config())
    ref = jcomp.Validator(jcomp.ValidatorConfig(node_name="tpu-0", namespace=NS))
    for base in ("tpu-jax-validation", comp.MULTISLICE_BASE):
        assert mine._group_service_name(key, base) == ref._group_service_name(key, base)
        for wid in (0, 3, 17):
            assert mine._group_pod_name(key, wid, base) == ref._group_pod_name(key, wid, base)
    assert utils.hashed_name("tpu-jax-validation", key) == \
        jhashed_name("tpu-jax-validation", key)
    assert len(mine._group_pod_name(key, 0)) <= 63
    assert utils.fnv1a_64(key.encode()) == jfnv1a_64(key.encode())
    assert (comp.COORDINATOR_PORT, comp.EPOCH_LABEL, comp.MULTISLICE_BASE,
            comp.VALIDATED_EPOCH_ANNOTATION) == (
        jcomp.COORDINATOR_PORT, jcomp.EPOCH_LABEL, jcomp.MULTISLICE_BASE,
        jcomp.VALIDATED_EPOCH_ANNOTATION)


def _node(name, **labels):
    return {"metadata": {"name": name, "labels": {
        consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
        consts.GKE_TPU_TOPOLOGY_LABEL: "2x4", consts.GKE_NODEPOOL_LABEL: "pool-a",
        **labels}}}


@pytest.mark.parametrize("labels", [
    [{consts.GKE_TPU_WORKER_ID_LABEL: "1"}, {consts.GKE_TPU_WORKER_ID_LABEL: "0"}],
    # feature discovery's label wins over GKE's
    [{consts.TFD_SLICE_WORKER_ID_LABEL: "0", consts.GKE_TPU_WORKER_ID_LABEL: "1"},
     {consts.TFD_SLICE_WORKER_ID_LABEL: "1", consts.GKE_TPU_WORKER_ID_LABEL: "0"}],
    [{consts.GKE_TPU_WORKER_ID_LABEL: "-1"}, {consts.GKE_TPU_WORKER_ID_LABEL: "0"}],
    [{consts.GKE_TPU_WORKER_ID_LABEL: "0", consts.GKE_TPU_TOPOLOGY_LABEL: "4x4"},
     {consts.GKE_TPU_WORKER_ID_LABEL: "1"}],
    [{consts.GKE_TPU_WORKER_ID_LABEL: "0"}, {consts.GKE_TPU_WORKER_ID_LABEL: "x"}],
])
def test_checked_worker_ids_are_the_references(labels):
    """The same ids, the same order, or the same error, on the same nodes;
    slice identity and host count as the reference reads them."""
    from tpu_operator.controllers.labels import slice_group_key
    from tpu_operator.k8s import nodeinfo as jnodeinfo

    members = [_node(f"tpu-{i}", **extra) for i, extra in enumerate(labels)]
    jmembers = copy.deepcopy(members)
    for m in members:
        assert nodeinfo.slice_group_key(m) == (slice_group_key(m) or "")
        assert nodeinfo.slice_hosts(m) == jnodeinfo.slice_hosts(m)
        assert nodeinfo.worker_id(m) == jnodeinfo.attributes(m).worker_id
    try:
        expected = jcomp.Validator._checked_worker_ids("pool-a", jmembers)
    except jcomp.ValidationError as e:
        with pytest.raises(ValidationError) as mine:
            Validator._checked_worker_ids("pool-a", members)
        assert str(mine.value) == str(e)
        return
    assert Validator._checked_worker_ids("pool-a", members) == expected
    assert members == jmembers


async def test_multislice_group_order_is_the_references(validation_root):
    """Global process ids: the slices by key, the hosts by worker id; the
    same group, order, ids and slices as the reference's, whatever order the
    apiserver lists the nodes in; nodes outside the group or without the
    accelerator label are no members."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        for pool in ("pool-z", "pool-a", "pool-m"):
            for i in (1, 0):
                _slice_node(fc, f"n-{pool}-{i}", str(i), pool=pool, **{
                    consts.MULTISLICE_GROUP_LABEL: "ms", consts.MULTISLICE_SLICES_LABEL: "3"})
        _slice_node(fc, "outside", "0", pool="pool-q")
        # no accelerator label: not a slice host, whatever its group label
        fc.add_node("cpu-node", tpu=False, labels={consts.MULTISLICE_GROUP_LABEL: "ms"})
        async with ApiClient(Config(base_url=fc.base_url)) as client, \
                JApiClient(JConfig(base_url=fc.base_url)) as jclient:
            mine = await Validator(fast_config(node_name="n-pool-m-1"),
                                   client=client)._multislice_group()
            ref = await jcomp.Validator(jcomp.ValidatorConfig(
                node_name="n-pool-m-1", namespace=NS), client=jclient)._multislice_group()
    assert mine[0] == ref[0] == "ms"
    names = [m["metadata"]["name"] for m in mine[1]]
    assert names == [m["metadata"]["name"] for m in ref[1]] == [
        "n-pool-a-0", "n-pool-a-1", "n-pool-m-0", "n-pool-m-1", "n-pool-z-0", "n-pool-z-1"]
    assert mine[2] == ref[2] == {n: i for i, n in enumerate(names)}
    assert {k: [m["metadata"]["name"] for m in v] for k, v in mine[3].items()} == \
        {k: [m["metadata"]["name"] for m in v] for k, v in ref[3].items()}


@pytest.mark.parametrize("gate_slice", [True, False])
async def test_rendezvous_pods_are_the_references(validation_root, gate_slice, monkeypatch):
    """The Service and each pod the port converges equal the reference's on
    the same nodes, but for the command, the resource's name and count (the
    node's cards, EXPECTED_DEVICES with it) and the floors."""
    for var in ("ALLREDUCE_MIN_GBPS", "MULTISLICE_MIN_GBPS", "RING_MIN_GBPS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TPU_METRICS_PUSH_URL", "http://agent:8932/push")
    monkeypatch.setenv("TPU_TRACEPARENT", "abc123-def456")
    owner = {"apiVersion": "apps/v1", "kind": "DaemonSet",
             "metadata": {"name": "tpu-operator-validator", "namespace": NS},
             "spec": {"template": {"spec": {"tolerations": [{"operator": "Exists"}]}}}}
    created = {}
    for pkg, make in (("mine", lambda c: Validator(fast_config(), client=c)),
                      ("ref", lambda c: jcomp.Validator(jcomp.ValidatorConfig(
                          node_name="tpu-0", namespace=NS), client=c))):
        async with FakeCluster(SimConfig(enabled=False)) as fc:
            fc.put(copy.deepcopy(owner))
            for i in range(2):
                _slice_node(fc, f"tpu-{i}", str(i), cards=8)
            client_cls, config_cls = ((ApiClient, Config) if pkg == "mine"
                                      else (JApiClient, JConfig))
            async with client_cls(config_cls(base_url=fc.base_url)) as client:
                v = make(client)
                members = sorted(await client.list_items("", "Node"),
                                 key=lambda m: m["metadata"]["name"])
                ids = {"tpu-0": 0, "tpu-1": 1}
                svc = v._group_service_name("pool-a")
                await v._ensure_group_workloads(
                    "pool-a", members, svc, "coord:8476", "e1", ids, gate_slice)
                created[pkg] = ([await client.get("", "Service", svc, NS)]
                                + [await client.get("", "Pod", v._group_pod_name("pool-a", i), NS)
                                   for i in (0, 1)])
    for mine, ref in zip(created["mine"], created["ref"]):
        for obj in (mine, ref):
            for key in ("uid", "resourceVersion", "creationTimestamp", "generation"):
                obj["metadata"].pop(key, None)
            for o in obj["metadata"].get("ownerReferences", []):
                o.pop("uid", None)
            obj.pop("status", None)
        if mine["kind"] == "Pod":
            ctr, rctr = mine["spec"]["containers"][0], ref["spec"]["containers"][0]
            assert ctr["command"] == comp.DISTRIBUTED_COMMAND
            assert rctr["command"] == ["python", "-m", "tpu_operator.workloads.distributed"]
            assert ctr["resources"]["limits"] == {consts.GPU_RESOURCE: "8"}
            assert rctr["resources"]["limits"] == {jconsts.TPU_RESOURCE: "4"}
            envs, renvs = _envs(mine), _envs(ref)
            assert envs["EXPECTED_DEVICES"] == "8" and renvs["EXPECTED_DEVICES"] == "4"
            # the floors: the port's from the H100 SXM NIC rate, over 16
            # cards on the slice; the reference's from the ICI or DCN rate
            assert float(envs["ALLREDUCE_MIN_GBPS"]) == (400.0 if gate_slice else 10.0)
            assert float(renvs["ALLREDUCE_MIN_GBPS"]) == (50.0 if gate_slice else 1.2)
            assert envs["RING_MIN_GBPS"] == renvs["RING_MIN_GBPS"] == "0.0"
            assert ("RESULTS_SCOPE" in envs) == (not gate_slice)
            ctr["command"], ctr["resources"] = rctr["command"], rctr["resources"]
            for e in ctr["env"]:
                if e["name"] in ("EXPECTED_DEVICES", "ALLREDUCE_MIN_GBPS"):
                    e["value"] = renvs[e["name"]]
        assert mine == ref


async def test_jax_ready_payload_is_the_references(validation_root, monkeypatch):
    """On the tombstone path (every rendezvous already proven at the current
    epoch) both packages write jax-ready from the same drop-boxes: the same
    keys and values but the time, and the reference's status reader and
    metrics mode read the port's ``multislice_workers``."""
    from tpu_operator.validator.metrics import NodeMetrics

    async with FakeCluster(SimConfig(enabled=False)) as fc:
        names = _multislice_nodes(fc, "ms-t")
        async with ApiClient(Config(base_url=fc.base_url)) as client, \
                JApiClient(JConfig(base_url=fc.base_url)) as jclient:
            v = Validator(fast_config(node_name=names[1], with_workload=True), client=client)
            ref = jcomp.Validator(jcomp.ValidatorConfig(
                node_name=names[1], namespace=NS, with_workload=True, sleep_interval=0.01,
                workload_retries=20), client=jclient)
            nodes = await client.list_items("", "Node")
            groups = {pool: [n for n in nodes
                             if n["metadata"]["labels"][consts.GKE_NODEPOOL_LABEL] == pool]
                      for pool in ("pool-a", "pool-b")}
            for key, members in groups.items():
                await client.create({"apiVersion": "v1", "kind": "Service", "metadata": {
                    "name": v._group_service_name(key), "namespace": NS, "annotations": {
                        comp.VALIDATED_EPOCH_ANNOTATION: await v._validation_epoch(members)}}})
            await client.create({"apiVersion": "v1", "kind": "Service", "metadata": {
                "name": v._group_service_name("ms-t", comp.MULTISLICE_BASE), "namespace": NS,
                "annotations": {comp.VALIDATED_EPOCH_ANNOTATION:
                                await v._validation_epoch(nodes)}}})
            payloads = []
            for validator in (v, ref):
                status.write_ready("plugin")
                status.write_workload_results({"distributed": {
                    "ok": True, "allreduce": {"algbw_gbps": 12.5, "min_gbps": 100.0},
                    "ring": {"link_gbps": 3.5, "min_gbps": 0.0}}})
                status.write_workload_results({"distributed": {
                    "ok": True, "allreduce": {"algbw_gbps": 7.5, "min_gbps": 10.0}}},
                    scope="multislice")
                await validator.run("jax")
                payloads.append(jstatus.read_status("jax"))
            assert await client.list_items("", "Pod", NS) == []
    mine, theirs = ({k: val for k, val in p.items() if k != "ts"} for p in payloads)
    assert mine == theirs
    assert mine["proven_by"] == "service-tombstone" and mine["worker_id"] == 1
    assert mine["multislice"]["workers"] == 4 and mine["multislice"]["worker_id"] == 1
    assert mine["multislice"]["algbw_gbps"] == 7.5 and mine["algbw_gbps"] == 12.5
    # the port's file, read by the reference's exporter
    status.write_ready("jax", {k: val for k, val in payloads[0].items()
                               if k not in ("component", "ts")})
    m = NodeMetrics()
    m.scrape()
    out = m.render().decode()
    assert 'metric="multislice_workers"' in out and 'metric="slice_workers"' in out
    assert 'metric="multislice_allreduce_gbps"' in out


@pytest.mark.parametrize("generation, cards, floor", [
    ("h100-sxm", 16, 400.0),   # 0.25 x 16 cards x 100 GB/s (four 200 Gb/s NICs)
    ("h200", 16, 1600.0),      # 0.25 x 16 x 400 GB/s (eight 400 Gb/s)
    ("unknown", 16, 0.0),      # no NIC rate known: report-only
])
def test_slice_floor_from_the_nic_rate(generation, cards, floor, monkeypatch):
    """The slice floor is the reference's slice fraction of n x the host NIC
    rate (the port's busbw counts the global buffer); ALLREDUCE_MIN_GBPS
    overrides it, an explicit 0 included; the cross-slice run keeps its
    own floor, 0.1 x the NIC rate."""
    for var in ("ALLREDUCE_MIN_GBPS", "MULTISLICE_MIN_GBPS"):
        monkeypatch.delenv(var, raising=False)
    info = nodeinfo.generation_info(generation)
    assert comp._slice_min_gbps(generation, cards) == floor == \
        comp.ALLREDUCE_GATE_FRACTION * cards * info.nic_gbps
    assert comp._multislice_min_gbps(generation) == round(0.1 * info.nic_gbps, 1)
    monkeypatch.setenv("ALLREDUCE_MIN_GBPS", "0")
    assert comp._slice_min_gbps(generation, cards) == 0.0
    monkeypatch.setenv("ALLREDUCE_MIN_GBPS", "55.5")
    assert comp._slice_min_gbps(generation, cards) == 55.5
