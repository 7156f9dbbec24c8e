"""The port's card-facing node agents against the reference's on one
synthetic host: feature discovery, the metrics agent (its /push, /counters
and /metrics over HTTP, its card counters), the exporter, the health
assessor and the validator's metrics mode.  The reference sees
``/dev/accel0..3``; the port a four-card NVML inventory and sample put in
place of the library's."""

import asyncio
import os
import socket
import subprocess
import sys

import aiohttp
import pytest

from tpu_operator import consts as jconsts
from tpu_operator.agents import feature_discovery as jfd
from tpu_operator.agents import metrics_agent as jagent
from tpu_operator.agents import metrics_exporter as jexporter
from tpu_operator.agents.node_status_exporter import HealthAssessor as JAssessor
from tpu_operator.validator import metrics as jmetrics
from tpu_operator.validator import status as jstatus
from tpu_operator_torch import nvml
from tpu_operator_torch.agents import feature_discovery as tfd
from tpu_operator_torch.agents import metrics_agent as tagent
from tpu_operator_torch.agents import metrics_exporter as texporter
from tpu_operator_torch.agents.node_status_exporter import HealthAssessor as TAssessor
from tpu_operator_torch.validator import cli
from tpu_operator_torch.validator import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "NVIDIA H100 80GB HBM3"


def cards(n: int) -> tuple:
    return tuple(nvml.Card(i, f"GPU-{i:08x}-0000-0000-0000-{i:012x}", i, NAME, 85520809984)
                 for i in range(n))


def sample(card: nvml.Card) -> dict:
    return {"gpu_utilization_percent": 10.0 * (card.index + 1),
            "memory_total_bytes": float(card.memory_total),
            "memory_used_bytes": 1e9 * (card.index + 1)}


class Host:
    """The synthetic host: ``n`` accel nodes for the reference, as many
    cards in the port's inventory; ``set(n)`` changes both."""

    def __init__(self, root, monkeypatch):
        self.dev = root / "hw" / "dev"
        self.dev.mkdir(parents=True)
        self.cards = ()
        self.fail = None
        monkeypatch.setenv("TPU_HW_ROOT", str(root / "hw"))
        monkeypatch.delenv("TPU_CHIP_COUNT", raising=False)
        monkeypatch.setattr(nvml, "inventory", self.inventory)
        monkeypatch.setattr(nvml, "sample", sample)
        self.set(4)

    def inventory(self) -> nvml.Inventory:
        if self.fail is not None:
            raise self.fail
        return nvml.Inventory(self.cards, "570.124.06", "12.8")

    def set(self, n: int) -> None:
        for path in self.dev.glob("accel*"):
            path.unlink()
        for i in range(n):
            (self.dev / f"accel{i}").touch()
        self.cards = cards(n)


@pytest.fixture
def host(tmp_path, monkeypatch, validation_root):
    (validation_root / "validations").mkdir()
    return Host(tmp_path, monkeypatch)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# feature discovery


NODES = [
    {},
    {"metadata": {"labels": {jconsts.GKE_TPU_TOPOLOGY_LABEL: "4x4",
                             jconsts.GKE_TPU_WORKER_ID_LABEL: "2"}}},
    {"metadata": {"labels": {jconsts.GKE_TPU_TOPOLOGY_LABEL: "2x2x4",
                             jconsts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5p-slice"}}},
]


@pytest.mark.parametrize("node", NODES)
@pytest.mark.parametrize("worker_env", ["", "1"])
def test_feature_discovery_matches_reference(host, validation_root, monkeypatch, node,
                                             worker_env):
    if worker_env:
        monkeypatch.setenv("TPU_WORKER_ID", worker_env)
    else:
        monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    worker_file = validation_root / "worker_id"
    ref = jfd.discover_features(node)
    ref_file = worker_file.read_text() if worker_file.exists() else None
    if worker_file.exists():
        worker_file.unlink()
    port = tfd.discover_features(node)
    port_file = worker_file.read_text() if worker_file.exists() else None
    for key in (jconsts.TFD_CHIPS_PER_HOST_LABEL, jconsts.TFD_SLICE_HOSTS_LABEL,
                jconsts.TFD_SLICE_WORKER_ID_LABEL, jconsts.TFD_ICI_TOPOLOGY_LABEL):
        assert port.get(key) == ref.get(key), key
    assert port_file == ref_file  # the same handoff file, written or absent
    assert port[jconsts.TFD_CHIP_LABEL] == "h100-sxm"
    assert port[jconsts.TFD_HBM_GB_LABEL] == "80"
    assert port["nvidia.com/gpu.product"] == "NVIDIA-H100-80GB-HBM3"
    assert port[jconsts.TFD_RUNTIME_VERSION_LABEL] == "570.124.06-cuda12.8"


def test_feature_discovery_removes_a_stale_worker_id(host, validation_root, monkeypatch):
    monkeypatch.setenv("TPU_WORKER_ID", "5")
    tfd.discover_features({})
    assert (validation_root / "worker_id").read_text() == "5"
    monkeypatch.delenv("TPU_WORKER_ID")
    labels = tfd.discover_features({})
    assert not (validation_root / "worker_id").exists()
    assert jconsts.TFD_SLICE_WORKER_ID_LABEL not in labels


# ---------------------------------------------------------------------------
# the metrics agent


PUSHES = [
    {"source": "workload", "workloads": {
        "matmul": {"counters": {"tpu_workload_achieved_tflops": 187.5, "tpu_workload_mfu": 0.95,
                                "tpu_workload_steps_total": 3, "not_a_known_counter": 1.0}},
        "train": {"counters": {"tpu_workload_tokens_per_sec": 120000.0},
                  "steps": [{"step_seq": 0, "wall_s": 0.5, "host": "h",
                             "phases": {"compute": 0.4, "bogus": 1.0}}]}}},
    {"workloads": {"matmul": {"counters": {"tpu_workload_mfu": 0.9}},
                   "serve": {"counters": {"tpu_workload_serving_tokens_per_sec": 55.5}}},
     "join_phases": {"compile": 1.5}},
]


async def _drive_agent(module, push_bodies) -> tuple:
    port = free_port()
    stop = asyncio.Event()
    task = asyncio.create_task(module.serve(port, stop, cache_ttl=0.0))
    try:
        async with aiohttp.ClientSession() as http:
            for _ in range(100):
                try:
                    async with http.get(f"http://127.0.0.1:{port}/counters") as r:
                        if r.status == 200:
                            break
                except aiohttp.ClientError:
                    await asyncio.sleep(0.05)
            accepted = []
            for body in push_bodies:
                async with http.post(f"http://127.0.0.1:{port}/push", json=body) as r:
                    accepted.append((r.status, (await r.json())["accepted"]))
            async with http.get(f"http://127.0.0.1:{port}/counters") as r:
                counters = await r.json()
            async with http.get(f"http://127.0.0.1:{port}/metrics") as r:
                text = await r.text()
            async with http.post(f"http://127.0.0.1:{port}/push", data=b"x" * 300000) as r:
                accepted.append((r.status, None))
    finally:
        stop.set()
        await asyncio.wait_for(task, 10)
    return accepted, counters, text


async def test_metrics_agent_pushes_match_reference(host):
    jacc, jcounters, jtext = await _drive_agent(jagent, PUSHES)
    tacc, tcounters, ttext = await _drive_agent(tagent, PUSHES)
    assert tacc == jacc == [(200, 2), (200, 2), (413, None)]
    assert tcounters["workloads"] == jcounters["workloads"]

    def workload_lines(text):
        return [line for line in text.splitlines() if "tpu_workload_" in line]

    assert workload_lines(ttext) == workload_lines(jtext) and workload_lines(ttext)
    # the card series: one per card, from NVML
    assert sorted(tcounters["chips"]) == ["0", "1", "2", "3"]
    assert tcounters["chips"]["1"]["tpu_duty_cycle_percent"] == 20.0
    assert tcounters["chips"]["1"]["tpu_hbm_memory_usage_bytes"] == 2e9
    assert 'tpu_hbm_memory_total_bytes{chip="3"} 85520809984.0' in ttext


def test_a_failed_nvml_query_counts_one_scrape_error(host, monkeypatch):
    def flaky(card):
        if card.index == 2:
            raise nvml.NvmlError("libnvidia-ml.so.1: nvmlDeviceGetUtilizationRates returned 15",
                                 nvml.ERROR_GPU_IS_LOST)
        return {"gpu_utilization_percent": 50.0}  # no memory, no NVLink: not errors

    monkeypatch.setattr(nvml, "sample", flaky)
    errors = {}
    first = asyncio.run(tagent.collect(None, errors))["chips"]
    assert [first[i]["tpu_chip_scrape_errors_total"] for i in range(4)] == [0.0, 0.0, 1.0, 0.0]
    assert first[2]["tpu_duty_cycle_percent"] == 0.0
    assert first[0]["tpu_duty_cycle_percent"] == 50.0
    assert first[0]["tpu_ici_transmitted_bytes_total"] == 0.0  # unsupported: zero fill
    assert first[0]["tpu_tensorcore_utilization_percent"] == 0.0  # no NVML source
    second = tagent.card_counters(errors)
    assert second[2]["tpu_chip_scrape_errors_total"] == 2.0
    # the card drops out of NVML's list: its failures stay in the snapshot
    host.cards = host.cards[:2]
    third = tagent.card_counters(errors)
    assert sorted(third) == [0, 1, 2] and third[2]["tpu_chip_scrape_errors_total"] == 2.0
    text = tagent.to_prometheus({"chips": third})
    assert text.count("tpu_duty_cycle_percent{") == 3


def test_metrics_agent_without_nvml_fails_loudly(host):
    host.fail = nvml.NvmlError("NVML (libnvidia-ml.so.1) not found under '/' nor by the loader")
    with pytest.raises(nvml.NvmlError, match=r"libnvidia-ml\.so\.1"):
        tagent.card_counters({})


async def test_exporter_matches_reference_sample_lines(host):
    snapshot = {"chips": {0: {"tpu_duty_cycle_percent": 42.0, "tpu_hbm_memory_usage_bytes": 9}},
                "workloads": {"matmul": {"tpu_workload_mfu": 0.9}}}
    allow = {"tpu_duty_cycle_percent", "tpu_workload_mfu"}
    for allowed in (None, allow):
        jlines = [x for x in jexporter.render(snapshot, "n1", allowed).splitlines()
                  if not x.startswith("# HELP")]
        tlines = [x for x in texporter.render(snapshot, "n1", allowed).splitlines()
                  if not x.startswith("# HELP")]
        assert tlines == jlines
    # the agent down: the exporter collects from NVML itself
    fallback = await texporter.fetch_snapshot(free_port())
    assert sorted(fallback["chips"]) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the health assessor and the validator's metrics mode


def _steps(host, validation_root):
    """(action, agent counters) per round; each action moves both hosts."""
    def ready(*components):
        for c in components:
            jstatus.write_ready(c)

    def clear(*components):
        for c in components:
            jstatus.clear(c)

    def counters(total):
        return {"chips": {"0": {"tpu_chip_scrape_errors_total": total}, "1": {}}}

    return [
        (lambda: None, None),
        (lambda: ready("libtpu", "pjrt", "plugin", "jax"), counters(0.0)),
        (lambda: clear("jax"), counters(0.0)),
        (lambda: None, counters(2.0)),
        (lambda: ready("jax"), counters(2.0)),
        (lambda: None, counters(3.0)),
        (lambda: host.set(0), counters(3.0)),
        (lambda: host.set(2), None),
        (lambda: clear("plugin"), {"chips": "garbage"}),
        (lambda: ready("plugin"), counters(3.0)),
    ]


def test_health_assessor_matches_reference(host, validation_root):
    jassess, tassess = JAssessor(), TAssessor()
    verdicts = []
    for action, counters in _steps(host, validation_root):
        action()
        j, t = jassess.assess(counters), tassess.assess(counters)
        assert t == j
        verdicts.append(t)
    reasons = [reason for _, reason in verdicts]
    assert "validator-regressed:jax" in reasons and "chip-scrape-failed" in reasons
    assert "no-devices" in reasons and ("ok", "") in verdicts


def test_assessor_reads_a_dead_nvml_as_no_devices(host):
    assessor = TAssessor()
    assert assessor.assess(None) == ("ok", "")
    host.fail = nvml.NvmlError("libnvidia-ml.so.1: nvmlDeviceGetCount_v2 returned 12", 12)
    assert assessor.assess(None) == ("unhealthy", "no-devices")


def test_validator_metrics_mode_matches_reference(host, monkeypatch):
    monkeypatch.setenv("NODE_NAME", "gpu-node-0")
    jstatus.write_ready("libtpu")
    jstatus.write_ready("jax", {"algbw_gbps": 800.5, "workers": 2, "ok": True,
                                "multislice": {"workers": 4, "algbw_gbps": 50.0}})
    jstatus.write_ready("perf", {"hbm_gbps": 2900.0, "mfu": 0.61, "error": "x"})
    for n in (4, 3, 0):
        host.set(n)
        ref, port = jmetrics.NodeMetrics(), tmetrics.NodeMetrics()
        ref.scrape()
        port.scrape()
        assert port.device_count == n
        assert port.render() == ref.render()
    jstatus.clear("jax")  # a metric gone from the payload stops being served
    port.scrape()
    assert "allreduce_gbps" not in port.render().decode()


def test_cli_serves_the_gauges_once(host, monkeypatch, capsys):
    monkeypatch.setenv("NODE_NAME", "gpu-node-0")
    host.set(3)
    jstatus.write_ready("plugin")
    assert cli.main(["--component", "metrics", "--oneshot"]) == 0
    out = capsys.readouterr().out
    assert 'tpu_validator_tpu_device_count{node="gpu-node-0"} 3.0' in out
    assert 'tpu_validator_validation_status{component="plugin",node="gpu-node-0"} 1.0' in out


_BLOCKED = """
import sys
for name in ("grpc", "google.protobuf", "aiohttp", "prometheus_client"):
    sys.modules[name] = None
import asyncio, os
from tpu_operator_torch import nvml
cards = tuple(nvml.Card(i, f"GPU-{i}", i, "NVIDIA H100 80GB HBM3", 85520809984) for i in range(2))
nvml.inventory = lambda: nvml.Inventory(cards, "570.124.06", "12.8")
nvml.sample = lambda card: {"gpu_utilization_percent": 1.0}
nvml.topology = lambda uuids: {frozenset((a, b)): 10 for a in uuids for b in uuids if a != b}
from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin
from tpu_operator_torch.deviceplugin import sliceconfig, __main__
from tpu_operator_torch.agents import feature_discovery, metrics_agent, metrics_exporter
from tpu_operator_torch.agents.node_status_exporter import HealthAssessor
from tpu_operator_torch.validator.metrics import NodeMetrics
plugin = GPUDevicePlugin()
plugin.refresh_devices()
assert plugin.snapshot() == [("GPU-0", "Healthy"), ("GPU-1", "Healthy")], plugin.snapshot()
assert plugin.allocate(["GPU-1"])["envs"]["CUDA_VISIBLE_DEVICES"] == "GPU-1"
assert plugin.preferred_allocation(["GPU-0", "GPU-1"], [], 1) == ["GPU-0"]
assert feature_discovery.discover_features({})["tpu.google.com/tpu.chips-per-host"] == "2"
snapshot = asyncio.run(metrics_agent.collect(metrics_agent.PushStore(), {}))
assert snapshot["chips"][1]["tpu_duty_cycle_percent"] == 1.0
assert metrics_agent.to_prometheus(snapshot).count("tpu_duty_cycle_percent{") == 2
assert HealthAssessor().assess(snapshot) == ("ok", "")
metrics = NodeMetrics()
metrics.scrape()
assert metrics.device_count == 2
print("OK", sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("grpc", "aiohttp", "prometheus_client", "torch", "jax")
    or m.startswith("google.protobuf"))))
"""


def test_agents_run_without_the_transport_packages(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "TPU_HW_ROOT": str(tmp_path),
           "TPU_VALIDATION_ROOT": str(tmp_path / "run")}
    (tmp_path / "dev").mkdir()
    for i in range(2):
        (tmp_path / "dev" / f"nvidia{i}").touch()
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK []"
