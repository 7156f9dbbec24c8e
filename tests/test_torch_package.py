"""Package rules of the PyTorch port: it imports neither JAX nor the
reference package, it never falls back to the CPU on its own, its local
multi-rank launcher fails fast, and its own copies of the reference's
JAX-free helpers (timing rules, trace context) behave as the originals."""

import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from tpu_operator.obs import trace as jtrace  # noqa: E402
from tpu_operator.workloads import timing as jtiming  # noqa: E402
from tpu_operator_torch.obs import trace as ttrace  # noqa: E402
from tpu_operator_torch.workloads import _ranks, resolve_device, subprocess_pythonpath  # noqa: E402
from tpu_operator_torch.workloads import timing as ttiming  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, runpy, sys
import tpu_operator_torch
names = [m.name for m in pkgutil.walk_packages(tpu_operator_torch.__path__, "tpu_operator_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke")  # its imports; main is guarded
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "tpu_operator"))
print(",".join(names))
print("LEAKED", leaked)
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "TORCH_DEVICE"}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def test_port_imports_neither_jax_nor_the_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names, leaked = proc.stdout.strip().splitlines()[-2:]
    for module in ("workloads.run_validation", "workloads.collectives", "workloads._ranks",
                   "workloads.ring_attention", "workloads.longctx", "workloads.matmul_bench",
                   "workloads.hbm_bench", "workloads.hbm_dma", "workloads.train_bench",
                   "workloads.moe", "workloads.ulysses", "workloads.pipeline",
                   "workloads.watchdog", "workloads.distributed",
                   "workloads.serving", "workloads.checkpoint", "workloads.compile_cache",
                   "workloads.warmpool", "utils", "obs.profile",
                   "kernels.vector_add", "kernels.flash_attention", "kernels.flash_backward",
                   "kernels.dma_pipeline", "kernels._build",
                   "k8s.nodeinfo", "obs.flight", "validator.status",
                   "hw", "k8s.client", "obs.events", "validator.components",
                   "validator.cli", "workloads.partition_acceptance",
                   "nvml", "obs.logging", "deviceplugin.plugin", "deviceplugin.rpc",
                   "deviceplugin.api_pb2", "deviceplugin.sliceconfig", "agents.base",
                   "agents.feature_discovery", "agents.metrics_agent",
                   "agents.metrics_exporter", "agents.node_status_exporter",
                   "validator.metrics", "slices", "agents.slice_manager",
                   "agents.runtime_manager", "agents.vfio_manager", "agents.config_manager",
                   "agents.runtime_prep", "agents.libtpu_installer",
                   "agents.vm_runtime_manager", "deviceplugin.__main__"):
        assert f"tpu_operator_torch.{module}" in names.split(",")
    assert leaked == "LEAKED []"


def _sources():
    pkg = os.path.join(REPO, "tpu_operator_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_reference():
    """Every import statement in the port's sources and chip_smoke.py,
    those inside functions too (the import check above sees only what
    importing runs)."""
    import ast

    banned = {"jax", "jaxlib", "ml_dtypes", "tpu_operator"}
    found = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                      for n in names if n.split(".")[0] in banned]
    assert len(list(_sources())) > 20
    assert found == []


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.delenv("TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    assert resolve_device().type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_gate_without_a_card_exits_nonzero(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.workloads.run_validation"],
        cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES="", TPU_VALIDATION_ROOT=str(tmp_path)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "workload-results").exists()  # no results claimed


def test_subprocess_pythonpath(monkeypatch):
    monkeypatch.delenv("PYTHONPATH", raising=False)
    assert subprocess_pythonpath() == REPO
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    assert subprocess_pythonpath() == REPO + os.pathsep + "/elsewhere"


def _rank_fails(rank, world_size, device):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank one fails")
    dist.barrier()  # would wait for rank 1 until the group's timeout
    return {}


def test_failing_rank_fails_the_run_fast():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank one fails"):
        _ranks.run(_rank_fails, 2, "cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60  # not the group's 120 s timeout


def test_flight_push_reaches_the_agent():
    """The copied push client POSTs the mapped counters and step windows to
    TPU_METRICS_PUSH_URL in the reference's body format."""
    import http.server
    import json
    import threading

    from tpu_operator_torch.obs import flight

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
    try:
        recorder = flight.FlightRecorder(push_url=f"http://127.0.0.1:{server.server_port}/push")
        with flight.activate(recorder):
            flight.record("allreduce", "step", step=0, step_s=0.5, gbps=10.0)
            flight.record_step("allreduce", step_seq=0, wall_s=0.5,
                               phases={"collective-wait": 0.5, "bogus": 1.0})
        # close() (on leaving activate) drains the push before returning
    finally:
        server.shutdown()
        thread.join(5.0)
    assert bodies and all(b["source"] == "workload" for b in bodies)
    work = {}
    for body in bodies:
        for check, entry in body["workloads"].items():
            work.setdefault(check, {"counters": {}, "steps": []})
            work[check]["counters"].update(entry["counters"])
            work[check]["steps"] += entry.get("steps", [])
    counters = work["allreduce"]["counters"]
    assert counters["tpu_workload_achieved_gbps"] == 10.0
    assert counters["tpu_workload_step_duration_seconds"] == 0.5
    (step,) = work["allreduce"]["steps"]
    assert step["step_seq"] == 0 and step["phases"] == {"collective-wait": 0.5}


@pytest.mark.parametrize(
    "raw, floor, per",
    [([1.0, 1.2, 1.1], 0.1, 10), ([0.3, 0.2], 0.15, 1), ([0.1], 0.2, 4)],
)
def test_subtract_floor_matches_reference(raw, floor, per):
    assert ttiming.subtract_floor(raw, floor, per) == jtiming.subtract_floor(raw, floor, per)


@pytest.mark.parametrize("link", [True, False])
@pytest.mark.parametrize("value", [50.0, 500.0])
def test_min_gate_matches_reference(monkeypatch, link, value):
    """Same verdict as the reference's rule, with nvlink in the place of
    ici and the cuda backend in the place of tpu."""
    monkeypatch.delenv("X_GATE", raising=False)
    mine = ttiming.apply_min_gate(
        {"ok": True, "gbps": value, "backend": "cuda",
         "transport": "nvlink" if link else "hbm-local"},
        metric="gbps", minimum=100.0, backends_env="X_GATE", label="x",
        require_interconnect=True,
    )
    ref = jtiming.apply_min_gate(
        {"ok": True, "gbps": value, "backend": "tpu",
         "transport": "ici" if link else "hbm-local"},
        metric="gbps", minimum=100.0, backends_env="X_GATE", label="x",
        require_ici=True,
    )
    assert mine == {**ref, "backend": "cuda", "transport": mine["transport"]}


@pytest.mark.parametrize(
    "value",
    ["abc123-def456", "abc123-0-beef", "abc123", "xyz-def", "a-b-c-d", "", "ABC-def"],
)
def test_trace_context_parse_matches_reference(value):
    mine, ref = ttrace.TraceContext.parse(value), jtrace.TraceContext.parse(value)
    assert (mine and (mine.trace_id, mine.span_id, mine.reconcile_id)) == (
        ref and (ref.trace_id, ref.span_id, ref.reconcile_id)
    )


def test_spans_join_the_adopted_trace():
    tracer = ttrace.Tracer()
    ctx = ttrace.TraceContext.parse("abc123-def456-beef")
    with tracer.adopt(ctx):
        with ttrace.span("check/x", kind=ttrace.KIND_PHASE, phase="x") as sp:
            with ttrace.span("inner") as inner:
                pass
    assert sp.trace_id == inner.trace_id == "abc123"
    assert sp.remote_parent == "def456" and sp.reconcile_id == inner.reconcile_id == "beef"
    assert inner.parent is sp and not inner.remote_parent
    assert sp.duration_s is not None
    with ttrace.span("untraced") as none:
        assert none is None
