"""Fixtures of the benchmark's tests: tiny sizes of the cells for the CPU,
and the look for a card, made inside a fixture (never at import)."""

import pytest

from benchmark.spec import Spec

TINY = {"d_model": 64, "n_heads": 4, "d_head": 16, "d_ff": 128}


@pytest.fixture
def spec():
    return Spec()


# The readiness-gate cell as BENCHMARK.json would name it: its runner,
# configuration, traffic, limits and readers are files of the benchmark,
# and the cell waits for a host whose process starts are steady enough to
# bound its time.
GATE = {
    "configs": {"name": "gate-h100", "source": "the gate pod's own settings",
                "file": "benchmark/configs/gate-h100.json", "reduced": [], "why": "a test"},
    "workloads": {"name": "gate.x1", "config": "gate-h100", "traffic": "gate.back_to_back",
                  "chips": 1, "why": "a test"},
    "end_to_end": {"name": "gate_s", "unit": "s", "better": "lower", "bound": 0.25,
                   "source": "host_clock", "workloads": ["gate.x1"]},
    "per_layer": [{"name": f"gate.{m}_s", "unit": "s", "better": "lower",
                   "source": "host_clock", "layer": "gate", "moves": "gate_s",
                   "workloads": ["gate.x1"]} for m in ("start", "checks")],
}


@pytest.fixture
def gate_spec():
    """The spec with the gate cell in it, where BENCHMARK.json has none."""
    spec = Spec()
    if "gate.x1" not in {w["name"] for w in spec.bench["workloads"]}:
        for key, entry in GATE.items():
            spec.bench[key] += entry if isinstance(entry, list) else [entry]
        setup = next(m for m in spec.bench["end_to_end"] if m["name"] == "setup_s")
        if "workloads" in setup:
            setup["workloads"].append("gate.x1")
    return spec


@pytest.fixture
def tiny(spec):
    """(config, traffic) of a training cell at a size the CPU runs in
    seconds: the widths cut to 64, the tokens to 32 a rank."""

    def make(cell: str):
        w = spec.workload(cell)
        config = dict(spec.config(w["config"]), **TINY)
        traffic = dict(spec.traffic(w["traffic"]), seq_per_mp=32, traced_seconds=0.2)
        return config, traffic

    return make


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.device_count()


@pytest.fixture(autouse=True)
def _program_unpatched():
    """A fault planted in this process (a one-card run's patch) goes with
    its test."""
    from tpu_operator_torch.workloads import collectives

    saved = {n: getattr(collectives, n) for n in ("transformer_step", "_sum", "vector_add_kernel")}
    yield
    for name, value in saved.items():
        setattr(collectives, name, value)
