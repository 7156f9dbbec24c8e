"""The port's warm-pool check (``tpu_operator_torch/workloads/warmpool.py``)
against the reference's contract: the result keys, the counters (here they
count kernel libraries), the flight samples, publication only after a miss,
and the three canonical programs' values.

The reference's hit path (``serialize_compiled``/``load_serialized``) fails
in this environment and is no oracle here; the programs' values are held
against ``jax.jit(fn)(*args)`` of the reference's programs instead."""

import os

import pytest

pytest.importorskip("torch")

from tpu_operator.obs import flight as jflight  # noqa: E402
from tpu_operator.workloads import compile_cache as jcc  # noqa: E402
from tpu_operator.workloads import warmpool as jwp  # noqa: E402
from tpu_operator_torch.kernels import _build  # noqa: E402
from tpu_operator_torch.obs import flight  # noqa: E402
from tpu_operator_torch.workloads import compile_cache as cc  # noqa: E402
from tpu_operator_torch.workloads import warmpool as wp  # noqa: E402

NAMES = ["alpha", "beta", "gamma"]
# warmpool.py:143-155, the reference's result keys
REFERENCE_KEYS = {"ok", "programs", "hits", "misses", "corrupt", "prewarmed", "published",
                  "compile_s", "fetch_s", "duration_s", "results"}


@pytest.fixture
def sources(tmp_path, monkeypatch):
    """Three kernel sources in a csrc/ of their own, an empty build dir."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in NAMES:
        (csrc / f"{name}.cu").write_text(f'extern "C" int tpu_{name}(int n) {{ return n; }}\n')
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    for var in (cc.FLEET_CACHE_URL_ENV, cc.ARTIFACTS_ENV, wp.GENERATION_ENV, wp.TOPOLOGY_ENV):
        monkeypatch.delenv(var, raising=False)
    return csrc


def _build_fn(builds: list):
    def build(name):
        _, path = _build.target(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"LIB " + name.encode())
        builds.append(name)
        return _build.Built(path, 0.1, "")
    return build


def _load(name, path):
    with open(path, "rb") as f:
        if f.read() != b"LIB " + name.encode():
            raise OSError(f"{path}: invalid ELF header")


def _fresh_node(tmp_path):
    """A node that has built nothing: the build dir emptied."""
    for f in os.listdir(_build.BUILD_DIR):
        os.remove(os.path.join(_build.BUILD_DIR, f))


def _run(tmp_path, builds, **kwargs):
    store = cc.ArtifactStore(str(tmp_path / "artifacts"))  # fresh stats each run
    return wp.run(store=store, names=NAMES, build=_build_fn(builds), load=_load,
                  device="cpu", **kwargs)


def test_cold_then_warm_counts_libraries(sources, tmp_path):
    builds = []
    cold = _run(tmp_path, builds)
    assert REFERENCE_KEYS <= set(cold)
    assert cold["ok"] and cold["programs"] == 3 and sorted(builds) == NAMES
    assert (cold["hits"], cold["misses"], cold["corrupt"]) == (0, 3, 0)
    assert cold["compile_s"] > 0 and cold["fetch_s"] == 0
    assert all(not lib["hit"] for lib in cold["libraries"].values())
    _fresh_node(tmp_path)
    warm = _run(tmp_path, builds)
    assert len(builds) == 3  # nothing built again
    assert (warm["hits"], warm["misses"], warm["corrupt"]) == (3, 0, 0)
    assert warm["compile_s"] == 0 and warm["fetch_s"] > 0
    assert set(warm["libraries"]) == set(NAMES)
    assert all(lib["hit"] and lib["bytes"] == len(b"LIB ") + len(name)
               for name, lib in warm["libraries"].items())
    assert sorted(os.listdir(_build.BUILD_DIR)) == sorted(
        os.path.basename(_build.target(name)[1]) for name in NAMES)


def test_library_that_fails_to_load_is_rebuilt(sources, tmp_path):
    builds = []
    _run(tmp_path, builds)
    _fresh_node(tmp_path)
    store = cc.ArtifactStore(str(tmp_path / "artifacts"))
    key = cc.library_key("beta", wp.key_fields())
    store.put(key, b"an envelope that verifies, a library that will not load")
    r = _run(tmp_path, builds)
    assert r["ok"] and sorted(builds) == sorted(NAMES + ["beta"])
    # the reference's counting: the store served a verified envelope (a hit
    # of the store), the load failed (corrupt), the library was rebuilt
    assert (r["hits"], r["misses"], r["corrupt"]) == (3, 0, 1)
    assert not r["libraries"]["beta"]["hit"] and r["compile_s"] > 0
    assert [name for name, lib in r["libraries"].items() if lib["hit"]] == ["alpha", "gamma"]


def test_no_store_builds_everything_and_counts_nothing(sources, tmp_path):
    builds = []
    r = wp.run(names=NAMES, build=_build_fn(builds), load=_load, device="cpu")
    assert r["ok"] and sorted(builds) == NAMES and r["compile_s"] > 0
    assert (r["hits"], r["misses"], r["published"]) == (0, 0, 0)


def test_cpu_default_needs_no_library(sources, tmp_path, monkeypatch):
    """On the CPU the store sees nothing and the programs run through the
    plain versions."""
    monkeypatch.setenv(cc.ARTIFACTS_ENV, str(tmp_path / "artifacts"))
    r = wp.quick_check(device="cpu")
    assert r["ok"] and r["libraries"] == {} and r["backend"] == "cpu"
    assert (r["hits"], r["misses"], r["compile_s"], r["fetch_s"]) == (0, 0, 0.0, 0.0)
    assert r["launches"] == {"vector_add": 0}
    assert all(v["finite"] and v["value"] == v["plain_value"] for v in r["results"].values())


class _Fleet:
    """A fleet client that keeps what it is given, in memory."""

    def __init__(self):
        self.envelopes = {}

    def enabled(self):
        return True

    def index(self, kind):
        return [{"name": n} for n, e in self.envelopes.items()
                if cc.parse_envelope(e)[0].kind() == kind]

    def fetch(self, name):
        return self.envelopes.get(name)

    def publish(self, envelope):
        self.envelopes[cc.parse_envelope(envelope)[1]["name"]] = envelope
        return True


def test_publish_after_a_miss_then_prewarm_a_fresh_node(sources, tmp_path):
    fleet, builds = _Fleet(), []
    seeder = wp.run(store=cc.ArtifactStore(str(tmp_path / "seeder")), client=fleet,
                    names=NAMES, build=_build_fn(builds), load=_load, device="cpu")
    assert seeder["misses"] == 3 and seeder["published"] == 3 and seeder["prewarmed"] == 0
    _fresh_node(tmp_path)
    node = wp.run(store=cc.ArtifactStore(str(tmp_path / "node")), client=fleet,
                  names=NAMES, build=_build_fn(builds), load=_load, device="cpu")
    assert node["prewarmed"] == 3 and node["hits"] == 3 and node["misses"] == 0
    assert node["published"] == 0  # a warm node never re-uploads
    assert sorted(builds) == NAMES


def test_key_fields_carry_torch_and_cuda_versions(monkeypatch):
    import torch

    monkeypatch.setenv(wp.GENERATION_ENV, "h100")
    monkeypatch.delenv(wp.TOPOLOGY_ENV, raising=False)
    fields = wp.key_fields()
    assert fields == {"generation": "h100", "topology": "",
                      "jax_version": torch.__version__,
                      "libtpu_version": torch.version.cuda or ""}
    assert wp.kind_from_env() == jcc.kind_fingerprint(**fields)
    monkeypatch.delenv(wp.GENERATION_ENV)
    assert wp.kind_from_env() == ""


def test_libraries_are_every_source():
    assert wp.libraries() == sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                                    if f.endswith(".cu"))
    assert len(wp.libraries()) == 6


@pytest.mark.parametrize("name", ["vector-add", "reduce-chain", "train-step"])
def test_programs_match_reference(name):
    import jax
    import numpy as np

    fn, args = jwp.validation_programs()[name]()
    ref = float(jax.jit(fn)(*args))
    mine, plain = wp.validation_programs()[name]("cpu")
    assert float(mine) == float(plain)
    assert float(mine) == pytest.approx(ref, rel=1e-5, abs=1e-30)
    assert np.isfinite(float(mine))


def test_flight_samples_match_reference(sources, tmp_path):
    """The same checks, phases and fields as the reference's samples: one
    ``warm-pool``/``compile`` per unit compiled (here a library), with
    ``compile_s`` and ``cache_hit``, and the store's ``compile-cache``/
    ``cache`` counters."""
    recorder = flight.FlightRecorder()
    with flight.activate(recorder):
        _run(tmp_path, [])
    ref = jflight.FlightRecorder()
    with jflight.activate(ref):
        jwp.run(store=None, programs={"vector-add": jwp.validation_programs()["vector-add"]})
        jcc.ArtifactStore(str(tmp_path / "ref")).record_flight_sample()

    def shape(samples):
        return {(s["check"], s["phase"], tuple(sorted(s["metrics"]))) for s in samples}

    mine = [s for s in recorder.samples if s["check"] in ("warm-pool", "compile-cache")]
    assert shape(mine) == shape(ref.samples)
    compiles = [s for s in mine if s["phase"] == "compile"]
    assert len(compiles) == 3 and all(s["metrics"]["cache_hit"] == 0.0 for s in compiles)
    (cache,) = [s for s in mine if s["check"] == "compile-cache"]
    assert cache["metrics"]["cache_misses"] == 3.0 and cache["metrics"]["cache_hits"] == 0.0
