"""The port's copy of the artifact plane (``tpu_operator_torch/workloads/
compile_cache.py``) against the reference's rules: keying, integrity, LRU,
concurrency (the reference's ``tests/test_compile_cache.py`` cases), and
byte compatibility with the reference's envelope and fleet cache, whose
operator side stays the reference's.  Then the library artifact: a hit
installs the library at ``_build``'s path and loads it, a payload that does
not load is corrupt and rebuilt, through an injected build and load."""

import concurrent.futures
import http.server
import json
import os
import threading
import urllib.parse

import pytest

pytest.importorskip("torch")

from tpu_operator.workloads import compile_cache as jcc  # noqa: E402
from tpu_operator_torch.kernels import _build  # noqa: E402
from tpu_operator_torch.workloads import compile_cache as cc  # noqa: E402

KEY = cc.CacheKey(
    generation="h100", topology="1x1",
    jax_version="2.11.0+cu128", libtpu_version="12.8", program="vector_add:0123456789abcdef",
)


def _variant(**changes) -> cc.CacheKey:
    return cc.CacheKey(**{**KEY.__dict__, **changes})


# ----------------------------------------------------------------------
# keying


def test_key_changes_with_every_field():
    base = KEY.fingerprint()
    for field in ("generation", "topology", "jax_version", "libtpu_version", "program"):
        assert _variant(**{field: "other"}).fingerprint() != base, field
    assert cc.CacheKey(**KEY.__dict__).fingerprint() == base


@pytest.mark.parametrize("field", ["generation", "topology", "jax_version", "libtpu_version",
                                   "program"])
def test_key_fingerprint_and_kind_match_reference(field):
    mine = _variant(**{field: "x"})
    ref = jcc.CacheKey(**mine.__dict__)
    assert mine.fingerprint() == ref.fingerprint() and mine.kind() == ref.kind()


def test_kind_excludes_program():
    assert _variant(program="flash_backward:fedcba9876543210").kind() == KEY.kind()
    assert _variant(topology="2x2").kind() != KEY.kind()


def test_store_miss_on_key_mismatch(tmp_path):
    store = cc.ArtifactStore(str(tmp_path))
    store.put(KEY, b"payload-a")
    assert store.get(_variant(jax_version="9.9.9")) is None
    assert store.get(KEY) == b"payload-a"
    assert (store.stats.hits, store.stats.misses) == (1, 1)


# ----------------------------------------------------------------------
# integrity: corrupt, truncated or mislabeled artifacts are rejected


def test_truncated_artifact_rejected(tmp_path):
    store = cc.ArtifactStore(str(tmp_path))
    path = store.put(KEY, b"x" * 1024)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-100])
    assert store.get(KEY) is None
    assert store.stats.corrupt == 1
    assert not os.path.exists(path)  # pruned so the next put republishes


def test_bitflip_rejected(tmp_path):
    store = cc.ArtifactStore(str(tmp_path))
    path = store.put(KEY, b"y" * 1024)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[-1] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    assert store.get(KEY) is None
    assert store.stats.corrupt == 1


def test_mislabeled_artifact_never_served(tmp_path):
    store = cc.ArtifactStore(str(tmp_path))
    other = _variant(generation="a100")
    store.put(other, b"wrong-hardware")
    os.replace(store.path_for(other), store.path_for(KEY))
    assert store.get(KEY) is None
    assert store.stats.corrupt == 1


def test_get_or_compile_recompiles_after_corruption(tmp_path):
    store = cc.ArtifactStore(str(tmp_path))
    builds = []

    def build():
        builds.append(1)
        return b"fresh" * 100

    payload, hit = store.get_or_compile(KEY, build)
    assert not hit and len(builds) == 1
    with open(store.path_for(KEY), "wb") as f:
        f.write(b"garbage")
    payload, hit = store.get_or_compile(KEY, build)
    assert not hit and len(builds) == 2 and payload == b"fresh" * 100
    _, hit = store.get_or_compile(KEY, build)
    assert hit and len(builds) == 2


def test_envelope_parse_rejects_bad_magic_and_name():
    envelope = cc.build_envelope(KEY, b"abc")
    key, _, payload = cc.parse_envelope(envelope)
    assert key == KEY and payload == b"abc"
    with pytest.raises(cc.CorruptArtifact):
        cc.parse_envelope(b"not-json\n" + b"abc")
    head, _, body = envelope.partition(b"\n")
    doc = json.loads(head)
    with pytest.raises(cc.CorruptArtifact, match="bad magic"):
        cc.parse_envelope(json.dumps({**doc, "magic": "tpuxc0"}).encode() + b"\n" + body)
    doc["key"]["generation"] = "a100"
    with pytest.raises(cc.CorruptArtifact, match="name does not match"):
        cc.parse_envelope(json.dumps(doc).encode() + b"\n" + body)


# ----------------------------------------------------------------------
# the LRU bound


def test_lru_eviction_respects_bound(tmp_path):
    payload = b"z" * 1000
    overhead = len(cc.build_envelope(KEY, payload)) - len(payload)
    store = cc.ArtifactStore(str(tmp_path), max_bytes=3 * (1000 + overhead) + 10)
    keys = [_variant(program=f"lib{i}:0") for i in range(5)]
    for i, key in enumerate(keys):
        store.put(key, payload)
        if os.path.exists(store.path_for(key)):
            os.utime(store.path_for(key), (i, i))  # strictly increasing mtimes
        store._evict_lru()
    assert store.total_bytes() <= store.max_bytes
    assert store.stats.evictions >= 2
    assert store.get(keys[0]) is None
    assert store.get(keys[-1]) == payload


def test_oversized_single_artifact_not_pinned(tmp_path):
    store = cc.ArtifactStore(str(tmp_path), max_bytes=100)
    store.put(KEY, b"w" * 1000)
    assert store.total_bytes() <= 100


def test_store_bound_and_root_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv(cc.MAX_BYTES_ENV, "12345")
    monkeypatch.setenv(cc.ARTIFACTS_ENV, str(tmp_path))
    store = cc.default_store()
    assert store.root == str(tmp_path) and store.max_bytes == 12345
    monkeypatch.setenv(cc.ARTIFACTS_ENV, "0")
    assert cc.default_store() is None
    monkeypatch.delenv(cc.ARTIFACTS_ENV)
    assert cc.default_store() is None  # never a persistent cache by default


# ----------------------------------------------------------------------
# concurrency: parallel validators on one node never tear an entry


def test_concurrent_get_or_compile_never_tears(tmp_path):
    payload = b"P" * 20000
    start = threading.Barrier(8)
    failures = []

    def worker(i):
        local = cc.ArtifactStore(str(tmp_path))  # own stats, shared dir
        start.wait()
        for _ in range(20):
            got, _ = local.get_or_compile(KEY, lambda: payload)
            if got != payload:
                failures.append((i, len(got)))
            data = local.read_envelope(KEY.fingerprint())
            if data is not None:
                try:
                    _, _, body = cc.parse_envelope(data)
                except cc.CorruptArtifact as e:
                    failures.append((i, str(e)))
                else:
                    if body != payload:
                        failures.append((i, "wrong payload"))

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(worker, range(8)))
    assert not failures
    assert cc.ArtifactStore(str(tmp_path)).get(KEY) == payload


def test_stats_add_sums_every_counter():
    a, b = cc.CacheStats(hits=1, misses=2, corrupt=1), cc.CacheStats(hits=3, bytes_read=7)
    a.add(b)
    assert (a.hits, a.misses, a.corrupt, a.bytes_read) == (4, 2, 1, 7)


# ----------------------------------------------------------------------
# the wire format and the fleet plane are the reference's


def test_port_envelope_parses_with_reference_and_back():
    mine = cc.build_envelope(KEY, b"\x7fELF library bytes", created=1.5)
    ref_key, header, payload = jcc.parse_envelope(mine)
    assert ref_key == jcc.CacheKey(**KEY.__dict__) and payload == b"\x7fELF library bytes"
    assert header["magic"] == jcc.ENVELOPE_MAGIC == cc.ENVELOPE_MAGIC
    theirs = jcc.build_envelope(jcc.CacheKey(**KEY.__dict__), b"payload", created=1.5)
    assert theirs == cc.build_envelope(KEY, b"payload", created=1.5)  # byte for byte
    key, _, payload = cc.parse_envelope(theirs)
    assert key == KEY and payload == b"payload"


def test_reference_fleet_cache_ingests_port_envelopes(tmp_path):
    fleet = jcc.FleetCompileCache(str(tmp_path))
    ok, name = fleet.ingest(cc.build_envelope(KEY, b"library"))
    assert ok and name == KEY.fingerprint()
    assert fleet.index(KEY.kind()) == [{"name": name, "program": KEY.program, "size": 7}]
    assert fleet.has_kind_labels("h100", "1x1", "12.8")
    ok, err = fleet.ingest(cc.build_envelope(KEY, b"library")[:-2])
    assert not ok and "truncated" in err


class _FleetServer:
    """The reference's ``FleetCompileCache`` behind its three routes
    (``/compile-cache/index``, ``/compile-cache/artifact[/<name>]``) on a
    localhost port."""

    def __init__(self, root: str):
        self.fleet = jcc.FleetCompileCache(root)
        fleet = self.fleet

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code, body=b""):
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                if url.path == "/compile-cache/index":
                    kind = urllib.parse.parse_qs(url.query).get("kind", [""])[0]
                    self._send(200, json.dumps({"artifacts": fleet.index(kind)}).encode())
                    return
                data = fleet.get(url.path.rsplit("/", 1)[-1])
                self._send(200, data) if data is not None else self._send(404)

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                ok, _ = fleet.ingest(body)
                self._send(200 if ok else 400)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.thread.join(5.0)


def test_publish_then_prewarm_through_reference_fleet(tmp_path):
    """A seeder publishes its kind's libraries to the reference's fleet
    cache; a fresh node's store prewarms them and hits without building."""
    keys = [_variant(program=f"lib{i}:{i:016x}") for i in range(3)]
    seeder = cc.ArtifactStore(str(tmp_path / "seeder"))
    for i, key in enumerate(keys):
        seeder.put(key, bytes([i]) * 100)
    seeder.put(_variant(topology="2x2"), b"another kind")
    with _FleetServer(str(tmp_path / "fleet")) as srv:
        client = cc.FleetCacheClient(srv.url)
        assert cc.publish_kind(seeder, KEY.kind(), client) == 3
        node = cc.ArtifactStore(str(tmp_path / "node"))
        assert cc.prewarm(node, KEY.kind(), client) == 3
        assert cc.prewarm(node, KEY.kind(), client) == 0  # already local
    assert [node.get(key) for key in keys] == [bytes([i]) * 100 for i in range(3)]
    assert (node.stats.hits, node.stats.misses, node.stats.prewarmed) == (3, 0, 3)


def test_unreachable_fleet_is_not_an_error(tmp_path):
    client = cc.FleetCacheClient("http://127.0.0.1:9")  # discard port: refused
    assert client.enabled() and client.index(KEY.kind()) == []
    assert cc.prewarm(cc.ArtifactStore(str(tmp_path)), KEY.kind(), client) == 0
    assert not cc.FleetCacheClient("").enabled()


# ----------------------------------------------------------------------
# the library artifact, through an injected build and load


@pytest.fixture
def sources(tmp_path, monkeypatch):
    """Two kernel sources in a csrc/ of their own and an empty build dir."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("alpha", "beta"):
        (csrc / f"{name}.cu").write_text(f'extern "C" int tpu_{name}(int n) {{ return n; }}\n')
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return csrc


def _fake_build(builds: list):
    def build(name):
        _, path = _build.target(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"LIB " + name.encode())
        builds.append(name)
        return _build.Built(path, 0.25, "")
    return build


def _fake_load(loads: list):
    def load(name, path):
        with open(path, "rb") as f:
            data = f.read()
        if data != b"LIB " + name.encode():
            raise OSError(f"{path}: invalid ELF header")
        loads.append(name)
    return load


def test_library_key_follows_the_source_and_flags(sources):
    digest, path = _build.target("alpha")
    key = cc.library_key("alpha", {"generation": "h100"})
    assert key.program == f"alpha:{digest}" and key.generation == "h100"
    assert path == os.path.join(_build.BUILD_DIR, f"libalpha-{digest}.so")
    (sources / "alpha.cu").write_text('extern "C" int tpu_alpha(int n) { return n + 1; }\n')
    assert cc.library_key("alpha", {}).program != key.program  # an edited source misses
    assert cc.entry_symbols("alpha") == ["tpu_alpha"]


def test_library_key_follows_the_shared_headers(sources):
    key = cc.library_key("alpha", {}).program
    (sources / "common.cuh").write_text("#pragma once\n")
    added = cc.library_key("alpha", {}).program
    assert added != key  # a new header misses
    (sources / "common.cuh").write_text("#pragma once\n// edited\n")
    assert cc.library_key("alpha", {}).program not in (key, added)  # so does an edited one


def test_compile_or_fetch_cold_then_warm(sources, tmp_path):
    store = cc.ArtifactStore(str(tmp_path / "store"))
    builds, loads = [], []
    key = cc.library_key("alpha", {})
    path, hit, seconds = cc.compile_or_fetch(store, key, "alpha", _fake_build(builds),
                                             _fake_load(loads))
    assert not hit and builds == ["alpha"] and loads == ["alpha"] and seconds > 0
    os.remove(path)  # a fresh node: nothing built
    path2, hit, _ = cc.compile_or_fetch(store, key, "alpha", _fake_build(builds),
                                        _fake_load(loads))
    assert hit and path2 == path and builds == ["alpha"] and loads == ["alpha", "alpha"]
    with open(path, "rb") as f:
        assert f.read() == b"LIB alpha"  # installed from the store
    assert (store.stats.hits, store.stats.misses, store.stats.puts) == (1, 1, 1)


def test_library_that_fails_to_load_is_corrupt_and_rebuilt(sources, tmp_path):
    store = cc.ArtifactStore(str(tmp_path / "store"))
    key = cc.library_key("beta", {})
    store.put(key, b"not a library")  # verifies as an envelope, will not load
    builds, loads = [], []
    path, hit, _ = cc.compile_or_fetch(store, key, "beta", _fake_build(builds),
                                       _fake_load(loads))
    assert not hit and builds == ["beta"] and loads == ["beta"]
    assert store.stats.corrupt == 1
    assert store.get(key) == b"LIB beta"  # the rebuilt library replaced it


def test_failed_build_raises(sources, tmp_path):
    def broken(name):
        raise RuntimeError("nvcc failed")

    with pytest.raises(RuntimeError, match="nvcc failed"):
        cc.compile_or_fetch(cc.ArtifactStore(str(tmp_path)), cc.library_key("alpha", {}),
                            "alpha", broken, _fake_load([]))


def test_load_library_rejects_a_file_that_is_no_library(sources, tmp_path):
    bogus = tmp_path / "libbogus.so"
    bogus.write_bytes(b"garbage")
    with pytest.raises(OSError):
        cc.load_library("alpha", str(bogus))
