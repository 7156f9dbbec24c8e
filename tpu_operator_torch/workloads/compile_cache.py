"""The fleet artifact cache over the port's kernel libraries: the artifact
plane and the seeding client of ``tpu_operator/workloads/compile_cache.py``
(its ``:60-700``), copied, with the library as the artifact.

For this port the compile on a node's join path is nvcc, not XLA: every
kernel source under ``csrc/`` builds into a shared library
(``kernels/_build.py``), which is what the reference's warm pool exists to
take off the critical path.  So the artifact is the bytes of
``_build``'s ``lib<name>-<digest>.so``, and its key's program field is
``"<name>:<digest>"`` with ``_build``'s own digest of the source and the
nvcc flags (the arch among them): an edited source or another arch never
gets a stale library.

The key keeps the reference's field names so that the envelope stays
byte-compatible and the unchanged operator's fleet cache
(``FleetCompileCache.ingest``) accepts it: ``jax_version`` carries
``torch.__version__`` and ``libtpu_version`` ``torch.version.cuda``.

- :class:`ArtifactStore`: content-addressed envelopes (an integrity sha256
  over the payload, atomic tmp + ``os.replace`` publication, a byte-bounded
  LRU), counted into the flight record.
- :class:`FleetCacheClient`, :func:`prewarm`, :func:`publish_kind`: the
  first node of a kind publishes its libraries, later ones pull them into
  their store before building anything.
- :func:`compile_or_fetch`: a hit installs the library at ``_build``'s
  path and loads it; a payload that fails to load counts as corrupt and is
  rebuilt; a miss builds with nvcc and stores the library.

The reference's XLA helpers (``enable``, ``aot_fingerprint``,
``serialize_compiled``, ``load_serialized``) have no counterpart, and the
operator-side ``FleetCompileCache`` stays the reference's.  Everything
here is an optimization, never a gate: cache trouble costs a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import asdict, dataclass, fields
from typing import Callable, Optional

log = logging.getLogger("tpu_operator_torch.compile_cache")

# environment contract (documented in docs/OBSERVABILITY.md, rendered into
# workload pods by the validator alongside TPU_COMPILE_CACHE)
ARTIFACTS_ENV = "TPU_COMPILE_CACHE_ARTIFACTS"
MAX_BYTES_ENV = "TPU_COMPILE_CACHE_MAX_BYTES"
FLEET_CACHE_URL_ENV = "TPU_FLEET_CACHE_URL"

ENVELOPE_MAGIC = "tpuxc1"
# artifact payload ceiling on BOTH the operator ingest route and the agent
# relay: the ports are unauthenticated and an unbounded body is an
# allocation amplifier (the /push discipline, sized for executables)
ARTIFACT_MAX_BYTES = 32 * 1024 * 1024
DEFAULT_STORE_MAX_BYTES = 512 * 1024 * 1024
_FETCH_TIMEOUT = 5.0


class CorruptArtifact(Exception):
    """Envelope failed parsing or integrity verification."""


@dataclass(frozen=True)
class CacheKey:
    """Identity of one built library: any field changing means the
    library may be wrong for the hardware/software it would run on."""

    generation: str = ""
    topology: str = ""
    jax_version: str = ""
    libtpu_version: str = ""
    program: str = ""  # "<name>:<digest>" of a kernel library

    def fingerprint(self) -> str:
        return hashlib.sha256(
            json.dumps(asdict(self), sort_keys=True).encode()
        ).hexdigest()

    def kind(self) -> str:
        """The warm-pool grouping: every field except the program — nodes
        of one kind can share every artifact of that kind."""
        return kind_fingerprint(
            self.generation, self.topology, self.jax_version, self.libtpu_version
        )


def key_from_fields(raw: dict) -> CacheKey:
    """CacheKey from an untrusted header field map (unknown fields
    dropped, values coerced to str) — the one construction rule shared by
    the envelope parser and the fleet index."""
    return CacheKey(**{
        f: str(raw.get(f, ""))
        for f in ("generation", "topology", "jax_version", "libtpu_version", "program")
    })


def kind_fingerprint(
    generation: str, topology: str, jax_version: str = "", libtpu_version: str = ""
) -> str:
    return hashlib.sha256(json.dumps(
        [generation, topology, jax_version, libtpu_version]
    ).encode()).hexdigest()


def current_versions() -> tuple[str, str]:
    """(torch version, CUDA version) of the installed torch: the software
    half of every :class:`CacheKey` minted locally, under the reference's
    ``jax_version`` and ``libtpu_version`` fields.  Read from the constants
    of torch's ``version.py`` (what ``torch.__version__`` and
    ``torch.version.cuda`` are) without importing torch: the validator's
    plugin component fills a workload pod's key fields with them."""
    import ast
    import importlib.util

    spec = importlib.util.find_spec("torch")
    with open(os.path.join(spec.submodule_search_locations[0], "version.py")) as f:
        tree = ast.parse(f.read())
    values = {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(node.value, ast.Constant):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(target, ast.Name):
                    values[target.id] = node.value.value
    return values["__version__"], values.get("cuda") or ""


# ---------------------------------------------------------------------------
# Envelope codec.


def build_envelope(key: CacheKey, payload: bytes, created: Optional[float] = None) -> bytes:
    header = {
        "magic": ENVELOPE_MAGIC,
        "name": key.fingerprint(),
        "key": asdict(key),
        "sha256": hashlib.sha256(payload).hexdigest(),
        "size": len(payload),
        "created": round(created if created is not None else time.time(), 3),
    }
    return json.dumps(header, sort_keys=True).encode() + b"\n" + payload


def parse_envelope(data: bytes) -> tuple[CacheKey, dict, bytes]:
    """(key, header, payload) or :class:`CorruptArtifact`.  Every check a
    reader needs before trusting the payload lives here: magic, key/name
    consistency (content addressing), declared size, and the payload
    sha256 — a truncated or bit-flipped artifact is rejected, never
    deserialized."""
    newline = data.find(b"\n")
    if newline < 0:
        raise CorruptArtifact("no header line")
    try:
        header = json.loads(data[:newline])
    except (UnicodeDecodeError, ValueError) as e:
        raise CorruptArtifact(f"unparsable header: {e}") from e
    if not isinstance(header, dict) or header.get("magic") != ENVELOPE_MAGIC:
        raise CorruptArtifact("bad magic")
    raw_key = header.get("key")
    if not isinstance(raw_key, dict):
        raise CorruptArtifact("missing key")
    key = key_from_fields(raw_key)
    if header.get("name") != key.fingerprint():
        raise CorruptArtifact("name does not match key (content addressing broken)")
    payload = data[newline + 1:]
    if header.get("size") != len(payload):
        raise CorruptArtifact(
            f"truncated payload: header says {header.get('size')}, got {len(payload)}"
        )
    if header.get("sha256") != hashlib.sha256(payload).hexdigest():
        raise CorruptArtifact("payload sha256 mismatch")
    return key, header, payload


# ---------------------------------------------------------------------------
# Artifact plane.


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    corrupt: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    prewarmed: int = 0
    published: int = 0

    def add(self, other: "CacheStats") -> None:
        """Count ``other``'s events in here too (a store view per worker
        thread, summed afterwards: no counter is shared across threads)."""
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def as_metrics(self) -> dict:
        return {
            "cache_hits": float(self.hits),
            "cache_misses": float(self.misses),
            "cache_bytes": float(self.bytes_read + self.bytes_written),
        }


class ArtifactStore:
    """Content-addressed artifact directory with integrity verification,
    atomic publication, and a byte-bounded LRU.

    Thread/process-safe by construction rather than locks: concurrent
    writers of one key both publish whole files via ``os.replace`` (last
    writer wins an identical artifact), and readers verify integrity, so
    no interleaving can surface a torn entry."""

    SUFFIX = ".xc"

    def __init__(self, root: str, max_bytes: Optional[int] = None):
        self.root = root
        env_max = os.environ.get(MAX_BYTES_ENV, "")
        if max_bytes is None:
            try:
                max_bytes = int(env_max) if env_max else DEFAULT_STORE_MAX_BYTES
            except ValueError:
                max_bytes = DEFAULT_STORE_MAX_BYTES
        self.max_bytes = max(0, max_bytes)
        self.stats = CacheStats()

    def path_for(self, key: CacheKey) -> str:
        return os.path.join(self.root, key.fingerprint() + self.SUFFIX)

    # ------------------------------------------------------------------
    def get(self, key: CacheKey) -> Optional[bytes]:
        """The verified payload, or None (miss).  A corrupt entry is
        deleted and rebuilt — a wrong library must never load."""
        path = self.path_for(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            self.stats.misses += 1
            return None
        try:
            stored_key, _, payload = parse_envelope(data)
            if stored_key != key:
                raise CorruptArtifact("stored key differs from requested key")
        except CorruptArtifact as e:
            log.warning("corrupt artifact %s: %s (rebuilding)", path, e)
            self.stats.corrupt += 1
            self.stats.misses += 1
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        self.stats.hits += 1
        self.stats.bytes_read += len(payload)
        try:
            os.utime(path)  # LRU recency
        except OSError:
            pass
        return payload

    def put(self, key: CacheKey, payload: bytes) -> Optional[str]:
        """Atomic tmp+replace publication; returns the path, or None when
        persistence failed (the built library is still usable — the cache
        is an optimization, never a gate)."""
        path = self.path_for(key)
        try:
            os.makedirs(self.root, exist_ok=True)
            envelope = build_envelope(key, payload)
            tmp = path + f".{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:
                f.write(envelope)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("artifact publish failed for %s: %s", path, e)
            return None
        self.stats.puts += 1
        self.stats.bytes_written += len(payload)
        self._evict_lru()
        return path

    def get_or_compile(
        self, key: CacheKey, compile_fn: Callable[[], bytes]
    ) -> tuple[bytes, bool]:
        """(payload, hit?).  Misses run ``compile_fn`` and publish."""
        payload = self.get(key)
        if payload is not None:
            return payload, True
        payload = compile_fn()
        self.put(key, payload)
        return payload, False

    # ------------------------------------------------------------------
    def entries(self) -> list[tuple[str, dict]]:
        """(artifact name, header) per entry — the publication manifest.
        Header-line reads only (a manifest walk must not pay payload
        bytes); unparsable headers are skipped, and payload integrity is
        verified where the payload is actually consumed (``get``, fleet
        ingest)."""
        out: list[tuple[str, dict]] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in sorted(names):
            if not name.endswith(self.SUFFIX):
                continue
            header = self.read_header(name[: -len(self.SUFFIX)])
            if (
                header is None
                or header.get("name") != name[: -len(self.SUFFIX)]
                or not isinstance(header.get("key"), dict)
            ):
                continue
            out.append((header["name"], header))
        return out

    def read_envelope(self, name: str) -> Optional[bytes]:
        """Raw envelope bytes by artifact name (for publication/serving);
        name is validated as a hex digest so a request can never traverse
        out of the store root."""
        if not valid_artifact_name(name):
            return None
        try:
            with open(os.path.join(self.root, name + self.SUFFIX), "rb") as f:
                return f.read()
        except OSError:
            return None

    def exists(self, name: str) -> bool:
        """Cheap liveness probe (the LRU may have evicted the file) — no
        payload read; callers that need the bytes still go through the
        verifying readers."""
        return valid_artifact_name(name) and os.path.isfile(
            os.path.join(self.root, name + self.SUFFIX)
        )

    def read_header(self, name: str) -> Optional[dict]:
        """The envelope's header line only — index/manifest probes must
        not pay a multi-MB payload read per entry.  Unparsable headers
        read as absent (the verifying readers prune them on access)."""
        if not valid_artifact_name(name):
            return None
        try:
            with open(os.path.join(self.root, name + self.SUFFIX), "rb") as f:
                line = f.readline(1 << 20)
        except OSError:
            return None
        try:
            header = json.loads(line)
        except (UnicodeDecodeError, ValueError):
            return None
        if not isinstance(header, dict) or header.get("magic") != ENVELOPE_MAGIC:
            return None
        return header

    def total_bytes(self) -> int:
        total = 0
        try:
            for name in os.listdir(self.root):
                if name.endswith(self.SUFFIX):
                    total += os.path.getsize(os.path.join(self.root, name))
        except OSError:
            pass
        return total

    def _evict_lru(self) -> None:
        """Drop oldest-touched entries until within ``max_bytes``.  The
        just-published entry carries the newest mtime, so it goes last —
        it is evicted only when it alone exceeds the whole bound (an
        artifact bigger than the budget must not pin the store forever)."""
        if not self.max_bytes:
            return
        try:
            entries = [
                (os.path.getmtime(p), p, os.path.getsize(p))
                for name in os.listdir(self.root)
                if name.endswith(self.SUFFIX)
                for p in (os.path.join(self.root, name),)
            ]
        except OSError:
            return
        total = sum(size for _, _, size in entries)
        entries.sort()  # oldest mtime first
        for _, path, size in entries:
            if total <= self.max_bytes:
                break
            try:
                os.remove(path)
            except OSError:
                continue
            total -= size
            self.stats.evictions += 1

    # ------------------------------------------------------------------
    def record_flight_sample(self) -> None:
        """Surface the counters through the ambient flight recorder (→
        agent push → fleet aggregator as tpu_workload_compile_cache_*);
        no-op in untracked processes like every flight record call."""
        try:
            from tpu_operator_torch.obs import flight

            flight.record("compile-cache", phase="cache", **self.stats.as_metrics())
        except Exception as e:  # noqa: BLE001 — telemetry must never gate
            log.debug("compile-cache flight sample failed: %s", e)


def valid_artifact_name(name: str) -> bool:
    """64-hex content digest — the one naming rule every surface (store,
    operator routes, agent relay) validates with; kind fingerprints share
    the shape."""
    return (
        isinstance(name, str)
        and len(name) == 64
        and all(c in "0123456789abcdef" for c in name)
    )


def default_store(root: Optional[str] = None) -> Optional[ArtifactStore]:
    """The node-local store under the artifact dir contract, or None when
    no location is configured (tests and dryruns must never write a
    persistent cache to the real host implicitly)."""
    root = root or os.environ.get(ARTIFACTS_ENV, "")
    if not root or root == "0":
        return None
    return ArtifactStore(root)


# ---------------------------------------------------------------------------
# Seeding plane: the workload-side client (the operator side,
# ``FleetCompileCache``, is the reference's).


class FleetCacheClient:
    """Workload-side HTTP client for the fleet cache (the agent relay or
    the operator surface directly, per ``TPU_FLEET_CACHE_URL``).  Blocking
    urllib on purpose — it runs in workload processes before the first
    build, exactly where an event loop does not exist.  Best-effort
    everywhere: an unreachable fleet cache means building, not failing."""

    def __init__(self, base_url: str = "", timeout: float = _FETCH_TIMEOUT):
        self.base_url = (base_url or os.environ.get(FLEET_CACHE_URL_ENV, "")).rstrip("/")
        self.timeout = timeout

    def enabled(self) -> bool:
        return bool(self.base_url)

    def _get(self, path: str) -> Optional[bytes]:
        try:
            with urllib.request.urlopen(
                self.base_url + path, timeout=self.timeout
            ) as resp:
                return resp.read()
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def index(self, kind: str) -> list[dict]:
        data = self._get("/compile-cache/index?kind=" + urllib.parse.quote(kind))
        if data is None:
            return []
        try:
            doc = json.loads(data)
        except ValueError:
            return []
        artifacts = doc.get("artifacts")
        return artifacts if isinstance(artifacts, list) else []

    def fetch(self, name: str) -> Optional[bytes]:
        if not valid_artifact_name(name):
            return None
        return self._get("/compile-cache/artifact/" + name)

    def publish(self, envelope: bytes) -> bool:
        if len(envelope) > ARTIFACT_MAX_BYTES:
            return False
        req = urllib.request.Request(
            self.base_url + "/compile-cache/artifact",
            data=envelope,
            headers={"Content-Type": "application/octet-stream"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status < 400
        except (urllib.error.URLError, OSError, ValueError):
            return False


def prewarm(
    store: ArtifactStore,
    kind: str,
    client: Optional[FleetCacheClient] = None,
) -> int:
    """Pull this kind's fleet artifacts into the local store BEFORE the
    first build; returns artifacts fetched.  Every fetched envelope is
    re-verified locally (parse_envelope) — a corrupt transfer costs a
    build, never a wrong library."""
    client = client or FleetCacheClient()
    if not client.enabled():
        return 0
    fetched = 0
    for entry in client.index(kind):
        name = entry.get("name", "")
        if not valid_artifact_name(name):
            continue
        if store.exists(name):
            continue  # already local
        data = client.fetch(name)
        if data is None:
            continue
        try:
            key, _, payload = parse_envelope(data)
        except CorruptArtifact as e:
            log.warning("prewarm: corrupt artifact %s from fleet cache: %s", name, e)
            store.stats.corrupt += 1
            continue
        if key.kind() != kind:
            continue  # server confusion; never store under a foreign kind
        if store.put(key, payload) is not None:
            fetched += 1
    store.stats.prewarmed += fetched
    return fetched


def publish_kind(
    store: ArtifactStore,
    kind: str,
    client: Optional[FleetCacheClient] = None,
) -> int:
    """Push this kind's local artifacts to the fleet cache (the seeder's
    half of the warm pool); returns artifacts accepted."""
    client = client or FleetCacheClient()
    if not client.enabled():
        return 0
    published = 0
    for name, header in store.entries():
        if key_from_fields(header["key"]).kind() != kind:
            continue
        data = store.read_envelope(name)
        if data is not None and client.publish(data):
            published += 1
    store.stats.published += published
    return published

# ---------------------------------------------------------------------------
# The artifact: a kernel library built by ``kernels/_build.py``.


def library_key(name: str, fields: dict) -> CacheKey:
    """``csrc/<name>.cu``'s key: ``fields`` (the hardware and software
    half) and the program ``"<name>:<digest>"``, ``_build``'s digest of
    the source and the nvcc flags."""
    from tpu_operator_torch.kernels import _build

    digest, _ = _build.target(name)
    return CacheKey(program=f"{name}:{digest}", **fields)


def entry_symbols(name: str) -> list[str]:
    """The ``extern "C"`` functions ``csrc/<name>.cu`` exports."""
    from tpu_operator_torch.kernels import _build

    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
        return re.findall(r'extern "C"[^(;{]*?\b(\w+)\s*\(', f.read())


def load_library(name: str, path: str) -> ctypes.CDLL:
    """``ctypes.CDLL(path)`` with every entry symbol of ``name`` resolved;
    raises OSError or AttributeError when the library is unusable."""
    lib = ctypes.CDLL(path)
    symbols = entry_symbols(name)
    if not symbols:
        raise AttributeError(f'csrc/{name}.cu exports no extern "C" function')
    for symbol in symbols:
        getattr(lib, symbol)
    return lib


def _install(payload: bytes, path: str) -> None:
    """Write a library where ``_build`` keeps it: tmp + ``os.replace``, so
    no process ever loads a half-written file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def compile_or_fetch(
    store: Optional[ArtifactStore], key: CacheKey, name: str,
    build: Optional[Callable] = None, load: Callable = load_library,
) -> tuple[str, bool, float]:
    """Install ``key``'s library from the store and load it, else build it
    (and publish it locally).  Returns ``(path, hit?, seconds)``, the
    seconds the measured critical-path cost.  A payload that fails to load
    (a foreign toolchain's library despite the key, a torn install) is
    treated as corrupt: dropped from the store and from ``_build``'s path,
    and rebuilt.  A build, or a load after the build, that fails raises.
    ``build(name) -> _build.Built`` and ``load(name, path)`` are
    ``_build.build`` and :func:`load_library` unless the caller injects
    others."""
    from tpu_operator_torch.kernels import _build

    build = build or _build.build
    _, path = _build.target(name)
    t0 = time.perf_counter()
    if store is not None:
        payload = store.get(key)
        if payload is not None:
            _install(payload, path)
            try:
                load(name, path)
                return path, True, time.perf_counter() - t0
            except (OSError, AttributeError) as e:
                log.warning("library %s failed to load: %s (rebuilding)", key.program, e)
                store.stats.corrupt += 1
                for stale in (store.path_for(key), path):
                    try:
                        os.remove(stale)
                    except OSError:
                        pass
    built = build(name)
    load(name, built.path)
    if store is not None:
        with open(built.path, "rb") as f:
            store.put(key, f.read())
    return built.path, False, time.perf_counter() - t0
