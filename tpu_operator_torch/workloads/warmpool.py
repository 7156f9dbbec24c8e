"""Warm-pool validation on PyTorch/CUDA: the kernel libraries through the
fleet artifact cache, then the validator's canonical programs.  Port of
``tpu_operator/workloads/warmpool.py``.

On the reference the compile on a joining node's critical path is XLA's;
here it is nvcc's, one shared library per kernel source under ``csrc/``
(``kernels/_build.py``).  The check takes that build off the path through
:mod:`tpu_operator_torch.workloads.compile_cache`:

1. prewarm the node-local store from the fleet (``TPU_FLEET_CACHE_URL``);
2. compile-or-fetch every library: a hit installs the stored library at
   ``_build``'s path and loads it, a miss runs nvcc and stores the result
   (the builds run concurrently, one nvcc each, as a cold node would);
3. EXECUTE the canonical programs (vector-add on kernel B1, from the
   library just fetched or built; a reduction chain and a layered matmul
   step in torch ops, as the reference's are XLA ops) and require each
   output finite and, on a card, equal to its plain version's: a hit still
   proves the card runs the programs, it only skips the compiler;
4. publish to the fleet after a miss (the seeder's half).

On the CPU no library is needed: the store sees nothing, and the programs
run through the plain versions.

Env contract (the reference's):
- ``TPU_COMPILE_CACHE_ARTIFACTS``: node-local artifact dir; unset, no
  artifact cache and every library builds.
- ``TPU_COMPILE_CACHE_MAX_BYTES``: the store's LRU bound.
- ``TPU_FLEET_CACHE_URL``: the fleet cache; unset, node-local only.
- ``TPU_CACHE_GENERATION`` / ``TPU_CACHE_TOPOLOGY``: the hardware half of
  the cache key (torch's and CUDA's versions are the software half).
"""

from __future__ import annotations

import concurrent.futures
import math
import os
import time
from typing import Callable, Optional

import torch

from tpu_operator_torch.workloads import compile_cache as cc
from tpu_operator_torch.workloads import resolve_device

GENERATION_ENV = "TPU_CACHE_GENERATION"
TOPOLOGY_ENV = "TPU_CACHE_TOPOLOGY"


def key_fields() -> dict:
    """The non-program :class:`~.compile_cache.CacheKey` fields for this
    process, from the env contract plus the live torch and CUDA versions."""
    torch_version, cuda_version = cc.current_versions()
    return {
        "generation": os.environ.get(GENERATION_ENV, ""),
        "topology": os.environ.get(TOPOLOGY_ENV, ""),
        "jax_version": torch_version,
        "libtpu_version": cuda_version,
    }


def kind_from_env() -> str:
    fields = key_fields()
    if not fields["generation"] and not fields["topology"]:
        return ""
    return cc.kind_fingerprint(**fields)


def libraries() -> list[str]:
    """Every kernel source's name under ``csrc/``."""
    from tpu_operator_torch.kernels import _build

    return sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))


def validation_programs() -> dict[str, Callable]:
    """name → ``fn(device) -> (output, plain output)``: the reference's three
    programs at its shapes.  vector-add's ``a + a`` runs on kernel B1 (its
    plain version on the CPU); the plain output of a program is the same
    program on the CPU with B1's plain version.  Every value is exact in
    f32 (integers below 2**24, powers of two), so a card's output equals
    the plain one bit for bit."""
    from tpu_operator_torch.kernels.vector_add import vector_add_kernel

    def vector_add(device):
        def fn(a):
            return vector_add_kernel(a, a).sum()

        a = torch.arange(1 << 12, dtype=torch.float32)
        return fn(a.to(device)), fn(a)

    def reduce_chain(device):
        def fn(a):
            for _ in range(4):
                a = a - a.mean(dim=0, keepdim=True)
                a = a / (1.0 + a.abs().max())
            return a.sum()

        a = torch.ones((64, 256), dtype=torch.float32)
        return fn(a.to(device)), fn(a)

    def train_step(device):
        def fn(a):
            for _ in range(6):
                a = torch.tanh(a @ a.T) @ a
            return a.sum()

        a = torch.ones((256, 256), dtype=torch.float32)
        return fn(a.to(device)), fn(a)

    return {
        "vector-add": vector_add,
        "reduce-chain": reduce_chain,
        "train-step": train_step,
    }


def run(
    store: Optional[cc.ArtifactStore] = None,
    client: Optional[cc.FleetCacheClient] = None,
    fields: Optional[dict] = None,
    programs: Optional[dict] = None,
    names: Optional[list] = None,
    build: Optional[Callable] = None,
    load: Callable = cc.load_library,
    device=None,
) -> dict:
    """Compile-or-fetch every kernel library (``names``; default: every
    source on a card, none on the CPU), then execute every canonical
    program.  Returns the check result: the store counters (hits, misses and
    ``compile_s`` count libraries), per-library hit and seconds, per-program
    values, and ``ok`` false only on a wrong execution (a non-finite output,
    or on a card one that differs from its plain version) — cache trouble
    is never a failure, it just costs builds.  ``build`` and ``load`` are
    :func:`~.compile_cache.compile_or_fetch`'s."""
    from tpu_operator_torch.kernels import vector_add as va
    from tpu_operator_torch.obs import flight

    device = resolve_device(device)
    store = store if store is not None else cc.default_store()
    client = client or cc.FleetCacheClient()
    fields = fields or key_fields()
    programs = programs or validation_programs()
    if names is None:
        names = libraries() if device.type == "cuda" else []
    kind = cc.kind_fingerprint(**fields)

    prewarmed = 0
    if store is not None and client.enabled():
        prewarmed = cc.prewarm(store, kind, client)

    t0 = time.perf_counter()

    def fetch(name):
        # a store view of its own per library: the builds run in threads,
        # and the counters are summed below
        view = cc.ArtifactStore(store.root, store.max_bytes) if store is not None else None
        path, hit, seconds = cc.compile_or_fetch(view, cc.library_key(name, fields), name,
                                                 build, load)
        return view, path, hit, seconds

    libs: dict[str, dict] = {}
    compile_s = 0.0
    fetch_s = 0.0
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        for name, (view, path, hit, seconds) in zip(names, pool.map(fetch, names)):
            if view is not None:
                store.stats.add(view.stats)
            if hit:
                fetch_s += seconds
            else:
                compile_s += seconds
            libs[name] = {"hit": hit, "seconds": round(seconds, 6),
                          "bytes": os.path.getsize(path)}
            flight.record(
                "warm-pool",
                phase="compile",
                compile_s=seconds if not hit else 0.0,
                cache_hit=float(hit),
            )

    ok = True
    results: dict[str, dict] = {}
    launches = va.launches
    for name, program in programs.items():
        out, plain = program(device)
        value, plain_value = float(out), float(plain)
        finite = math.isfinite(value)
        equal = value == plain_value
        ok = ok and finite and (equal or device.type != "cuda")
        results[name] = {"finite": finite, "value": value, "plain_value": plain_value}

    published = 0
    if store is not None and client.enabled() and store.stats.misses > 0:
        # only a node that actually BUILT something new publishes: warm
        # nodes must not re-upload the seeder's libraries (the fleet side
        # is idempotent regardless)
        published = cc.publish_kind(store, kind, client)
    if store is not None:
        store.record_flight_sample()

    stats = store.stats if store is not None else cc.CacheStats()
    return {
        "ok": ok,
        "programs": len(results),
        "hits": stats.hits,
        "misses": stats.misses,
        "corrupt": stats.corrupt,
        "prewarmed": prewarmed,
        "published": published,
        "compile_s": round(compile_s, 6),
        "fetch_s": round(fetch_s, 6),
        "duration_s": round(time.perf_counter() - t0, 6),
        "results": results,
        "libraries": libs,
        # kernel B1's launches in this run (the vector-add program's)
        "launches": {"vector_add": va.launches - launches},
        "backend": device.type,
    }


def quick_check(device=None) -> dict:
    return run(device=device)
