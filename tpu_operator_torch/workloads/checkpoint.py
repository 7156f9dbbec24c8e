"""Migratable training state on PyTorch: atomic sharded checkpoints and
reshard-on-restore.  Port of ``tpu_operator/workloads/checkpoint.py``.

- :func:`save_checkpoint` writes the reference's snapshot format byte for
  byte: every array as its distinct shards (raw bytes, the shard's *global
  index ranges*, a content hash), the manifest last inside a temp
  directory, the directory published with one ``os.replace``, and a
  ``LATEST`` pointer (itself tmp + replace).  A crash at any byte leaves the
  previous snapshot authoritative.
- :func:`load_checkpoint` verifies the manifest and every shard and falls
  back to the next-newest valid snapshot on any corruption.  It returns
  torch tensors on the CPU, or, given a mesh, each rank's cut of them on its
  device: the shards carry global index ranges, so a snapshot taken under
  one mesh restores bitwise under another, and a snapshot written by either
  package restores into the other.
- bf16 has no numpy dtype without ``ml_dtypes``; its raw 2-byte bits are
  written and read under the reference's manifest name ``"bfloat16"``.
- :class:`Checkpointer` serializes and coalesces snapshot requests;
  :class:`MigrationSignal` watches the drain signal (the pod annotation via
  the downward-API file, SIGTERM as the fallback).
- :func:`main` (``python -m tpu_operator_torch.workloads.checkpoint``) is
  the migratable training job, the chaos-migrate payload: a (dp, mp)
  Megatron MLP over ``TPU_JOB_TOPOLOGY``, one rank per card (NCCL; gloo on
  the CPU), that checkpoints every ``TPU_CKPT_EVERY`` steps and on the drain
  signal, exits 0, and restores (resharding) on the next launch.

Every phase is recorded on the ambient flight recorder, as the reference's.
"""

from __future__ import annotations

import functools
import hashlib
import json
import math
import os
import re
import shutil
import signal
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from tpu_operator_torch import consts
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import profile as obs_profile

MANIFEST_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
LATEST_NAME = "LATEST"
# highest step the training loop ever COMPLETED on this checkpoint dir (vs
# LATEST, the newest durable snapshot): the gap at restore is the lost steps
HIGHWATER_NAME = "HIGHWATER"
_STEP_DIR_RE = re.compile(r"^step-(\d{8})$")

# fault-injection env, applied to signal-triggered (final) snapshots only:
#   kill      SIGKILL self after the shard files, before the manifest
#   slow:<s>  sleep <s> seconds mid-snapshot
FAULT_ENV = "TPU_CKPT_FAULT"

# manifest dtype name -> torch dtype (numpy's names; bfloat16 the reference's)
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


class CheckpointError(Exception):
    """A snapshot that must not be trusted (torn manifest, hash mismatch)."""


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _np_dtype(name: str) -> np.dtype:
    """numpy dtype that holds a manifest dtype's bytes: bfloat16's bits as
    int16 (reinterpreted as torch bf16 on the way out)."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


@dataclass
class Sharded:
    """A global array held as shards, each with its global index ranges
    (``((start, stop), ...)`` per dim): what rank 0 gathers from the ranks of
    a mesh, the counterpart of a JAX array's addressable shards.  Shards of
    replicated dims repeat; the snapshot keeps one of each."""

    shape: tuple
    dtype: torch.dtype
    shards: list  # [(index, tensor)]


def _dtype_name(value) -> str:
    dtype = value.dtype
    if isinstance(dtype, torch.dtype):
        return _DTYPE_NAMES[dtype]
    return str(np.dtype(dtype).name)


def _blob(data) -> bytes:
    """Raw bytes of a torch tensor or numpy array, C order."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().contiguous()
        if data.dtype == torch.bfloat16:
            data = data.view(torch.int16)
        return data.numpy().tobytes()
    return np.ascontiguousarray(data).tobytes()


def _shards_of(value) -> list:
    """(global index ranges, data) per distinct shard of ``value``: a
    :class:`Sharded` value's shards deduplicated by index and sorted, anything
    else one full-coverage shard."""
    if not isinstance(value, Sharded):
        return [(tuple((0, d) for d in value.shape), value)]
    seen: dict = {}
    for index, data in value.shards:
        seen.setdefault(tuple(tuple(r) for r in index), data)
    return sorted(seen.items(), key=lambda kv: kv[0])


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    arrays: dict,
    mesh_shape: Optional[tuple] = None,
    specs: Optional[dict] = None,
    extra: Optional[dict] = None,
    keep: int = 2,
    fault: Optional[Callable[[], None]] = None,
) -> str:
    """Write one atomic snapshot; returns the published snapshot dir.

    ``arrays`` maps name -> numpy array, torch tensor or :class:`Sharded`.
    ``specs`` maps name -> partition spec as a list (``["dp", None]``: dim 0
    sharded over the mesh's dp axis), recorded for restore-time placement.
    ``fault`` is the test seam invoked after the shard files exist but
    before the manifest: the canonical torn point."""
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    manifest: dict = {
        "version": MANIFEST_VERSION,
        "step": int(step),
        "mesh": list(mesh_shape) if mesh_shape else None,
        "ts": time.time(),
        "arrays": {},
        "extra": extra or {},
    }
    for name, value in arrays.items():
        entry: dict = {
            "shape": [int(d) for d in value.shape],
            "dtype": _dtype_name(value),
            "spec": list((specs or {}).get(name) or []),
            "shards": [],
        }
        for i, (index, data) in enumerate(_shards_of(value)):
            fname = f"{name}-{i:05d}.bin"
            blob = _blob(data)
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(blob)
            entry["shards"].append({
                "file": fname,
                "index": [list(r) for r in index],
                "bytes": len(blob),
                "sha256": _sha256(blob),
            })
        manifest["arrays"][name] = entry
    if fault is not None:
        fault()  # torn point: shards on disk, no manifest yet
    # manifest last, inside the tmp dir, itself via tmp+replace; then the
    # directory rename publishes the snapshot as one atomic unit
    mtmp = os.path.join(tmp, MANIFEST_NAME + ".tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(tmp, MANIFEST_NAME))
    if os.path.isdir(final):
        _rmtree(final)  # a re-snapshot of the same step replaces it whole
    os.replace(tmp, final)
    _publish_latest(ckpt_dir, os.path.basename(final))
    _gc(ckpt_dir, keep=keep)
    flight.record(
        "migration", "checkpoint", step=step,
        checkpoint_s=time.perf_counter() - t0,
        arrays=float(len(arrays)),
    )
    return final


def _publish_latest(ckpt_dir: str, name: str) -> None:
    tmp = os.path.join(ckpt_dir, LATEST_NAME + f".tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(name)
    os.replace(tmp, os.path.join(ckpt_dir, LATEST_NAME))


def publish_highwater(ckpt_dir: str, step: int) -> None:
    """Stamp the highest completed step (tmp + replace, as LATEST)."""
    tmp = os.path.join(ckpt_dir, HIGHWATER_NAME + f".tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(str(int(step)))
    os.replace(tmp, os.path.join(ckpt_dir, HIGHWATER_NAME))


def read_highwater(ckpt_dir: str) -> int:
    """The step the job had reached when it last ran, or -1 when no stamp."""
    try:
        with open(os.path.join(ckpt_dir, HIGHWATER_NAME)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return -1


def _rmtree(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def _snapshot_dirs(ckpt_dir: str) -> list:
    """Complete snapshot dir names, newest first (tmp debris excluded)."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    return sorted((n for n in names if _STEP_DIR_RE.match(n)), reverse=True)


def _gc(ckpt_dir: str, keep: int) -> None:
    for name in _snapshot_dirs(ckpt_dir)[keep:]:
        _rmtree(os.path.join(ckpt_dir, name))
    # stale tmp dirs from crashed snapshots are debris, not evidence
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return
    for name in names:
        if ".tmp-" in name and not os.path.isfile(os.path.join(ckpt_dir, name)):
            _rmtree(os.path.join(ckpt_dir, name))


def _read_manifest(snap_dir: str) -> dict:
    """Parse one snapshot's manifest and validate its structure; raises
    CheckpointError on a missing, truncated or malformed manifest.  Shard
    content is verified by :func:`_assemble` on the one read that also
    rebuilds the tensors."""
    path = os.path.join(snap_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"unreadable manifest at {path}: {e}") from e
    if manifest.get("version") != MANIFEST_VERSION:
        raise CheckpointError(
            f"manifest version {manifest.get('version')!r} != {MANIFEST_VERSION}"
        )
    if not isinstance(manifest.get("arrays"), dict) or "step" not in manifest:
        raise CheckpointError(f"malformed manifest at {path}")
    return manifest


@dataclass
class Checkpoint:
    """One verified snapshot, reassembled: global torch tensors on the CPU
    (or, when a target mesh was given, this rank's cut of each on its
    device, under the recorded specs)."""

    step: int
    arrays: dict
    mesh_shape: Optional[tuple]
    specs: dict
    path: str
    extra: dict = field(default_factory=dict)


def _assemble(snap_dir: str, entry: dict) -> torch.Tensor:
    """Rebuild one global array, verifying every shard (presence, size,
    content hash) on the same read; raises CheckpointError on any tear."""
    shape = tuple(entry["shape"])
    name = entry["dtype"]
    if name not in _TORCH_DTYPES:
        raise CheckpointError(f"unsupported dtype {name!r}")
    out = np.empty(shape, dtype=_np_dtype(name))
    for shard in entry["shards"]:
        spath = os.path.join(snap_dir, shard.get("file", ""))
        try:
            with open(spath, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise CheckpointError(f"missing shard {spath}: {e}") from e
        if len(blob) != shard.get("bytes"):
            raise CheckpointError(
                f"shard {spath} truncated: {len(blob)} != {shard.get('bytes')}"
            )
        if _sha256(blob) != shard.get("sha256"):
            raise CheckpointError(f"shard {spath} content hash mismatch")
        index = tuple(slice(a, b) for a, b in shard["index"])
        piece_shape = tuple(b - a for a, b in shard["index"])
        out[index] = np.frombuffer(blob, dtype=out.dtype).reshape(piece_shape)
    tensor = torch.from_numpy(out)
    return tensor.view(torch.bfloat16) if name == "bfloat16" else tensor


def load_checkpoint(ckpt_dir: str, mesh=None) -> Optional[Checkpoint]:
    """Newest *valid* snapshot, or None.  Corrupt snapshots are skipped and
    the scan falls back to older complete ones; the LATEST pointer is an
    optimization, the manifest verification is the authority.  ``mesh``
    (``collectives.Mesh``): place each array's cut on this rank."""
    order = _snapshot_dirs(ckpt_dir)
    try:
        with open(os.path.join(ckpt_dir, LATEST_NAME)) as f:
            latest = f.read().strip()
        if latest in order:  # try the pointer first
            order = [latest] + [n for n in order if n != latest]
    except OSError:
        pass
    t0 = time.perf_counter()
    for name in order:
        snap_dir = os.path.join(ckpt_dir, name)
        try:
            manifest = _read_manifest(snap_dir)
            arrays = {
                aname: _assemble(snap_dir, entry)
                for aname, entry in manifest["arrays"].items()
            }
        except CheckpointError:
            continue
        specs = {
            aname: tuple(entry.get("spec") or ())
            for aname, entry in manifest["arrays"].items()
        }
        if mesh is not None:
            arrays = {aname: _place(mesh, arrays[aname], specs[aname]) for aname in arrays}
        ckpt = Checkpoint(
            step=int(manifest["step"]),
            arrays=arrays,
            mesh_shape=tuple(manifest["mesh"]) if manifest.get("mesh") else None,
            specs=specs,
            path=snap_dir,
            extra=manifest.get("extra") or {},
        )
        # lost-step delta from on-disk stamps: HIGHWATER is where the killed
        # process stood, the manifest step is where this one resumes
        step_at_kill = read_highwater(ckpt_dir)
        flight.record(
            "migration", "restore", step=ckpt.step,
            restore_s=time.perf_counter() - t0,
            arrays=float(len(arrays)),
            step_at_kill=float(step_at_kill),
            step_at_restore=float(ckpt.step),
            lost_steps=float(max(0, step_at_kill - ckpt.step)),
        )
        return ckpt
    return None


def _shard_index(shape, spec, axes: dict, coords: dict) -> tuple:
    """Global index ranges of one rank's cut of an array of ``shape`` under
    ``spec``: a dim the spec names splits evenly over that mesh axis (of
    size ``axes[name]``), at the rank's coordinate on it (``coords[name]``);
    the others stay whole."""
    index = []
    for i, dim in enumerate(shape):
        axis = spec[i] if i < len(spec) else None
        if axis is None:
            index.append((0, int(dim)))
            continue
        n = axes[axis]
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {axis}={n}")
        size = dim // n
        index.append((coords[axis] * size, (coords[axis] + 1) * size))
    return tuple(index)


def _coords(mesh, rank: int) -> dict:
    return dict(zip(("dp", "mp"), divmod(rank, mesh.mp)))


def _place(mesh, array: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's cut of a reassembled global array under ``mesh``
    (``collectives.Mesh``) with its recorded partition spec, on the rank's
    device: the reshard, since the collection carries global index ranges,
    any mesh shape cuts the same tensors along its own lines."""
    index = _shard_index(array.shape, spec, mesh.shape, _coords(mesh, mesh.rank))
    piece = array[tuple(slice(a, b) for a, b in index)]
    return piece.contiguous().to(mesh.device)


def gather_sharded(local: torch.Tensor, shape: tuple, spec: tuple, mesh) -> Optional[Sharded]:
    """Every rank's cut of one array (``local``, as :func:`_place` cut it),
    gathered to rank 0 with its global index ranges; None on the other
    ranks.  Collective: every rank of the mesh calls it."""
    import torch.distributed as dist

    pieces = [local]
    if mesh.size > 1:
        # f32 carries bf16 exactly, and every backend gathers it
        pieces = [torch.empty_like(local, dtype=torch.float32) for _ in range(mesh.size)]
        dist.all_gather(pieces, local.float().contiguous())
        if mesh.rank != 0:
            return None
    shards = [(_shard_index(shape, spec, mesh.shape, _coords(mesh, rank)),
               piece.to(local.dtype).cpu()) for rank, piece in enumerate(pieces)]
    return Sharded(tuple(shape), local.dtype, shards)


class Checkpointer:
    """Snapshot coordinator: serializes writes, coalesces concurrent
    requests, applies the seeded chaos faults to *final* snapshots only."""

    def __init__(self, ckpt_dir: str, keep: int = 2):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._lock = threading.Lock()
        self._saving = False
        self._last_step: Optional[int] = None
        self._last_path: Optional[str] = None

    def save(
        self,
        step: int,
        arrays: dict,
        mesh_shape: Optional[tuple] = None,
        specs: Optional[dict] = None,
        extra: Optional[dict] = None,
        final: bool = False,
    ) -> Optional[str]:
        """Snapshot ``step``; concurrent callers coalesce onto the in-flight
        or previous path, and a re-request of a persisted step is a no-op,
        except for ``final`` (signal-triggered) snapshots, which always
        write: a final request that races an in-flight save waits for it and
        then writes its own (exiting 0 on a snapshot that never ran would
        hand the coordinator a false checkpoint-complete)."""
        while True:
            with self._lock:
                if not self._saving:
                    if self._last_step == step and not final:
                        return self._last_path
                    self._saving = True
                    break
                if not final:
                    return self._last_path
            time.sleep(0.01)  # final: outwait the in-flight writer
        try:
            path = save_checkpoint(
                self.ckpt_dir, step, arrays, mesh_shape=mesh_shape,
                specs=specs, extra=extra, keep=self.keep,
                fault=_env_fault() if final else None,
            )
            with self._lock:
                self._last_step, self._last_path = step, path
            return path
        finally:
            with self._lock:
                self._saving = False


def _env_fault() -> Optional[Callable[[], None]]:
    """The chaos checkpoint fault as a callable, from TPU_CKPT_FAULT."""
    spec = os.environ.get(FAULT_ENV, "")
    if not spec:
        return None
    kind, _, arg = spec.partition(":")

    def fault() -> None:
        if kind == "kill":
            print(json.dumps({"fault_injected": "kill-during-checkpoint"}),
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        elif kind == "slow":
            try:
                time.sleep(float(arg or 0))
            except ValueError:
                pass

    return fault


class MigrationSignal:
    """The drain signal, from either channel:

    - the downward-API annotations file (``TPU_MIGRATE_SIGNAL_FILE``), which
      the kubelet rewrites when the coordinator stamps
      ``tpu.google.com/migrate=requested``;
    - SIGTERM, the fallback every eviction delivers.

    The port runs a job of several cards as ranks in child processes, which
    the pod's SIGTERM does not reach: given ``mirror_file``, the handler
    also creates that file, and a copy of the signal sent to a rank (it
    pickles without its handler) reads it as SIGTERM."""

    def __init__(self, annotations_file: Optional[str] = None,
                 install_sigterm: bool = True, mirror_file: str = ""):
        self.annotations_file = (
            annotations_file
            if annotations_file is not None
            else os.environ.get(consts.MIGRATE_SIGNAL_FILE_ENV, "")
        )
        self.mirror_file = mirror_file
        self._sigterm = threading.Event()
        if install_sigterm:
            try:
                signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                pass  # non-main thread (tests): file channel only

    def __getstate__(self) -> dict:
        return {"annotations_file": self.annotations_file, "mirror_file": self.mirror_file,
                "sigterm": self._sigterm.is_set()}

    def __setstate__(self, state: dict) -> None:
        self.annotations_file = state["annotations_file"]
        self.mirror_file = state["mirror_file"]
        self._sigterm = threading.Event()
        if state["sigterm"]:
            self._sigterm.set()

    def _on_sigterm(self, signum, frame) -> None:
        self._sigterm.set()
        if self.mirror_file:
            try:
                with open(self.mirror_file, "w"):
                    pass
            except OSError:
                pass

    @property
    def sigterm(self) -> bool:
        return self._sigterm.is_set() or bool(self.mirror_file
                                              and os.path.exists(self.mirror_file))

    def requested(self) -> bool:
        if self.sigterm:
            return True
        if not self.annotations_file:
            return False
        try:
            with open(self.annotations_file) as f:
                text = f.read()
        except OSError:
            return False
        return self._parse(text)

    @staticmethod
    def _parse(text: str) -> bool:
        """Downward-API format (``key="value"`` lines, values Go-quoted);
        plain ``key=value`` accepted for hand-written test files."""
        for line in text.splitlines():
            key, sep, value = line.partition("=")
            if not sep or key.strip() != consts.MIGRATE_ANNOTATION:
                continue
            if value.strip().strip('"') == consts.MIGRATE_REQUESTED:
                return True
        return False


# ---------------------------------------------------------------------------
# The migratable training job (the chaos-migrate soak's payload).

SPECS = {"w1": (None, "mp"), "w2": ("mp", None)}
LEARNING_RATE = 0.05


def _mesh_from_topology(topology: str, devices: int) -> tuple:
    """(dp, mp) over exactly topology-many cards: the first topology dim is
    dp, the rest collapse into mp ("4x4" -> 4x4, "2x4" -> 2x4).  When fewer
    cards exist than the topology names, the mesh degrades to (1, all cards)
    instead of crashing: a restore pod may land on a smaller slice, and the
    checkpoint reshards under any mesh."""
    from tpu_operator_torch.utils import parse_topology, topology_chips

    dims = parse_topology(topology)
    chips = topology_chips(topology)
    if devices < chips:
        print(json.dumps({
            "event": "topology-degraded", "declared": topology,
            "devices": devices,
        }), flush=True)
        return 1, devices
    return dims[0], chips // dims[0]


def _init_params(d_model: int, d_hidden: int) -> dict:
    """The reference's draws (seed 0), rounded to bf16."""
    rng = np.random.default_rng(0)
    scale = 1.0 / np.sqrt(d_model)
    return {
        "w1": torch.from_numpy(rng.standard_normal((d_model, d_hidden), dtype=np.float32)
                               * scale).bfloat16(),
        "w2": torch.from_numpy(rng.standard_normal((d_hidden, d_model), dtype=np.float32)
                               * scale).bfloat16(),
    }


def _input(global_batch: int, d_model: int) -> torch.Tensor:
    """The reference's batch (seed 7), rounded to bf16."""
    return torch.from_numpy(np.random.default_rng(7).standard_normal(
        (global_batch, d_model), dtype=np.float32)).bfloat16()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 product as XLA computes one on the host: f32 products summed
    in f32 (TF32 off on a card); the caller rounds where the reference's
    result is bf16."""
    return torch.matmul(a.float(), b.float())


def train_step(params: dict, x: torch.Tensor, mesh, global_batch: int) -> tuple:
    """One SGD step of the reference's Megatron MLP on this rank's cut:
    ``relu(x @ w1) @ w2`` with w1 split by columns over mp and w2 by rows,
    y summed over mp, loss ``mean(y^2)`` over the global batch, its exact
    gradient (bf16 where the reference's is) summed over dp, and
    ``w - 0.05 g`` in f32 rounded to bf16.  Returns (loss, new params)."""
    from tpu_operator_torch.workloads.collectives import _sum

    w1, w2 = params["w1"], params["w2"]
    a = _mm(x, w1).bfloat16()
    h = torch.clamp_min(a, 0)
    y = _sum(_mm(h, w2), mesh.mp_group, mesh.mp).bfloat16()
    yf = y.float()
    n = global_batch * yf.shape[1]
    loss = _sum((yf * yf).sum().reshape(1), mesh.dp_group, mesh.dp) / n
    dy = ((2.0 * yf) * (1.0 / n)).bfloat16()
    dh = _mm(dy, w2.t()).bfloat16()
    # d/da max(a, 0): 1 above, 0 below, 1/2 at the tie (JAX's maximum)
    da = torch.where(a > 0, dh, torch.where(a == 0, dh * 0.5, torch.zeros_like(dh)))
    grads = {"w1": _sum(_mm(x.t(), da), mesh.dp_group, mesh.dp).bfloat16(),
             "w2": _sum(_mm(h.t(), dy), mesh.dp_group, mesh.dp).bfloat16()}
    new = {k: (params[k].float() - LEARNING_RATE * grads[k].float()).to(params[k].dtype)
           for k in params}
    return loss, new


def _train(rank, world_size, device, ckpt_dir, topology, steps, ckpt_every, step_sleep_s,
           d_model, d_hidden, shape, sig, progress) -> dict:
    """The loop on one rank (rank 0 decides, checkpoints and reports)."""
    import torch.distributed as dist

    from tpu_operator_torch.workloads import collectives

    mesh = collectives.make_mesh(world_size, rank, device, shape=shape)
    dp, mp = mesh.dp, mesh.mp
    lead = rank == 0
    report = progress if lead else None

    start_step = resumed_from = 0
    highwater_prior = read_highwater(ckpt_dir)
    acct_useful_s = acct_wasted_s = 0.0
    replayed_steps = 0
    t_restore0 = time.perf_counter()
    ckpt = load_checkpoint(ckpt_dir, mesh=mesh)
    acct_wasted_s += time.perf_counter() - t_restore0  # restore overhead
    shapes = {"w1": (d_model, d_hidden), "w2": (d_hidden, d_model)}
    if ckpt is not None:
        params = {"w1": ckpt.arrays["w1"], "w2": ckpt.arrays["w2"]}
        start_step = resumed_from = ckpt.step
        if report is not None:
            report({"event": "restored", "resumed_from_step": ckpt.step,
                    "from_mesh": list(ckpt.mesh_shape or ()), "mesh": [dp, mp]})
    else:
        params = {k: _place(mesh, v, SPECS[k]) for k, v in _init_params(d_model, d_hidden).items()}
        if report is not None:
            report({"event": "started", "mesh": [dp, mp]})

    global_batch = 8 * dp
    i = mesh.coords[0]
    x = _input(global_batch, d_model)[i * 8:(i + 1) * 8].to(device)

    ckpt_writer = Checkpointer(ckpt_dir)
    ckpt_writer._last_step = resumed_from or None

    def gathered() -> dict:
        return {k: gather_sharded(v, shapes[k], SPECS[k], mesh) for k, v in params.items()}

    def snapshot(step: int, final: bool) -> None:
        nonlocal acct_wasted_s
        t_ckpt0 = time.perf_counter()
        try:
            arrays = gathered()
            if lead:
                ckpt_writer.save(step, arrays, mesh_shape=(dp, mp), specs=SPECS, final=final)
        finally:
            acct_wasted_s += time.perf_counter() - t_ckpt0  # ckpt overhead

    def stop_requested() -> bool:
        """Rank 0 reads the signal; every rank acts on its answer."""
        if world_size == 1:
            return sig.requested()
        flag = torch.tensor([float(lead and sig.requested())], device=device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    checkpointed = resumed_from if ckpt is not None else -1
    step = start_step
    losses: list = []
    barrier = obs_profile.FileStepBarrier.from_env() if lead else None
    compiled = False
    timer = obs_profile.StepTimer()
    while step < steps:
        if stop_requested():
            snapshot(step, final=True)
            checkpointed = step
            if report is not None:
                report({"event": "checkpointed", "step": step, "trigger": "migrate-signal"})
            if barrier is not None:
                barrier.leave()  # a migrating member must not wedge its peers
            break
        timer.reset()
        t_step0 = time.perf_counter()
        # the first step pays the cuBLAS/NCCL warm-up; later steps run warm
        with timer.phase(obs_profile.PHASE_COMPUTE if compiled else obs_profile.PHASE_COMPILE):
            loss, params = train_step(params, x, mesh, global_batch)
            losses.append(float(loss))
        compiled = True
        step += 1
        if step_sleep_s:
            with timer.phase(obs_profile.PHASE_COMPUTE):
                time.sleep(step_sleep_s)
        if barrier is not None:
            timer.add(obs_profile.PHASE_COLLECTIVE_WAIT, barrier.wait(step))
        step_wall_s = time.perf_counter() - t_step0
        replayed = step <= highwater_prior
        if replayed:
            replayed_steps += 1
            acct_wasted_s += step_wall_s
        else:
            acct_useful_s += step_wall_s
            if lead:
                publish_highwater(ckpt_dir, step)
        flight.record(
            "migration", "step", step=step, step_s=step_sleep_s,
            replayed=1.0 if replayed else 0.0,
            replayed_steps=float(replayed_steps),
            acct_useful_s=acct_useful_s,
            acct_wasted_s=acct_wasted_s,
        )
        flight.record_step("migration", step_seq=step, wall_s=step_wall_s, phases=timer.spans())
        if ckpt_every and step % ckpt_every == 0 and step < steps:
            snapshot(step, final=False)
            checkpointed = step
            if report is not None:
                report({"event": "progress", "step": step})

    final = gathered()
    if not lead:
        return {}
    digest = hashlib.sha256()
    for name in ("w1", "w2"):
        full = torch.empty(shapes[name], dtype=params[name].dtype)
        for index, data in _shards_of(final[name]):
            full[tuple(slice(a, b) for a, b in index)] = data
        digest.update(_blob(full))
    finite = all(math.isfinite(v) for v in losses) if losses else True
    return {
        "ok": finite,
        "steps_done": step - start_step,
        "step": step,
        "resumed_from_step": resumed_from,
        "checkpointed_step": checkpointed,
        "migrated_out": bool(sig.requested()),
        "mesh": [dp, mp],
        "topology": topology,
        "losses_finite": finite,
        "backend": device.type,
        "losses": losses,
        # the final bf16 weights (w1 then w2, C order): two runs that must
        # agree bit for bit compare this
        "weights_sha256": digest.hexdigest(),
    }


def run_migratable_training(
    ckpt_dir: str,
    topology: str,
    steps: int = 50,
    ckpt_every: int = 10,
    step_sleep_s: float = 0.0,
    d_model: int = 32,
    d_hidden: int = 64,
    signal_source: Optional[MigrationSignal] = None,
    progress: Optional[Callable[[dict], None]] = None,
    device=None,
    devices: Optional[int] = None,
) -> dict:
    """The migratable train loop: restore -> step -> periodic checkpoint ->
    (on the drain signal) final checkpoint and clean exit.

    One rank per card of the (dp, mp) mesh that ``topology`` names over the
    ``devices`` present (default: the visible cards; ``DIST_CPU_RANKS``, else
    1, on the CPU), in this process when the mesh is one card, else in
    spawned ranks (NCCL; gloo on the CPU), rank 0 deciding and writing.
    There ``progress`` must pickle (``main``'s does); a
    :class:`MigrationSignal` pickles with its file channels, and SIGTERM to
    this process reaches rank 0 through its mirror file.  Returns the
    reference's result keys, plus ``losses`` and ``weights_sha256``."""
    from tpu_operator_torch.workloads import _ranks, collectives, resolve_device

    device = resolve_device(device)
    if devices is None:
        devices = collectives.local_world_size(device)
    sig = signal_source or MigrationSignal()
    dp, mp = _mesh_from_topology(topology, devices)
    kwargs = dict(ckpt_dir=ckpt_dir, topology=topology, steps=steps, ckpt_every=ckpt_every,
                  step_sleep_s=step_sleep_s, d_model=d_model, d_hidden=d_hidden,
                  shape=(dp, mp), progress=progress)
    if dp * mp == 1:
        return _train(0, 1, device, sig=sig, **kwargs)
    with tempfile.TemporaryDirectory(prefix="tpu-migrate-") as tmp:
        mirrored = isinstance(sig, MigrationSignal) and not sig.mirror_file
        if mirrored:
            sig.mirror_file = os.path.join(tmp, "sigterm")
        try:
            # the ranks' deadline: start-up, then a generous bound per step
            return _ranks.run(_train_rank, dp * mp, device.type,
                              timeout_s=600.0 + steps * (10.0 + step_sleep_s), sig=sig, **kwargs)
        finally:
            if mirrored:
                sig.mirror_file = ""


def _train_rank(rank, world_size, device, **kwargs) -> dict:
    return _train(rank, world_size, device, **kwargs)


def emit(result_file: str, event: dict) -> None:
    """One progress event as a JSON line on stdout, and appended to
    ``result_file`` when set (the job's drop-box)."""
    line = json.dumps({"ts": round(time.time(), 3), **event})
    print(line, flush=True)
    if result_file:
        try:
            with open(result_file, "a") as f:
                f.write(line + "\n")
        except OSError:
            pass


def main() -> int:
    from tpu_operator_torch.validator import status as vstatus
    from tpu_operator_torch.workloads import resolve_device

    resolve_device()  # no card and no TORCH_DEVICE=cpu request: raise
    ckpt_dir = os.environ.get(consts.CKPT_DIR_ENV, "")
    if not ckpt_dir:
        print(json.dumps({"ok": False, "error": f"{consts.CKPT_DIR_ENV} required"}))
        return 1
    os.makedirs(ckpt_dir, exist_ok=True)
    topology = os.environ.get(consts.JOB_TOPOLOGY_ENV, "2x4")
    progress = functools.partial(emit, os.environ.get("TPU_JOB_RESULT_FILE", ""))

    recorder = flight.recorder_for(vstatus.flight_record_path("migration"))
    with flight.activate(recorder):
        result = run_migratable_training(
            ckpt_dir,
            topology,
            steps=int(os.environ.get("TRAIN_STEPS", "50")),
            ckpt_every=int(os.environ.get("TPU_CKPT_EVERY", "10")),
            step_sleep_s=float(os.environ.get("TRAIN_STEP_SLEEP_S", "0") or 0),
            progress=progress,
        )
        flight.record_result("migration", result)
    progress({"event": "result", **result})
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
