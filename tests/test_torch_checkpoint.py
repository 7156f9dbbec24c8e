"""Parity of the port's checkpoint layer (``tpu_operator_torch.workloads.
checkpoint``) with the JAX reference, on the CPU: the snapshot format both
ways (the same arrays give byte-identical shard files and manifests; bf16
travels as its raw bits without ``ml_dtypes``; a JAX-sharded array and the
port's gathered shards give the same files), the reference's torn-snapshot
cases, the coalescing writer, the migration signal, and the migratable
training job on 1 and 4 gloo ranks against JAX on 1 and 4 virtual devices.

The training parity tolerance: both sides compute every product as f32
products of bf16 values summed in f32 and rounded once to bf16, but the two
libraries sum in their own orders, so a rounding may land on the
neighbouring bf16 value (a relative step of 2^-8 = 3.9e-3); then the runs
drift apart slowly.  The weights agree within 2 bf16 steps of their
magnitude over these few steps, and the losses within 1e-3 relative of a
float64 recomputation with the reference's bf16 roundings (the reference
reports no losses).
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator import consts as jconsts  # noqa: E402
from tpu_operator.workloads import checkpoint as jcp  # noqa: E402
from tpu_operator_torch import consts as tconsts  # noqa: E402
from tpu_operator_torch.workloads import checkpoint as cp  # noqa: E402
from tpu_operator_torch.workloads.collectives import Mesh  # noqa: E402

SPECS = {"w1": (None, "mp"), "w2": ("mp", None)}
LOSS_RTOL = 1e-3
WEIGHT_STEPS = 2 * 2.0 ** -8  # of the weights' magnitude


def _np_params():
    rng = np.random.default_rng(3)
    return {
        "w1": rng.standard_normal((16, 32)).astype(np.float32),
        "w2": rng.standard_normal((32, 16)).astype(np.float32),
    }


def _jmesh(dp, mp):
    import jax
    from jax.sharding import Mesh as JMesh

    return JMesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp), ("dp", "mp"))


def _files(snap: str) -> dict:
    """Every file of a snapshot; the manifest without its wall-clock stamp."""
    out = {}
    for name in sorted(os.listdir(snap)):
        with open(os.path.join(snap, name), "rb") as f:
            blob = f.read()
        if name == cp.MANIFEST_NAME:
            manifest = json.loads(blob)
            manifest.pop("ts")
            blob = json.dumps(manifest, sort_keys=True).encode()
        out[name] = blob
    return out


def test_constants_match_reference():
    for name in ("CKPT_DIR_ENV", "JOB_TOPOLOGY_ENV", "MIGRATE_SIGNAL_FILE_ENV",
                 "MIGRATE_ANNOTATION", "MIGRATE_REQUESTED"):
        assert getattr(tconsts, name) == getattr(jconsts, name)
    for name in ("MANIFEST_VERSION", "MANIFEST_NAME", "LATEST_NAME", "HIGHWATER_NAME",
                 "FAULT_ENV"):
        assert getattr(cp, name) == getattr(jcp, name)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_same_arrays_give_byte_identical_snapshots(tmp_path, kind):
    arrays = _np_params()
    mine = {k: torch.from_numpy(v) for k, v in arrays.items()} if kind == "torch" else arrays
    a = cp.save_checkpoint(str(tmp_path / "t"), 7, mine, mesh_shape=(2, 4), specs=SPECS,
                           extra={"note": [1, 2]})
    b = jcp.save_checkpoint(str(tmp_path / "j"), 7, arrays, mesh_shape=(2, 4), specs=SPECS,
                            extra={"note": [1, 2]})
    assert _files(a) == _files(b)
    ck = cp.load_checkpoint(str(tmp_path / "j"))
    assert ck.step == 7 and ck.mesh_shape == (2, 4) and ck.specs["w1"] == (None, "mp")
    for k, v in arrays.items():
        assert ck.arrays[k].dtype == torch.float32 and ck.arrays[k].numpy().tobytes() == v.tobytes()


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_bf16_round_trips_bitwise_across_packages(tmp_path, direction):
    w = (np.arange(64, dtype=np.float32).reshape(8, 8) / 7.0).astype(jnp.bfloat16)
    tw = torch.from_numpy(np.arange(64, dtype=np.float32).reshape(8, 8) / 7.0).bfloat16()
    d = str(tmp_path)
    if direction == "jax-to-torch":
        jcp.save_checkpoint(d, 1, {"w": w})
        got = cp.load_checkpoint(d).arrays["w"]
        assert got.dtype == torch.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == w.tobytes()
    else:
        path = cp.save_checkpoint(d, 1, {"w": tw})
        got = jcp.load_checkpoint(d).arrays["w"]
        assert str(got.dtype) == "bfloat16" and got.tobytes() == w.tobytes()
        assert _files(path) == _files(jcp.save_checkpoint(str(tmp_path / "j"), 1, {"w": w}))


def _port_mesh(dp, mp, rank):
    return Mesh(dp, mp, rank, torch.device("cpu"))


def test_sharded_snapshot_matches_jax_and_reshards(tmp_path):
    """A JAX array sharded over a (2, 4) mesh and the port's gathered shards
    of the same cut give the same files; a (2, 4) snapshot restores bitwise
    under (1, 4) on every rank, each rank holding its own cut."""
    arrays = _np_params()
    jparams = {k: jcp._place(_jmesh(2, 4), v, SPECS[k]) for k, v in arrays.items()}
    jpath = jcp.save_checkpoint(str(tmp_path / "j"), 42, jparams, mesh_shape=(2, 4), specs=SPECS)
    tparams = {}
    for k, v in arrays.items():
        cuts = [(cp._shard_index(v.shape, SPECS[k], {"dp": 2, "mp": 4}, cp._coords(
            _port_mesh(2, 4, r), r)), cp._place(_port_mesh(2, 4, r), torch.from_numpy(v),
                                                  SPECS[k])) for r in range(8)]
        tparams[k] = cp.Sharded(v.shape, torch.float32, cuts)
    tpath = cp.save_checkpoint(str(tmp_path / "t"), 42, tparams, mesh_shape=(2, 4), specs=SPECS)
    assert _files(tpath) == _files(jpath)
    assert len(json.load(open(os.path.join(jpath, cp.MANIFEST_NAME)))["arrays"]["w1"]
               ["shards"]) == 4
    for rank in range(4):
        ck = cp.load_checkpoint(str(tmp_path / "j"), mesh=_port_mesh(1, 4, rank))
        assert ck.step == 42
        assert ck.arrays["w1"].numpy().tobytes() == \
            np.ascontiguousarray(arrays["w1"][:, rank * 8:(rank + 1) * 8]).tobytes()
        assert ck.arrays["w2"].numpy().tobytes() == arrays["w2"][rank * 8:(rank + 1) * 8].tobytes()


def test_torn_manifest_rejected_and_falls_back(tmp_path):
    d = str(tmp_path)
    cp.save_checkpoint(d, 1, _np_params())
    good = cp.load_checkpoint(d).path
    cp.save_checkpoint(d, 2, _np_params())
    newest = cp.load_checkpoint(d).path
    assert newest != good
    with open(os.path.join(newest, cp.MANIFEST_NAME), "w") as f:
        f.write('{"version": 1, "step": 2, "arrays": {"w1": {"sha')
    assert cp.load_checkpoint(d).step == 1
    with open(os.path.join(good, cp.MANIFEST_NAME), "w") as f:
        f.write("")
    assert cp.load_checkpoint(d) is None


@pytest.mark.parametrize("damage", ["hash", "truncate"])
def test_damaged_shard_rejected(tmp_path, damage):
    d = str(tmp_path)
    cp.save_checkpoint(d, 1, _np_params())
    cp.save_checkpoint(d, 2, _np_params())
    newest = cp.load_checkpoint(d).path
    path = os.path.join(newest, next(n for n in sorted(os.listdir(newest)) if n.endswith(".bin")))
    if damage == "hash":
        with open(path, "r+b") as f:
            f.write(b"\xff\xff\xff\xff")
    else:
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
    assert cp.load_checkpoint(d).step == 1
    assert jcp.load_checkpoint(d).step == 1  # the reference agrees


def test_stale_latest_pointer_falls_back_to_scan(tmp_path):
    d = str(tmp_path)
    cp.save_checkpoint(d, 3, _np_params())
    with open(os.path.join(d, cp.LATEST_NAME), "w") as f:
        f.write("step-99999999")
    assert cp.load_checkpoint(d).step == 3


def test_fault_before_manifest_never_publishes(tmp_path):
    d = str(tmp_path)
    cp.save_checkpoint(d, 1, _np_params())

    def boom():
        raise RuntimeError("killed mid-snapshot")

    with pytest.raises(RuntimeError):
        cp.save_checkpoint(d, 2, _np_params(), fault=boom)
    assert cp.load_checkpoint(d).step == 1
    cp.save_checkpoint(d, 3, _np_params())
    assert not any(".tmp-" in n for n in os.listdir(d))


def test_gc_keeps_newest(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        cp.save_checkpoint(d, step, _np_params(), keep=2)
    assert cp._snapshot_dirs(d) == ["step-00000004", "step-00000003"]


def test_concurrent_snapshot_requests_coalesce(tmp_path):
    """While one snapshot is in flight, a second request returns the
    previous path; a final request waits and then writes its own."""
    d = str(tmp_path)
    writer = cp.Checkpointer(d)
    arrays = _np_params()
    started, release = threading.Event(), threading.Event()
    results = {}

    def slow_fault():
        started.set()
        release.wait(timeout=10)

    def a():
        with writer._lock:
            writer._saving = True
        try:
            results["a"] = cp.save_checkpoint(d, 5, arrays, fault=slow_fault)
            with writer._lock:
                writer._last_step, writer._last_path = 5, results["a"]
        finally:
            with writer._lock:
                writer._saving = False

    ta = threading.Thread(target=a)
    ta.start()
    started.wait(timeout=10)
    assert writer.save(5, arrays) is None
    final_done = threading.Event()

    def final():
        results["final"] = writer.save(6, arrays, final=True)
        final_done.set()

    tf = threading.Thread(target=final)
    tf.start()
    assert not final_done.wait(timeout=0.2)  # blocked behind a
    release.set()
    ta.join(timeout=10)
    tf.join(timeout=10)
    assert results["final"].endswith("step-00000006")
    assert writer.save(5, arrays) == results["a"]
    assert sorted(cp._snapshot_dirs(d)) == ["step-00000005", "step-00000006"]


def test_migration_signal_channels(tmp_path):
    import pickle

    sig = tmp_path / "annotations"
    s = cp.MigrationSignal(str(sig), install_sigterm=False)
    assert s.requested() is False
    for text, want in (('other.io/key="x"\n', False),
                       (f'{tconsts.MIGRATE_ANNOTATION}="requested"\n', True),
                       (f"{tconsts.MIGRATE_ANNOTATION}=requested\n", True),
                       (f'{tconsts.MIGRATE_ANNOTATION}="denied"\n', False)):
        sig.write_text(text)
        assert s.requested() is want
        assert jcp.MigrationSignal._parse(text) is want
    mirror = str(tmp_path / "sigterm")
    s2 = cp.MigrationSignal("", install_sigterm=False, mirror_file=mirror)
    copy = pickle.loads(pickle.dumps(s2))  # a rank's copy: file channels only
    assert not s2.requested() and not copy.requested()
    s2._on_sigterm(15, None)
    assert s2.requested() and copy.requested()  # the copy reads the mirror


def test_env_fault_parses_slow(monkeypatch):
    monkeypatch.setenv(cp.FAULT_ENV, "slow:0.01")
    fault = cp._env_fault()
    assert fault is not None
    fault()
    monkeypatch.delenv(cp.FAULT_ENV)
    assert cp._env_fault() is None


def _jax_run(d, topology, steps, ckpt_every):
    return jcp.run_migratable_training(
        d, topology, steps=steps, ckpt_every=ckpt_every,
        signal_source=jcp.MigrationSignal("", install_sigterm=False))


def _weights(load, d):
    """(step, {name: float64 weights}) of the newest snapshot in ``d``."""
    ck = load(d)
    return ck.step, {k: (ck.arrays[k].double().numpy() if isinstance(ck.arrays[k], torch.Tensor)
                         else np.asarray(ck.arrays[k]).astype(np.float64))
                     for k in ("w1", "w2")}


def _bf16(a):
    return torch.from_numpy(a).bfloat16().double().numpy()


def _loss(w, global_batch):
    """The reference's loss in float64, with its bf16 roundings of the
    hidden activations and of y."""
    x = _bf16(np.random.default_rng(7).standard_normal((global_batch, 32), dtype=np.float32)
              .astype(np.float64))
    h = np.maximum(_bf16(x @ w["w1"]), 0)
    y = _bf16(h @ w["w2"])
    return float(np.mean(y * y))


@pytest.mark.parametrize("topology, ranks", [("1x1", 1), ("2x2", 4)])
def test_migratable_training_matches_jax(tmp_path, topology, ranks):
    """Six steps with a snapshot at step 5, on 1 gloo rank against JAX on 1
    CPU device and on 4 gloo ranks (2 x 2) against JAX on 4: the same
    losses, and the same bf16 weights at step 5 (tolerance: module doc)."""
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    os.makedirs(dt)
    os.makedirs(dj)
    mine = cp.run_migratable_training(dt, topology, steps=6, ckpt_every=5, device="cpu",
                                      devices=ranks,
                                      signal_source=cp.MigrationSignal("", install_sigterm=False))
    ref = _jax_run(dj, topology, 6, 5)
    for key in ("ok", "steps_done", "step", "resumed_from_step", "checkpointed_step",
                "migrated_out", "mesh", "topology", "losses_finite"):
        assert mine[key] == ref[key], key
    assert mine["backend"] == "cpu" and len(mine["losses"]) == 6
    (ts, tw), (js, jw) = _weights(cp.load_checkpoint, dt), _weights(jcp.load_checkpoint, dj)
    assert ts == js == 5
    for k in tw:
        err = np.abs(tw[k] - jw[k]).max()
        print(f"{topology}: {k} at step 5, max |port - jax| = {err!r}")
        assert err <= WEIGHT_STEPS * np.abs(jw[k]).max(), k
    batch = 8 * mine["mesh"][0]
    init = {k: v.double().numpy() for k, v in cp._init_params(32, 64).items()}
    for step, w in ((0, init), (5, jw)):  # the loss each step starts from
        want = _loss(w, batch)
        assert abs(mine["losses"][step] - want) <= LOSS_RTOL * want, step
    assert all(b < a for a, b in zip(mine["losses"], mine["losses"][1:]))


def test_jax_snapshot_resumes_in_the_port_on_another_mesh(tmp_path):
    """JAX trains on (2, 2) and snapshots at step 4; the port resumes it on
    1 rank and on 4 ranks (1 x 4), landing on step 4 and training on, with
    the same weights after the resume as JAX's own resume on (1, 4)."""
    d = str(tmp_path / "j")
    os.makedirs(d)
    _jax_run(d, "2x2", 5, 4)
    events = []
    r1 = cp.run_migratable_training(d, "1x1", steps=6, ckpt_every=0, device="cpu", devices=1,
                                    signal_source=cp.MigrationSignal("", install_sigterm=False),
                                    progress=events.append)
    assert r1["resumed_from_step"] == 4 and r1["step"] == 6 and r1["mesh"] == [1, 1]
    restored = next(e for e in events if e["event"] == "restored")
    assert restored["from_mesh"] == [2, 2]
    dt = str(tmp_path / "t")
    os.makedirs(dt)
    cp.run_migratable_training(dt, "2x2", steps=5, ckpt_every=4, device="cpu", devices=4,
                               signal_source=cp.MigrationSignal("", install_sigterm=False))
    r4 = jcp.run_migratable_training(dt, "1x4", steps=6, ckpt_every=5,
                                     signal_source=jcp.MigrationSignal("",
                                                                       install_sigterm=False))
    assert r4["resumed_from_step"] == 4 and r4["mesh"] == [1, 4] and r4["step"] == 6


def test_training_degrades_topology_to_available_devices(tmp_path):
    r = cp.run_migratable_training(str(tmp_path), "4x4", steps=3, ckpt_every=0, device="cpu",
                                   devices=2,
                                   signal_source=cp.MigrationSignal("", install_sigterm=False))
    assert r["ok"] and r["mesh"] == [1, 2] and r["step"] == 3


def test_migratable_training_checkpoints_on_signal(tmp_path):
    d = str(tmp_path)
    sig_file = tmp_path / "sig"
    sig = cp.MigrationSignal(str(sig_file), install_sigterm=False)
    fired = {}

    def progress(e):
        if e.get("event") == "progress" and "at" not in fired:
            fired["at"] = e["step"]
            sig_file.write_text(f'{tconsts.MIGRATE_ANNOTATION}="requested"\n')

    r = cp.run_migratable_training(d, "1x1", steps=1000, ckpt_every=2, signal_source=sig,
                                   progress=progress, device="cpu")
    assert r["migrated_out"] is True and r["checkpointed_step"] == r["step"] == fired["at"]
    ck = jcp.load_checkpoint(d)  # the reference reads the port's snapshot
    assert ck.step == r["checkpointed_step"]
    assert json.load(open(os.path.join(ck.path, cp.MANIFEST_NAME)))["mesh"] == [1, 1]
    resumed = cp.run_migratable_training(d, "1x1", steps=r["step"] + 2, ckpt_every=0,
                                         device="cpu",
                                         signal_source=cp.MigrationSignal("",
                                                                          install_sigterm=False))
    assert resumed["resumed_from_step"] == r["step"] and resumed["steps_done"] == 2
