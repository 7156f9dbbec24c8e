"""Parity of the port's pipelined transformer (``collectives.make_mesh3``,
``transformer_pipeline_params_from_jax``, ``transformer_pipeline_step`` and
``transformer_pipeline_burn_in``, the ``transformer-pp`` check) with the JAX
reference on the CPU.

The reference's own weights and microbatches are carried across as full
host f32 arrays.  Its step runs in a subprocess with XLA's excess precision
off (``--xla_allow_excess_precision=false``): a stage's input gradient goes
through the bf16 casts of the layer's input, and with the flag on (XLA's
default) the CPU compiler keeps some of the cotangents those casts round in
f32, so that the first stage's updates move by 1e-3 to 4e-3 of the largest
update with the flag alone.  With it off the reference rounds where its
program says it does, which is what the port does.  Gloo ranks stand for the
reference's virtual CPU devices: 4 for (2, 1, 2), 8 for (2, 2, 2).
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402
from tpu_operator_torch.kernels import flash_backward as fb  # noqa: E402
from tpu_operator_torch.workloads import _ranks  # noqa: E402
from tpu_operator_torch.workloads import collectives as tc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_MODEL, D_HIDDEN, HEADS = 64, 128, 4
X_SHAPE = (4, 2, 32, D_MODEL)  # M microbatches of 2 sequences, 16 tokens per mp rank
MESHES = {1: (1, 1, 1), 4: (2, 1, 2), 8: (2, 2, 2)}
LOSS_RTOL = 2e-3    # as test_torch_train.py
WEIGHT_ATOL = 2e-2  # updated weights, max abs
UPDATE_RTOL = 1e-3  # the update itself, max |mine - ref| over max |ref|
F32_RTOL = 1e-4     # kernels vs plain on the card, of max |plain|

# one reference step per mesh, in a fresh interpreter with the flags above
_JAX_STEPS = """
import functools, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from tpu_operator.workloads import collectives as jc
out, shape = sys.argv[1], json.loads(sys.argv[2])
for n in shape["meshes"]:
    mesh = jc.make_mesh3(n_devices=n)
    params = jc.transformer_pipeline_params(mesh, d_model=shape["d"], d_hidden=shape["h"])
    x = jax.device_put(jax.random.normal(jax.random.PRNGKey(3), tuple(shape["x"]), jnp.float32),
                       NamedSharding(mesh, P(None, "dp", "mp", None)))
    step = jax.jit(functools.partial(jc.transformer_pipeline_step, mesh, shape["heads"]))
    loss, new = step(params, x)
    arrays = {"x": np.asarray(x), "loss": np.float32(loss)}
    arrays.update({"w_" + k: np.asarray(v, np.float32) for k, v in params.items()})
    arrays.update({"new_" + k: np.asarray(v, np.float32) for k, v in new.items()})
    np.savez(f"{out}/jax-{n}.npz", **arrays)
"""


@pytest.fixture(scope="module")
def jc():
    """The reference's collectives, imported here so that the card test
    below also runs where JAX is not installed."""
    from tpu_operator.workloads import collectives

    return collectives


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("transformer-pp"))


@pytest.fixture(scope="module")
def jax_steps(tmp):
    """{n: (weights, x, loss, new weights)} of the reference's step on the
    n-device mesh, full host arrays."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false")
    shape = {"meshes": list(MESHES), "d": D_MODEL, "h": D_HIDDEN, "heads": HEADS,
             "x": list(X_SHAPE)}
    proc = subprocess.run([sys.executable, "-c", _JAX_STEPS, tmp, json.dumps(shape)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    steps = {}
    for n in MESHES:
        z = np.load(f"{tmp}/jax-{n}.npz")
        steps[n] = ({k: z["w_" + k] for k in tc.TRANSFORMER_WEIGHTS}, z["x"], float(z["loss"]),
                    {k: z["new_" + k] for k in tc.TRANSFORMER_WEIGHTS})
    return steps


@pytest.fixture(scope="module")
def port_step(jax_steps, tmp):
    """``(result, updated weights)`` of one port step on ``n`` gloo ranks
    (a ``shape`` mesh when given), on the weights and microbatches of the
    reference's ``weights_of``-device run (default ``n``); cached."""

    @functools.lru_cache(maxsize=None)
    def run(n: int, use_kernel: bool, weights_of: int = 0, shape=None):
        weights, x, _, _ = jax_steps[weights_of or n]
        path = f"{tmp}/new-{n}-{use_kernel}-{shape}.npz"
        r = tc.transformer_pipeline_run(weights, x, HEADS, steps=1, world_size=n,
                                        use_kernel=use_kernel, device="cpu", shape=shape,
                                        out_path=path)
        return r, dict(np.load(path))

    return run


def _update_err(new, ref, old) -> float:
    upd, ref_upd = new - old, ref - old
    return float(np.abs(upd - ref_upd).max() / np.abs(ref_upd).max())


def _mesh_rank(rank: int, n: int, device) -> dict:
    import torch.distributed as dist

    mesh = tc.make_mesh3(n, rank, device)
    mine = {"shape": mesh.shape, "coords": list(mesh.coords), "groups": {
        name: dist.get_process_group_ranks(getattr(mesh, name))
        for name in ("pp_group", "dp_group", "mp_group", "stage_group")}}
    every = [None] * n
    dist.all_gather_object(every, mine)
    return {"ranks": every}


@pytest.mark.parametrize("n", [1, 2, 8])
def test_make_mesh3_matches_reference(jc, n):
    """The shape on n ranks is the reference's ``make_mesh3(n_devices=n)``
    shape, each rank sits at its row-major coordinates, and each group
    holds the ranks that share the other coordinates."""
    ref = dict(jc.make_mesh3(n_devices=n).shape)
    assert dict(zip(("pp", "dp", "mp"), tc._split_pp(n))) == ref
    if n == 1:
        mesh = tc.make_mesh3(1, 0, "cpu")
        assert mesh.shape == ref and mesh.size == 1 and mesh.coords == (0, 0, 0)
        return
    ranks = _ranks.run(_mesh_rank, n, "cpu", timeout_s=120)["ranks"]
    pp, dp, mp = ref["pp"], ref["dp"], ref["mp"]
    for rank, r in enumerate(ranks):
        s, i, j = r["coords"]
        assert r["shape"] == ref and rank == (s * dp + i) * mp + j
        assert r["groups"] == {
            "pp_group": [(t * dp + i) * mp + j for t in range(pp)],
            "dp_group": [(s * dp + t) * mp + j for t in range(dp)],
            "mp_group": [(s * dp + i) * mp + t for t in range(mp)],
            "stage_group": list(range(s * dp * mp, (s + 1) * dp * mp)),
        }


def test_mesh3_coords_follow_the_reference_layout(jc):
    """Rank r sits where the reference's ``devices.reshape(pp, dp, mp)``
    puts device r."""
    import jax

    ids = np.vectorize(lambda d: d.id)(jc.make_mesh3(n_devices=8).devices)
    for rank in range(8):
        mesh = tc.Mesh(dp=2, mp=2, rank=rank, device=torch.device("cpu"), pp=2)
        assert ids[mesh.coords] == jax.devices()[rank].id
    flat = tc.Mesh(dp=2, mp=2, rank=3, device=torch.device("cpu"))
    assert flat.coords == (1, 1) and flat.shape == {"dp": 2, "mp": 2}


def test_params_from_jax_shard_like_the_reference(jc):
    """Rank r of the (2, 2, 2) mesh holds the reference's shard on device r."""
    jmesh = jc.make_mesh3(n_devices=8)
    params = jc.transformer_pipeline_params(jmesh, d_model=D_MODEL, d_hidden=D_HIDDEN)
    full = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for rank, dev in enumerate(jmesh.devices.flat):
        mesh = tc.Mesh(dp=2, mp=2, rank=rank, device=torch.device("cpu"), pp=2)
        mine = tc.transformer_pipeline_params_from_jax(full, mesh)
        for key in tc.TRANSFORMER_WEIGHTS:
            (shard,) = [s for s in params[key].addressable_shards if s.device == dev]
            np.testing.assert_array_equal(mine[key].numpy(), np.asarray(shard.data)[0])


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("n", list(MESHES))
def test_pipeline_step_matches_jax(jax_steps, port_step, n, use_kernel):
    """Loss and every stage's updated weights after one step, against the
    reference's step on its n-device mesh.  The kernel path runs B3 and
    B4's plain versions here."""
    weights, _, ref_loss, ref_new = jax_steps[n]
    r, new = port_step(n, use_kernel)
    assert r["ok"] and r["devices"] == n
    assert r["mesh"] == dict(zip(("pp", "dp", "mp"), MESHES[n]))
    assert r.get("pp_degenerate", False) == (MESHES[n][0] == 1)
    assert r["attention_kernel"] == ("plain-flash-fwd-bwd" if use_kernel else "plain")
    assert r["losses"][0] == pytest.approx(ref_loss, rel=LOSS_RTOL)
    weight_err = {k: float(np.abs(new[k] - ref_new[k]).max()) for k in tc.TRANSFORMER_WEIGHTS}
    update_err = {k: _update_err(new[k], ref_new[k], weights[k]) for k in tc.TRANSFORMER_WEIGHTS}
    # the measured differences (shown by ``pytest -rP``)
    print(f"{MESHES[n]}, {r['attention_kernel']}: loss rel "
          f"{abs(r['losses'][0] - ref_loss) / ref_loss:.3g}, weights max abs "
          f"{max(weight_err.values()):.3g}, updates max rel {max(update_err.values()):.3g}")
    for k in tc.TRANSFORMER_WEIGHTS:
        assert new[k].shape == ref_new[k].shape, k
        assert weight_err[k] <= WEIGHT_ATOL, k
        assert update_err[k] <= UPDATE_RTOL, k


def test_full_mesh_loss_equals_stage_only_mesh(port_step):
    """The reference's own pin, in the port: the (2, 2, 2) step computes the
    loss of the (2, 1, 1) step on the same weights and microbatches (the dp
    and mp sharding cancel to the same math), within 2e-2."""
    full, _ = port_step(8, False)
    stages, _ = port_step(2, False, 8, (2, 1, 1))
    assert stages["mesh"] == {"pp": 2, "dp": 1, "mp": 1}
    assert full["losses"][0] == pytest.approx(stages["losses"][0], rel=2e-2)


def test_burn_in_on_one_rank():
    """The check's defaults on the CPU: the degenerate (1, 1, 1) mesh, said
    so, and a loss that falls at every step."""
    r = tc.transformer_pipeline_burn_in(world_size=1, device="cpu")
    assert r["ok"] and r["pp_degenerate"] and r["mesh"] == {"pp": 1, "dp": 1, "mp": 1}
    losses = r["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert r["attention_kernel"] == "plain" and r["backend"] == "cpu"
    assert r["launches"] == {"flash_block_update_f32": 0, "flash_block_backward": 0}


def test_pipeline_weights_from_seed():
    w = tc.transformer_pipeline_weights(2, 32, 48, seed=3)
    assert list(w) == list(tc.TRANSFORMER_WEIGHTS)
    assert w["wq"].shape == (2, 32, 32) and w["w1"].shape == (2, 32, 48)
    assert w["w2"].shape == (2, 48, 32) and all(a.dtype == np.float32 for a in w.values())
    np.testing.assert_array_equal(w["w2"], tc.transformer_pipeline_weights(2, 32, 48, 3)["w2"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _scaled(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("q_off, k_off", [(0, 0), (16, 0)], ids=["diagonal", "visible"])
def test_stage_shape_kernels_match_plain(cuda, q_off, k_off):
    """B3's f32 entry and B4 at a stage's hop on the card, (BH, Tq, Tk, D)
    = (8, 16, 16, 16): b 2 x 4 heads, 16 tokens per mp rank, head dim 16;
    the diagonal hop and the one every key of which is visible."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    bh, t, d = 8, 16, 16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    q, k, v, do = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
    fresh = (torch.full((bh, t), fa.NEG_INF, device=cuda), torch.zeros((bh, t), device=cuda),
             torch.zeros((bh, t, d), device=cuda))
    m, l, o = (x.clone() for x in fresh)
    before = (fa.block_update_f32_launches, fb.backward_launches)
    fa.flash_block_update(q, k, v, q_off, k_off, m, l, o, True)
    rm, rl, ro = fa.flash_block_update_reference(q, k, v, q_off, k_off, *fresh, True)
    assert _scaled(o / l[..., None], ro / rl[..., None]) <= F32_RTOL
    assert _scaled(l, rl) <= F32_RTOL and _scaled(m, rm) <= 1e-5
    lse = rm + torch.log(rl)
    dsum = (do * (ro / rl[..., None])).sum(-1)
    acc = (randn(bh, t, d), randn(bh, t, d), randn(bh, t, d))
    mine = tuple(a.clone() for a in acc)
    fb.flash_block_backward(q, k, v, do, lse, dsum, *mine, q_off, k_off, True)
    ref = fb.flash_block_backward_reference(q, k, v, do, lse, dsum, *acc, q_off, k_off, True)
    torch.cuda.synchronize()
    assert (fa.block_update_f32_launches, fb.backward_launches) == (before[0] + 1,
                                                                    before[1] + 1)
    for got, want, a in zip(mine, ref, acc):
        assert _scaled(got - a, want - a) <= F32_RTOL
