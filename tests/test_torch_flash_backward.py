"""Parity of the port's ring-remat training path with the JAX reference on
the CPU: kernel B4's plain version (``kernels/flash_backward.py``) against
the reference's Pallas kernel, kernel B3's f32 entry, and the gradients of
``ring_attention_remat`` on one rank and on four.

Inputs are made with numpy from a seed and handed to both sides (bf16 values
rounded once).  The Pallas kernels run in interpret mode, as the reference's
own tests run them here.  The four-rank case runs four gloo ranks against a
four-device JAX mesh.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

torch = pytest.importorskip("torch")

from tpu_operator.workloads import ring_attention as jra  # noqa: E402
from tpu_operator_torch.kernels import _build  # noqa: E402
from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402
from tpu_operator_torch.kernels import flash_backward as fb  # noqa: E402
from tpu_operator_torch.workloads import _ranks  # noqa: E402
from tpu_operator_torch.workloads import ring_attention as tra  # noqa: E402

# B4 against Pallas, per output: max |mine - ref| over max |ref| of this
# hop's contribution.  f32: the same f32 formula, summed in another order.
# bf16: P and dS are rounded to bf16 from f32 values that differ in their
# last bits, so an element can land one bf16 step (2^-8 relative) apart.
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = 1e-4  # remat gradients, f32 end to end


def _inputs(rng, dtype, q_off=0, k_off=0, causal=False, bh=2, tq=32, tk=24, d=8):
    """q, k, v, dO in ``dtype`` (as f32 numpy holding the rounded values),
    lse above each row's log-sum-exp over the keys it sees here (so P <=
    1), NEG_INF for a row that sees none (as the forward leaves a row that
    saw no key anywhere), dsum, and non-zero incoming accumulators: the
    travelling ring sums of earlier hops."""
    def draw(*shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()

    q, k, v, do = draw(bh, tq, d), draw(bh, tk, d), draw(bh, tk, d), draw(bh, tq, d)
    s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(d)
    seen = np.ones((tq, tk), bool)
    if causal:
        seen = (q_off + np.arange(tq))[:, None] >= (k_off + np.arange(tk))[None, :]
    mass = np.where(seen, np.exp(s), 0.0).sum(-1)
    lse = np.where(mass > 0, np.log(np.maximum(mass, 1e-30)) + 0.4, jra.NEG_INF)
    lse = lse.astype(np.float32)
    dsum = (0.5 * rng.standard_normal((bh, tq))).astype(np.float32)
    acc = [rng.standard_normal(shape, dtype=np.float32)
           for shape in ((bh, tq, d), (bh, tk, d), (bh, tk, d))]
    return [q, k, v, do], lse, dsum, acc


MASKS = {  # (q_off, k_off, causal) for Tq 32, Tk 24
    "causal-partial": (40, 30, True),
    "causal-rows-with-no-key": (0, 16, True),  # rows 0-15: lse NEG_INF, the guard
    "full": (40, 30, False),
    "causal-fully-masked": (40, 40 + 32 + 8, True),
}


@pytest.mark.parametrize("tiled", [False, True], ids=["one-q-tile", "q-tiled"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_backward_plain_matches_pallas(monkeypatch, dtype, mask, tiled):
    """One hop's backward on top of non-zero accumulators: the port's plain
    B4 (what the wrapper runs on the CPU, in place) against the reference's
    Pallas kernel.  ``q-tiled`` forces 8-row q tiles on both sides, the
    path real training shapes take.  A fully masked hop leaves the
    accumulators exactly as they were."""
    if tiled:
        monkeypatch.setattr(jra, "_q_tile", lambda tq, tk, **kw: 8)
        monkeypatch.setattr(fb, "_q_tile", lambda tq, tk, **kw: 8)
    q_off, k_off, causal = MASKS[mask]
    qkvdo, lse, dsum, acc = _inputs(np.random.default_rng(0), dtype, q_off, k_off, causal)
    ref = jra.flash_block_backward(*(jnp.asarray(x, dtype) for x in qkvdo), jnp.asarray(lse),
                                   jnp.asarray(dsum), *map(jnp.asarray, acc), q_off, k_off,
                                   causal)
    ref = [np.asarray(x) for x in ref]
    tqkvdo = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in qkvdo]
    tacc = [torch.from_numpy(a.copy()) for a in acc]
    before = _build.launches()
    mine = fb.flash_block_backward(*tqkvdo, torch.from_numpy(lse), torch.from_numpy(dsum), *tacc,
                                   q_off, k_off, causal)
    assert _build.launches() == before  # the CPU takes the plain version
    assert all(a is b for a, b in zip(mine, tacc))  # updated in place
    for name, m, r, a in zip(("dq", "dk", "dv"), mine, ref, acc):
        if mask == "causal-fully-masked":
            np.testing.assert_array_equal(m.numpy(), a)
            np.testing.assert_array_equal(r, a)
            continue
        contribution = r - a
        err = np.abs((m.numpy() - a) - contribution).max() / np.abs(contribution).max()
        assert err <= BWD_TOL[dtype], (name, err)


def test_block_backward_wrapper_rejects_what_the_kernel_does_not_take():
    qkvdo, lse, dsum, acc = _inputs(np.random.default_rng(1), "float32")
    q, k, v, do = (torch.from_numpy(x) for x in qkvdo)
    lse, dsum = torch.from_numpy(lse), torch.from_numpy(dsum)
    dq, dk, dv = (torch.from_numpy(a) for a in acc)
    with pytest.raises(TypeError):  # mixed storage
        fb.flash_block_backward(q, k, v, do.bfloat16(), lse, dsum, dq, dk, dv, 0, 0, True)
    with pytest.raises(TypeError):
        fb.flash_block_backward(q.half(), k.half(), v.half(), do.half(), lse, dsum, dq, dk, dv,
                                0, 0, True)
    with pytest.raises(ValueError):  # accumulators must be f32
        fb.flash_block_backward(q, k, v, do, lse, dsum, dq.double(), dk, dv, 0, 0, True)
    with pytest.raises(ValueError):  # dk is [BH, Tk, D]
        fb.flash_block_backward(q, k, v, do, lse, dsum, dq, dq.clone(), dv, 0, 0, True)
    with pytest.raises(ValueError):
        fb.flash_block_backward(q, k, v, do, lse[:, :8], dsum, dq, dk, dv, 0, 0, True)


_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tpu_operator_torch", "csrc", "flash_backward.cu")


@pytest.mark.parametrize("kernel", ["dkdv_kernel", "dq_kernel"])
def test_b4_kernels_keep_the_names_the_benchmark_reads(kernel):
    """The benchmark finds B4 f32 in a device trace by its two kernels'
    demangled names (``benchmark/readings.py``): each is a ``__global__``
    template whose first argument is the storage type, which only float
    takes (a ``static_assert``), launched as ``<float, DP>``, so that its
    instances read ``dkdv_kernel<float, 128>``.  The bf16 kernels, in
    ``flash_attention.cu``, carry names the readers do not match."""
    readings = pytest.importorskip("benchmark.readings")
    code = _source_code()
    declared = re.search(r"template <typename T, int DP>\s*__global__ void\s+"
                         r"__launch_bounds__\(kConsumers \+ 128, 1\)\s+" + kernel
                         + r"\([^)]*\)\s*\{\s*static_assert\(std::is_same<T, float>::value",
                         code)
    assert declared, f"no __global__ template {kernel}<T, DP> for float alone in {_SOURCE}"
    assert re.search(r"\b" + kernel + r"<float, DP><<<", code), \
        f"{kernel} is not launched as <float, DP>"
    pattern = next(p for p in readings.B4_F32 if kernel in p)
    for dp in (64, 128):
        name = f"void (anonymous namespace)::{kernel}<float, {dp}>(Maps, BwdParams)"
        assert re.search(pattern, name)
        assert not re.search(pattern, name.replace("float", "__nv_bfloat16"))
        bf16 = kernel.replace("_kernel", "_mma_kernel")
        assert not re.search(pattern, f"void (anonymous namespace)::{bf16}<{dp}>(BwdParams)")
    others = [p for p in readings.B4_F32 if kernel not in p]
    assert others and not any(re.search(p, f"{kernel}<float, 128>") for p in others)


def _source_code() -> str:
    """flash_backward.cu without its comments."""
    with open(_SOURCE) as f:
        source = f.read()
    return re.sub(r"//[^\n]*", "", source)


@pytest.mark.parametrize("kernel, band", [("fold_f32_kernel", False), ("fold_band_kernel", True)])
def test_b3_kernels_keep_the_names_the_benchmark_reads(kernel, band):
    """The benchmark finds B3 f32 in a device trace by the fold's kernel
    names: ``benchmark/readings.B3_F32`` the causal one alone,
    ``readings_lm.B3_F32`` both.  Each is a ``__global__`` template on DP,
    launched once a hop."""
    readings = pytest.importorskip("benchmark.readings")
    readings_lm = pytest.importorskip("benchmark.readings_lm")
    code = _source_code()
    assert re.search(r"template <int DP>\s*__global__ void\s+__launch_bounds__\([^)]*\)\s+"
                     + kernel + r"\(", code), f"no __global__ template {kernel}<DP>"
    assert len(re.findall(r"\b" + kernel + r"<DP><<<", code)) == 1
    for dp in (64, 128):
        name = f"void (anonymous namespace)::{kernel}<{dp}>(Maps, FoldParams)"
        assert re.search(readings_lm.B3_F32, name)
        assert bool(re.search(readings.B3_F32, name)) is not band


def test_the_fold_runs_on_wgmma_fed_by_tma():
    """B3 f32's body, from the fold's section to the launches, issues its
    products on ``wgmma`` (S = Q K^T through ``rows_issue``, o += e V through
    ``pv_issue``) from tiles TMA lands, and the whole source holds the f32
    training kernels alone: no ``mma.sync``, no ``cp.async`` and no bf16."""
    code = _source_code()
    start = code.index("struct Fold {")
    body = code[start:code.index("int set_smem(", start)]
    assert "rows_issue<DP>(" in body and "pv_issue<DP>(" in body
    assert "wgmma_n128(" in body and "wgmma_n64(" in body and "wgmma_commit()" in body
    assert "load_tile<DP, kWalkRows>(" in body and "setmaxnreg" in body
    assert not re.search(r"mma\.sync|m16n8k|cp\.async|cp_async|mma_all|rows_dot|acc_dot|bfloat16|"
                         r"if constexpr \(sizeof", code)
    with open(_SOURCE) as f:  # nor in its comments
        assert not re.search(r"mma\.sync|cp\.async|__nv_bfloat16", f.read())


def _fold_state(rng, bh, t, d):
    """A carried (m, l, o) state in f32: one earlier, fully visible block
    folded in by the reference."""
    q, k, v = (jnp.asarray(rng.standard_normal((bh, t, d), dtype=np.float32)) for _ in range(3))
    m0 = jnp.full((bh, t), jra.NEG_INF, jnp.float32)
    l0, o0 = jnp.zeros((bh, t), jnp.float32), jnp.zeros((bh, t, d), jnp.float32)
    return jra.flash_block_update(q, k, v, 64, 0, m0, l0, o0, True)


@pytest.mark.parametrize(
    "q_off, k_off, causal",
    [(64, 48, True), (64, 64, True), (64, 200, False), (64, 64 + 32 + 8, True)],
    ids=["causal-offsets", "diagonal", "non-causal", "fully-masked"],
)
def test_f32_block_update_matches_pallas(q_off, k_off, causal):
    """Kernel B3 on f32 q/k/v, the transformer step's: the port's plain
    version (the wrapper on the CPU, in place) against the reference's
    Pallas kernel on the same f32 inputs.  No bf16 rounding on either side,
    so 1e-5 covers summation order; a fully masked block changes nothing."""
    bh, t, d = 4, 32, 8
    rng = np.random.default_rng(2)
    m, l, o = _fold_state(rng, bh, t, d)
    q, k, v = (rng.standard_normal((bh, t, d), dtype=np.float32) for _ in range(3))
    ref = jra.flash_block_update(*map(jnp.asarray, (q, k, v)), q_off, k_off, m, l, o, causal)
    state = tuple(torch.from_numpy(np.array(x)) for x in (m, l, o))
    before = _build.launches()
    mine = fa.flash_block_update(*map(torch.from_numpy, (q, k, v)), q_off, k_off, *state, causal)
    assert _build.launches() == before
    assert all(a is b for a, b in zip(mine, state))
    for a, b in zip(mine, ref):
        if causal and k_off > q_off + t:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_block_update_rejects_other_dtypes():
    q = torch.ones(1, 8, 8, dtype=torch.float16)
    m, l, o = torch.zeros(1, 8), torch.zeros(1, 8), torch.zeros(1, 8, 8)
    with pytest.raises(TypeError):
        fa.flash_block_update(q, q, q, 0, 0, m, l, o, True)
    with pytest.raises(TypeError):  # mixed storage
        fa.flash_block_update(q.float(), q.bfloat16(), q.bfloat16(), 0, 0, m, l, o, True)


# ---------------------------------------------------------------------------
# ring_attention_remat: gradients of sum(out * cot)

SHAPE = (2, 64, 2, 8)  # [B, T, H, D]: 16 tokens per rank on four


def _qkv_cot():
    rng = np.random.default_rng(3)
    return tuple(rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(4))


@functools.lru_cache(maxsize=None)
def _jax_grads(n: int, use_pallas: bool, causal: bool):
    """The reference's remat gradients under shard_map on ``n`` devices."""
    q, k, v, cot = _qkv_cot()
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))

    def loss(q, k, v):
        def inner(q, k, v, cot):
            out = jra.ring_attention_remat(q, k, v, "x", causal, ("x",), use_pallas)
            return jax.lax.psum(jnp.sum(out * cot), "x")

        return jax.shard_map(inner, mesh=mesh, in_specs=(P(None, "x"),) * 4, out_specs=P(),
                             check_vma=not use_pallas)(q, k, v, jnp.asarray(cot))

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in grads]


def _port_grads(use_kernel: bool, causal: bool, rows=slice(None), group=None):
    q, k, v, cot = (torch.from_numpy(x[:, rows].copy()) for x in _qkv_cot())
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = tra.ring_attention_remat(q, k, v, causal, use_kernel, group)
    return torch.autograd.grad((out * cot).sum(), (q, k, v))


CASES = [(use_kernel, causal) for use_kernel in (False, True) for causal in (True, False)]
CASE_IDS = [f"{'kernel' if uk else 'plain'}-{'causal' if c else 'full'}" for uk, c in CASES]


@pytest.mark.parametrize("use_kernel, causal", CASES, ids=CASE_IDS)
def test_remat_gradients_one_rank_match_jax(use_kernel, causal):
    """One rank against a one-device mesh: the plain path against the
    reference's jnp backward, the kernel path (plain B3 and B4 here)
    against its Pallas path."""
    ref = _jax_grads(1, use_kernel, causal)
    mine = _port_grads(use_kernel, causal)
    errs = [float(np.abs(a.numpy() - b).max()) for a, b in zip(mine, ref)]
    print(f"1 rank: dq, dk, dv max abs {errs}")  # shown by ``pytest -rP``
    assert max(errs) < GRAD_TOL, errs


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("causal", [True, False])
def test_remat_backward_matches_autograd_through_the_forward(use_kernel, causal):
    """The second ring pass against torch autograd through the plain
    forward (one rank: no rotation to differentiate), the counterpart of
    the reference's ``test_ring_attention_remat_backward_matches_ad``."""
    q, k, v, cot = (torch.from_numpy(x) for x in _qkv_cot())
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out, _ = tra._plain_ring_forward(q, k, v, causal)
    ref = torch.autograd.grad((out * cot).sum(), (q, k, v))
    for name, a, b in zip("qkv", _port_grads(use_kernel, causal), ref):
        err = float((a - b).abs().max())
        assert err < GRAD_TOL, (name, err)


def _remat_grads_rank(rank, n, device, out_path):
    """One rank of the four-rank case: every (path, causal) case's gradients
    of this rank's rows, gathered on rank 0 and saved."""
    import torch.distributed as dist

    block = SHAPE[1] // n
    rows = slice(rank * block, (rank + 1) * block)
    grads = {}
    for use_kernel, causal in CASES:
        for name, g in zip("qkv", _port_grads(use_kernel, causal, rows)):
            parts = [torch.empty_like(g) for _ in range(n)]
            dist.all_gather(parts, g.contiguous())
            grads[f"{use_kernel}-{causal}-{name}"] = torch.cat(parts, dim=1).numpy()
    if rank == 0:
        np.savez(out_path, **grads)
    return {}


def test_remat_gradients_four_ranks_match_jax(tmp_path):
    """Four gloo ranks against a four-device mesh, in every case: K/V
    rotated p - 1 times, dK/dV carried home by the p-th rotation.  A dK/dV
    homing off by one hop passes on one rank and fails here."""
    path = str(tmp_path / "grads.npz")
    _ranks.run(_remat_grads_rank, 4, "cpu", out_path=path)
    mine = np.load(path)
    for use_kernel, causal in CASES:
        ref = _jax_grads(4, use_kernel, causal)
        errs = [float(np.abs(mine[f"{use_kernel}-{causal}-{name}"] - b).max())
                for name, b in zip("qkv", ref)]
        print(f"4 ranks, kernel path {use_kernel}, causal {causal}: dq, dk, dv max abs {errs}")
        assert max(errs) < GRAD_TOL, (use_kernel, causal, errs)

