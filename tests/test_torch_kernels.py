"""The port's CUDA kernels against their plain PyTorch versions.

The wrapper contract runs everywhere; the kernel itself needs an NVIDIA card
(marked ``cuda``, skipped without one).  On a machine with a card and no JAX:

    TPU_OPERATOR_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py -q
"""

import math
import os
import re

import pytest

torch = pytest.importorskip("torch")

from tpu_operator_torch.kernels import dma_pipeline as dp  # noqa: E402
from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402
from tpu_operator_torch.kernels import vector_add as va  # noqa: E402

OUT_RTOL = 1e-2    # flash: max|out - plain| / max|plain|; one bf16 step at the largest
# output is at most 2^-7 = 7.8e-3 of it
STATE_RTOL = 1e-5  # flash: m, l, lse in f32, sums in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tpu_operator_torch", "csrc")


def test_hopper_helpers_are_defined_once():
    """The TMA, mbarrier and wgmma helpers live in ``csrc/hopper.cuh``
    alone: no kernel source defines one of them again, and each source that
    calls one includes the header."""
    with open(os.path.join(_CSRC, "hopper.cuh")) as f:
        helpers = re.findall(r"^(?:__device__ __forceinline__ |inline )\w+ (\w+)\(", f.read(),
                             re.M)
    assert {"mbar_wait", "tma_load_3d", "desc_sw128", "wgmma_wait0", "encode_tiled"} <= set(helpers)
    users = 0
    for name in sorted(os.listdir(_CSRC)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_CSRC, name)) as f:
            source = f.read()
        for helper in helpers:
            assert not re.search(r"^[^\n(;]*\b" + helper + r"\([^;]*\)\s*\{", source, re.M), \
                f"{name} defines {helper} again"
        if any(re.search(r"\b" + helper + r"\(", source) for helper in helpers):
            assert '#include "hopper.cuh"' in source, f"{name} calls a helper without the header"
            users += 1
    assert users == 3  # flash_forward_sm90.cu, flash_backward.cu, dma_pipeline.cu


def test_cpu_tensors_take_the_plain_version():
    rng = torch.Generator().manual_seed(0)
    x = torch.randn(300, 600, generator=rng)
    y = torch.randn(300, 600, generator=rng)
    before = va.launches
    assert torch.equal(va.vector_add_kernel(x, y), x + y)
    assert va.launches == before  # no kernel launched for CPU tensors


@pytest.mark.parametrize(
    "x, y, err",
    [
        (torch.ones(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64), TypeError),
        (torch.ones(4), torch.ones(5), ValueError),
        (torch.ones(4, 4).t(), torch.ones(4, 4), ValueError),
        (torch.ones(4), torch.ones(4, dtype=torch.bfloat16), TypeError),
    ],
    ids=["f64", "shape", "non-contiguous", "mixed-dtypes"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(x, y, err):
    with pytest.raises(err):
        va.vector_add_kernel(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, offset", [((2048, 512), 0), ((1000, 509), 0),
                                           ((2048, 512), 1), ((3,), 0), ((7,), 1),
                                           ((4099,), 0), ((3, 1000), 0), ((1027,), 0)])
def test_kernel_bit_identical_to_plain(cuda, shape, offset):
    """One IEEE f32 add either way: tolerance 0, on the vector path, the
    masked tail and the unaligned scalar path; a block covers 1024 f32, so
    4099 and 3000 elements end mid-vector and mid-block."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = math.prod(shape) + offset
    x = torch.randn(n, generator=gen, device=cuda)[offset:].view(shape)
    y = torch.randn(n, generator=gen, device=cuda)[offset:].view(shape)
    before = va.launches
    out = va.vector_add_kernel(x, y)
    torch.cuda.synchronize()
    assert va.launches == before + 1
    ref = va.vector_add_reference(x, y)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("shape, offset", [((2048, 512), 0), ((1000, 509), 0),
                                           ((2048, 512), 1), ((4103,), 0), ((7,), 0)])
def test_kernel_bit_identical_to_plain_half(cuda, dtype, shape, offset):
    """bf16 and f16: widened to f32, added, rounded once to nearest-even, as
    ``x + y`` on the card; compared as int16, tolerance 0.  8 elements a
    vector, 2048 a block: 4103 ends mid-vector and mid-block."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    n = math.prod(shape) + offset
    x = torch.randn(n, generator=gen, device=cuda).to(dtype)[offset:].view(shape)
    y = torch.randn(n, generator=gen, device=cuda).to(dtype)[offset:].view(shape)
    before = va.launches
    out = va.vector_add_kernel(x, y)
    torch.cuda.synchronize()
    assert va.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out.view(torch.int16), va.vector_add_reference(x, y).view(torch.int16))


@pytest.mark.cuda
def test_cuda_tensor_of_wrong_dtype_raises(cuda):
    x = torch.ones(8, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        va.vector_add_kernel(x, x)


# ---------------------------------------------------------------------------
# flash attention (kernels B5 and B3)


def _qkv(device, bh, tq, tk, d, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((bh, t, d), generator=gen, device=device).to(torch.bfloat16)
                 for t in (tq, tk, tk))


def _fresh(bh, t, d, device):
    return (torch.full((bh, t), fa.NEG_INF, device=device), torch.zeros((bh, t), device=device),
            torch.zeros((bh, t, d), device=device))


def _rel(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def _scaled(a, b) -> float:
    """max |a - b| over max |b|: at 32k keys the outputs are about 0.02."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def test_flash_cpu_tensors_take_the_plain_version():
    q, k, v = _qkv("cpu", 2, 48, 48, 8)
    before = (fa.forward_launches, fa.block_update_launches)
    paths_before = dict(fa.forward_path_launches)
    out, lse = fa.flash_attention_local(q, k, v, True, 16, 16)
    # the decode's shape, which plans to the split on a card
    qd, kd, vd = _qkv("cpu", 2, 8, 1024, 8)
    ref_d = fa.flash_attention_local_reference(qd, kd, vd, True, 1024, 1024, 1016)
    assert all(torch.equal(a, b) for a, b in
               zip(fa.flash_attention_local(qd, kd, vd, True, q_off=1016), ref_d))
    ref_out, ref_lse = fa.flash_attention_local_reference(q, k, v, True, 16, 16)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    m, l, o = _fresh(2, 48, 8, "cpu")
    ref = fa.flash_block_update_reference(q, k, v, 0, 0, m, l, o, True)
    got = fa.flash_block_update(q, k, v, 0, 0, m, l, o, True)
    assert got[0] is m and got[2] is o  # in place
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (fa.forward_launches, fa.block_update_launches) == before
    assert fa.forward_path_launches == paths_before


@pytest.mark.parametrize(
    "args, err",
    [
        # f32 q with bf16 k/v: the forward takes q, k, v all bf16 or all f32
        ((torch.ones(1, 8, 8), torch.ones(1, 8, 8).bfloat16(), torch.ones(1, 8, 8).bfloat16()),
         TypeError),
        ((torch.ones(1, 8, 8).double(),) * 3, TypeError),
        ((torch.ones(1, 8, 8).bfloat16(), torch.ones(1, 8, 16).bfloat16(),
          torch.ones(1, 8, 16).bfloat16()), ValueError),
        ((torch.ones(8, 8).bfloat16(),) * 3, ValueError),
        ((torch.ones(1, 8, 8).bfloat16().transpose(1, 2),) * 3, ValueError),
    ],
    ids=["f32", "f64", "head-dim", "rank", "non-contiguous"],
)
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(args, err):
    with pytest.raises(err):
        fa.flash_attention_local(*args)


def test_flash_block_update_rejects_a_wrong_state():
    q, k, v = _qkv("cpu", 2, 16, 16, 8)
    m, l, o = _fresh(2, 16, 8, "cpu")
    with pytest.raises(ValueError):
        fa.flash_block_update(q, k, v, 0, 0, m.double(), l, o, True)
    with pytest.raises(ValueError):
        fa.flash_block_update(q, k, v, 0, 0, m, l, o[:, :8], True)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bh, tq, tk, d, causal, q_off",
    [(8, 4096, 4096, 128, True, 0), (8, 4096, 4096, 128, False, 0),
     (8, 8, 32768, 128, True, 32760), (4, 40, 40, 8, True, 0), (4, 136, 136, 16, True, 0),
     (4, 136, 136, 8, False, 0), (2, 200, 200, 64, True, 0)],
)
def test_flash_forward_kernel_matches_plain(cuda, bh, tq, tk, d, causal, q_off):
    q, k, v = _qkv(cuda, bh, tq, tk, d)
    before = fa.forward_launches
    out, lse = fa.flash_attention_local(q, k, v, causal, 16, 8, q_off)
    torch.cuda.synchronize()
    assert fa.forward_launches == before + 1
    ref, ref_lse = fa.flash_attention_local_reference(q, k, v, causal, 16, 8, q_off)
    assert _scaled(out, ref) <= OUT_RTOL
    assert _rel(lse, ref_lse) <= STATE_RTOL


# each forward path at its cases: label, bh, tq, tk, d, causal, q_off, k_off
FORWARD_PATH_CASES = {
    "wgmma": [
        ("prefill (8, 32768, 128) causal", 8, 32768, 32768, 128, True, 0, 0),
        ("(8, 4096, 128) causal", 8, 4096, 4096, 128, True, 0, 0),
        ("(8, 4096, 128) non-causal", 8, 4096, 4096, 128, False, 0, 0),
        ("(2, 200, 64) causal, Tq not a multiple of 128", 2, 200, 200, 64, True, 0, 0),
        ("(4, 1024, 128) q_off 64", 4, 1024, 1024, 128, True, 64, 0),
        ("(4, 1024, 128) q_off 1024, every key visible", 4, 1024, 1024, 128, True, 1024, 0),
        ("(4, 1024, 128) every row masked", 4, 1024, 1024, 128, True, 0, 1088),
    ],
    "split": [
        ("decode 8 x 32768", 8, 8, 32768, 128, True, 32760, 0),
        ("Tq 1 at the end", 8, 1, 32768, 128, True, 32767, 0),
        ("ragged Tk 32768 + 40", 8, 8, 32808, 128, True, 32800, 0),
        ("BH 1", 1, 8, 32768, 128, True, 32760, 0),
        ("non-causal", 8, 8, 32768, 128, False, 0, 0),
        ("D 16, every row masked", 4, 8, 4096, 16, True, 0, 4200),
    ],
    "mma": [
        ("serving T 40 D 8", 4, 40, 40, 8, True, 0, 0),
        ("serving T 40 D 16", 4, 40, 40, 16, True, 0, 0),
        ("serving T 136 D 8", 4, 136, 136, 8, True, 0, 0),
        ("serving T 136 D 16", 4, 136, 136, 16, True, 0, 0),
        ("serving T 136 D 16 non-causal", 4, 136, 136, 16, False, 0, 0),
    ],
}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "path, case", [(p, c) for p, cases in FORWARD_PATH_CASES.items() for c in cases],
    ids=[f"{p}: {c[0]}" for p, cases in FORWARD_PATH_CASES.items() for c in cases])
def test_each_forward_path_matches_plain(cuda, path, case):
    _, bh, tq, tk, d, causal, q_off, k_off = case
    q, k, v = _qkv(cuda, bh, tq, tk, d, seed=3)
    before = dict(fa.forward_path_launches)
    out, lse = fa._flash_forward_on(path, q, k, v, causal, q_off, k_off)
    torch.cuda.synchronize()
    assert fa.forward_path_launches[path] == before[path] + 1
    ref, ref_lse = fa.flash_attention_local_reference(q, k, v, causal, q_off=q_off, k_off=k_off)
    if not ref.float().any():  # every row masked: exactly the reference's sentinel
        assert not out.float().any() and bool((lse == fa.NEG_INF).all())
        return
    assert _scaled(out, ref) <= OUT_RTOL
    assert _rel(lse, ref_lse) <= STATE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("bh, tq, tk, d, q_off, path", [
    (8, 1024, 1024, 128, 0, "wgmma"), (8, 8, 32768, 128, 32760, "split"),
    (4, 40, 40, 8, 0, "mma"), (4, 1024, 1024, 32, 0, "mma")])
def test_forward_plan_counts_its_path(cuda, bh, tq, tk, d, q_off, path):
    q, k, v = _qkv(cuda, bh, tq, tk, d, seed=4)
    before = dict(fa.forward_path_launches)
    total = fa.forward_launches
    fa.flash_attention_local(q, k, v, True, q_off=q_off)
    torch.cuda.synchronize()
    assert fa.forward_launches == total + 1
    assert fa.forward_path_launches == {**before, path: before[path] + 1}


# kernel B5's f32 entry (the serving engine's flash attend): label, bh, tq,
# tk, d, causal, q_off, k_off
F32_FORWARD_CASES = [
    *[(f"serving length {n} D {d}", 2, 8, 16 * -(-n // 16), d, True, n - 8, 0)
      for n in (24, 40, 136) for d in (8, 16)],
    ("ragged Tq 136 x Tk 200 D 64 non-causal", 2, 136, 200, 64, False, 0, 0),
    ("Tq 40 x Tk 300 D 128 causal", 3, 40, 300, 128, True, 260, 0),
    ("BH 1", 1, 8, 48, 16, True, 40, 0),
    ("every row masked", 2, 8, 64, 16, True, 0, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_FORWARD_CASES, ids=[c[0] for c in F32_FORWARD_CASES])
def test_flash_forward_f32_kernel_matches_plain(cuda, case):
    """f32 q/k/v plan to the f32 path; the kernel is within F32_RTOL of the
    plain version, masked rows exact, and two launches bit-identical."""
    _, bh, tq, tk, d, causal, q_off, k_off = case
    q, k, v = (x.float() for x in _qkv(cuda, bh, tq, tk, d, seed=5))
    before = dict(fa.forward_path_launches)
    out, lse = fa.flash_attention_local(q, k, v, causal, 16, 8, q_off, k_off)
    again = fa.flash_attention_local(q, k, v, causal, 16, 8, q_off, k_off)
    torch.cuda.synchronize()
    assert fa.forward_path_launches == {**before, "f32": before["f32"] + 2}
    assert out.dtype == torch.float32
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = fa.flash_attention_local_reference(q, k, v, causal, 16, 8, q_off, k_off)
    if not ref.any():
        assert not out.any() and bool((lse == fa.NEG_INF).all())
        return
    assert _scaled(out, ref) <= F32_RTOL
    assert _rel(lse, ref_lse) <= STATE_RTOL


@pytest.mark.cuda
def test_forward_f32_path_rejects_what_it_does_not_take(cuda):
    q, k, v = (x.float() for x in _qkv(cuda, 2, 8, 64, 16))
    with pytest.raises(TypeError):  # bf16 on the f32 path
        fa._flash_forward_on("f32", *(x.bfloat16() for x in (q, k, v)))
    with pytest.raises(TypeError):  # f32 on a bf16 path
        fa._flash_forward_on("mma", q, k, v)
    with pytest.raises(ValueError):  # D 12
        fa._flash_forward_on("f32", *(x[..., :12].contiguous() for x in (q, k, v)))


# kernel B5's paged f32 entry (the serving engine's flash attend): label,
# lengths, heads, head dim, block tokens, pool blocks, table width
PAGED_CASES = [
    ("engine step", [24, 26, 28, 30, 32, 33, 34, 35], 2, 16, 16, 96, 8),
    ("page edges and a blind row", [0, 1, 15, 16, 17, 31, 32, 33], 2, 8, 16, 96, 8),
    ("split edges D 64", [511, 512, 513, 1025], 4, 64, 16, 256, 72),
    ("8-token pages D 128", [257, 1000], 3, 128, 8, 256, 128),
]


def _paged_inputs(device, lengths, heads, d, bt, blocks, width, seed=6):
    """q and pools of randoms; each request's pages from a seeded
    permutation of the pool, table entries past them -1 (never read)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(blocks, generator=torch.Generator().manual_seed(seed))
    tables = torch.full((len(lengths), width), -1, dtype=torch.int32)
    taken = 0
    for r, n in enumerate(lengths):
        pages = -(-n // bt)
        tables[r, :pages] = perm[taken:taken + pages].to(torch.int32)
        taken += pages
    q = torch.randn((len(lengths), heads, d), generator=gen, device=device)
    k_pool, v_pool = (torch.randn((blocks, bt, heads, d), generator=gen, device=device)
                      for _ in range(2))
    return q, k_pool, v_pool, tables.to(device), torch.tensor(lengths, dtype=torch.int32,
                                                               device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_flash_paged_kernel_matches_plain(cuda, case):
    """One launch per call on the ``paged_f32`` path; within F32_RTOL of the
    plain version (lse within STATE_RTOL), blind rows exact, two launches
    bit-identical, and each request alone the same bits as its batch row."""
    _, lengths, *shape = case
    q, k_pool, v_pool, tables, lens = _paged_inputs(cuda, lengths, *shape)
    before = dict(fa.forward_path_launches)
    out, lse = fa.flash_attention_paged(q, k_pool, v_pool, tables, lens)
    again = fa.flash_attention_paged(q, k_pool, v_pool, tables, lens)
    torch.cuda.synchronize()
    assert fa.forward_path_launches == {**before, "paged_f32": before["paged_f32"] + 2}
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    for r in range(len(lengths)):
        alone = fa.flash_attention_paged(q[r:r + 1], k_pool, v_pool, tables[r:r + 1],
                                         lens[r:r + 1])
        assert torch.equal(alone[0][0], out[r]) and torch.equal(alone[1][0], lse[r])
    ref, ref_lse = fa.flash_attention_paged_reference(q, k_pool, v_pool, tables, lens)
    blind = lens == 0
    assert not out[blind].any() and bool((lse[blind] == fa.NEG_INF).all())
    assert _scaled(out[~blind], ref[~blind]) <= F32_RTOL
    assert _rel(lse[~blind], ref_lse[~blind]) <= STATE_RTOL


@pytest.mark.cuda
def test_flash_paged_rejects_what_the_kernel_does_not_take(cuda):
    q, k_pool, v_pool, tables, lens = _paged_inputs(cuda, [20, 9], 2, 16, 16, 8, 2)
    before = dict(fa.forward_path_launches)
    with pytest.raises(ValueError):  # D 12: the kernel takes multiples of 8
        fa.flash_attention_paged(*(x[..., :12].contiguous() for x in (q, k_pool, v_pool)),
                                 tables, lens)
    with pytest.raises(ValueError):  # the tables on the CPU
        fa.flash_attention_paged(q, k_pool, v_pool, tables.cpu(), lens)
    with pytest.raises(TypeError):  # int64 lengths
        fa.flash_attention_paged(q, k_pool, v_pool, tables, lens.long())
    assert fa.forward_path_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["wgmma", "split", "mma"])
def test_forward_paths_reject_what_they_do_not_take(cuda, path):
    q, k, v = _qkv(cuda, 2, 256, 256, 64)
    base = torch.zeros(2 * 256 * 64 + 8, device=cuda, dtype=torch.bfloat16)
    unaligned = base[4:4 + 2 * 256 * 64].view(2, 256, 64)  # 8 bytes off
    before = dict(fa.forward_path_launches)
    with pytest.raises(ValueError):
        fa._flash_forward_on(path, unaligned, k, v)
    with pytest.raises(ValueError):
        fa._flash_forward_on(path, *(torch.zeros(2, 256, 12, device=cuda,
                                                 dtype=torch.bfloat16),) * 3)
    with pytest.raises(ValueError):
        fa._flash_forward_on(path, q.cpu(), k.cpu(), v.cpu())
    if path == "wgmma":
        with pytest.raises(ValueError):  # D 32: the mma kernel's
            fa._flash_forward_on(path, *(x[..., :32].contiguous() for x in (q, k, v)))
    with pytest.raises(ValueError):
        fa._flash_forward_on("tiles", q, k, v)
    assert fa.forward_path_launches == before


# the bf16 block update: label, bh, tq, tk, d, q_off, k_off, causal.  The
# ring hop's (4, 512, 128) at q_off 1024 first, then the shapes that stress
# the cut of the keys over 16-row q tiles and their warps
UPDATE_CASES = [
    ("diagonal", 4, 512, 512, 128, 1024, 1024, True),
    ("half-visible", 4, 512, 512, 128, 1024, 768, True),
    ("fully visible hop", 4, 512, 512, 128, 1024, 512, True),
    ("non-causal", 4, 512, 512, 128, 1024, 0, False),
    ("fully masked", 4, 512, 512, 128, 1024, 1600, True),
    ("some q tiles see no key", 4, 512, 512, 128, 1024, 1280, True),
    ("ragged 200 x 200 D 64", 3, 200, 200, 64, 0, 0, True),
    ("136 x 200 D 16, partly visible", 4, 136, 200, 16, 200, 100, True),
    ("BH 1", 1, 512, 512, 128, 1024, 1024, True),
    ("D 8", 4, 40, 72, 8, 64, 48, True),
]
UPDATE_IDS = [c[0] for c in UPDATE_CASES]


def _update_inputs(device, bh, tq, tk, d, q_off, k_off, seed=1):
    """q, k, v and a carried state: an earlier, fully visible block folded
    in, and every third row left fresh (NEG_INF, 0, 0)."""
    q, k, v = _qkv(device, bh, tq, tk, d, seed=seed)
    _, k0, v0 = _qkv(device, bh, tq, tk, d, seed=seed + 1)
    state = fa.flash_block_update_reference(q, k0, v0, q_off, k_off, *_fresh(bh, tq, d, device),
                                            False)
    for x, fresh in zip(state, _fresh(bh, tq, d, device)):
        x[:, ::3] = fresh[:, ::3]
    return (q, k, v), state


@pytest.mark.cuda
@pytest.mark.parametrize("case", UPDATE_CASES, ids=UPDATE_IDS)
def test_flash_block_update_kernel_matches_plain(cuda, case):
    """Within the limits of the plain version, and bit-identical across two
    launches on the same inputs (no atomics, a fixed merge order); a fully
    masked block leaves the state bit for bit as it was."""
    _, bh, tq, tk, d, q_off, k_off, causal = case
    (q, k, v), state = _update_inputs(cuda, bh, tq, tk, d, q_off, k_off)
    runs = [tuple(x.clone() for x in state) for _ in range(2)]
    before = fa.block_update_launches
    for run in runs:
        fa.flash_block_update(q, k, v, q_off, k_off, *run, causal)
    torch.cuda.synchronize()
    assert fa.block_update_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    m, l, o = runs[0]
    if causal and k_off > q_off + tq:
        assert all(torch.equal(a, b) for a, b in zip((m, l, o), state))
        return
    rm, rl, ro = fa.flash_block_update_reference(q, k, v, q_off, k_off, *state, causal)
    assert _rel(m, rm) <= STATE_RTOL and _rel(l, rl) <= STATE_RTOL

    def out(o_, l_):
        return o_ / torch.where(l_ > 0, l_, 1.0)[..., None]

    assert _scaled(out(o, l), out(ro, rl)) <= OUT_RTOL


# ---------------------------------------------------------------------------
# DMA-pipeline copy (kernel B2)


def _bits(device, shape, dtype=torch.float32, seed=0):
    """Random bit patterns of ``dtype`` with NaN payloads (quiet and
    signalling, both signs) and infinities among them."""
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    info = torch.iinfo(ints)
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(info.min, info.max, (math.prod(shape),), generator=gen,
                         device=device, dtype=ints)
    special = ([0x7FC00001, 0x7FA00000, -0x003FFFFF, 0x7F800000, -0x00800000]
               if dtype == torch.float32 else [0x7FC1, 0x7FA0, -0x003F, 0x7F80, -0x0080])
    bits[:len(special)] = torch.tensor(special, dtype=ints, device=device)
    return bits.view(dtype).view(shape), ints


def test_dma_cpu_tensors_take_the_plain_version():
    x, ints = _bits("cpu", (64, 512))
    before = dp.launches
    out = dp.dma_pipeline_copy(x, 2, 16, 2)
    assert dp.launches == before
    assert out.data_ptr() != x.data_ptr()  # a copy, not the input
    assert torch.equal(out.view(ints), x.view(ints))
    assert torch.equal(out.view(ints), dp.dma_pipeline_copy_reference(x, 2).view(ints))


_UNALIGNED = torch.zeros(64 * 512 + 1)[1:].view(64, 512)


@pytest.mark.parametrize(
    "x, iters, match",
    [(_UNALIGNED, 1, "16-byte aligned"), (torch.zeros(64, 3), 1, "multiples of 16"),
     (torch.zeros(512, 64).t(), 1, "contiguous"), (torch.zeros(8, 8, 4), 1, "rows, cols"),
     (torch.zeros(64, 4), 0, "iters")],
    ids=["unaligned", "12-byte-rows", "non-contiguous", "rank-3", "no-pass"],
)
def test_dma_wrapper_rejects_what_the_kernel_does_not_take(x, iters, match):
    with pytest.raises(ValueError, match=match):
        dp.dma_pipeline_copy(x, iters, 8, 1)


@pytest.mark.parametrize(
    "nbytes, tile, slots, blocks",
    [(256 << 20, 32768, 4, 132),      # the probe: one ring of 4 x 32 KiB per SM
     (256 << 20, 32768, 2, 396),      # 2 slots: three rings per SM
     (256 << 20, 3616, 64, 132),      # 64 slots of 3616 bytes
     (256 << 20, 16384, 4, 396),
     (512 << 10, 32768, 4, 16),       # fewer tiles than SMs: one block per tile
     (128 << 10, 2048, 64, 64),
     (16, 16, 1, 1)],
)
def test_dma_grid_fills_the_sms_with_rings(nbytes, tile, slots, blocks):
    """As many blocks as fit on 132 SMs at once (228 KiB each, 1 KiB kept
    per block, at most 32 blocks), and no more than tiles."""
    assert dp.grid_blocks(nbytes, tile, slots, 132) == blocks


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, iters, chunk_rows, slots",
    [((32, 512), 2, 8, 2), ((32, 512), 1, 8, 1), ((32, 512), 1, 8, 4), ((32, 512), 3, 16, 2),
     ((131072, 512), 1, 2048, 4), ((131072, 512), 2, 2048, 64),
     ((131072, 512), 16, 2048, 4),   # the probe's shape at 16 passes
     ((5000, 500), 3, 40, 4),        # the last round split into pieces under a tile
     ((65536, 512), 2, 2048, 1),     # one slot: each reload waits on the store just issued
     ((64, 512), 2, 1, 64),          # 64 slots, one 2 KiB piece per block
     ((1024, 128), 2, 64, 4)],       # 16 tiles for more SMs than that
)
def test_dma_kernel_bit_identical_to_plain(cuda, shape, iters, chunk_rows, slots):
    """A copy is bit for bit: compared as int32, NaN payloads included."""
    x, ints = _bits(cuda, shape)
    before = dp.launches
    out = dp.dma_pipeline_copy(x, iters, chunk_rows, slots)
    torch.cuda.synchronize()
    assert dp.launches == before + 1
    assert torch.equal(out.view(ints), dp.dma_pipeline_copy_reference(x, iters).view(ints))


@pytest.mark.cuda
def test_dma_kernel_copies_bf16(cuda):
    x, ints = _bits(cuda, (256, 512), torch.bfloat16, seed=1)
    out = dp.dma_pipeline_copy(x, 2, 64, 2)
    torch.cuda.synchronize()
    assert torch.equal(out.view(ints), x.view(ints))


@pytest.mark.cuda
def test_dma_kernel_rejects_an_unaligned_view(cuda):
    x = torch.zeros(64 * 512 + 1, device=cuda)[1:].view(64, 512)
    before = dp.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        dp.dma_pipeline_copy(x, 1, 8, 1)
    assert dp.launches == before


# ---------------------------------------------------------------------------
# the training path: the FA2 block backward (kernel B4) and B3's f32 entry

from tpu_operator_torch.kernels import flash_backward as fb  # noqa: E402

F32_RTOL = 1e-4  # f32 kernels: max|kernel - plain| / max|plain|, sums in another order
BWD_RTOL = {torch.float32: F32_RTOL, torch.bfloat16: OUT_RTOL}

# bh, tq, tk, d, q_off, k_off, causal: the train hop (one card), a fully
# visible hop at its width (the four-card training's), the transformer
# check's, ragged shapes with partial masks, a non-causal hop, head dims
# between the kernels' templates, Tq and Tk not multiples of 64 at D 128
TRAIN_CASES = [
    (128, 2048, 2048, 128, 0, 0, True),
    (8, 2048, 2048, 128, 2048, 0, True),
    (16, 16, 16, 32, 0, 0, True),
    (8, 16, 16, 16, 0, 0, True),  # a transformer-pp stage's hop
    (8, 16, 16, 16, 16, 0, True),
    (4, 136, 200, 16, 200, 100, True),
    (2, 200, 136, 64, 0, 16, True),
    (3, 40, 72, 8, 0, 0, False),
    (3, 200, 200, 40, 0, 0, True),
    (3, 200, 264, 72, 64, 0, True),
    (2, 300, 420, 128, 120, 0, True),
]


def _hop(device, dtype, bh, tq, tk, d, q_off, k_off, causal, seed=0, window=0):
    """A hop's inputs as the remat backward sees them: q, k, v, dO, the
    forward's lse and dsum = rowsum(dO * O) (under the sliding ``window``
    when one is given), and non-zero incoming accumulators."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, do = randn(bh, tq, d).to(dtype), randn(bh, tq, d).to(dtype)
    k, v = randn(bh, tk, d).to(dtype), randn(bh, tk, d).to(dtype)
    m, l, o = fa.flash_block_update_reference(q.float(), k.float(), v.float(), q_off, k_off,
                                              *_fresh(bh, tq, d, device), causal, window)
    denom = torch.where(l > 0, l, 1.0)
    lse = m + torch.log(denom)
    dsum = (do.float() * (o / denom[..., None])).sum(-1)
    acc = (randn(bh, tq, d), randn(bh, tk, d), randn(bh, tk, d))
    return (q, k, v, do, lse, dsum), acc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bh, tq, tk, d, q_off, k_off, causal", TRAIN_CASES)
def test_flash_block_backward_kernel_matches_plain(cuda, dtype, bh, tq, tk, d, q_off, k_off,
                                                   causal):
    """Each output's contribution (the kernel adds into the accumulators)
    against the plain version's."""
    args, acc = _hop(cuda, dtype, bh, tq, tk, d, q_off, k_off, causal)
    ref = fb.flash_block_backward_reference(*args, *acc, q_off, k_off, causal)
    mine = tuple(a.clone() for a in acc)
    before = fb.backward_launches
    fb.flash_block_backward(*args, *mine, q_off, k_off, causal)
    torch.cuda.synchronize()
    assert fb.backward_launches == before + 1
    for got, want, a in zip(mine, ref, acc):
        assert _scaled(got - a, want - a) <= BWD_RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_block_backward_fully_masked_hop_changes_nothing(cuda, dtype):
    args, acc = _hop(cuda, dtype, 4, 136, 200, 16, 0, 136 + 64, True)
    mine = tuple(a.clone() for a in acc)
    fb.flash_block_backward(*args, *mine, 0, 136 + 64, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(mine, acc))


# bh, tq, tk, d, q_off, k_off, causal, carried state
FOLD_CASES = [
    (128, 2048, 2048, 128, 0, 0, True, False),
    (8, 2048, 2048, 128, 2048, 0, True, True),
    (16, 16, 16, 32, 0, 0, True, False),
    (8, 16, 16, 16, 0, 0, True, False),  # a transformer-pp stage's hop
    (8, 16, 16, 16, 16, 0, True, True),
    (4, 136, 200, 16, 200, 100, True, True),
    (3, 40, 72, 8, 0, 0, False, True),
    (3, 200, 200, 40, 0, 0, True, False),
    (3, 200, 264, 72, 64, 0, True, True),
    (2, 300, 420, 128, 120, 0, True, True),
    (4, 136, 200, 16, 0, 200, True, True),  # fully masked
]


@pytest.mark.cuda
@pytest.mark.parametrize("bh, tq, tk, d, q_off, k_off, causal, carried", FOLD_CASES)
def test_flash_block_update_f32_kernel_matches_plain(cuda, bh, tq, tk, d, q_off, k_off, causal,
                                                     carried):
    q, k, v = (x.float() for x in _qkv(cuda, bh, tq, tk, d, seed=3))
    state = _fresh(bh, tq, d, cuda)
    if carried:  # an earlier, fully visible block already folded in
        _, k0, v0 = (x.float() for x in _qkv(cuda, bh, tq, tk, d, seed=4))
        state = fa.flash_block_update_reference(q, k0, v0, q_off, k_off, *state, False)
    m, l, o = (x.clone() for x in state)
    before = (fa.block_update_launches, fa.block_update_f32_launches)
    fa.flash_block_update(q, k, v, q_off, k_off, m, l, o, causal)
    torch.cuda.synchronize()
    assert (fa.block_update_launches, fa.block_update_f32_launches) == (before[0], before[1] + 1)
    if causal and k_off > q_off + tq:
        assert all(torch.equal(a, b) for a, b in zip((m, l, o), state))
        return
    rm, rl, ro = fa.flash_block_update_reference(q, k, v, q_off, k_off, *state, causal)
    assert _rel(m, rm) <= STATE_RTOL and _scaled(l, rl) <= F32_RTOL
    assert _scaled(o / l[..., None], ro / rl[..., None]) <= F32_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["backward f32", "backward bf16", "update f32"])
@pytest.mark.parametrize("bh, tq, tk, d, q_off, k_off, causal",
                         [(128, 2048, 2048, 128, 0, 0, True), (3, 200, 264, 72, 64, 0, True)])
def test_training_kernels_are_deterministic(cuda, kernel, bh, tq, tk, d, q_off, k_off, causal):
    """No atomics: two launches on identical inputs give the same bits."""
    if kernel.startswith("backward"):
        dtype = torch.float32 if kernel.endswith("f32") else torch.bfloat16
        args, acc = _hop(cuda, dtype, bh, tq, tk, d, q_off, k_off, causal, seed=5)
        runs = []
        for _ in range(2):
            out = tuple(a.clone() for a in acc)
            fb.flash_block_backward(*args, *out, q_off, k_off, causal)
            runs.append(out)
    else:
        q, k, v = (x.float() for x in _qkv(cuda, bh, tq, tk, d, seed=5))
        runs = []
        for _ in range(2):
            state = _fresh(bh, tq, d, cuda)
            fa.flash_block_update(q, k, v, q_off, k_off, *state, causal)
            runs.append(state)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# bh, tq, tk, q_off, k_off, window at D 128: the sliding layers' hop (a
# sequence's own keys) at W 128 and 1024, W past T (the causal hop), a hop
# whose keys precede the queries (only the band's edge seen; offsets),
# one wholly before the band, and ragged T
WINDOW_CASES = [
    (8, 1024, 1024, 0, 0, 128),
    (8, 2048, 2048, 0, 0, 1024),
    (4, 1024, 1024, 0, 0, 4096),
    (4, 1024, 1024, 1024, 0, 128),
    (4, 1024, 1024, 1536, 512, 1024),
    (4, 512, 512, 2048, 0, 128),
    (2, 300, 420, 120, 0, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bh, tq, tk, q_off, k_off, window", WINDOW_CASES)
def test_windowed_f32_kernels_match_plain(cuda, bh, tq, tk, q_off, k_off, window):
    """B4 f32 and B3 f32 with a sliding window against their plain versions,
    each launched twice, bit-identical; a hop outside the band changes
    nothing."""
    d = 128
    args, acc = _hop(cuda, torch.float32, bh, tq, tk, d, q_off, k_off, True, seed=11,
                     window=window)
    runs = []
    for _ in range(2):
        mine = tuple(a.clone() for a in acc)
        fb.flash_block_backward(*args, *mine, q_off, k_off, True, window)
        runs.append(mine)
    q, k, v = args[:3]
    state = _fresh(bh, tq, d, cuda)
    folds = []
    for _ in range(2):
        fold = tuple(x.clone() for x in state)
        fa.flash_block_update(q, k, v, q_off, k_off, *fold, True, window)
        folds.append(fold)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(torch.equal(a, b) for a, b in zip(*folds))
    if q_off + tq - 1 - (k_off + tk - 1) >= window and q_off - k_off - tk + 1 >= window:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], acc))
        assert all(torch.equal(a, b) for a, b in zip(folds[0], state))
        return
    ref = fb.flash_block_backward_reference(*args, *acc, q_off, k_off, True, window)
    for got, want, a in zip(runs[0], ref, acc):
        assert _scaled(got - a, want - a) <= F32_RTOL
    m, l, o = folds[0]
    rm, rl, ro = fa.flash_block_update_reference(q, k, v, q_off, k_off, *state, True, window)
    seen = rl > 0
    assert torch.equal(seen, l > 0)
    assert _rel(m[seen], rm[seen]) <= STATE_RTOL and _scaled(l, rl) <= F32_RTOL
    out, ref = o / l.clamp_min(1e-30)[..., None], ro / rl.clamp_min(1e-30)[..., None]
    assert _scaled(out[seen], ref[seen]) <= F32_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["backward", "update"])
def test_a_window_past_the_sequence_is_the_causal_path_bit_for_bit(cuda, kernel):
    """At the probe's hop (128, 2048, 128) a window of 2048 or more hides
    no key: the kernels give the causal path's bits exactly."""
    bh, t, d = 128, 2048, 128
    args, acc = _hop(cuda, torch.float32, bh, t, t, d, 0, 0, True, seed=12)
    outs = []
    for window in (0, t, 1 << 20):
        if kernel == "backward":
            out = tuple(a.clone() for a in acc)
            fb.flash_block_backward(*args, *out, 0, 0, True, window)
        else:
            out = _fresh(bh, t, d, cuda)
            fa.flash_block_update(*args[:3], 0, 0, *out, True, window)
        outs.append(out)
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_block_backward_rejects_an_unaligned_view(cuda, dtype):
    """The kernels copy 16 bytes at a time: a view off 16-byte alignment is
    refused before any launch, never read wrong."""
    args, acc = _hop(cuda, dtype, 2, 64, 64, 32, 0, 0, True)
    q = args[0]
    base = torch.zeros(q.numel() + 4, device=cuda, dtype=dtype)
    unaligned = base[2:2 + q.numel()].view(q.shape)
    unaligned.copy_(q)
    before = fb.backward_launches
    with pytest.raises(ValueError, match="16-byte"):
        fb.flash_block_backward(unaligned, *args[1:], *acc, 0, 0, True)
    assert fb.backward_launches == before
