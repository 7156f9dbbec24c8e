"""The port's CUDA kernels against their plain PyTorch versions.

The wrapper contract runs everywhere; the kernel itself needs an NVIDIA card
(marked ``cuda``, skipped without one).  On a machine with a card and no JAX:

    TPU_OPERATOR_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py -q
"""

import math

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
        (torch.ones(4, dtype=torch.bfloat16), torch.ones(4, dtype=torch.bfloat16), TypeError),
        (torch.ones(4), torch.ones(5), ValueError),
        (torch.ones(4, 4).t(), torch.ones(4, 4), ValueError),
    ],
    ids=["bf16", "shape", "non-contiguous"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(x, y, err):
    with pytest.raises(err):
        va.vector_add_kernel(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, offset", [((2048, 512), 0), ((1000, 509), 0),
                                           ((2048, 512), 1), ((3,), 0), ((7,), 1)])
def test_kernel_bit_identical_to_plain(cuda, shape, offset):
    """One IEEE f32 add either way: tolerance 0, on the vector path, the
    masked tail and the unaligned scalar path."""
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
def test_cuda_tensor_of_wrong_dtype_raises(cuda):
    x = torch.ones(8, device=cuda, dtype=torch.float16)
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
    out, lse = fa.flash_attention_local(q, k, v, True, 16, 16)
    ref_out, ref_lse = fa.flash_attention_local_reference(q, k, v, True, 16, 16)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    m, l, o = _fresh(2, 48, 8, "cpu")
    ref = fa.flash_block_update_reference(q, k, v, 0, 0, m, l, o, True)
    got = fa.flash_block_update(q, k, v, 0, 0, m, l, o, True)
    assert got[0] is m and got[2] is o  # in place
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (fa.forward_launches, fa.block_update_launches) == before


@pytest.mark.parametrize(
    "args, err",
    [
        ((torch.ones(1, 8, 8), torch.ones(1, 8, 8), torch.ones(1, 8, 8)), TypeError),
        ((torch.ones(1, 8, 8).bfloat16(), torch.ones(1, 8, 16).bfloat16(),
          torch.ones(1, 8, 16).bfloat16()), ValueError),
        ((torch.ones(8, 8).bfloat16(),) * 3, ValueError),
        ((torch.ones(1, 8, 8).bfloat16().transpose(1, 2),) * 3, ValueError),
    ],
    ids=["f32", "head-dim", "rank", "non-contiguous"],
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


@pytest.mark.cuda
@pytest.mark.parametrize("k_off, causal", [(1024, True), (768, True), (0, False), (1600, True)],
                         ids=["diagonal", "half-visible", "non-causal", "fully-masked"])
def test_flash_block_update_kernel_matches_plain(cuda, k_off, causal):
    bh, t, d = 4, 512, 128
    q, k, v = _qkv(cuda, bh, t, t, d, seed=1)
    _, k0, v0 = _qkv(cuda, bh, t, t, d, seed=2)
    state = fa.flash_block_update_reference(q, k0, v0, 1024, 512, *_fresh(bh, t, d, cuda), True)
    m, l, o = (x.clone() for x in state)
    before = fa.block_update_launches
    fa.flash_block_update(q, k, v, 1024, k_off, m, l, o, causal)
    torch.cuda.synchronize()
    assert fa.block_update_launches == before + 1
    if causal and k_off > 1024 + t:
        assert all(torch.equal(a, b) for a, b in zip((m, l, o), state))
        return
    rm, rl, ro = fa.flash_block_update_reference(q, k, v, 1024, k_off, *state, causal)
    assert _rel(m, rm) <= STATE_RTOL and _rel(l, rl) <= STATE_RTOL
    assert _scaled(o / l[..., None], ro / rl[..., None]) <= OUT_RTOL


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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, iters, chunk_rows, slots",
    [((32, 512), 2, 8, 2), ((32, 512), 1, 8, 1), ((32, 512), 1, 8, 4), ((32, 512), 3, 16, 2),
     ((131072, 512), 1, 2048, 4), ((131072, 512), 2, 2048, 64)],
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

# bh, tq, tk, d, q_off, k_off, causal: the train hop (one card), the
# transformer check's, ragged shapes with partial masks, a non-causal hop
TRAIN_CASES = [
    (128, 2048, 2048, 128, 0, 0, True),
    (16, 16, 16, 32, 0, 0, True),
    (4, 136, 200, 16, 200, 100, True),
    (2, 200, 136, 64, 0, 16, True),
    (3, 40, 72, 8, 0, 0, False),
]


def _hop(device, dtype, bh, tq, tk, d, q_off, k_off, causal, seed=0):
    """A hop's inputs as the remat backward sees them: q, k, v, dO, the
    forward's lse and dsum = rowsum(dO * O), and non-zero incoming
    accumulators."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, do = randn(bh, tq, d).to(dtype), randn(bh, tq, d).to(dtype)
    k, v = randn(bh, tk, d).to(dtype), randn(bh, tk, d).to(dtype)
    m, l, o = fa.flash_block_update_reference(q.float(), k.float(), v.float(), q_off, k_off,
                                              *_fresh(bh, tq, d, device), causal)
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
    (16, 16, 16, 32, 0, 0, True, False),
    (4, 136, 200, 16, 200, 100, True, True),
    (3, 40, 72, 8, 0, 0, False, True),
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
