"""The port's CUDA kernels against their plain PyTorch versions.

The wrapper contract runs everywhere; the kernel itself needs an NVIDIA card
(marked ``cuda``, skipped without one).  On a machine with a card and no JAX:

    TPU_OPERATOR_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py -q
"""

import math

import pytest

torch = pytest.importorskip("torch")

from tpu_operator_torch.kernels import vector_add as va  # noqa: E402


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
