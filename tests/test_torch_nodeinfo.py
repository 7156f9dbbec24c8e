"""The port's NVIDIA card catalogue (``tpu_operator_torch.k8s.nodeinfo``):
card names as CUDA reports them map to their data-sheet peaks."""

import pytest

torch = pytest.importorskip("torch")

from tpu_operator_torch.k8s import nodeinfo  # noqa: E402


@pytest.mark.parametrize("name, generation, hbm_gbps, tflops", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm", 3350.0, 989.0),
    ("NVIDIA H100 PCIe", "h100-pcie", 2000.0, 756.0),
    ("NVIDIA H100 NVL", "h100-nvl", 3900.0, 835.0),
    ("NVIDIA H200", "h200", 4800.0, 989.0),
])
def test_card_names_map_to_their_peaks(name, generation, hbm_gbps, tflops):
    assert nodeinfo.generation_of(name) == generation
    info = nodeinfo.generation_info(generation)
    assert info.generation == generation
    assert (info.hbm_gbps, info.peak_bf16_tflops) == (hbm_gbps, tflops)


@pytest.mark.parametrize("name", ["Tesla T4", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_card_maps_to_zeros(name):
    info = nodeinfo.generation_info(nodeinfo.generation_of(name))
    assert nodeinfo.generation_of(name) == "unknown"
    assert (info.hbm_gb, info.hbm_gbps, info.peak_bf16_tflops) == (0, 0.0, 0.0)


def test_cpu_is_its_own_generation_with_no_peaks():
    assert nodeinfo.detect_generation("cpu") == "cpu"
    assert nodeinfo.generation_info("cpu") == nodeinfo.UNKNOWN_ACCELERATOR


@pytest.mark.parametrize("generation, tflops", [
    ("h100-sxm", 67.0), ("h100-pcie", 51.0), ("h100-nvl", 60.0), ("h200", 67.0), ("unknown", 0.0),
])
def test_f32_peaks_outside_the_tensor_cores(generation, tflops):
    """The data sheets' f32 CUDA-core peaks: the denominator of the f32
    flash kernels' operations bound."""
    assert nodeinfo.generation_info(generation).peak_fp32_tflops == tflops


@pytest.mark.parametrize("generation, tflops", [
    ("h100-sxm", 494.5), ("h100-pcie", 378.0), ("h100-nvl", 417.5), ("h200", 494.5),
    ("unknown", 0.0),
])
def test_tf32_peaks_are_half_the_bf16_peak(generation, tflops):
    """The data sheets' dense TF32 tensor-core peaks: the denominator of the
    f32 flash kernels' operations bound, three TF32 passes per product."""
    info = nodeinfo.generation_info(generation)
    assert info.peak_tf32_tflops == tflops == info.peak_bf16_tflops / 2
