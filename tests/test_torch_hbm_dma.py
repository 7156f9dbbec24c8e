"""Parity of the port's hbm-dma probe (``tpu_operator_torch.workloads.
hbm_dma``) and of the DMA-pipeline copy (kernel B2's plain version) with the
JAX reference's ``hbm_pallas``, on identical inputs, on the CPU.  The
reference's Pallas kernel runs in interpret mode, as its own tests run it
here; each case is kept to a few chunks."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator.workloads import hbm_pallas as jdma  # noqa: E402
from tpu_operator_torch.kernels import dma_pipeline as dp  # noqa: E402
from tpu_operator_torch.workloads import hbm_dma as tdma  # noqa: E402


def _arange():
    x = np.arange(32 * 512, dtype=np.float32).reshape(32, 512)
    return x, torch.from_numpy(x.copy()), jnp.asarray(x)


@pytest.mark.parametrize("iters, chunk_rows, slots", [(2, 8, 2), (1, 8, 1), (1, 8, 4), (3, 16, 2)])
def test_dma_copy_bit_identical_to_pallas(iters, chunk_rows, slots):
    x, tx, jx = _arange()
    ref = np.asarray(jdma.dma_pipeline_copy(jx, iters=iters, chunk_rows=chunk_rows, slots=slots))
    before = dp.launches
    mine = dp.dma_pipeline_copy(tx, iters, chunk_rows, slots).numpy()
    assert dp.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(mine.view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(mine.view(np.int32), x.view(np.int32))


@pytest.mark.parametrize("chunk_rows, slots, match",
                         [(10, 2, "not divisible"), (16, 3, "slots"), (8, 0, "slots")])
def test_dma_copy_errors_match_pallas(chunk_rows, slots, match):
    """A remainder tail would never be copied; surplus slots would copy
    past the end of the buffer: both sides refuse the same calls."""
    _, tx, jx = _arange()
    with pytest.raises(ValueError, match=match):
        jdma.dma_pipeline_copy(jx, iters=1, chunk_rows=chunk_rows, slots=slots)
    with pytest.raises(ValueError, match=match):
        dp.dma_pipeline_copy(tx, 1, chunk_rows, slots)


def test_quick_benchmark_matches_pallas():
    mine = tdma.quick_benchmark(device="cpu")
    ref = jdma.quick_benchmark()
    assert mine["ok"] and ref["ok"]
    for key in ("methodology", "slots", "chunk_mb", "size_mb", "iters", "best_of",
                "fraction_of_peak"):
        assert mine[key] == ref[key], key
    assert mine["fraction_of_peak"] is None and mine["backend"] == "cpu"
    assert mine["kernel"] == "plain" and mine["gbps"] > 0
    assert set(ref) <= set(mine)
    assert mine["tile_bytes"] == 32 * 1024  # a 128 KiB chunk streams in 32 KiB tiles


@pytest.mark.parametrize("size_mb, chunk_mb, slots",
                         [(1.0, 0.25, 8), (0.5, 0.125, 1), (0.3, 0.07, 2)])
def test_sizing_rules_match_pallas(size_mb, chunk_mb, slots):
    """The reference's rules: chunk rows from chunk_mb (at least 8), rows
    rounded down to whole chunks, slots clamped to the chunk count."""
    kwargs = dict(size_mb=size_mb, iters=1, chunk_mb=chunk_mb, slots=slots, best_of=1)
    mine = tdma.dma_stream_benchmark(device="cpu", **kwargs)
    ref = jdma.dma_stream_benchmark(**kwargs)
    for key in ("size_mb", "chunk_mb", "slots", "iters", "methodology"):
        assert mine[key] == ref[key], key


def test_broken_copy_fails_the_self_check(monkeypatch):
    """A copy that leaves an interior tile unwritten fails the check: the
    min/max self-check reads every element."""
    def skips_a_tile(x, iters, chunk_rows, slots):
        out = dp.dma_pipeline_copy_reference(x, iters)
        out[x.shape[0] // 2].zero_()
        return out

    monkeypatch.setattr(tdma, "dma_pipeline_copy", skips_a_tile)
    r = tdma.quick_benchmark(device="cpu")
    assert not r["ok"] and "wrong data" in r["error"]


@pytest.mark.parametrize(
    "shape, chunk_rows, slots, expected",
    [((131072, 512), 2048, 1, 32768), ((131072, 512), 2048, 4, 32768),
     ((131072, 512), 2048, 8, 29040), ((131072, 512), 2048, 64, 3616),
     ((32, 512), 8, 2, 16384), ((9000, 4), 1, 9000, 16)],
)
def test_tile_fits_the_shared_memory(shape, chunk_rows, slots, expected):
    """At most 32 KiB and at most a chunk, ``slots`` of them within a
    block's 227 KiB beside the barriers, a multiple of 16 bytes."""
    tile = dp.tile_bytes(torch.empty(shape), chunk_rows, slots)
    assert tile == expected and tile % 16 == 0
    bars = 128 * ((slots + 15) // 16)
    assert bars + slots * tile <= dp.SMEM_BYTES


def test_too_many_slots_for_shared_memory_raise():
    x = torch.empty((10000, 4))
    with pytest.raises(ValueError, match="shared memory"):
        dp.dma_pipeline_copy(x, 1, 1, 10000)
