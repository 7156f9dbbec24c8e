"""The validation workloads on PyTorch, driven by ``run_validation``: the
readiness gate (the vector-add kernel check, the NCCL allreduce benchmark,
the sharded burn-in), the long-context checks (longctx prefill, decode,
ring attention) on the flash kernels, the post-ready perf probes (matmul
MFU, the hbm stream, the hbm-dma cross-check on the DMA-pipeline kernel, the
per-link ring), training (the flagship transformer step, its throughput
benchmark) on the ring-remat flash kernels, and the parallelism census
(ulysses, moe, pipeline).  ``python -m tpu_operator_torch.workloads.
distributed`` is the multi-host program: one process per host, one rank
per card, bounded by the peer watchdog.

Device selection has no fallback: the gate runs on ``cuda`` unless the
caller asks for the CPU (``TORCH_DEVICE=cpu``, the counterpart of the
reference's ``JAX_PLATFORMS=cpu`` request, or an explicit ``device``).  A
node with no visible card fails the gate; it never measures the host CPU
under the card's name.
"""

import os

DEVICE_ENV = "TORCH_DEVICE"


def resolve_device(device=None):
    """The device a workload runs on: ``device`` when given, else
    ``TORCH_DEVICE``, else ``cuda``.  Raises when CUDA is asked for (or
    defaulted to) and no card is visible.  Imports torch here: importing
    the package does not (the validator's control-plane components read
    ``compile_cache`` without paying for torch)."""
    import torch

    requested = device if device is not None else os.environ.get(DEVICE_ENV, "") or "cuda"
    dev = torch.device(requested)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: the readiness gate needs an NVIDIA GPU "
            f"(set {DEVICE_ENV}=cpu to run the checks on the CPU on purpose)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {requested!r}: expected cuda or cpu")
    return dev


def subprocess_pythonpath() -> str:
    """PYTHONPATH value for a spawned worker that re-imports this package
    via ``python -m``: the parent's package root prepended to the existing
    PYTHONPATH.  It does NOT pin the worker to the parent's copy: ``-m``
    still puts the child's cwd at sys.path[0]."""
    import tpu_operator_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(tpu_operator_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    return root + os.pathsep + existing if existing else root
