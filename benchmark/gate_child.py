"""``python -m benchmark.gate_child [--profile OUT] [--patch module:function]``:
one pass of the readiness gate.  The gate's pod entry (``python -m
tpu_operator_torch.workloads.run_validation``) runs in this process, with
the environment and exit code it would have alone; every pass of a gate
cell, timed or not, starts here.

Around the entry this keeps what the harness judges the pass by, in
``$TPU_VALIDATION_ROOT/benchmark/`` (``CAPTURE``), and nothing else of the
entry changes:

- ``vector_add.npy``: each sum that kernel B1 handed ``collectives
  .vector_add``, as the kernel returned it;
- ``allreduce.json``: for each bfloat16 buffer that the allreduce check
  turns into float32 to find its error, its element count, its smallest
  and largest element, and whether it is the check's input (the first
  buffer seen) or a result;
- ``modules.json``: the loaded modules whose top-level name is JAX's or the
  JAX package's, once the entry has ended.

``--patch`` plants a fault or the control of the tests first, under the
capture; ``--profile`` runs the entry under ``torch.profiler`` and writes
the summary of its trace to OUT as JSON."""

import argparse
import importlib
import json
import os
import runpy
import sys

ENTRY = "tpu_operator_torch.workloads.run_validation"
CAPTURE = "benchmark"


class Capture:
    """The outputs of one pass, taken where the program produces them."""

    def __init__(self):
        self.sums = []       # B1's outputs, on the device until the pass ends
        self.buffers = []    # (numel, aminmax on the device, data_ptr)

    def install(self) -> None:
        import torch

        from tpu_operator_torch.workloads import collectives

        kernel = collectives.vector_add_kernel

        def vector_add_kernel(x, y):
            out = kernel(x, y)
            self.sums.append(out)
            return out

        collectives.vector_add_kernel = vector_add_kernel

        rank_fn = collectives._allreduce_rank
        to_float = torch.Tensor.float

        def float_(t, *args, **kwargs):
            if t.dtype == torch.bfloat16:
                # one small reduction on the stream; nothing waits for it
                self.buffers.append((t.numel(), torch.aminmax(t), t.data_ptr()))
            return to_float(t, *args, **kwargs)

        def allreduce_rank(*args, **kwargs):
            torch.Tensor.float = float_
            try:
                return rank_fn(*args, **kwargs)
            finally:
                torch.Tensor.float = to_float

        collectives._allreduce_rank = allreduce_rank

    def write(self, path: str) -> None:
        import numpy as np

        if self.sums:
            np.save(os.path.join(path, "vector_add.npy"),
                    np.stack([s.detach().float().cpu().numpy() for s in self.sums]))
        first = self.buffers[0][2] if self.buffers else None
        buffers = [{"numel": n, "min": float(mm.min), "max": float(mm.max),
                    "input": ptr == first} for n, mm, ptr in self.buffers]
        with open(os.path.join(path, "allreduce.json"), "w") as f:
            json.dump(buffers, f)


def main() -> int:
    parser = argparse.ArgumentParser(prog="python -m benchmark.gate_child")
    parser.add_argument("--profile", default="")
    parser.add_argument("--patch", default="")
    args = parser.parse_args()
    out = os.path.join(os.environ["TPU_VALIDATION_ROOT"], CAPTURE)
    os.makedirs(out, exist_ok=True)
    if args.patch:
        module, fn = args.patch.split(":")
        getattr(importlib.import_module(module), fn)()
    capture = Capture()
    capture.install()
    prof = annotation = None
    if args.profile:
        import torch

        from benchmark import trace as btrace

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
        annotation = torch.profiler.record_function(btrace.WINDOW)
        annotation.__enter__()
    code = 0
    try:
        runpy.run_module(ENTRY, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        if prof is not None:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            annotation.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            with open(args.profile, "w") as f:
                json.dump(btrace.summarize_profile(prof), f)
        capture.write(out)
        from benchmark import modcheck

        with open(os.path.join(out, "modules.json"), "w") as f:
            json.dump(modcheck.banned_modules(), f)
    return code


if __name__ == "__main__":
    sys.exit(main())
