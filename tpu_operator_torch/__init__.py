"""PyTorch/CUDA port of the operator's compute payloads, for NVIDIA Hopper.

A second package beside ``tpu_operator``: the JAX package stays the
reference, and each module here is held against its JAX counterpart by a
parity test on identical numpy inputs.  Nothing in this package imports
``jax`` or ``tpu_operator``; where a JAX-free module of the reference is
needed, the port keeps its own copy of the part it uses.

Layout (mirrors ``tpu_operator/``):

- ``workloads/``  — ``run_validation`` and the checks it runs: the readiness
  gate and the transformer step (``collectives``), long-context attention
  and its training path (``longctx``, ``ring_attention``), the perf probes
  (``matmul_bench``, ``hbm_bench``, ``hbm_dma``), the training benchmark
  (``train_bench``), the parallelism census (``ulysses``, ``moe``,
  ``pipeline``), the multi-host program (``distributed``, ``watchdog``), the
  serving engine and its replica (``serving``) and the migratable training
  job with the snapshot format (``checkpoint``); the local multi-rank
  launcher (``_ranks``) and the shared timing rules (``timing``)
- ``kernels/``    — the hand-written CUDA kernels, their plain PyTorch
  versions, and the ``nvcc`` + ``ctypes`` build (``_build``); sources live in
  ``csrc/``
- ``k8s/``        — the NVIDIA card catalogue (``nodeinfo``)
- ``obs/``, ``validator/``, ``consts``, ``utils`` — own copies of the trace
  spans, the flight recorder, the step-phase timer and barrier, the
  drop-box paths, the migration constants and the topology helpers

Entry points run on ``cuda`` unless the caller asks for the CPU
(``TORCH_DEVICE=cpu``, or a ``device`` argument); with no card and no such
request they raise instead of falling back.
"""
