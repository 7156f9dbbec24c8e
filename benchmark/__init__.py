"""The benchmark of the PyTorch and CUDA port (``tpu_operator_torch``).

``python -m benchmark --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card(s) of this machine and
prints one JSON line.  Everything that belongs to one configuration, traffic
mix, cell or per-layer metric is a file of its own, found by its name:

- ``configs/<config>.json``  the deployment or model configuration
- ``traffic/<traffic>.json`` the parameters one general runner reads; its
  ``kind`` names the runner, ``kinds/<kind>.py``
- ``cells/<cell>.json``      the limits that decide ``correct`` in that cell
- ``metrics/<metric>.py``    the reader of one per-layer metric

The yardstick lives here and nowhere in the program: the FLOP and byte
counts (``counts.py``), the data-sheet peaks (``peaks.py``), the reading of
profiler traces (``trace.py``), the plain reference of the training layer
(``reference/layer.py``) and the comparison (``compare.py``).  Nothing here
imports JAX or the JAX package.
"""
