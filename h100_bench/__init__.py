"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything a cell needs is found by name:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<mix>.json``: the traffic mix's parameters, whose ``kind`` names
  the loop module ``traffic/<kind>.py`` that drives the program;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``counts/``: the frozen operation and byte counts;
* ``reference/``: the plain reference that decides ``correct``.

Nothing here imports JAX or the JAX package ``repro``.
"""
