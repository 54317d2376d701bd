"""The benchmark of ``ldpcdecoders_tpu_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``: the cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``), and each
per-layer metric is read by ``metrics/<name>.py``.  Adding a cell, a
configuration or a metric is adding files and entries.
"""
