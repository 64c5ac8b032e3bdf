"""The benchmark of ``tec_mollm_tpu_torch`` on NVIDIA H100s.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON line. Everything a cell is made of is a
file found by name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<mix>.json``, ``drivers/<kind>.py`` and ``metrics/<metric>.py``.
Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the program.
"""
