"""The benchmark of ``gaussian_processes_tpu_torch`` (PyTorch + CUDA, one H100 a cell).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything a cell needs is found by name: its configuration under
``configs/``, its traffic mix under ``traffic/`` (data read by the kind
module ``kinds/<kind>.py`` that the mix names), and each per-layer metric's
reader under ``metrics/``.  The plain reference that decides ``correct`` is
``reference/``; it imports nothing of the program.
"""
