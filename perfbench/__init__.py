"""The benchmark of the PyTorch and CUDA port (``twotower_tpu_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Everything that belongs to one
configuration, traffic mix or per-layer metric sits in a file of its own,
found by the name ``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<mix>.json`` (its ``driver`` names ``drivers/<driver>.py``) and
``metrics/<metric>.py``. ``reference/`` holds the plain reference that
decides ``correct``; it imports nothing of the program.
"""
