"""fmbench: the benchmark of tpufm_torch, the PyTorch and CUDA port.

``python3 fmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of BENCHMARK.json on one card and prints one JSON
result line. Everything is found by name: a configuration in
``configs/<name>.json``, a traffic mix in ``traffic/<name>.json``, the call
into the program that a mix drives in ``entries/<entry>.py``, and each metric
in ``metrics/<name>.py``. The yardstick (generators, the plain reference,
the trace reduction, the metric arithmetic) lives here and imports nothing
of the program.
"""
