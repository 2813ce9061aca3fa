"""The benchmark of the BARQ port (``repro_torch``) on one NVIDIA H100:
cells named in ``BENCHMARK.json`` at the repository root, run with
``python3 barqbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""
