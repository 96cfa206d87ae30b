"""The benchmark of ``repro_torch``: the AFD serve loop under open-loop
traffic. ``python3 afdbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell once; ``BENCHMARK.json`` names the
cells, and each configuration, traffic mix, check limit and per-layer
metric is a file of its own under this folder, found by name."""
