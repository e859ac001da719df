"""Benchmark of the PyTorch / CUDA port (`src/repro_torch`) on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a data file or reader of its own
(`configs/`, `traffic/`, `workloads/`, `metrics/`), found by the name
`BENCHMARK.json` gives it. The yardstick itself — data and query
generators, the plain brute-force reference and the comparison that
decides `correct`, the kernels' operation and byte formulas, the card's
peaks, and the trace arithmetic — is frozen here, so that a change to
the program cannot move it. Nothing here imports JAX or the JAX package.
"""
