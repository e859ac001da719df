#!/usr/bin/env python3
"""Run one cell of the benchmark once on the card and print its result.

    python3 portbench/run.py --workload hl2d-bulk --seed 7 --seconds 20 --trace 0

Exits non-zero, with no result, where there is no CUDA device or fewer
than the cell asks for, and where a module of JAX or of the JAX package
was loaded. The last line of standard output is the result's JSON
object; the numbers compared with their limits are the last lines of
standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process, few threads: the host's math libraries run single-threaded,
# so their pools do not contend with the program's own threads
THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for name in THREAD_ENV:
        os.environ[name] = "1"
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    harness.prepare_env(ROOT)
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
