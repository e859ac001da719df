#!/usr/bin/env python3
"""Run chip_smoke.py's phase 3 (the main path, whose end holds phase 11
(b), the obs export), phase 10 (training, whose last step's peak memory
phase 11 (c) reads) and phase 11 (accounting) by themselves on one card.

    python3 tools/accounting_phase.py

Builds the kernels as chip_smoke.py does, then calls its `run_main`,
`run_train` and `run_accounting`: the same checks and readings, without
the other phases. Prints the phases' lines, their wall seconds, phase
11's readings as one JSON object, then the card's name and power limit.
Exits non-zero where a check fails or there is no card.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("accounting_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_lib

    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    cuda_lib.build()
    print(f"build: {cuda_lib.BUILD_INFO['seconds']:.2f} s")
    dev = torch.device("cuda:0")
    pts, queries, r = cs.main_data()
    t0 = time.perf_counter()
    launches, idx, exported = cs.run_main(dev, pts, queries, r)
    del idx
    t1 = time.perf_counter()
    _, train_out = cs.run_train(dev)
    t2 = time.perf_counter()
    account = cs.run_accounting(dev, pts, queries, r, train_out)
    t3 = time.perf_counter()
    print(f"phase 3 seconds {t1 - t0:.3f}; phase 10 seconds {t2 - t1:.3f}; "
          f"phase 11 seconds {t3 - t2:.3f}; phase 3 launches {json.dumps(launches)}")
    print(json.dumps({"export": exported, **account}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
