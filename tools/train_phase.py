#!/usr/bin/env python3
"""Run chip_smoke.py's phase 2 (b) (the top-k kernels' sort route on a
k = 2,000 streaming query) and phase 10 (training) by themselves on one
card.

    python3 tools/train_phase.py

Builds the kernels as chip_smoke.py does (printing ptxas's report of the
sort kernels), then calls its `run_large_k` and `run_train`: the same
checks and readings, without the other phases. Prints the phases' lines,
their wall seconds, their readings as one JSON object, then the card's
name and power limit. Exits non-zero where a check fails or there is no
card.
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
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_lib

    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    cuda_lib.build()
    print(f"build: {cuda_lib.BUILD_INFO['seconds']:.2f} s")
    lines = cuda_lib.BUILD_INFO.get("ptxas", "").splitlines()
    for i, line in enumerate(lines):
        if "topk_sort_kernel" in line:
            print("ptxas: " + " | ".join(x.strip() for x in lines[i:i + 3]))
    dev = torch.device("cuda:0")
    pts, queries, r = cs.main_data()
    t0 = time.perf_counter()
    routes, checked, big = cs.run_large_k(dev, pts, queries, r)
    t1 = time.perf_counter()
    launches, out = cs.run_train(dev)
    t2 = time.perf_counter()
    print(f"phase 2 (b) seconds {t1 - t0:.3f}; phase 10 seconds {t2 - t1:.3f}; "
          f"launches {json.dumps(launches)}")
    print(json.dumps({"large_k": {"routes": routes, "shapes": checked, **big},
                      "train": out}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
