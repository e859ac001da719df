#!/usr/bin/env python3
"""Run chip_smoke.py's phase 9 (the recurrent mixers: recurrentgemma-9b at
full width and depth, xlstm-125m whole, the serve launcher) by itself on
one card.

    python3 tools/recurrent_phase.py

Builds the kernels as chip_smoke.py does, then calls its `run_recurrent`:
the same checks and readings, without phases 1-8 before it. Prints the
phase's lines, its wall seconds and kernel launches, its readings as one
JSON object, then the card's name and power limit. Exits non-zero where
a check fails or there is no card.
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
        print("recurrent_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_lib

    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    cuda_lib.build()
    t0 = time.perf_counter()
    launches, out = cs.run_recurrent(torch.device("cuda:0"))
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 9 seconds {out['phase_s']:.3f}; launches {json.dumps(launches)}")
    print(json.dumps(out))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
