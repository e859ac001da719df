#!/usr/bin/env python3
"""Run chip_smoke.py's phase 12 (the mesh) by itself on one card.

    python3 tools/mesh_phase.py

Calls chip_smoke.py's `run_mesh`, which starts the six production-mesh
dry-run cells and runs the live mesh beside them: the same checks and
readings, without the other phases (no kernel is on this path, so nothing is built). Prints the
phase's lines, its wall seconds, its readings as one JSON object, then
the card's name and power limit. Exits non-zero where a check fails or
there is no card.
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
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    out = cs.run_mesh(dev)
    print(f"phase 12 seconds {time.perf_counter() - t0:.3f}")
    print(json.dumps(out))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
