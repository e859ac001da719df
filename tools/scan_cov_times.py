#!/usr/bin/env python3
"""Time topk_l2 and cov_matvec at chip_smoke.py's shapes, on one card, for
the port in any source tree.

    python3 tools/scan_cov_times.py [--src DIR] [--label NAME]

`--src` is the `src` directory whose `repro_torch` is timed (default: this
repository's), so one command can time two commits on one card: unpack
the other commit with `git archive` into a directory that .gitignore lists
and run it, then this tree, then this tree and it again. The readings are
chip_smoke.py's own (`check_scan`, `check_cov`) on chip_smoke.py's data:
topk_l2 at Q = 64 and Q = 5,300 against the N = 4,096 arena, and
cov_matvec at 500,000 x 2 and 100,000 x 64 in f32, each checked bitwise
against that tree's plain version first, then timed eager ("ms"), as
replayed CUDA graphs ("graph_ms") and on the host ("host_ms").

Prints chip_smoke.py's lines, then a JSON object with the readings, then
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_cov_times: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))  # ahead of chip_smoke's
    from repro_torch.kernels import cuda_lib

    dev = torch.device("cuda:0")
    card = cs.card_line()
    cuda_lib.build()
    pts, queries, r = cs.main_data()
    out = {"label": args.label, "src": args.src, "card": card,
           "topk_l2": cs.check_scan(dev, pts, queries, r)}
    x_root, x_wide = cs.cov_inputs(dev, pts, torch.Generator(device=dev).manual_seed(0))
    out["cov_matvec"] = {"root": cs.check_cov("root", x_root),
                         "wide": cs.check_cov("wide", x_wide)}
    print(json.dumps(out))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
