#!/usr/bin/env python3
"""Time both routes of the pairwise_sq_l2 kernel against D, on one card.

    python3 tools/pairwise_routes.py

At M = 4,096, N = 65,536 (chip_smoke.py's wide shape) and D = 2..16, in
f32 and bf16, it times the narrow route ("cuda_core", bitwise equal to
the plain version, built for D <= NARROW_MAX_D) and the wide route
("wgmma_*")
with CUDA events, in turns (narrow, wide, wide, narrow), and prints one
line per (dtype, D) and then a JSON object with every reading and the
card's name and power limit. The smallest D at which the wide route is
faster in both dtypes is what `kWideMinD` in
src/repro_torch/kernels/csrc/pairwise_l2.cu is set to.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

M, N = 4096, 65536


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("pairwise_routes: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import pairwise_l2 as pw

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        wide = pw.route(pw.WIDE_MIN_D, torch.empty((), dtype=dtype).element_size())
        for d in range(2, pw.NARROW_MAX_D + 2):
            q = torch.randn((M, d), generator=gen, device=dev).to(dtype)
            p = torch.randn((N, d), generator=gen, device=dev).to(dtype)
            narrow_ok = d <= pw.NARROW_MAX_D

            def narrow():
                return pw.pairwise_cuda(q, p, route_name="cuda_core")

            def wide_fn():
                return pw.pairwise_cuda(q, p, route_name=wide)

            t = [time_ms(narrow) if narrow_ok else None, time_ms(wide_fn),
                 time_ms(wide_fn), time_ms(narrow) if narrow_ok else None]
            n_ms = [x for x in (t[0], t[3]) if x is not None]
            row = {"dtype": str(dtype).split(".")[-1], "d": d,
                   "narrow_ms": n_ms, "wide_ms": [t[1], t[2]]}
            rows.append(row)
            print(f"{row['dtype']} D={d}: narrow {n_ms} wide {[t[1], t[2]]}",
                  flush=True)
            del q, p
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "m": M, "n": N,
                      "wide_min_d": pw.WIDE_MIN_D, "routes": rows}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
