#!/usr/bin/env python3
"""Host cost of the steps a kernel wrapper takes per call, on one card.

    python3 tools/wrapper_host_cost.py [--src DIR] [--label NAME]

The launch-bound kernels (topk_l2, cov_matvec) take less device time per
call than their Python wrappers take to enqueue them, so a wrapper's host
steps set the eager time. Each step is called back to back 3,000 times
and timed on the host's wall clock by chip_smoke.py's `time_host_ms`
(the card synchronized before and after, not between); microseconds a
call. chip_smoke.py's "host_ms"
gives the whole wrapper's cost at the main path's shapes.

Then the whole wrappers of the leaf, arena and pairwise kernels, each
called back to back at a serving-sized shape (inputs on the card, made
once), timed the same way — the kernel modules' launch functions and the
public `kernels.ops` wrappers above them (which also bill the obs
registry and, where the tree has the autotuner, look up its plan). `--src` is the `src` directory whose
`repro_torch` is timed (default: this repository's), so one command can
time two commits' wrappers on one card, in turns (unpack the other with
`git archive` into a directory that .gitignore lists).

Prints one line per step and per wrapper, a JSON object of the wrapper
readings, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wrapper_host_cost: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))  # ahead of chip_smoke's
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.kernels import pairwise_l2 as pw
    from repro_torch.kernels import topk_l2 as tk

    dev = torch.device("cuda:0")
    lib = cuda_lib.library()
    q = torch.zeros((64, 2), device=dev)

    def device_switch():
        with torch.cuda.device(dev):
            pass

    def device_kept():
        with cuda_lib.on_device(0):
            pass

    stream = cuda_lib.current_stream(0)
    steps = {
        "torch.empty(1000) f32": lambda: torch.empty(1000, device=dev),
        "torch.empty((64, 10)) i32": lambda: torch.empty(
            (64, 10), dtype=torch.int32, device=dev),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "cuda_lib.current_stream(0)": lambda: cuda_lib.current_stream(0),
        "with torch.cuda.device(dev)": device_switch,
        "with cuda_lib.on_device(0)": device_kept,
        "cuda_lib.ticket_counters (kept)":
            lambda: cuda_lib.ticket_counters(0, stream, 1),
        "tk.scan_geometry(64, 4096, 10)": lambda: tk.scan_geometry(64, 4096, 10),
        "tk._check(q)": lambda: tk._check(q, "q", torch.float32, (64, 2), dev),
        "tensor.data_ptr()": q.data_ptr,
        "ctypes call, 13 arguments (returns early)":
            lambda: lib.cov_matvec_launch(0, 0, 0, 0, 0, 2, 1, 1, 1, 0, 0, 0, 0),
    }
    try:
        from repro_torch.kernels import autotune
    except ImportError:  # a tree from before the autotuner
        autotune = None
    if autotune is not None:
        steps["autotune.choose_plan (cached)"] = lambda: autotune.choose_plan(
            "topk_l2", 8, 4096, 2, 10, backend="cuda")
    for name, fn in steps.items():
        us = 1e3 * cs.time_host_ms(fn, reps=3000)
        print(f"{name:44s} {us:8.3f} us", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, c, kp = 8, 256, 18  # a class-8 dispatch: 8 leaves of 32 a row
    lq = torch.rand((rows, 2), generator=gen, device=dev)
    cands = (lq[:, None, :] + 0.1 * torch.randn(
        (rows, c, 2), generator=gen, device=dev)).to(torch.bfloat16)
    cg = torch.arange(rows * c, dtype=torch.int32, device=dev).reshape(rows, c)
    r_sq = torch.full((rows,), 0.01, device=dev)
    arena = torch.rand((4096, 2), generator=gen, device=dev)
    ag = torch.arange(4096, dtype=torch.int32, device=dev)
    wrappers = {
        f"tk.leaf_topk_cuda R={rows} C={c} D=2 k'={kp} bf16":
            lambda: tk.leaf_topk_cuda(lq, cands, cg, r_sq, kp),
        "tk.topk_cuda Q=8 N=4096 D=2 k=10":
            lambda: tk.topk_cuda(lq, arena, ag, r_sq, 10),
        "pw.pairwise_cuda M=8 N=4096 D=2 (narrow route)":
            lambda: pw.pairwise_cuda(lq, arena),
        f"ops.leaf_topk_l2_raw R={rows} C={c} D=2 k'={kp} bf16":
            lambda: ops.leaf_topk_l2_raw(lq, cands, cg, 0.1, kp),
        "ops.topk_l2 Q=8 N=4096 D=2 k=10":
            lambda: ops.topk_l2(lq, arena, ag, 0.1, 10),
    }
    out = {"label": args.label, "src": args.src}
    for name, fn in wrappers.items():
        us = 1e3 * cs.time_host_ms(fn, reps=3000)
        out[name] = us
        print(f"[{args.label}] {name:44s} {us:8.3f} us a call", flush=True)
    print(json.dumps(out))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
