#!/usr/bin/env python3
"""Host cost of the steps a kernel wrapper takes per call, on one card.

    python3 tools/wrapper_host_cost.py

The launch-bound kernels (topk_l2, cov_matvec) take less device time per
call than their Python wrappers take to enqueue them, so a wrapper's host
steps set the eager time. Each step is called back to back 3,000 times
and timed on the host's wall clock by chip_smoke.py's `time_host_ms`
(the card synchronized before and after, not between); microseconds a
call. chip_smoke.py's "host_ms"
gives the whole wrapper's cost at the main path's shapes.

Prints one line per step, then the card's name and power limit.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("wrapper_host_cost: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_lib
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
    for name, fn in steps.items():
        us = 1e3 * cs.time_host_ms(fn, reps=3000)
        print(f"{name:44s} {us:8.3f} us", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
