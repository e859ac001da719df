"""Readings that set a cell's limits: the program's compared numbers
and the control's, on several seeds, in one process on the card.

    python3 portbench/tools/readings.py --workload hl2d-bulk \
        --seeds 11,12,13 --seconds 5 [--control]

Each seed is one whole run of the cell (set-up, window, comparison) at
the cell's own size. With --control the same run is judged a second
time with the reference computed in bfloat16 put in the program's place
(`compare.control_answers`): its numbers must fail the limits. One JSON
line a seed; the benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from portbench import catalog, harness

    harness.prepare_env(ROOT)
    cell = catalog.cell(args.workload)
    dev = torch.device("cuda:0")
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(cell, seed, args.seconds, False, t0, dev,
                          with_control=args.control)
        line = {"workload": cell.name, "seed": seed, "correct": res["correct"],
                "metrics": res["metrics"], "info": res["info"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "compared": {k: v["value"] for k, v in res["compared"].items()}}
        if args.control:
            line["control_correct"] = res["control_correct"]
            line["control"] = {k: v["value"] for k, v in res["control_compared"].items()}
        print(json.dumps(line), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
