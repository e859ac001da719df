"""Find the highest rate the serving cell's frontend sustains: one index
in the configuration's state, one frontend, open-loop Poisson arrivals at
each rate in turn.

    python3 portbench/tools/sweep.py --workload hl2d-serve \
        --rates 20,40,60,80 --seconds 15 --seed 5

Per rate, one JSON line: requests, p50 / p95 / max latency, the mean
latency of the first and the last third of the requests, and how long
the replies took to drain after the last send. A backlog that grows
through the run shows as a last third far slower than the first and a
drain of seconds. The knee is the highest rate without one.
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
    p.add_argument("--workload", default="hl2d-serve")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from portbench import catalog, data, harness, traffic

    harness.prepare_env(ROOT)
    from repro_torch import obs
    from repro_torch.kernels import cuda_lib

    obs.REGISTRY.disable()
    cuda_lib.build()
    cell = catalog.cell(args.workload)
    dev = torch.device("cuda:0")
    env = harness.Env(cell, dev, args.seed, 60.0)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        harness.build_index(env, tmp)
        harness.warm_up(env)
        print(json.dumps({"setup_s": time.perf_counter() - T_START}), flush=True)
        rng = data.rng_for(args.seed, 99)
        for rate in (float(r) for r in args.rates.split(",")):
            tr = dict(env.traffic, rate_per_s=rate)
            offsets = traffic.arrival_offsets(tr, args.seconds, rng)
            q = traffic.make_queries(tr["queries"], len(offsets), rng, env.lo, env.hi)
            out = traffic.open_loop(env, offsets, q, 60.0)
            lat = out["latency_ms"]
            third = max(1, len(lat) // 3)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(lat), "failed": int((~out["ok"]).sum()),
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                "max_ms": float(lat.max()), "first_third_mean_ms": float(lat[:third].mean()),
                "last_third_mean_ms": float(lat[-third:].mean()),
                "drain_s": out["t_end"] - (out["t0"] + offsets[-1]),
                "send_lag_max_ms": float(out["send_lag_ms"].max())}), flush=True)
        env.frontend.stop()
        env.index.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
