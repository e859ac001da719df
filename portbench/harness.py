"""One run of one cell: set-up, the measured window, the traced slice,
the comparison, the result line.

Set-up (timed into `setup_s` from process start to the window's first
request): imports, the kernel library (built into the checkout's
`build/repro_torch/` on a first run, loaded after), the data from the
seed, the index in the configuration's state (bulk load, then the
streamed half), and a warm-up of the cell's own shapes only.

With trace 0 the program's observability registry is off and the
window gives the cell's end-to-end metrics. With trace 1 the registry
is on for the window; the per-layer metrics read its counters and spans
over the window, the harness's own timers, and one profiled slice of the
same traffic after the window (one batch, one update cycle, or a few
seconds of arrivals).

After the window: the device's peak memory is read, the program's state
is freed, and the answers are held against the plain reference
(`compare.py`).
"""
from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

from . import catalog, compare, data, devtrace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the program's switches that would change what a configuration states
PROGRAM_ENV = ("REPRO_FUSED_TRAVERSAL", "REPRO_FRONTIER_CAP", "REPRO_QUANT_SLACK",
               "REPRO_BLOCK_PLAN", "REPRO_STORAGE_DTYPE", "REPRO_TORCH_BUILD_DIR")
# seed streams
DATA, WARM, WINDOW, SLICE, SAMPLE = range(5)


def prepare_env(root=catalog.ROOT) -> None:
    """Fixed cache directories inside the checkout; the program's source
    on the path; the program's switches at their defaults."""
    for name in PROGRAM_ENV:
        os.environ.pop(name, None)
    build = os.path.join(root, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(build, "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    src = os.path.join(root, "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


class Env:
    """What the traffic loops need of a run."""

    def __init__(self, cell, dev, seed, wait_s):
        self.cell, self.dev, self.seed, self.wait_s = cell, dev, seed, wait_s
        self.config, self.traffic = cell.config, cell.traffic
        self.log = log
        self.index = self.frontend = None
        self.setup_steps = {}

    def sync(self) -> None:
        if self.dev.type == "cuda":
            import torch

            torch.cuda.synchronize(self.dev)


def query_box(cfg: dict, n: int) -> tuple:
    """(lo, hi, r): the box uniform queries are drawn in and the radius,
    r = the configured fraction of the box's diagonal. Both come from the
    configuration's points drawn from one fixed seed (`box_from_seed`),
    not the run's: the extremes of a sample move with its seed, and with
    them the work."""
    ds = cfg["dataset"]
    ref = data.points(ds["generator"], n, ds["dim"],
                      data.rng_for(cfg["query"]["box_from_seed"], DATA))
    lo, hi = ref.min(0), ref.max(0)
    diag = np.linalg.norm(hi.astype(np.float64) - lo.astype(np.float64))
    return lo, hi, float(cfg["query"]["radius_frac_of_bbox_diagonal"] * diag)


def build_index(env, tmpdir):
    """The configuration's index and state: bulk load, then the streamed
    part in batches, no queries. Fills env's data fields."""
    from repro_torch.core import TreeSpec
    from repro_torch.index import StreamingConfig, StreamingIndex

    cfg = env.config
    ds, ix, dur, st = cfg["dataset"], cfg["index"], cfg["durability"], cfg["initial_state"]
    env.dim = ds["dim"]
    n = st["bulk_load"] + st["stream"]
    pts = data.points(ds["generator"], n, env.dim, data.rng_for(env.seed, DATA))
    env.lo, env.hi, env.r = query_box(cfg, n)
    env.k = int(cfg["query"]["k"])
    spec = TreeSpec.ballstar(leaf_size=ix["leaf_size"])
    idx = StreamingIndex(StreamingConfig(
        dim=env.dim, delta_capacity=ix["delta_capacity"], spec=spec,
        merge_factor=ix["merge_factor"], backend=ix["backend"],
        storage_dtype=ix["storage_dtype"],
        wal_path=os.path.join(tmpdir, "index.wal") if dur["wal"] else None,
        wal_sync=dur["wal_sync"], auto_checkpoint=dur["auto_checkpoint"],
        device=str(env.dev)))
    acct = traffic.Account(env.dim)
    nb = st["bulk_load"]
    t0 = time.perf_counter()
    acct.added(idx.bulk_load(pts[:nb]), pts[:nb])
    env.sync()
    t1 = time.perf_counter()
    for lo in range(nb, len(pts), st["stream_batch"]):
        chunk = pts[lo:lo + st["stream_batch"]]
        acct.added(idx.add(chunk), chunk)
    env.sync()
    env.setup_steps.update(bulk_load_s=t1 - t0, stream_s=time.perf_counter() - t1)
    env.index, env.account = idx, acct


def warm_up(env) -> None:
    """The cell's own shapes once, from a seed stream of their own."""
    import collections

    tr, rng = env.traffic, data.rng_for(env.seed, WARM)
    mode = tr["mode"]
    if mode == "batches":
        q = traffic.make_queries(tr["queries"], tr["batch"], rng, env.lo, env.hi)
        env.index.constrained_knn(q, env.k, env.r)
    elif mode == "updates":
        env.fifo = collections.deque(
            np.concatenate([g for _, g in env.account.events]).tolist())
        traffic.update_batch(env, rng, env.fifo)
        traffic.query_batch(env, rng)
    elif mode == "serve":
        from repro_torch.serve.frontend import FrontendConfig, SearchFrontend

        fe = tr["frontend"]
        env.frontend = SearchFrontend(env.index, FrontendConfig(
            k=env.k, radius=env.r, max_batch=fe["max_batch"],
            max_queue=fe["max_queue"], overload_policy=fe["policy"]))
        env.frontend.start()   # the frontend's own warm-up: every batch class
    else:
        raise ValueError(f"unknown traffic mode {mode!r}")
    env.sync()


def slice_fn(env):
    """One more stretch of the cell's traffic, for the profiler."""
    tr, rng = env.traffic, data.rng_for(env.seed, SLICE)
    mode = tr["mode"]
    if mode == "batches":
        return lambda: traffic.run_batches(env, 0.0, rng)
    if mode == "updates":
        def cycle():
            for _ in range(tr["queries_every"]):
                traffic.update_batch(env, rng, env.fifo)
            traffic.query_batch(env, rng)
        return cycle

    def arrivals():
        secs = float(tr.get("slice_s", 3.0))
        offsets = traffic.arrival_offsets(tr, secs, rng)
        q = traffic.make_queries(tr["queries"], len(offsets), rng, env.lo, env.hi)
        traffic.open_loop(env, offsets, q, env.wait_s)
    return arrivals


def gc_clock():
    """(totals, callback): installed in `gc.callbacks`, the callback sums
    the collector's seconds and collections into totals."""
    acc = {"gc_s": 0.0, "gc_collections": 0}
    began = [0.0]

    def callback(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            acc["gc_s"] += time.perf_counter() - began[0]
            acc["gc_collections"] += 1
    return acc, callback


def host_probe_s() -> float:
    """Seconds of a fixed piece of host work of the program's kind (small
    torch operations on the CPU, then plain Python): how fast this run's
    host was, to set beside its window. It runs after the comparison."""
    import torch

    x = torch.zeros(64)
    t0 = time.perf_counter()
    for _ in range(40000):
        x = x + 1.0
    acc = 0
    for i in range(1000000):
        acc += i & 7
    return time.perf_counter() - t0


def registry_delta(before: dict, after: dict) -> dict:
    """Counters and span seconds accrued in between."""
    c0 = before["counters"]
    out = {"counters": {key: v - c0.get(key, 0) for key, v in after["counters"].items()},
           "span_s": {}}
    h0 = before["histograms"]
    for key, h in after["histograms"].items():
        if key.startswith("span."):
            out["span_s"][key[5:]] = h["sum"] - h0.get(key, {"sum": 0.0})["sum"]
    return out


class Ctx:
    """What the metric readers see."""

    def __init__(self, cell, setup_s, window, registry=None, trace=None):
        self.cell, self.setup_s, self.window = cell, setup_s, window
        self.registry, self.trace = registry, trace


def read_metrics(specs, ctx) -> dict:
    out = {}
    for m in specs:
        v = catalog.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def check(env, win, limits: dict, sample: int, control: bool = False) -> tuple:
    """(correct, compared, rows checked) of the window's answers;
    `control` puts the bfloat16 reference in the program's place."""
    arr = win["answers"].arrays()
    values = {"failed": win["failed"]}
    if "missing_acks" in win:
        values["lost_acks"] = win["missing_acks"]
    if arr is not None:
        q, g, d, pos = arr
        rows = compare.sample_rows(len(q), sample, data.rng_for(env.seed, SAMPLE))
        q, g, d, pos = q[rows], g[rows], d[rows], pos[rows]
        if control:
            g, d = compare.control_answers(env.account, q, pos, env.k, env.r, env.dev)
        values.update(compare.numbers(env.account, q, g, d, pos, env.k, env.r, env.dev))
        values["checked"] = len(q)
    ok, compared = compare.judge(values, limits)
    return ok and arr is not None, compared, values.get("checked", 0)


def traced_calls(sliced) -> dict:
    """Per wrapped kernel: calls, calls whose device time was read, their
    device seconds; beside it the device seconds of the events whose
    name says top-k (a cross-check of the attribution)."""
    out = {}
    for i, call in enumerate(sliced["calls"]):
        acc = out.setdefault(call[0], {"calls": 0, "resolved": 0, "device_s": 0.0})
        acc["calls"] += 1
        if i in sliced["call_device_s"]:
            acc["resolved"] += 1
            acc["device_s"] += sliced["call_device_s"][i]
    out["named_topk_s"] = {n: s for n, s in sliced["device_s_by_name"].items()
                           if "topk" in n}
    return out


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, dev,
        wait_s: float = 60.0, with_control: bool = False) -> dict:
    """One run; returns the result line as a dict. `with_control` adds
    the control's numbers on the same queries under "control_compared"
    (the readings that set the limits; the benchmark's own runs never run
    it). The program's registry is left as it was found."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import cuda_lib, ops

    registry_was_on = obs.REGISTRY.enabled
    (obs.REGISTRY.enable if trace else obs.REGISTRY.disable)()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        cuda_lib.build()
    env = Env(cell, dev, seed, wait_s)
    env.setup_steps["to_index_s"] = time.perf_counter() - t_start
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        build_index(env, tmpdir)
        t0 = time.perf_counter()
        warm_up(env)
        env.setup_steps["warm_up_s"] = time.perf_counter() - t0
        setup_s = time.perf_counter() - t_start
        before = obs.snapshot() if trace else None
        gc_acc, gc_cb = gc_clock()
        gc.callbacks.append(gc_cb)
        cpu0 = time.process_time()
        try:
            win = traffic.WINDOWS[env.traffic["mode"]](
                env, float(seconds), data.rng_for(env.seed, WINDOW))
        finally:
            gc.callbacks.remove(gc_cb)
        win["cpu_s"] = time.process_time() - cpu0
        registry = registry_delta(before, obs.snapshot()) if trace else None
        sliced = devtrace.profiled(slice_fn(env), dev, ops) if trace else None
        env.sync()
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        n_live = env.index.n_live
        if env.frontend is not None:
            env.frontend.stop()
        env.index.close()
        env.index = env.frontend = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ok, compared, checked = check(env, win, cell.limits,
                                      int(cell.check.get("sample", 0)))
        check_s = time.perf_counter() - t0
        probe_s = host_probe_s()
        if with_control:
            control_ok, control_compared, _ = check(
                env, win, cell.limits, int(cell.check.get("sample", 0)), True)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
        (obs.REGISTRY.enable if registry_was_on else obs.REGISTRY.disable)()
    ctx = Ctx(cell, setup_s, win, registry, sliced)
    specs = cell.per_layer if trace else cell.end_to_end
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(ok), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": read_metrics(specs, ctx),
              "device": device}
    if sliced is not None:
        device["busy_s"] = sliced["busy_s"]
        device["window_s"] = sliced["window_s"]
        result["breakdown"] = {"device_ops": sliced["top_ops"],
                               "idle_gaps": sliced["idle_gaps"]}
    result["info"] = {
        "seed": seed, "window_s": win["seconds"], "window_cpu_s": win["cpu_s"],
        **gc_acc, "host_probe_s": probe_s,
        "checked": checked,
        "check_s": check_s, "n_live": n_live, "radius": env.r,
        "setup_steps": env.setup_steps,
        **{key: win[key] for key in ("batches", "update_batches", "queries",
                                     "updates", "requests", "drain_s") if key in win},
        **({"batch_s": [round(x, 4) for x in win["batch_s"]]} if "batch_s" in win else {}),
        **({"query_batch_s": [round(x, 4) for x in win["query_batch_s"]]}
           if "query_batch_s" in win else {}),
        **({"send_lag_ms_max": float(np.max(win["send_lag_ms"], initial=0.0)),
            "errors": win["errors"]} if "send_lag_ms" in win else {}),
        **({"profiled_s": sliced["profiled_s"], "trace_read_s": sliced["read_s"],
            "device_events": sliced["device_events"],
            "unresolved_calls": sliced["unresolved_calls"],
            "traced_calls": traced_calls(sliced),
            "index_events": {key: v for key, v in registry["counters"].items()
                             if key.startswith(("index.seals", "index.merges",
                                                "index.compactions")) and v}}
           if sliced else {}),
    }
    if with_control:
        result["control_compared"] = control_compared
        result["control_correct"] = control_ok
    result["compared"] = compared
    return result


def main(args, t_start: float) -> int:
    """The command line's run on the card."""
    import json

    import torch

    cell = catalog.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, found {torch.cuda.device_count()}")
        return 2
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace), t_start,
                     torch.device("cuda:0"))
    except Exception:
        traceback.print_exc()
        return 1
    # the result's process must not have loaded JAX or the JAX package by
    # the time the window has closed
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package loaded: {found}")
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
