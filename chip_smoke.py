#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. card    — the card's name and power limit (nvidia-smi), then the
               nvcc build of the kernels from `src/repro_torch/kernels/csrc`.
  2. kernels — each hand-written kernel against its plain PyTorch
               version on the card, at the main path's shapes: ids and
               slots must be equal, squared distances within the stated
               tolerance; kernel / plain / library times and the bound.
  3. main    — the streaming constrained-kNN path at the paper's scale:
               highleyman 2-D, 500,000 points, 5,300 queries, k = 10,
               r = 5% of the bbox diagonal, ball*-tree leaf_size 32,
               delta_capacity 4096, merge_factor 4, bf16 storage.
               Bulk-load half, stream the rest in batches of 2,000 with a
               64-query batch after each and deletes every 4th batch,
               then answer all 5,300 queries and check them against an
               exact brute scan over the live set. The builder's
               determinism (same points twice -> same tree, bitwise) is
               checked first.

The last lines of standard output are a `{"kernels": [...]}` JSON
object, the card's name and power limit, and `{"ok": true, ...}`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): device memory 3.35 TB/s, FP32 outside
# the tensor cores 67 TFLOP/s — the rates the bounds below divide by
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

LEAF_SRC = "src/repro_torch/kernels/csrc/topk_l2.cu"
LEAF_REPLACES = "src/repro/kernels/topk_l2.py:459"   # _leaf_kernel
SCAN_REPLACES = "src/repro/kernels/topk_l2.py:249"   # _kernel


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over `reps` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -- phase 2: kernels vs plain versions ----------------------------------------
def _pow2_scales(c: torch.Tensor, group: int) -> torch.Tensor:
    """Per-candidate pow2 int8 scales, one per run of `group` candidates
    (a leaf), as the int8 encoder makes them."""
    r, n, _ = c.shape
    amax = c.abs().reshape(r, n // group, group * c.shape[2]).amax(-1)
    mant, ex = torch.frexp((amax / 127.0).double())
    sc = torch.exp2(torch.where(mant == 0.5, ex - 1, ex).double())
    sc = torch.where(amax > 0, sc, torch.ones_like(sc)).float()
    return sc.repeat_interleave(group, dim=1).contiguous()


def check_leaf(dev, gen, rows=5300 * 4, c=2048, d=2, kp=18):
    from repro_torch.kernels import topk_l2 as tk

    q = (torch.rand((rows, d), generator=gen, device=dev) * 8.0 - 4.0)
    cands = q[:, None, :] + 0.3 * torch.randn(
        (rows, c, d), generator=gen, device=dev)
    gids = torch.arange(rows * c, device=dev, dtype=torch.int32).reshape(rows, c)
    gids = torch.where(torch.rand((rows, c), generator=gen, device=dev) < 0.1,
                       torch.full_like(gids, -1), gids)
    r = torch.full((rows,), 0.25, device=dev)
    r_sq = tk.radius_sq_upper(r)
    variants = {}
    worst = 0.0
    for name in ("bfloat16", "int8", "float32"):
        if name == "int8":
            sc = _pow2_scales(cands, 32)
            store = torch.clamp(torch.round(cands / sc[:, :, None]), -127, 127)
            store = store.to(torch.int8).contiguous()
            args = (q, store, gids, r_sq, kp)
            kw = {"cscale": sc}
            itemsize = 1
        else:
            dt = getattr(torch, name)
            store = cands.to(dt).contiguous()
            args = (q, store, gids, r_sq, kp)
            kw = {}
            itemsize = store.element_size()
        got = tk.leaf_topk_cuda(*args, **kw)
        want = tk.leaf_topk_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]) or not torch.equal(got[2], want[2]):
            bad = (got[1] != want[1]).any(1).nonzero()[:4, 0].tolist()
            raise AssertionError(f"leaf_topk[{name}] ids/slots differ, rows {bad}")
        fin = torch.isfinite(want[0])
        if not torch.equal(torch.isfinite(got[0]), fin):
            raise AssertionError(f"leaf_topk[{name}] fill pattern differs")
        err = float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() else 0.0
        tol = float((1e-6 * want[0][fin].abs()).max()) if fin.any() else 0.0
        if err > tol:
            raise AssertionError(f"leaf_topk[{name}] sq err {err} > rtol 1e-6")
        worst = max(worst, err)
        ms = time_ms(lambda: tk.leaf_topk_cuda(*args, **kw), reps=20)
        plain_ms = time_ms(lambda: tk.leaf_topk_plain(*args, **kw), reps=3, warmup=1)
        # the bytes and operations the function needs: q, candidates at
        # their storage width (+ int8 scales), gids and gate read once,
        # the (R, k') triple written once (topk_l2.leaf_block_plan)
        plan = tk.leaf_block_plan(rows, c, d, kp, itemsize=itemsize)
        t_bytes = plan["hbm_bytes"] / HBM_BYTES_PER_S
        t_ops = plan["flops"] / FP32_FLOP_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        variants[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "hbm_bytes": plan["hbm_bytes"], "max_abs_err": err,
        }
        log(f"kernel leaf_topk[{name}] R={rows} C={c} D={d} k'={kp}: "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({plan['hbm_bytes']} B) "
            f"max_abs_err={err}")
    return variants, worst


def check_scan(dev, gen, pts, queries, r, nq=5300, n=4096, k=10):
    from repro_torch.kernels import topk_l2 as tk

    q = torch.from_numpy(queries[:nq].astype(np.float32)).to(dev)
    p = torch.from_numpy(pts[:n].astype(np.float32)).to(dev)
    gids = torch.arange(n, device=dev, dtype=torch.int32)
    gids[::7] = -1  # tombstoned arena slots
    r_sq = tk.radius_sq_upper(torch.full((nq,), r, device=dev))
    got = tk.topk_cuda(q, p, gids, r_sq, k)
    want = tk.topk_plain(q, p, gids, r_sq, k)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]) or not torch.equal(got[2], want[2]):
        bad = (got[1] != want[1]).any(1).nonzero()[:4, 0].tolist()
        raise AssertionError(f"topk_l2 ids/slots differ, rows {bad}")
    fin = torch.isfinite(want[0])
    if not torch.equal(torch.isfinite(got[0]), fin):
        raise AssertionError("topk_l2 fill pattern differs")
    err = float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() else 0.0
    # expansion-form bound: 8·2⁻²⁴·(|q|² + |p|²) on the squared distance
    scale = (q * q).sum(1).max() + (p * p).sum(1).max()
    if err > 8 * 2.0**-24 * float(scale):
        raise AssertionError(f"topk_l2 sq err {err} beyond expansion bound")
    ms = time_ms(lambda: tk.topk_cuda(q, p, gids, r_sq, k), reps=20)
    plain_ms = time_ms(lambda: tk.topk_plain(q, p, gids, r_sq, k), reps=3, warmup=1)

    def library():
        return torch.topk(torch.cdist(q, p), k, dim=1, largest=False)

    library_ms = time_ms(library, reps=10)
    # per pair: the expansion form and two compares (gate, k-th key);
    # inputs read once, the (Q, k) triple written once
    plan = tk.block_plan(nq, n, 2, k)
    t_bytes = plan["hbm_bytes"] / HBM_BYTES_PER_S
    t_ops = plan["flops"] / FP32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(f"kernel topk_l2 Q={nq} N={n} D=2 k={k}: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
        f"library_ms={library_ms:.4f} max_abs_err={err}")
    return {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "max_abs_err": err,
    }


# -- phase 3: the main path ------------------------------------------------------
def check_determinism(pts, spec, dev):
    from repro_torch.core import build

    t0 = time.perf_counter()
    a = build(pts, spec, device=dev)
    t1 = time.perf_counter()
    b = build(pts, spec, device=dev)
    for f in ("center", "radius", "child_l", "child_r", "start", "count",
              "points", "perm", "leaf_of_node", "leaf_points", "leaf_index"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"builder not deterministic: field {f}")
    log(f"determinism: two builds of {len(pts)} points identical "
        f"(n_nodes={a.n_nodes}, build_s={t1 - t0:.3f})")


def brute_referent(idx, queries, k, r, dev, chunk=128):
    """Exact constrained k-NN over the live set in the index's own
    arithmetic: segment-resident points by the difference form (the
    leaf kernel's plain version over every live segment point), arena
    points by the topk_l2 kernel's plain version over the snapshot's
    arena, the two parts folded by the engine's merge."""
    from repro_torch.kernels import topk_l2 as tk
    from repro_torch.kernels.ops import _refine
    from repro_torch.query import merge as qmerge

    snap = idx.snapshot()
    seg_parts = [s.live_points() for s in idx.segments]
    sp = torch.from_numpy(np.concatenate([p for p, _ in seg_parts])).to(dev)
    sg = torch.from_numpy(
        np.concatenate([g for _, g in seg_parts]).astype(np.int32)).to(dev)
    out_d, out_g = [], []
    for lo in range(0, len(queries), chunk):
        q = torch.from_numpy(queries[lo:lo + chunk].astype(np.float32)).to(dev)
        nq = q.shape[0]
        rb = torch.full((nq,), r, device=dev)
        r_sq = tk.radius_sq_upper(rb)
        sq, g, _ = tk.leaf_topk_plain(
            q, sp[None].expand(nq, -1, -1), sg[None].expand(nq, -1), r_sq, k)
        parts = [_refine(sq, g, rb)]
        if snap.delta_n_live:
            dsq, dg, _ = tk.topk_plain(q, snap.delta_points, snap.delta_gids,
                                       r_sq, k)
            parts.append(_refine(dsq, dg, rb))
        d, g = qmerge.merge_parts(parts, k)
        out_d.append(d.cpu().numpy())
        out_g.append(g.cpu().numpy())
    return np.concatenate(out_d), np.concatenate(out_g)


SPANS = ("engine.dispatch", "search.phase1", "search.gather", "search.kernel",
         "search.rescore", "search.merge", "engine.stack", "engine.delta",
         "engine.merge")


def profile_pass(fn) -> dict:
    """Run `fn` once under torch.profiler and split it by the index's
    spans: per span name, the host ms of its ranges (profiler overhead
    included) and the device ms of the aten kernels launched inside
    them; per kernel of the port, its device ms and launches; for the
    whole pass, its host ms, the ms the device was busy (union of
    kernel and copy intervals) and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.pass"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = {name: {"host_ms": 0.0, "device_ms": 0.0, "ranges": 0}
             for name in SPANS}
    wall_us = 0.0
    for ev in events:
        if ev.device_type != DeviceType.CPU:
            continue
        if ev.name == "smoke.pass":
            wall_us = ev.time_range.elapsed_us()
        elif ev.name in spans:
            sp = spans[ev.name]
            sp["host_ms"] += ev.time_range.elapsed_us() / 1e3
            sp["device_ms"] += ev.device_time_total / 1e3
            sp["ranges"] += 1
    # device work: kernels, copies and sets — not the device-side images
    # of the host's annotation ranges, which carry the host ranges' names
    host_names = {ev.name for ev in events if ev.device_type == DeviceType.CPU}
    device = [
        ev for ev in events
        if ev.device_type == DeviceType.CUDA and ev.name not in host_names
        and not getattr(ev, "is_user_annotation", False)
    ]
    intervals = [(ev.time_range.start, ev.time_range.end) for ev in device]
    # the profiler links a kernel to its range through the aten op that
    # launched it; the port's kernels launch through ctypes, outside any
    # op, so their time is read from the device events by kernel name
    kernels = {name: {"device_ms": 0.0, "launches": 0}
               for name in ("leaf_topk", "topk_l2")}
    for ev in device:
        for name, acc in kernels.items():
            if f"{name}_kernel" in ev.name:
                acc["device_ms"] += ev.time_range.elapsed_us() / 1e3
                acc["launches"] += 1
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):  # union of the device intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    if not intervals or wall_us <= 0:
        raise AssertionError("the profiler saw no device work in the pass")
    return {
        "spans": spans,
        "kernels": kernels,
        "pass_host_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_events": len(intervals),
    }


def run_main(dev, pts, queries, r):
    from repro_torch import obs
    from repro_torch.core import TreeSpec
    from repro_torch.index import StreamingConfig, StreamingIndex
    from repro_torch.kernels import ops

    k, q_batch, batch = 10, 64, 2_000
    n = len(pts)
    n_prefill = n // 2
    spec = TreeSpec.ballstar(leaf_size=32)
    check_determinism(pts[:n_prefill], spec, dev)

    idx = StreamingIndex(StreamingConfig(
        dim=2, delta_capacity=4096, spec=spec, merge_factor=4,
        storage_dtype="bfloat16", device=dev))
    rng = np.random.default_rng(0)
    obs.REGISTRY.reset()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    idx.bulk_load(pts[:n_prefill])
    t_bulk = time.perf_counter() - t0
    log(f"main: bulk_load {n_prefill} points in {t_bulk:.3f} s")
    # one query batch before the timed stream: first-call costs (CUDA
    # context work, the kernel library's load) are set-up, not latency
    t0 = time.perf_counter()
    idx.constrained_knn(queries[:q_batch], k, r)
    log(f"main: first query batch (warm-up) {time.perf_counter() - t0:.3f} s")

    t_insert = 0.0
    n_inserted = n_deleted = 0
    lat = []
    qi = 0
    for lo in range(n_prefill, n, batch):
        chunk = pts[lo:lo + batch]
        t0 = time.perf_counter()
        gids = idx.add(chunk)
        torch.cuda.synchronize()
        t_insert += time.perf_counter() - t0
        n_inserted += len(chunk)
        off = qi % (len(queries) - q_batch)
        qi += q_batch
        t0 = time.perf_counter()
        idx.constrained_knn(queries[off:off + q_batch], k, r)  # host results
        lat.append(time.perf_counter() - t0)
        if (lo - n_prefill) // batch % 4 == 3:
            live = idx.live_gids()
            victims = rng.choice(live, size=len(gids) // 10, replace=False)
            n_deleted += idx.delete(victims)
    st = idx.stats()
    log(f"main: streamed {n_inserted} points in {len(lat)} batches, "
        f"deleted {n_deleted}; segments={st['n_segments']} "
        f"delta_fill={st['delta_fill']} seals={st['seals']} "
        f"merges={st['tiered_merges'] + st['purge_merges']}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = idx.constrained_knn(queries, k, r)
    t_full = time.perf_counter() - t0
    launches = ops.launch_counts()
    counters = obs.snapshot()["counters"]
    fused_used = counters.get("engine.fused_traversal{kind=used}", 0)
    n_query_batches = len(lat) + 2  # + the warm-up batch and this pass
    log(f"main: {len(queries)} queries in {t_full:.3f} s; launches={launches} "
        f"fused_used={fused_used} fallbacks="
        f"{counters.get('engine.fused_traversal{kind=overflow_fallback}', 0)} "
        f"quant_fallback={counters.get('quantized.rescore{result=fallback}', 0)}")
    if launches["leaf_topk"] <= 0 or launches["topk_l2"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if fused_used <= 0:
        raise AssertionError("the fused traversal never ran")

    # phase split of the same pass, from a profiler trace of it
    obs.REGISTRY.reset()
    split = profile_pass(lambda: idx.constrained_knn(queries, k, r))
    syncs = {key: v for key, v in obs.snapshot()["counters"].items()
             if key.startswith("search.host_syncs")}
    log("main: phase split of one pass (profiled) " + json.dumps(split))
    log("main: host syncs of one pass " + json.dumps(syncs))

    bd, bg = brute_referent(idx, queries, k, r, dev)
    if not np.array_equal(bg.astype(np.int64), res.gids):
        bad = np.nonzero((bg != res.gids).any(1))[0]
        raise AssertionError(
            f"{len(bad)} query rows differ from the brute referent, e.g. "
            f"{bad[:3].tolist()}: {res.gids[bad[0]]} vs {bg[bad[0]]}")
    fin = np.isfinite(bd)
    if not np.array_equal(fin, np.isfinite(res.distances)):
        raise AssertionError("fill pattern differs from the brute referent")
    derr = float(np.abs(res.distances[fin] - bd[fin]).max()) if fin.any() else 0.0
    if derr > 1e-6 * float(np.abs(bd[fin]).max()):
        raise AssertionError(f"distances differ from the referent by {derr}")
    if not np.isfinite(res.distances).any():
        raise AssertionError("no query found a neighbor")
    log(f"main: {len(queries)} x k={k} results == brute referent "
        f"(ids equal, max |dist diff| {derr}), "
        f"{int(fin.sum())} finite neighbors")

    lat_ms = np.asarray(lat) * 1e3
    summary = {
        "n_points": n, "n_queries": len(queries), "k": k, "radius": r,
        "bulk_load_s": t_bulk,
        "inserts_per_s": n_inserted / t_insert if t_insert else None,
        "batch64_p50_ms": float(np.percentile(lat_ms, 50)) if len(lat) else None,
        "batch64_p99_ms": float(np.percentile(lat_ms, 99)) if len(lat) else None,
        "queries_5300_s": t_full,
        "phase_split_profiled": split,
        "host_syncs_one_pass": syncs,
        "launches": launches,
        "query_batches": n_query_batches,
        "stats": {key: st[key] for key in ("n_segments", "seals",
                                           "tiered_merges", "purge_merges")},
    }
    log("main: summary " + json.dumps(summary))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs a card",
              file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import highleyman, uniform_queries
    from repro_torch.kernels import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False  # cdist yardstick in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"card: {card}")
    cuda_lib.build()
    info = cuda_lib.BUILD_INFO
    log(f"build: {info['seconds']:.2f} s -> {info['path']}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("ptxas: " + line.strip())

    pts = highleyman(500_000, seed=0)
    queries = uniform_queries(pts, 5_300, seed=1)
    r = 0.05 * float(np.linalg.norm(pts.max(0) - pts.min(0)))

    gen = torch.Generator(device=dev).manual_seed(0)
    leaf_variants, leaf_err = check_leaf(dev, gen)
    scan = check_scan(dev, gen, pts, queries, r)

    launches = run_main(dev, pts, queries, r)

    bf = leaf_variants["bfloat16"]
    kernels = [
        {
            "name": "leaf_topk", "route": "cuda", "source": LEAF_SRC,
            "replaces": LEAF_REPLACES, "launches": launches["leaf_topk"],
            "max_abs_err": leaf_err, "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": None, "variants": leaf_variants,
        },
        {
            "name": "topk_l2", "route": "cuda", "source": LEAF_SRC,
            "replaces": SCAN_REPLACES, "launches": launches["topk_l2"],
            "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
            "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
            "bound_by": scan["bound_by"], "library_ms": scan["library_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
