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
  4. primitives — the public kernel API (`kernels/ops.py`) and the host
               layer, driven once with the launch counts set to 0 just
               before and read just after:
               (a) one ball*-tree over all 500,000 points (the port's
                   builder); `lower_bounds` of the 5,300 queries against
                   every node — the paper's D_N — held against the
                   kernel's plain version and, on 64 sampled rows,
                   against an f64 D_N as `search_host` computes it;
               (b) `pairwise_sq_l2` at M = 4,096, N = 65,536, D = 128,
                   f32 and bf16 — the kernel's wide route, on the tensor
                   cores (3xTF32 for f32) — against the plain version and
                   an f64 product within the expansion ceiling (the
                   paper shape takes the narrow route: bitwise equal);
               (c) `power_iteration` (16 steps) at 500,000 x 2 and at
                   100,000 x 64 (columns scaled 5, 2, 1, ...): |cos| >
                   0.999 against the exact eigenvector; `cov_matvec` run
                   twice gives the same y bitwise;
               (d) the quickstart's 20,000 points built by the host
                   builder (`core.build(backend="host")`), searched on the
                   card by `core.search`: ids equal to `brute`, node
                   counts equal to `search_host` on 100 queries, and the
                   constrained vs knn-then-filter node counts.
               Then kernel / plain / library times and bounds of both
               primitive kernels.

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

# H100 SXM peaks (NVIDIA data sheet, dense): device memory 3.35 TB/s; f32
# outside the tensor cores 67 TFLOP/s; bf16 on the tensor cores with f32
# sums 989 TFLOP/s; TF32 495 TFLOP/s — the rates the bounds below divide
# by. A bf16 × bf16 product is exact in f32, so the tensor cores compute
# the same function where both operands are bf16. An f32 × f32 matrix
# product computed to f32 accuracy has a faster route than the CUDA cores:
# three TF32 products per term (the 3xTF32 split), at 495 / 3 = 165
# TFLOP/s ("f32_product"); it applies to pairwise_sq_l2's operations only,
# the one matrix product here. Any other f32 operand takes the f32 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
                   "f32_product": 495e12 / 3}

LEAF_SRC = "src/repro_torch/kernels/csrc/topk_l2.cu"
LEAF_REPLACES = "src/repro/kernels/topk_l2.py:459"   # _leaf_kernel
SCAN_REPLACES = "src/repro/kernels/topk_l2.py:249"   # _kernel
PAIR_SRC = "src/repro_torch/kernels/csrc/pairwise_l2.cu"
PAIR_REPLACES = "src/repro/kernels/pairwise_l2.py:77"  # _kernel
COV_SRC = "src/repro_torch/kernels/csrc/cov_matvec.cu"
COV_REPLACES = "src/repro/kernels/cov_matvec.py:25"    # _kernel
# phase 4's shapes: the wide pairwise (M, N, D), the wide power iteration
# (N, D), and the host path's point count (the quickstart's)
PAIR_WIDE = (4096, 65536, 128)
COV_WIDE = (100_000, 64)
HOST_POINTS = 20_000


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


def _bound(plan, operands=torch.float32) -> tuple:
    """(bound ms, what bounds it) of a launch plan: the larger of its
    bytes over the memory rate and its operations over the peak rate of
    the type its products take (`operands`: bf16 only where every
    operand of a product is bf16; "f32_product" for the f32 matrix
    product of pairwise_sq_l2, which three TF32 products per term
    compute to f32 accuracy at a third of the TF32 rate)."""
    t_bytes = plan["hbm_bytes"] / HBM_BYTES_PER_S
    t_ops = plan["flops"] / PEAK_FLOP_PER_S[operands]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
        # bitwise: sq, gid and slot (the kernel repeats the plain
        # version's arithmetic, and the (sq, slot) keys are unique)
        for what, x, y in zip(("sq", "gid", "slot"), got, want):
            if not torch.equal(x, y):
                bad = (x != y).any(1).nonzero()[:4, 0].tolist()
                raise AssertionError(f"leaf_topk[{name}] {what} differs, rows {bad}")
        err = 0.0
        ms = time_ms(lambda: tk.leaf_topk_cuda(*args, **kw), reps=20)
        plain_ms = time_ms(lambda: tk.leaf_topk_plain(*args, **kw), reps=3, warmup=1)
        # the bytes and operations the function needs: q, candidates at
        # their storage width (+ int8 scales), gids and gate read once,
        # the (R, k') triple written once (topk_l2.leaf_block_plan)
        plan = tk.leaf_block_plan(rows, c, d, kp, itemsize=itemsize)
        bound_ms, bound_by = _bound(plan)
        variants[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "hbm_bytes": plan["hbm_bytes"], "max_abs_err": err,
        }
        log(f"kernel leaf_topk[{name}] R={rows} C={c} D={d} k'={kp}: "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({plan['hbm_bytes']} B) "
            f"outputs bitwise equal to the plain version")
    return variants, 0.0


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
    bound_ms, bound_by = _bound(tk.block_plan(nq, n, 2, k))
    log(f"kernel topk_l2 Q={nq} N={n} D=2 k={k}: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
        f"library_ms={library_ms:.4f} max_abs_err={err}")
    return {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, "max_abs_err": err,
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


# -- phase 4: the kernel primitives and the host layer ---------------------------
def _expansion_tol(q, p) -> float:
    """Cancellation bound of the expansion form on the square:
    8·2⁻²⁴·(max|q|² + max|p|²)."""
    qf, pf = q.float(), p.float()
    return 8 * 2.0**-24 * float((qf * qf).sum(1).max() + (pf * pf).sum(1).max())


def check_pairwise(name, q, p, reps=10):
    """Kernel vs plain version and vs an f64 product at one shape; the
    route D chose, times and bound. The narrow route must equal the plain
    version bitwise; the wide route (tensor cores) is held to the
    expansion ceiling against it. Against f64, on 64 sampled rows, the
    reference is the plain version's norms (the kernel's, bit for bit)
    with the f64 product q·pᵀ: what the kernel computes differently is
    the cross term, while the norms' own f32 rounding, which both share,
    can pass the ceiling at D = 128 over millions of pairs."""
    from repro_torch.kernels import pairwise_l2 as pw

    d = q.shape[1]
    route = pw.route(d, q.element_size())
    got = pw.pairwise_cuda(q, p)
    want = pw.pairwise_plain(q, p)
    torch.cuda.synchronize()
    tol = _expansion_tol(q, p)
    if route == "cuda_core":
        if not torch.equal(got, want):
            raise AssertionError(f"pairwise_sq_l2[{name}] narrow route != plain")
        err = 0.0
    else:
        err = float((got - want).abs().max())
        if err > tol:
            raise AssertionError(f"pairwise_sq_l2[{name}] err {err} > {tol}")
    del want
    rows = torch.from_numpy(np.random.default_rng(3).choice(
        q.shape[0], 64, replace=False)).to(q.device)
    qs, zero = q[rows], torch.zeros((1, d), device=q.device)
    qn = pw.pairwise_plain(qs, zero)[:, 0].double()  # |q|², the plain order
    pn = pw.pairwise_plain(p, zero)[:, 0].double()
    ref = torch.clamp(qn[:, None] + pn[None, :]
                      - 2.0 * (qs.double() @ p.double().T), min=0.0)
    err64 = float((got[rows].double() - ref).abs().max())
    del got, ref
    if err64 > tol:
        raise AssertionError(f"pairwise_sq_l2[{name}] vs f64: {err64} > {tol}")
    ms = time_ms(lambda: pw.pairwise_cuda(q, p), reps=reps)
    plain_ms = time_ms(lambda: pw.pairwise_plain(q, p), reps=2, warmup=1)
    qf, pf = q.float(), p.float()
    library_ms = time_ms(lambda: torch.cdist(
        qf, pf, compute_mode="use_mm_for_euclid_dist"), reps=reps)
    plan = pw.block_plan(q.shape[0], p.shape[0], d, q.element_size())
    both_bf16 = q.dtype == p.dtype == torch.bfloat16
    bound_ms, bound_by = _bound(
        plan, torch.bfloat16 if both_bf16 else "f32_product")
    out = {"route": route, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "max_abs_err": err,
           "max_abs_err_f64": err64, "tol": tol}
    if not both_bf16:
        # the bound at the CUDA cores' f32 rate, for comparison
        out["bound_ms_f32_rate"] = _bound(plan, torch.float32)[0]
    torch.cuda.empty_cache()
    log(f"kernel pairwise_sq_l2[{name}] M={q.shape[0]} N={p.shape[0]} "
        f"D={d} route={route}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}) library_ms={library_ms:.4f} "
        f"max_abs_err vs plain {err} vs f64 on 64 rows {err64} "
        f"(bound {tol:.3e})")
    return out


def check_cov(name, x, reps=50):
    """Kernel vs plain version at one shape, bitwise reproducibility;
    times and bound."""
    from repro_torch.kernels import cov_matvec as cm

    n, d = x.shape
    mean = x.float().mean(0)
    w = torch.randn(d, generator=torch.Generator(device=x.device).manual_seed(5),
                    device=x.device)
    w = w / torch.linalg.vector_norm(w)
    y1 = cm.cov_matvec_cuda(x, mean, w)
    y2 = cm.cov_matvec_cuda(x, mean, w)
    want = cm.cov_matvec_plain(x, mean, w)
    if not torch.equal(y1, y2):
        raise AssertionError(f"cov_matvec[{name}] differs between two runs")
    diff = (y1 - want).abs()
    err = float(diff.max())
    # per column, the f32 bound of the longest chain of additions in the
    # kernel's sum: 2·chain·2⁻²⁴·(|Xc|ᵀ(|Xc||w|))
    rows, blocks, groups = cm.geometry(n, d)
    chain = rows // groups + groups.bit_length() + blocks + 8 + d
    xc = (x.float() - mean).abs()
    tols = 2 * chain * 2.0**-24 * (xc.T @ (xc @ w.abs()))
    tol = float(tols.min())
    if (diff > tols).any():
        raise AssertionError(f"cov_matvec[{name}] err {err} beyond its bound")
    ms = time_ms(lambda: cm.cov_matvec_cuda(x, mean, w), reps=reps)
    plain_ms = time_ms(lambda: cm.cov_matvec_plain(x, mean, w), reps=3, warmup=1)
    bound_ms, bound_by = _bound(cm.block_plan(n, d, x.element_size()))
    log(f"kernel cov_matvec[{name}] N={n} D={d}: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
        f"max_abs_err={err} (tol {tol:.3e}) two runs bitwise equal")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "max_abs_err": err,
            "tol": tol}


def check_dn_f64(lb, q, tree, rows):
    """lower_bounds on sampled rows vs D_N in f64, as search_host
    computes it: max(0, ||q - c|| - radius). Tolerance per entry: the
    expansion form's bound E on the square, carried through the sqrt
    (min(√E, E/d)), plus the rounding of the f32 sqrt and subtraction."""
    qh = q[rows].double().cpu().numpy()
    c = np.asarray(tree.center, np.float32).astype(np.float64)
    rad = np.asarray(tree.radius, np.float32).astype(np.float64)
    d64 = np.sqrt(((qh[:, None, :] - c[None]) ** 2).sum(-1))
    want = np.maximum(d64 - rad[None], 0.0)
    got = lb[rows].double().cpu().numpy()
    e = 8 * 2.0**-24 * ((qh * qh).sum(1)[:, None] + (c * c).sum(1)[None])
    tol = np.minimum(np.sqrt(e), e / np.maximum(d64, 1e-30))
    tol = tol + 2.0**-22 * (d64 + rad[None])
    err = np.abs(got - want)
    if not (err <= tol).all():
        i = np.unravel_index(np.argmax(err - tol), err.shape)
        raise AssertionError(f"lower_bounds vs f64 D_N: {err[i]} > {tol[i]}")
    return float(err.max())


def host_path(dev):
    """(d): host-built tree, searched on the card, held to brute and to
    search_host's node counts; Table 2's node counts."""
    from repro_torch import core
    from repro_torch.core import TreeSpec, brute, search_host
    from repro_torch.data.synthetic import highleyman, uniform_queries

    pts = highleyman(HOST_POINTS, seed=0).astype(np.float32)
    queries = uniform_queries(pts, 100, seed=1).astype(np.float32)
    k, r = 10, 0.5
    t0 = time.perf_counter()
    tree = core.build(pts, TreeSpec.ballstar(leaf_size=32), backend="host")
    t_build = time.perf_counter() - t0
    res = core.search.search(tree, queries, k, r, device=dev)
    ids = res.indices.cpu().numpy()
    visited = res.nodes_visited.cpu().numpy()
    p64 = pts.astype(np.float64)
    host_c, host_f = [], []
    for i, q in enumerate(queries):
        bi, _ = brute.constrained_knn(p64, q, k, r)
        got = ids[i][ids[i] >= 0]
        if not np.array_equal(got, bi):
            raise AssertionError(f"host tree, query {i}: {got} vs brute {bi}")
        st = search_host.constrained_knn(tree, q, k, r)
        if int(visited[i]) != st.nodes_visited:
            raise AssertionError(
                f"host tree, query {i}: nodes_visited {visited[i]} on the "
                f"card vs {st.nodes_visited} in search_host")
        host_c.append(st.nodes_visited)
        host_f.append(search_host.knn_then_filter(tree, q, k, r).nodes_visited)
    v_c, v_f = float(np.mean(host_c)), float(np.mean(host_f))
    out = {"n_points": len(pts), "n_queries": len(queries), "k": k, "r": r,
           "n_nodes": tree.n_nodes, "build_host_s": t_build,
           "nodes_constrained": v_c, "nodes_knn_then_filter": v_f,
           "node_saving": 1.0 - v_c / v_f}
    log(f"primitives: host-built tree ({tree.n_nodes} nodes, built in "
        f"{t_build:.3f} s) searched on the card: 100 x k={k} ids == brute, "
        f"nodes_visited == search_host; nodes visited constrained {v_c:.1f} "
        f"vs knn-then-filter {v_f:.1f} (-{100 * out['node_saving']:.1f}%)")
    return out


def run_primitives(dev, pts, queries):
    from repro_torch.core import TreeSpec, build, first_component_exact
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    tree = build(pts, TreeSpec.ballstar(leaf_size=32), device=dev)
    log(f"primitives: tree over {len(pts)} points, n_nodes={tree.n_nodes} "
        f"(built in {time.perf_counter() - t0:.3f} s)")
    q = torch.from_numpy(queries.astype(np.float32)).to(dev)
    centers = torch.from_numpy(np.asarray(tree.center, np.float32)).to(dev)
    radii = torch.from_numpy(np.asarray(tree.radius, np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    wm, wn, wd = PAIR_WIDE
    wide = {name: (torch.randn((wm, wd), generator=gen, device=dev).to(dt),
                   torch.randn((wn, wd), generator=gen, device=dev).to(dt))
            for name, dt in (("wide_f32", torch.float32),
                             ("wide_bf16", torch.bfloat16))}
    x_root = torch.from_numpy(pts.astype(np.float32)).to(dev)
    scale = torch.ones(COV_WIDE[1], device=dev)
    scale[0], scale[1] = 5.0, 2.0
    x_wide = torch.randn(COV_WIDE, generator=gen, device=dev) * scale
    torch.cuda.synchronize()

    # the path: every call through the public wrappers, counts from 0
    ops.reset_launch_counts()
    lb = ops.lower_bounds(q, centers, radii)
    for a, b in wide.values():
        ops.pairwise_sq_l2(a, b)
    w_root = ops.power_iteration(x_root, iters=16, generator=gen)
    w_wide = ops.power_iteration(x_wide, iters=16, generator=gen)
    host = host_path(dev)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"primitives: launches={launches}")
    for name in ("pairwise_sq_l2", "cov_matvec"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the path")

    # (a) the paper shape: lower_bounds vs its plain version and f64
    if lb.shape != (len(queries), tree.n_nodes) or not torch.isfinite(lb).all():
        raise AssertionError(f"lower_bounds: bad output {tuple(lb.shape)}")
    from repro_torch.kernels import pairwise_l2 as pw
    plain = torch.clamp(torch.sqrt(pw.pairwise_plain(q, centers))
                        - radii[None, :], min=0.0)
    lb_err = float((lb - plain).abs().max())
    del plain
    # an error e in the square moves the root by at most √e
    if lb_err > _expansion_tol(q, centers) ** 0.5:
        raise AssertionError(f"lower_bounds vs plain: err {lb_err}")
    rows = np.random.default_rng(2).choice(len(queries), 64, replace=False)
    dn_err = check_dn_f64(lb, q, tree, torch.from_numpy(rows).to(dev))
    pruned = float((lb > 0).float().mean())
    del lb
    torch.cuda.empty_cache()
    log(f"primitives: lower_bounds {len(queries)} x {tree.n_nodes} "
        f"(~{4 * len(queries) * tree.n_nodes / 1e9:.2f} GB): max |kernel - "
        f"plain| {lb_err}, max |f32 - f64 D_N| on 64 rows {dn_err}; "
        f"{100 * pruned:.1f}% of (query, node) pairs have D_N > 0")
    pair = {"paper": check_pairwise("paper", q, centers)}
    for name, (a, b) in wide.items():
        pair[name] = check_pairwise(name, a, b)

    # (c) power iteration at both shapes
    cos = {}
    for name, x, w in (("root", x_root, w_root), ("wide", x_wide, w_wide)):
        we = first_component_exact(x.cpu().numpy())
        cos[name] = abs(float(np.dot(w.double().cpu().numpy(), we)))
        if not cos[name] > 0.999:
            raise AssertionError(f"power_iteration[{name}] |cos| {cos[name]}")
    log(f"primitives: power_iteration |cos| vs first_component_exact {cos}")
    cov = {"root": check_cov("root", x_root), "wide": check_cov("wide", x_wide)}
    log("primitives: summary " + json.dumps({
        "n_nodes": tree.n_nodes, "lower_bounds_err_vs_plain": lb_err,
        "lower_bounds_err_vs_f64": dn_err, "pairwise": pair,
        "power_iteration_cos": cos, "cov_matvec": cov, "host_path": host,
        "launches": launches}))
    return launches, pair, cov


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
    prim_launches, pair, cov = run_primitives(dev, pts, queries)

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
    for name, src, replaces, res, main_key in (
        ("pairwise_sq_l2", PAIR_SRC, PAIR_REPLACES, pair, "paper"),
        ("cov_matvec", COV_SRC, COV_REPLACES, cov, "root"),
    ):
        m = res[main_key]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": prim_launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in res.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "variants": res,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
