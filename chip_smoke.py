#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. card    — the card's name and power limit (nvidia-smi), then the
               nvcc build of the kernels from `src/repro_torch/kernels/csrc`.
  2. kernels — each hand-written kernel against its plain PyTorch
               version on the card, at the main path's shapes: the top-k
               kernels' (sq, gid, slot) bitwise equal — topk_l2 at both
               of the main path's shapes, Q = 64 (every streaming batch)
               and Q = 5,300 (the final pass), N = 4,096; kernel / plain /
               library times and the bound.
  3. main    — the streaming constrained-kNN path at the paper's scale:
               highleyman 2-D, 500,000 points, 5,300 queries, k = 10,
               r = 5% of the bbox diagonal, ball*-tree leaf_size 32,
               delta_capacity 4096, merge_factor 4, bf16 storage.
               Bulk-load half, stream the rest in batches of 2,000 with a
               64-query batch after each and deletes every 4th batch,
               then answer all 5,300 queries and check them against an
               exact brute scan over the live set; topk_l2's launches by
               query count. The builder's determinism (same points twice
               -> same tree, bitwise) is checked first.
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
                   0.999 against the exact eigenvector; at 4,096 x 2,049
                   and 4,096 x 12,032 (cov_matvec's wide-row route) |cos|
                   > 0.9999 against the same 16 steps in f64; `cov_matvec`
                   (one launch a call) bitwise equal to its plain version
                   at all four shapes, f32 and bf16, and run twice gives
                   the same y bitwise;
               (d) the quickstart's 20,000 points built by the host
                   builder (`core.build(backend="host")`), searched on the
                   card by `core.search`: ids equal to `brute`, node
                   counts equal to `search_host` on 100 queries, and the
                   constrained vs knn-then-filter node counts.
               Then kernel / plain / library times and bounds of both
               primitive kernels.
  5. serve   — the durable serving tier, on the main path's data and
               configuration:
               (a) a WAL in a temporary directory (auto_checkpoint on,
                   wal_sync off); bulk-load 250,000, stream 250,000 in
                   batches of 2,000 with phase 3's deletes and no queries,
                   one checkpoint() midway (the inline-merge stream
                   reaches no compact()/maintain() point, where
                   auto_checkpoint fires); the 5,300 queries; close();
                   then a fresh index on the same files (the recovery):
                   live gid set equal, all 5,300 answers bitwise equal to
                   the pre-close ones, ids equal to the brute referent;
                   inserts/s with the WAL on, recovery seconds,
                   checkpoint loads, WAL records replayed, WAL and
                   checkpoint bytes;
               (b) `SearchFrontend(k=10, r, max_batch=64)` over the
                   recovered index, warmed up; 8 client threads each
                   submit 64 of the queries synchronously: every reply
                   bitwise equal to the direct answer, every dispatch in
                   the pow2 class set; p50 / p99 submit->resolve latency,
                   qps, mean occupancy, dispatches per class, warm-up
                   seconds, phase 1's share of the engine's host time,
                   and the read-path kernels' launches (counted from 0
                   after the warm-up, read after stop()) by call shape;
                   then each of those kernels at every call shape the
                   serving run gave it (Q = 1 and 8 arena scans with
                   their splits and last-block merge, the leaf scans of
                   1- and 8-query dispatches) against its plain version,
                   bitwise, with its times and bound.

Kernel times ("ms") are CUDA-event means over back-to-back eager calls
through the wrapper, what the port pays. For the two launch-bound
kernels (topk_l2, cov_matvec) two more readings stand beside it:
"graph_ms", the device time per call of calls captured in one CUDA
graph and replayed (`time_graph_ms`: the host's enqueue cost left out),
and "host_ms", the wrapper's host time per call (`time_host_ms`); where
host_ms exceeds graph_ms, the eager "ms" is the host's.

The last lines of standard output are a `{"kernels": [...]}` JSON
object, the card's name and power limit, and `{"ok": true, ...}`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
# (N, D), cov_matvec's wide-row route (N, D > 2,048), and the host path's
# point count (the quickstart's)
PAIR_WIDE = (4096, 65536, 128)
COV_WIDE = (100_000, 64)
COV_ROWS = ((4096, 2049), (4096, 12_032))
HOST_POINTS = 20_000
# phase 5: client threads and synchronous requests each
SERVE_CLIENTS, SERVE_PER_CLIENT = 8, 64


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


def time_graph_ms(fn, reps: int = 50, rounds: int = 3) -> float:
    """Mean device milliseconds per call of `fn`: `reps` calls captured
    in one CUDA graph, replayed `rounds` times between two CUDA events —
    the launches back to back on the device, without the host's enqueue
    cost. Two warm-up calls on the capture stream first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (rounds * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def time_host_ms(fn, reps: int = 200) -> float:
    """Mean host milliseconds per call of `fn`: the time the calling
    thread spends enqueuing it (wall clock over `reps` calls, the card
    synchronized before them and after, not between)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return ms


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


def _leaf_case(dev, gen, rows, c, d, kp, name, reps=20):
    """leaf_topk at one shape and storage type, on random candidates
    around random queries with 10% dead slots and the gate r = 0.25:
    (sq, gid, slot) bitwise equal to the plain version (the kernel
    repeats its arithmetic, and the (sq, slot) keys are unique); kernel
    and plain times, the bound."""
    from repro_torch.kernels import topk_l2 as tk

    q = (torch.rand((rows, d), generator=gen, device=dev) * 8.0 - 4.0)
    cands = q[:, None, :] + 0.3 * torch.randn(
        (rows, c, d), generator=gen, device=dev)
    gids = torch.arange(rows * c, device=dev, dtype=torch.int32).reshape(rows, c)
    gids = torch.where(torch.rand((rows, c), generator=gen, device=dev) < 0.1,
                       torch.full_like(gids, -1), gids)
    r_sq = tk.radius_sq_upper(torch.full((rows,), 0.25, device=dev))
    kw = {}
    if name == "int8":
        sc = _pow2_scales(cands, 32)
        store = torch.clamp(torch.round(cands / sc[:, :, None]), -127, 127)
        store = store.to(torch.int8).contiguous()
        kw = {"cscale": sc}
    else:
        store = cands.to(getattr(torch, name)).contiguous()
    args = (q, store, gids, r_sq, kp)
    got = tk.leaf_topk_cuda(*args, **kw)
    want = tk.leaf_topk_plain(*args, **kw)
    torch.cuda.synchronize()
    for what, x, y in zip(("sq", "gid", "slot"), got, want):
        if not torch.equal(x, y):
            bad = (x != y).any(1).nonzero()[:4, 0].tolist()
            raise AssertionError(
                f"leaf_topk[{name}] R={rows} C={c} {what} differs, rows {bad}")
    ms = time_ms(lambda: tk.leaf_topk_cuda(*args, **kw), reps=reps)
    plain_ms = time_ms(lambda: tk.leaf_topk_plain(*args, **kw), reps=3, warmup=1)
    # the bytes and operations the function needs: q, candidates at
    # their storage width (+ int8 scales), gids and gate read once, the
    # (R, k') triple written once (topk_l2.leaf_block_plan)
    plan = tk.leaf_block_plan(rows, c, d, kp, itemsize=store.element_size())
    bound_ms, bound_by = _bound(plan)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "hbm_bytes": plan["hbm_bytes"],
            "max_abs_err": 0.0}


def check_leaf(dev, gen, rows=5300 * 4, c=2048, d=2, kp=18):
    variants = {}
    for name in ("bfloat16", "int8", "float32"):
        v = variants[name] = _leaf_case(dev, gen, rows, c, d, kp, name)
        log(f"kernel leaf_topk[{name}] R={rows} C={c} D={d} k'={kp}: "
            f"kernel_ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} "
            f"bound_ms={v['bound_ms']:.5f} ({v['hbm_bytes']} B) "
            f"outputs bitwise equal to the plain version")
    return variants, 0.0


def check_scan(dev, pts, queries, r, shapes=((64, 4096), (5300, 4096)), k=10,
               label="kernel"):
    """topk_l2 at the main path's shapes — Q = 64 (the 64-query batches
    against the whole 4,096-slot arena) and Q = 5,300 (the final pass) —
    every 7th arena slot tombstoned: (sq, gid, slot) bitwise equal to the
    plain version; kernel (eager, graph-replayed and host), plain and
    library times, the bound."""
    from repro_torch.kernels import topk_l2 as tk

    out = {}
    for nq, n in shapes:
        q = torch.from_numpy(queries[:nq].astype(np.float32)).to(dev)
        p = torch.from_numpy(pts[:n].astype(np.float32)).to(dev)
        gids = torch.arange(n, device=dev, dtype=torch.int32)
        gids[::7] = -1  # tombstoned arena slots
        r_sq = tk.radius_sq_upper(torch.full((nq,), r, device=dev))
        got = tk.topk_cuda(q, p, gids, r_sq, k)
        want = tk.topk_plain(q, p, gids, r_sq, k)
        torch.cuda.synchronize()
        for what, x, y in zip(("sq", "gid", "slot"), got, want):
            if not torch.equal(x, y):
                bad = (x != y).any(1).nonzero()[:4, 0].tolist()
                raise AssertionError(f"topk_l2 Q={nq} {what} differs, rows {bad}")

        def kernel():
            return tk.topk_cuda(q, p, gids, r_sq, k)

        def library():
            return torch.topk(torch.cdist(q, p), k, dim=1, largest=False)

        ms = time_ms(kernel, reps=20)
        graph_ms = time_graph_ms(kernel)
        host_ms = time_host_ms(kernel)
        plain_ms = time_ms(lambda: tk.topk_plain(q, p, gids, r_sq, k),
                           reps=3, warmup=1)
        library_ms = time_ms(library, reps=10)
        # per pair: the expansion form and two compares (gate, k-th key);
        # inputs read once, the (Q, k) triple written once
        plan = tk.block_plan(nq, n, 2, k)
        bound_ms, bound_by = _bound(plan)
        found = int((want[1] >= 0).sum())
        log(f"{label} topk_l2 Q={nq} N={n} D=2 k={k} blocks={plan['blocks']}: "
            f"kernel_ms={ms:.5f} graph_ms={graph_ms:.5f} host_ms={host_ms:.5f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"library_ms={library_ms:.4f}; (sq, gid, slot) bitwise equal to "
            f"the plain version, {found} neighbors found")
        out[f"q{nq}"] = {
            "q": nq, "n": n, "ms": ms, "graph_ms": graph_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "max_abs_err": 0.0,
            "blocks": plan["blocks"],
        }
    return out


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
    by_kernel = {"leaf_topk": ("leaf_topk_kernel",),
                 "topk_l2": ("topk_pnorm_kernel", "topk_scan_kernel")}
    kernels = {name: {"device_ms": 0.0, "launches": 0} for name in by_kernel}
    for ev in device:
        for name, acc in kernels.items():
            if any(k in ev.name for k in by_kernel[name]):
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


def check_referent(res, bd, bg, what):
    """ids equal to the brute referent's, the same fill pattern, and
    distances within 1e-6 of its largest."""
    if not np.array_equal(bg.astype(np.int64), res.gids):
        bad = np.nonzero((bg != res.gids).any(1))[0]
        raise AssertionError(
            f"{what}: {len(bad)} query rows differ from the brute referent, "
            f"e.g. {bad[:3].tolist()}: {res.gids[bad[0]]} vs {bg[bad[0]]}")
    fin = np.isfinite(bd)
    if not np.array_equal(fin, np.isfinite(res.distances)):
        raise AssertionError(f"{what}: fill pattern differs from the brute referent")
    derr = float(np.abs(res.distances[fin] - bd[fin]).max()) if fin.any() else 0.0
    if derr > 1e-6 * float(np.abs(bd[fin]).max()):
        raise AssertionError(f"{what}: distances differ from the referent by {derr}")
    return derr


INGEST_BATCH = 2_000


def ingest(idx, pts, after_bulk=None, after_add=None) -> dict:
    """The main path's ingest, shared by phases 3 and 5: bulk-load the
    first half of `pts`, then stream the rest in batches of INGEST_BATCH;
    after every 4th batch delete a tenth of a batch's count, drawn from
    the live set (rng seed 0). `after_bulk()` runs once after the bulk
    load, `after_add(b, batches)` after batch b's add, before its
    deletes; neither is in the timed insert seconds."""
    n = len(pts)
    n_prefill = n // 2
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    idx.bulk_load(pts[:n_prefill])
    t_bulk = time.perf_counter() - t0
    if after_bulk is not None:
        after_bulk()
    starts = range(n_prefill, n, INGEST_BATCH)
    t_insert, n_deleted = 0.0, 0
    for b, lo in enumerate(starts):
        t0 = time.perf_counter()
        gids = idx.add(pts[lo:lo + INGEST_BATCH])
        torch.cuda.synchronize()
        t_insert += time.perf_counter() - t0
        if after_add is not None:
            after_add(b, len(starts))
        if b % 4 == 3:
            victims = rng.choice(idx.live_gids(), size=len(gids) // 10,
                                 replace=False)
            n_deleted += idx.delete(victims)
    return {"bulk_s": t_bulk, "insert_s": t_insert, "prefill": n_prefill,
            "inserted": n - n_prefill, "deleted": n_deleted,
            "batches": len(starts)}


def run_main(dev, pts, queries, r):
    from repro_torch import obs
    from repro_torch.core import TreeSpec
    from repro_torch.index import StreamingConfig, StreamingIndex
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_l2 as tk

    k, q_batch = 10, 64
    n = len(pts)
    spec = TreeSpec.ballstar(leaf_size=32)
    check_determinism(pts[:n // 2], spec, dev)

    idx = StreamingIndex(StreamingConfig(
        dim=2, delta_capacity=4096, spec=spec, merge_factor=4,
        storage_dtype="bfloat16", device=dev))
    obs.REGISTRY.reset()
    ops.reset_launch_counts()
    lat = []

    def warm_up():
        # one query batch before the timed stream: first-call costs (CUDA
        # context work, the kernel library's load) are set-up, not latency
        t0 = time.perf_counter()
        idx.constrained_knn(queries[:q_batch], k, r)
        log(f"main: first query batch (warm-up) {time.perf_counter() - t0:.3f} s")

    def query_batch(b, _batches):
        off = (b * q_batch) % (len(queries) - q_batch)
        t0 = time.perf_counter()
        idx.constrained_knn(queries[off:off + q_batch], k, r)  # host results
        lat.append(time.perf_counter() - t0)

    ing = ingest(idx, pts, after_bulk=warm_up, after_add=query_batch)
    t_bulk, t_insert, n_inserted = ing["bulk_s"], ing["insert_s"], ing["inserted"]
    log(f"main: bulk_load {ing['prefill']} points in {t_bulk:.3f} s")
    st = idx.stats()
    log(f"main: streamed {n_inserted} points in {len(lat)} batches, "
        f"deleted {ing['deleted']}; segments={st['n_segments']} "
        f"delta_fill={st['delta_fill']} seals={st['seals']} "
        f"merges={st['tiered_merges'] + st['purge_merges']}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = idx.constrained_knn(queries, k, r)
    t_full = time.perf_counter() - t0
    launches = ops.launch_counts()
    by_q = tk.launches_by_q()
    counters = obs.snapshot()["counters"]
    fused_used = counters.get("engine.fused_traversal{kind=used}", 0)
    n_query_batches = len(lat) + 2  # + the warm-up batch and this pass
    log(f"main: {len(queries)} queries in {t_full:.3f} s; launches={launches} "
        f"fused_used={fused_used} fallbacks="
        f"{counters.get('engine.fused_traversal{kind=overflow_fallback}', 0)} "
        f"quant_fallback={counters.get('quantized.rescore{result=fallback}', 0)}")
    log(f"main: topk_l2 device launches by query count {by_q} "
        f"(two per call: the |p|^2 pre-pass and the split scan)")
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
    derr = check_referent(res, bd, bg, "main")
    fin = np.isfinite(bd)
    if not fin.any():
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
        "topk_l2_launches_by_q": by_q,
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
    """Kernel vs plain version at one shape, bitwise, and bitwise
    reproducibility; times (eager, graph-replayed and host) and bound."""
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
    if not torch.equal(y1, want):
        err = float((y1 - want).abs().max())
        raise AssertionError(f"cov_matvec[{name}] != plain version (max {err})")
    ms = time_ms(lambda: cm.cov_matvec_cuda(x, mean, w), reps=reps)
    graph_ms = time_graph_ms(lambda: cm.cov_matvec_cuda(x, mean, w), reps=reps)
    host_ms = time_host_ms(lambda: cm.cov_matvec_cuda(x, mean, w))
    plain_ms = time_ms(lambda: cm.cov_matvec_plain(x, mean, w), reps=3, warmup=1)
    bound_ms, bound_by = _bound(cm.block_plan(n, d, x.element_size()))
    rows, blocks, groups = cm.geometry(n, d)
    log(f"kernel cov_matvec[{name}] N={n} D={d} {x.dtype} route={cm.route(d)} "
        f"blocks={blocks} rows_per_block={rows}, one launch a call: kernel_ms={ms:.5f} "
        f"graph_ms={graph_ms:.5f} host_ms={host_ms:.5f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}); bitwise equal to the plain "
        f"version and across two runs")
    return {"ms": ms, "graph_ms": graph_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "max_abs_err": 0.0, "blocks": blocks, "route": cm.route(d)}


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


def scaled_normal(shape, gen, dev):
    """Normal columns scaled 5, 2, 1, 1, ... (from `gen`): one dominant
    direction for the power iteration."""
    scale = torch.ones(shape[1], device=dev)
    scale[0], scale[1] = 5.0, 2.0
    return torch.randn(shape, generator=gen, device=dev) * scale


def cov_inputs(dev, pts, gen):
    """power_iteration's and cov_matvec's two inputs: the root split (the
    points, 500,000 x 2) and 100,000 x 64 scaled normal columns."""
    x_root = torch.from_numpy(pts.astype(np.float32)).to(dev)
    return x_root, scaled_normal(COV_WIDE, gen, dev)


def power_iteration_f64(x, iters, seed):
    """`ops.power_iteration`'s steps in f64 on the card, from the same
    start vector (a generator seeded `seed`): the yardstick for rows too
    wide for an exact host eigensolver."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    w = torch.randn(x.shape[1], generator=g, device=x.device).double()
    w = w / torch.linalg.vector_norm(w)
    xc = x.double() - x.double().mean(0)
    for _ in range(iters):
        v = xc.T @ (xc @ w)
        w = v / torch.linalg.vector_norm(v)
    return w


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
    x_root, x_wide = cov_inputs(dev, pts, gen)
    gen_rows = torch.Generator(device=dev).manual_seed(1)  # gen's draws as before
    x_rows = {d: scaled_normal((n, d), gen_rows, dev) for n, d in COV_ROWS}
    torch.cuda.synchronize()

    # the path: every call through the public wrappers, counts from 0
    ops.reset_launch_counts()
    lb = ops.lower_bounds(q, centers, radii)
    for a, b in wide.values():
        ops.pairwise_sq_l2(a, b)
    w_root = ops.power_iteration(x_root, iters=16, generator=gen)
    w_wide = ops.power_iteration(x_wide, iters=16, generator=gen)
    w_rows = {d: ops.power_iteration(
        x, iters=16, generator=torch.Generator(device=dev).manual_seed(7))
        for d, x in x_rows.items()}
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
    # rows wider than 2,048 (cov_matvec's wide route): against the same
    # 16 steps in f64 from the same start vector
    for d, x in x_rows.items():
        c = abs(float(torch.dot(w_rows[d].double(), power_iteration_f64(x, 16, 7))))
        cos[f"d{d}_vs_f64_steps"] = c
        if not c > 0.9999:
            raise AssertionError(f"power_iteration[D={d}] |cos| vs f64 steps {c}")
    log(f"primitives: power_iteration on {x_rows[COV_ROWS[0][1]].shape[0]} rows of "
        f"D = {sorted(x_rows)}: |cos| vs the f64 steps "
        f"{[cos[f'd{d}_vs_f64_steps'] for d in sorted(x_rows)]}")
    cov = {"root": check_cov("root", x_root), "wide": check_cov("wide", x_wide),
           "root_bf16": check_cov("root_bf16", x_root.to(torch.bfloat16)),
           "wide_bf16": check_cov("wide_bf16", x_wide.to(torch.bfloat16))}
    for d, x in x_rows.items():
        cov[f"d{d}"] = check_cov(f"d{d}", x, reps=20)
        cov[f"d{d}_bf16"] = check_cov(f"d{d}_bf16", x.to(torch.bfloat16), reps=20)
    del x_rows
    torch.cuda.empty_cache()
    log("primitives: summary " + json.dumps({
        "n_nodes": tree.n_nodes, "lower_bounds_err_vs_plain": lb_err,
        "lower_bounds_err_vs_f64": dn_err, "pairwise": pair,
        "power_iteration_cos": cos, "cov_matvec": cov, "host_path": host,
        "launches": launches}))
    return launches, pair, cov


# -- phase 5: the durable serving tier -------------------------------------------
def run_durable(dev, pts, queries, r, tmp):
    """(a) the main path's ingest with the WAL on, one checkpoint midway,
    the 5,300 queries, close(); then recovery from the files into a fresh
    index, whose answers must equal the pre-close ones bitwise and the
    brute referent's ids. Returns the recovered index and its answers."""
    from repro_torch.core import TreeSpec
    from repro_torch.index import StreamingConfig, StreamingIndex

    k = 10
    n = len(pts)
    cfg = StreamingConfig(
        dim=2, delta_capacity=4096, spec=TreeSpec.ballstar(leaf_size=32),
        merge_factor=4, storage_dtype="bfloat16", device=dev,
        wal_path=os.path.join(tmp, "main.wal"), auto_checkpoint=True)
    idx = StreamingIndex(cfg)
    t_ckpt = None

    def checkpoint_midway(b, batches):
        # the inline-merge stream reaches no compact()/maintain() merge
        # point, where auto_checkpoint fires: one checkpoint on demand
        nonlocal t_ckpt
        if b == batches // 2:
            t0 = time.perf_counter()
            idx.checkpoint()
            t_ckpt = time.perf_counter() - t0

    ing = ingest(idx, pts, after_add=checkpoint_midway)
    t_bulk, t_insert, n_deleted = ing["bulk_s"], ing["insert_s"], ing["deleted"]
    st = idx.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    before = idx.constrained_knn(queries, k, r)
    t_pass = time.perf_counter() - t0
    live_before = idx.live_gids()
    idx.close()
    wal_bytes = os.path.getsize(cfg.wal_path)
    ckpt_bytes = os.path.getsize(cfg.wal_path + ".ckpt")

    t0 = time.perf_counter()
    rec = StreamingIndex(cfg)
    torch.cuda.synchronize()
    t_recover = time.perf_counter() - t0
    rs = rec.stats()
    if not np.array_equal(rec.live_gids(), live_before):
        raise AssertionError("recovered live gid set differs from the pre-close one")
    after = rec.constrained_knn(queries, k, r)
    for what, x, y in (("ids", after.gids, before.gids),
                       ("distances", after.distances, before.distances)):
        if not np.array_equal(x, y):
            bad = np.nonzero((x != y).any(1))[0]
            raise AssertionError(f"recovered {what} differ from the pre-close "
                                 f"answers in {len(bad)} rows, e.g. {bad[:3].tolist()}")
    bd, bg = brute_referent(rec, queries, k, r, dev)
    derr = check_referent(after, bd, bg, "recovered index")
    if rs["checkpoint_loads"] != 1 or rs["wal_replayed"] <= 0:
        raise AssertionError(f"recovery did not read checkpoint + tail: {rs}")
    summary = {
        "n_points": n, "n_deleted": n_deleted, "wal_sync": cfg.wal_sync,
        "bulk_load_s": t_bulk,
        "inserts_per_s_wal_on": ing["inserted"] / t_insert,
        "checkpoint_s": t_ckpt, "queries_5300_s": t_pass,
        "wal_records_written": st["wal_records"],
        "wal_records_truncated": st["wal_records_truncated"],
        "wal_bytes": wal_bytes, "checkpoint_bytes": ckpt_bytes,
        "recovery_s": t_recover, "checkpoint_loads": rs["checkpoint_loads"],
        "wal_records_replayed": rs["wal_replayed"],
        "segments": rs["n_segments"], "n_live": rs["n_live"],
        "max_abs_dist_vs_referent": derr,
    }
    log(f"serve(a): {ing['inserted']} inserts with the WAL on at "
        f"{summary['inserts_per_s_wal_on']:.0f}/s; checkpoint {t_ckpt:.3f} s; "
        f"WAL {wal_bytes} B, checkpoint {ckpt_bytes} B; recovery {t_recover:.3f} s "
        f"(checkpoint loads {rs['checkpoint_loads']}, WAL records replayed "
        f"{rs['wal_replayed']}); live gids equal, {len(queries)} answers bitwise "
        f"equal to the pre-close ones, ids == brute referent")
    log("serve(a): summary " + json.dumps(summary))
    return rec, after, summary


def run_serve(rec, queries, r, direct):
    """(b) `SearchFrontend` over the recovered index: warm-up, then
    SERVE_CLIENTS threads each submitting SERVE_PER_CLIENT of the queries
    synchronously (as `benchmarks/serve_bench.py` does). Every reply must
    equal the index's direct answer bitwise, and every dispatch must lie
    in the pow2 class set. Launch counts are set to 0 after the warm-up
    and read after stop(): live traffic only, one dispatcher thread."""
    import threading

    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_l2 as tk
    from repro_torch.serve.frontend import FrontendConfig, SearchFrontend

    k = 10
    cfg = FrontendConfig(k=k, radius=r, max_batch=64)
    fe = SearchFrontend(rec, cfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fe.start()
    warmup_s = time.perf_counter() - t0
    warm_launches = ops.launch_counts()
    base = {b: fe._c_dispatch[b].value for b in cfg.batch_classes}
    spans = ("search.phase1", "engine.plan", "engine.stack", "engine.dispatch",
             "engine.delta", "engine.merge")

    def span_sums():
        return {name: obs.REGISTRY.histogram(f"span.{name}", unit="s").sum
                for name in spans}

    span0 = span_sums()
    ops.reset_launch_counts()
    n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
    replies = [None] * n_req
    lat_ms = [None] * n_req

    def client(c):
        for i in range(c * SERVE_PER_CLIENT, (c + 1) * SERVE_PER_CLIENT):
            t = time.perf_counter()
            replies[i] = fe.submit(queries[i]).result(600)
            lat_ms[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    fe.stop()
    if any(t.is_alive() for t in threads):
        raise AssertionError("a serving client never finished")
    launches = ops.launch_counts()
    by_q = tk.launches_by_q()
    shapes = dict(tk.LAUNCH_SHAPES)
    span1 = span_sums()
    per_class = {b: fe._c_dispatch[b].value - base[b] for b in cfg.batch_classes}
    n_dispatch = sum(per_class.values())
    for i, reply in enumerate(replies):
        if not (np.array_equal(reply.gids, direct.gids[i])
                and np.array_equal(reply.distances, direct.distances[i])):
            raise AssertionError(f"frontend reply {i} differs from the direct answer: "
                                 f"{reply.gids} vs {direct.gids[i]}")
    if n_dispatch <= 0 or not set(by_q) <= set(cfg.batch_classes):
        raise AssertionError(f"dispatches outside the pow2 classes: {per_class}, "
                             f"topk_l2 launches by Q {by_q}")
    if launches["leaf_topk"] <= 0 or launches["topk_l2"] <= 0:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    lat = np.asarray(lat_ms)
    engine_s = sum(span1[n] - span0[n] for n in spans if n != "search.phase1")
    phase1_s = span1["search.phase1"] - span0["search.phase1"]
    summary = {
        "clients": SERVE_CLIENTS, "requests_per_client": SERVE_PER_CLIENT,
        "requests": n_req, "wall_s": wall, "qps": n_req / wall,
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p99_ms": float(np.percentile(lat, 99)),
        "dispatches": n_dispatch, "dispatches_per_class": per_class,
        "mean_batch_occupancy": n_req / n_dispatch,
        "warmup_s": warmup_s, "warmup_launches": warm_launches,
        "launches": launches, "topk_l2_launches_by_q": by_q,
        "engine_host_s": engine_s, "phase1_host_s": phase1_s,
        "phase1_share_of_engine": phase1_s / engine_s if engine_s else None,
    }
    log(f"serve(b): {n_req} requests from {SERVE_CLIENTS} clients in {wall:.3f} s "
        f"({summary['qps']:.1f} qps), submit->resolve p50 "
        f"{summary['latency_p50_ms']:.3f} ms p99 {summary['latency_p99_ms']:.3f} ms; "
        f"{n_dispatch} dispatches {per_class}, mean occupancy "
        f"{summary['mean_batch_occupancy']:.3f}; warm-up {warmup_s:.3f} s; "
        f"launches {launches}, topk_l2 by Q {by_q}; every reply == the direct answer")
    log("serve(b): summary " + json.dumps(summary))
    return launches, summary, shapes


def check_serve_shapes(dev, pts, queries, r, shapes, launches):
    """(b), then: both read-path kernels at every call shape the serving
    run gave them (`topk_l2.LAUNCH_SHAPES`, read after stop()) against
    their plain versions on the same inputs, bitwise — leaf_topk on
    random candidates at a dispatch's (R, C, D, k', storage), topk_l2 on
    the main path's points and queries at its (Q, N) — with kernel,
    plain and library times and the bound. These launches come after
    the serving run's counts were read. Returns the per-shape readings
    of each kernel."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {"leaf_topk": [], "topk_l2": []}
    for key, n_launch in sorted(shapes.items()):
        if key[0] == "leaf_topk":
            _, rows, c, d, kp, dtype = key
            v = _leaf_case(dev, gen, rows, c, d, kp, dtype, reps=10)
            log(f"serve kernel leaf_topk[{dtype}] R={rows} C={c} D={d} "
                f"k'={kp} ({n_launch} launches): kernel_ms={v['ms']:.5f} "
                f"plain_ms={v['plain_ms']:.4f} bound_ms={v['bound_ms']:.6f}; "
                f"outputs bitwise equal to the plain version")
            out["leaf_topk"].append({"r": rows, "c": c, "d": d, "k": kp,
                                     "dtype": dtype, "launches": n_launch, **v})
        else:
            _, m, n, d, k = key
            if d != pts.shape[1]:
                raise AssertionError(f"topk_l2 served at D={d}, data has "
                                     f"D={pts.shape[1]}")
            # the queries with the most in-radius points of the arena
            # first, so that even Q = 1 fills its k-list across splits
            qa = torch.from_numpy(queries.astype(np.float32)).to(dev)
            pa = torch.from_numpy(pts[:n].astype(np.float32)).to(dev)
            hits = (torch.cdist(qa, pa) <= r).sum(1)
            order = torch.argsort(hits, descending=True, stable=True).cpu().numpy()
            (v,) = check_scan(dev, pts, queries[order], r, shapes=((m, n),), k=k,
                              label=f"serve kernel ({n_launch} launches)").values()
            out["topk_l2"].append({"k": k, "launches": n_launch, **v})
    for name, rows in out.items():
        checked = sum(row["launches"] for row in rows)
        if checked != launches[name] or not rows:
            raise AssertionError(f"{name}: {launches[name]} serving launches, "
                                 f"{checked} of them at checked shapes")
    return out


def main_data():
    """The main path's data: highleyman 500,000 points, 5,300 uniform
    queries, r = 5% of the bbox diagonal."""
    from repro_torch.data.synthetic import highleyman, uniform_queries

    pts = highleyman(500_000, seed=0)
    queries = uniform_queries(pts, 5_300, seed=1)
    return pts, queries, 0.05 * float(np.linalg.norm(pts.max(0) - pts.min(0)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs a card",
              file=sys.stderr)
        return 2
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

    pts, queries, r = main_data()

    gen = torch.Generator(device=dev).manual_seed(0)
    leaf_variants, leaf_err = check_leaf(dev, gen)
    scan = check_scan(dev, pts, queries, r)

    launches = run_main(dev, pts, queries, r)
    prim_launches, pair, cov = run_primitives(dev, pts, queries)
    with tempfile.TemporaryDirectory() as tmp:
        rec, direct, _ = run_durable(dev, pts, queries, r, tmp)
        serve_launches, serve, serve_shapes = run_serve(rec, queries, r, direct)
        rec.close()
    served = check_serve_shapes(dev, pts, queries, r, serve_shapes, serve_launches)

    bf = leaf_variants["bfloat16"]
    kernels = [
        {
            "name": "leaf_topk", "route": "cuda", "source": LEAF_SRC,
            "replaces": LEAF_REPLACES, "launches": launches["leaf_topk"],
            "max_abs_err": leaf_err, "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": None,
            "variants": {**leaf_variants,
                         "serve": {"launches": serve_launches["leaf_topk"],
                                   "shapes": served["leaf_topk"]}},
        },
        {
            # the final pass's shape, Q = 5,300, as in earlier runs; the
            # 64-query batches' shape under variants["q64"]
            "name": "topk_l2", "route": "cuda", "source": LEAF_SRC,
            "replaces": SCAN_REPLACES, "launches": launches["topk_l2"],
            "max_abs_err": 0.0, "ms": scan["q5300"]["ms"],
            "graph_ms": scan["q5300"]["graph_ms"],
            "plain_ms": scan["q5300"]["plain_ms"],
            "bound_ms": scan["q5300"]["bound_ms"],
            "bound_by": scan["q5300"]["bound_by"],
            "library_ms": scan["q5300"]["library_ms"],
            "variants": {**scan, "serve": {
                "launches": serve_launches["topk_l2"],
                "launches_by_q": serve["topk_l2_launches_by_q"],
                "shapes": served["topk_l2"]}},
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
            **({"graph_ms": m["graph_ms"]} if "graph_ms" in m else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
