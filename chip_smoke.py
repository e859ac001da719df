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
               library times and the bound. (b) the sort route of both
               top-k kernels (k above the list route's 1,024): a
               streaming index on the card (50,000 + 3,000 points, bf16
               storage) answers 64 queries at k = 2,000 (launch counts
               set to 0 just before, read just after), ids equal to the
               brute referent; the fused traversal and both sort routes
               must run; each call shape against the plain version,
               bitwise, timed beside its bound.
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
  6. distributed — the distributed index on the main path's data, four
               shards on the card, launch counts set to 0 before (a) and
               read after (c); phase 3's index, flushed and answered
               first, outside the count, is the single-device referent:
               (a) `build_sharded` over the 500,000 points and
                   `constrained_knn` of the 5,300 queries (the four trees
                   in one stacked walk), ids == a brute referent;
                   `brute_constrained_knn` over 499,998 points (topk_l2
                   at Q = 5,300, N = 125,000 a shard), ids == a brute
                   referent; build, query and brute seconds;
               (b) `ShardedStreamingIndex(n_shards=4)` with four WALs:
                   phase 3's ingest without queries (one checkpoint
                   midway), 16 timed batches of 64 queries, the 5,300
                   queries (ids == a brute referent over its live set,
                   and a pass's host time split by span, `shard.fold`
                   among them), then flushed: answers bitwise equal to the
                   flushed single-device index; inserts/s, p50 / p99,
                   pass seconds, stack-cache builds over the batches;
               (c) shard 1 down (`shard.search` armed): a flagged partial
                   answer without its gids, the full answer's other ids
                   in order, one failover counted; close, reopen from the
                   WALs: live gids equal, answers bitwise equal to the
                   pre-close ones; recovery seconds;
               (d) both read-path kernels at every call shape (a)–(c)
                   launched them against their plain versions, bitwise,
                   with times and bounds (as phase 5 (b)).

  7. knnlm   — the kNN-LM serving path: qwen2-0.5b at its full published
               width (24 layers, d = 896, 494,032,768 parameters) with
               random weights from a seeded generator. First the serve
               launcher (`repro_torch.launch.serve --retrieval`) runs
               once; then the launch counts are set to 0 and:
               (a) the model on the card, its parameter count; the same
                   weights on the CPU: logits of a 64-token prompt, card
                   against CPU; prefill(2,048) + 3 decode steps against
                   forward(2,051) (three 1,024-chunks, the multi-chunk
                   online softmax), within the reference's tolerance;
               (b) `Engine.generate`, batch 4, 32-token prompts, 16 new
                   tokens: greedy twice equal, two sampled requests
                   differ, a seeded generator reproduces its draw;
                   prefill ms, decode ms per token, tokens/s;
               (c) a Datastore of 262,144 states (64 token batches of
                   4 x 1,024: forward logits projected to 32-d, the next
                   tokens as values; leaf_size 64, delta_capacity 256);
                   3 decode steps (KNNLM_STEPS), each a `lookup` (k = 8,
                   r = 0.6 x |std(keys)|), `knn_interpolate` (rows sum
                   to 1) and an `add` of the step's states; every
                   lookup's valid pattern, distances and values == a
                   brute referent over the live set (exact duplicate
                   keys may tie); then the added states evicted and all
                   12 queries looked up and checked again; build
                   seconds, lookups/s, the engine's fused / fallback
                   dispatches, launches by call shape;
               (d) both read-path kernels, D = 32 (their generic
                   routes), against their plain versions, bitwise, with
                   times and bounds: topk_l2 at every call shape (c)
                   launched; leaf_topk, which (c) does not launch (its
                   lookups overflow the fused traversal's frontier cap
                   and take the classic loop), at the shape the fused
                   path would give it.
  8. moe     — the MoE and MLA layers, with random weights from seeded
               generators; phase 7's model freed first. cuBLAS sums bf16
               products in f32 in this phase (no bf16 split-K reduction),
               as the reference's products do. The launch counts are set
               to 0 before (a) and read after (e):
               (a) deepseek-v2-lite-16b at its full published width and
                   depth (27 layers: MLA throughout, a dense first FFN,
                   26 MoE FFNs of 64 routed experts, top-6, 2 shared;
                   15,706,484,224 parameters, 2,661,150,208 active) on the
                   card: parameter count, weight and peak memory;
                   `Engine.generate` at the launcher's defaults (batch 4,
                   32-token prompts, 16 new tokens), greedy twice equal;
                   prefill ms and decode ms per token beside their bounds
                   (every expert's weights are read each step), tokens/s;
                   one decode step profiled: device events by class
                   (products, MoE dispatch, the rest), busy ms, idle share;
               (b) its first 3 layers (the dense one and two MoE layers)
                   on the card and, copied, on the CPU: forward and
                   prefill of 63 tokens (one dispatch group, C = 8: tokens
                   drop) and 3 decode steps; max |err| and argmax
                   agreement, each MoE call's dropped count equal on both,
                   tokens whose experts differ counted;
               (c) prefill(2,048) + 3 decode steps against forward(2,051)
                   at full depth, with the capacity factor n_experts /
                   top_k so that no assignment drops (0 dropped checked);
               (d) phi3.5-moe at full width, 4 of its 32 layers: card
                   against CPU as in (b), and `Engine.generate`;
               (e) the serve launcher (`--arch deepseek-v2-lite-16b
                   --smoke --retrieval`), its launch counts and the
                   lookup's dispatch kind.
  9. recurrent — the recurrent mixers (RG-LRU; mLSTM / sLSTM), with
               random weights from seeded generators; phase 8's models
               freed first, bf16 split-K reduction off as in phase 8. The
               launch counts are set to 0 before (a) and read after (e):
               (a) recurrentgemma-9b at its full published width and
                   depth (38 layers: 26 RG-LRU, 12 local MQA attention,
                   window 2,048, one KV head, head_dim 256; d = d_rnn =
                   4,096, vocab 256,000, untied; 9,627,095,040
                   parameters): parameter count, weight and peak memory;
                   `Engine.generate` at the launcher's defaults, greedy
                   twice equal; prefill ms and decode ms per token beside
                   their bounds, tokens/s; one decode step profiled:
                   device events by class, busy ms, idle share;
               (b) its first 3 layers (rglru, rglru, attn) on the card
                   and, copied, on the CPU: forward and prefill of 63
                   tokens and 3 decode steps, max |err| and argmax
                   agreement, within the reference's tolerance;
               (c) prefill(2,048) + 3 decode steps against forward(2,051)
                   at full depth, batch 1: the attention's rolling buffer
                   (T = 2,048) wraps at the first decode, the RG-LRU
                   states and conv windows carry across;
               (d) xlstm-125m whole (12 layers: 9 mLSTM, 3 sLSTM, d = 768,
                   tied, no FFN): card against CPU as in (b), held layer
                   by layer on the card's input (each layer's output and
                   the logits; end to end a one-ulp change moves its
                   random-weight logits by ~0.5, on the CPU alone too:
                   printed, with the CPU's spread between thread counts);
                   prefill(2,048) + 3 decode steps against forward(2,304)
                   (9 mLSTM chunks of 256; positions 2,047-2,050);
                   `Engine.generate`, greedy twice equal, decode ms per
                   token;
               (e) the serve launcher (`--arch xlstm-125m --smoke
                   --retrieval`), its launch counts and the lookup's
                   dispatch kind.
  10. train  — training on the card, launch counts set to 0 before (a)
               and read after (d) (the path reaches no kernel):
               (a) qwen2-0.5b at full width and depth, f32 master
                   weights, AdamW, remat "full", batch 4 x 2,048 from
                   `data/tokens`: 2 warm-up and 5 timed steps; losses
                   (finite, the timed mean below the first), step
                   seconds, tokens/s, peak memory, the share of the
                   dense bf16 rate (`train_flops`), one step profiled;
               (b) its first 3 layers with the tied embedding, the same
                   f32 weights and batch (1 x 2,048) on the card and the
                   CPU: loss, every gradient, the card's AdamW on the
                   CPU's gradients, and every parameter's first AdamW
                   update within the stated tolerances;
               (c) xlstm-125m whole at examples/train_lm.py's batch
                   (8 x 256), under deterministic algorithms: 6 steps
                   with a checkpoint every 3, then a failure injected at
                   step 4 and a resume whose parameters and moments equal
                   the uninterrupted run's bitwise; the uninterrupted run
                   continued from its step-6 checkpoint to 20 steps (one
                   schedule for all), whose loss falls (mean of the last
                   5 below the first 5);
               (d) `launch/train.main --smoke` on the card for
                   deepseek-v2-lite-16b (MLA + MoE) and recurrentgemma-9b
                   (RG-LRU + local attention), reduced: neither fits one
                   card for training whole.
                   (a)'s last step runs alone under
                   `reset_peak_memory_stats()`: its peak is phase 11's
                   referent.
  11. accounting — the accounting tier (`kernels/autotune`, `obs/export`,
               `launch/dryrun`):
               (a) topk_l2 at phase 2's shapes (Q = 64 and 5,300, N =
                   4,096, k = 10) under the autotuner's three best-ranked
                   splits and today's `scan_geometry` split: bitwise equal
                   to the plain version, eager and graph ms beside the
                   model's prediction; the tuned split at most 10% slower
                   than today's, or today's;
               (b) (run at the end of phase 3, before its profiled pass)
                   `obs.export.to_payload()`: its autotune keys and its
                   quantized section, whose bf16 record shows a reduction
                   factor of 2.0 and both rescore outcomes; `dump_json`
                   read back equal;
               (c) `launch/dryrun.run_cell` of phase 10's cell (qwen2-0.5b,
                   train 4 x 2,048, remat "full", AdamW) on meta tensors:
                   its counted peak within 10% of the last step's
                   `max_memory_allocated()`, its product FLOPs 1.0-1.5x
                   `train_flops`, both ratios printed; then the decode_32k
                   cell of qwen2-0.5b, deepseek-v2-lite-16b,
                   recurrentgemma-9b and xlstm-125m at the published size,
                   one line each.

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

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
# before torch makes its first cuBLAS handle: a fixed workspace, so that
# cuBLAS is deterministic where phase 10 (c) asks for deterministic
# algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks: the package's envelope, `kernels/autotune` (NVIDIA's data
# sheet, dense): device memory 3.35 TB/s; f32 outside the tensor cores 67
# TFLOP/s; bf16 on the tensor cores with f32 sums 989 TFLOP/s; TF32 495
# TFLOP/s — the rates the bounds below divide by. A bf16 × bf16 product is
# exact in f32, so the tensor cores compute the same function where both
# operands are bf16. An f32 × f32 matrix product computed to f32 accuracy
# has a faster route than the CUDA cores: three TF32 products per term
# (the 3xTF32 split), at 495 / 3 = 165 TFLOP/s ("f32_product"); it applies
# to pairwise_sq_l2's operations only, the one matrix product here. Any
# other f32 operand takes the f32 rate. Read where used, not at import,
# so that a tool can point `repro_torch` at another source tree first.
def envelope() -> tuple:
    """(device memory bytes/s, peak operations/s by operand type)."""
    from repro_torch.kernels import autotune

    return autotune.HBM_BW, autotune.PEAK_FLOPS


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
    hbm, peak = envelope()
    t_bytes = plan["hbm_bytes"] / hbm
    t_ops = plan["flops"] / peak[operands]
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
    around random queries (their distances spread alike at any D) with
    10% dead slots and the gate r = 0.25:
    (sq, gid, slot) bitwise equal to the plain version (the kernel
    repeats its arithmetic, and the (sq, slot) keys are unique); kernel
    and plain times, the bound."""
    from repro_torch.kernels import topk_l2 as tk

    q = (torch.rand((rows, d), generator=gen, device=dev) * 8.0 - 4.0)
    # the same spread of distances at any D (0.3 a coordinate at D = 2)
    cands = q[:, None, :] + 0.3 * (2.0 / d) ** 0.5 * torch.randn(
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
    or at `shapes` over `pts` of any D, every 7th arena slot tombstoned:
    (sq, gid, slot) bitwise equal to the
    plain version (over blocks of query rows where Q·N passes 2²⁸: each
    row's selection is its own); kernel (eager, graph-replayed and host),
    plain and library times, the bound."""
    from repro_torch.kernels import topk_l2 as tk

    out = {}
    for nq, n in shapes:
        q = torch.from_numpy(queries[:nq].astype(np.float32)).to(dev)
        p = torch.from_numpy(pts[:n].astype(np.float32)).to(dev)
        gids = torch.arange(n, device=dev, dtype=torch.int32)
        gids[::7] = -1  # tombstoned arena slots
        r_sq = tk.radius_sq_upper(torch.full((nq,), r, device=dev))
        big = nq * n > 1 << 28

        def plain():
            if not big:
                return tk.topk_plain(q, p, gids, r_sq, k)
            step = max(1, (1 << 26) // n)
            parts = [tk.topk_plain(q[i:i + step], p, gids, r_sq[i:i + step], k)
                     for i in range(0, nq, step)]
            return tuple(torch.cat(x) for x in zip(*parts))

        got = tk.topk_cuda(q, p, gids, r_sq, k)
        want = plain()
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
        plain_ms = time_ms(plain, reps=1 if big else 3, warmup=1)
        library_ms = time_ms(library, reps=10)
        # per pair: the expansion form and two compares (gate, k-th key);
        # inputs read once, the (Q, k) triple written once
        d = p.shape[1]
        plan = tk.block_plan(nq, n, d, k)
        bound_ms, bound_by = _bound(plan)
        found = int((want[1] >= 0).sum())
        log(f"{label} topk_l2 Q={nq} N={n} D={d} k={k} blocks={plan['blocks']}: "
            f"kernel_ms={ms:.5f} graph_ms={graph_ms:.5f} host_ms={host_ms:.5f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"library_ms={library_ms:.4f}; (sq, gid, slot) bitwise equal to "
            f"the plain version, {found} neighbors found")
        out[f"q{nq}"] = {
            "q": nq, "n": n, "d": d, "ms": ms, "graph_ms": graph_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "max_abs_err": 0.0,
            "blocks": plan["blocks"],
        }
    return out


# phase 2 (b): the top-k kernels' sort route on the streaming path: k above
# the list route's 1,024 (topk_l2._MAX_K), at bf16 storage k' = k + 8 in
# the leaf kernel; a 50,000-point index (leaf_size 32) with 3,000 points
# in its delta arena, 64 queries at half the main path's radius, whose
# leaf frontiers stay within the fused traversal's cap of 64
LARGE_K = 2000
LARGE_K_POINTS = (50_000, 3_000)


def run_large_k(dev, pts, queries, r):
    """Phase 2 (b): a streaming index on the card answers 64 queries at k =
    2,000 (launch counts set to 0 just before, read just after): ids equal
    to the brute referent's; the fused traversal answers them (one leaf
    launch a class) and both kernels take the sort route; then each call
    shape against the plain version, bitwise, with times and bounds."""
    from repro_torch import obs
    from repro_torch.core import TreeSpec
    from repro_torch.index import StreamingConfig, StreamingIndex
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_l2 as tk

    n_bulk, n_delta = LARGE_K_POINTS
    rr = r / 2
    idx = StreamingIndex(StreamingConfig(
        dim=2, delta_capacity=4096, spec=TreeSpec.ballstar(leaf_size=32),
        merge_factor=4, storage_dtype="bfloat16", device=dev))
    idx.bulk_load(pts[:n_bulk])
    idx.add(pts[n_bulk:n_bulk + n_delta])
    q = queries[:64]
    fused = obs.REGISTRY.counter("engine.fused_traversal", kind="used")
    used0 = fused.value
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = idx.constrained_knn(q, LARGE_K, rr)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = tk.launches_by_route()
    shapes = dict(tk.LAUNCH_SHAPES)
    bd, bg = brute_referent(idx, q, LARGE_K, rr, dev)
    check_referent(res, bd, bg, "large-k")
    found = int((res.gids >= 0).sum())
    if fused.value == used0 or any(routes[n]["sort"] == 0 for n in routes):
        raise AssertionError(f"large-k: the fused path or a sort route was not "
                             f"taken: {json.dumps(routes)}")
    log(f"large-k: {n_bulk} + {n_delta} points, 64 queries, k={LARGE_K}, "
        f"r={rr:.6f}: {seconds:.3f} s, {found} neighbors, ids == brute "
        f"referent; launches by route {json.dumps(routes)}")
    checked = check_serve_shapes(dev, pts, q, rr, shapes, launches, label="large-k")
    del idx
    return routes, checked, {"seconds": seconds, "found": found}


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


def _live_parts(idx):
    """The live points of a single-device or sharded index, with global
    ids, as the index holds them: (segment points, segment gids) on the
    host, and each delta arena's (points, gids) tensors on its device."""
    if hasattr(idx, "shards"):  # sharded: local ids through g_of[s]
        snap = idx.snapshot()
        seg, arenas = [], []
        for s, (sub, sub_snap) in enumerate(zip(idx.shards, snap.shards)):
            g_of = snap.g_of[s]
            seg += [(p, g_of[g]) for p, g in (v.live_points() for v in sub.segments)]
            if sub_snap.delta_n_live:
                dg = sub_snap.delta_gids.long()
                table = torch.from_numpy(g_of).to(dg.device)
                glob = torch.where(dg >= 0, table[dg.clamp(min=0)], -1)
                arenas.append((sub_snap.delta_points, glob.to(torch.int32)))
        return seg, arenas
    snap = idx.snapshot()
    arenas = ([(snap.delta_points, snap.delta_gids)] if snap.delta_n_live else [])
    return [s.live_points() for s in idx.segments], arenas


def brute_referent(idx, queries, k, r, dev):
    """Exact constrained k-NN over the live set of a single-device or a
    sharded index, in the index's own arithmetic (`referent`): its
    segments' live points by the difference form, each delta arena by
    the expansion form."""
    seg_parts, arenas = _live_parts(idx)
    return referent(np.concatenate([p for p, _ in seg_parts]),
                    np.concatenate([g for _, g in seg_parts]),
                    arenas, queries, k, r, dev)


def referent(seg_pts, seg_gids, arenas, queries, k, r, dev, chunk=128):
    """Exact constrained k-NN by brute force: the points (seg_pts,
    seg_gids) by the difference form (the leaf kernel's plain version, as
    a tree's leaf scans compute it), each (points, gids) tensor pair of
    `arenas` by the expansion form (the topk_l2 kernel's plain version,
    as an arena or a brute scan computes it), the parts folded by the
    engine's merge; `seg_pts` None: arenas only."""
    from repro_torch.kernels import topk_l2 as tk
    from repro_torch.kernels.ops import _refine
    from repro_torch.query import merge as qmerge

    if seg_pts is not None:
        sp = torch.from_numpy(np.asarray(seg_pts, np.float32)).to(dev)
        sg = torch.from_numpy(np.asarray(seg_gids).astype(np.int32)).to(dev)
    out_d, out_g = [], []
    for lo in range(0, len(queries), chunk):
        q = torch.from_numpy(queries[lo:lo + chunk].astype(np.float32)).to(dev)
        nq = q.shape[0]
        rb = torch.full((nq,), r, device=dev)
        r_sq = tk.radius_sq_upper(rb)
        parts = []
        if seg_pts is not None:
            sq, g, _ = tk.leaf_topk_plain(
                q, sp[None].expand(nq, -1, -1), sg[None].expand(nq, -1), r_sq, k)
            parts.append(_refine(sq, g, rb))
        for ap, ag in arenas:
            dsq, dg, _ = tk.topk_plain(q, ap, ag, r_sq, k)
            parts.append(_refine(dsq, dg, rb))
        d, g = qmerge.merge_parts(parts, k)
        out_d.append(d.cpu().numpy())
        out_g.append(g.cpu().numpy())
    return np.concatenate(out_d), np.concatenate(out_g)


SPANS = ("engine.dispatch", "search.phase1", "search.gather", "search.kernel",
         "search.rescore", "search.merge", "engine.stack", "engine.delta",
         "engine.merge", "shard.fold")


def profile_pass(fn, classes=None) -> dict:
    """Run `fn` once under torch.profiler and split it by the index's
    spans: per span name, the host ms of its ranges (profiler overhead
    included) and the device ms of the aten kernels launched inside
    them; per kernel of the port, its device ms and launches; for the
    whole pass, its host ms, the ms the device was busy (union of
    kernel and copy intervals) and the device's idle share. `classes`
    ({class: name substrings}) also sums the device events' ms and count
    by the first class whose substring their name holds ("other" for
    none), and lists the 8 device event names that took the most time."""
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
    by_class, by_name = {}, {}
    for ev in device if classes else ():
        name = next((c for c, subs in classes.items()
                     if any(sub in ev.name for sub in subs)), "other")
        for acc in (by_class.setdefault(name, {"device_ms": 0.0, "events": 0}),
                    by_name.setdefault(ev.name[:80], {"device_ms": 0.0, "events": 0})):
            acc["device_ms"] += ev.time_range.elapsed_us() / 1e3
            acc["events"] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms"])[:8]
    return {
        "by_class": by_class,
        "top_events": dict(top),
        "spans": spans,
        "kernels": kernels,
        "pass_host_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_events": len(intervals),
    }


def span_sums(names) -> dict:
    """Host seconds recorded so far under each span name (the obs
    registry's `span.<name>` histograms)."""
    from repro_torch import obs

    return {name: obs.REGISTRY.histogram(f"span.{name}", unit="s").sum
            for name in names}


def span_split(fn) -> dict:
    """Run `fn` once, unprofiled, and split its host time by the index's
    spans (nested spans count inside their parents, as in
    `profile_pass`): seconds of the run and of each span within it.
    Cheap where the profiler is not: its trace of a four-shard pass is
    slow to read."""
    s0 = span_sums(SPANS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s1 = span_sums(SPANS)
    return {"pass_s": wall, "span_s": {n: s1[n] - s0[n] for n in SPANS}}


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
    exported = check_export()

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
    return launches, idx, exported


def check_export() -> dict:
    """Phase 11 (b), run at the end of phase 3 before its profiled pass
    resets the registry: `obs.export.to_payload()` of the streaming run —
    its `autotune` decisions and its `quantized` section, whose bf16
    record must show the stream halved (reduction factor 2.0) and both
    rescore outcomes (phase 3 streams bf16 and falls back to f32) — and
    the payload written by `dump_json` and read back equal."""
    from repro_torch.obs import export

    payload = json.loads(json.dumps(export.to_payload()))
    with tempfile.TemporaryDirectory() as tmp:
        back = export.load_json(export.dump_json(os.path.join(tmp, "BENCH_obs.json")))
    payload.pop("generated_unix")
    back.pop("generated_unix")
    if back != payload:
        raise AssertionError("accounting(b): the payload read back differs")
    bf = payload["quantized"].get("bfloat16")
    if (bf is None or bf["reduction_factor"] != 2.0 or bf["rescore_exact"] <= 0
            or bf["rescore_fallback"] <= 0):
        raise AssertionError(f"accounting(b): quantized section {payload['quantized']}")
    log(f"accounting(b): obs payload of phase 3: autotune keys "
        f"{sorted(payload['autotune'])}; quantized {json.dumps(payload['quantized'])}; "
        f"dump_json / load_json round trip equal")
    return {"autotune": payload["autotune"], "quantized": payload["quantized"]}


# -- phase 6: the distributed index ----------------------------------------------
N_SHARDS = 4
# phase 6 (b): query batches timed one by one
SHARD_BATCHES, SHARD_BATCH = 16, 64


def _result(ids, dist):
    from repro_torch.index.search import StreamResult

    return StreamResult(gids=np.asarray(ids, np.int64),
                        distances=np.asarray(dist, np.float32))


def _same_answers(a, b, what):
    for part, x, y in (("ids", a.gids, b.gids),
                       ("distances", a.distances, b.distances)):
        if not np.array_equal(x, y):
            bad = np.nonzero((x != y).any(1))[0]
            raise AssertionError(f"{what}: {part} differ in {len(bad)} rows, "
                                 f"e.g. {bad[:3].tolist()}")


def run_static(dev, pts, queries, r, k, spec):
    """(a) `build_sharded` over all the points and `constrained_knn` (the
    four shards' trees stacked into one walk on the card), ids == a
    brute referent in the trees' arithmetic; `brute_constrained_knn`
    over the first 499,998 points (padded to an even split: gid -1 in two
    slots), ids == a brute referent in topk_l2's arithmetic."""
    from repro_torch.core import distributed
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    index = distributed.build_sharded(pts, dev, spec, n_shards=N_SHARDS)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids, dist = distributed.constrained_knn(index, queries, k, r)
    t_query = time.perf_counter() - t0
    launches_tree = ops.launch_counts()["topk_l2"]
    sub = pts[:len(pts) - 2]
    t0 = time.perf_counter()
    bids, bdist = distributed.brute_constrained_knn(
        sub, dev, queries, k, r, n_shards=N_SHARDS)
    t_brute = time.perf_counter() - t0
    launches_brute = ops.launch_counts()["topk_l2"] - launches_tree

    bd, bg = referent(pts, np.arange(len(pts)), [], queries, k, r, dev)
    derr = check_referent(_result(ids, dist), bd, bg, "distributed(a) tree")
    p_dev = torch.from_numpy(sub.astype(np.float32)).to(dev)
    g_dev = torch.arange(len(sub), dtype=torch.int32, device=dev)
    bd2, bg2 = referent(None, None, [(p_dev, g_dev)], queries, k, r, dev)
    derr2 = check_referent(_result(bids, bdist), bd2, bg2, "distributed(a) brute")
    out = {"n_points": len(pts), "n_shards": index.n_shards,
           "nodes_per_shard": [t.n_nodes for t in index.trees],
           "build_s": t_build, "query_s": t_query, "brute_points": len(sub),
           "brute_s": t_brute, "topk_l2_launches_tree": launches_tree,
           "topk_l2_launches_brute": launches_brute,
           "max_abs_dist_vs_referent": [derr, derr2]}
    log(f"distributed(a): build_sharded {len(pts)} points over {index.n_shards} "
        f"shards in {t_build:.3f} s; constrained_knn of {len(queries)} queries in "
        f"{t_query:.3f} s, ids == brute referent; brute_constrained_knn over "
        f"{len(sub)} points in {t_brute:.3f} s ({launches_brute} topk_l2 launches), "
        f"ids == brute referent")
    return out


def run_sharded(dev, pts, queries, r, k, spec, tmp, want_flushed):
    """(b) and (c): the sharded streaming index, four shards on the card,
    WALs in `tmp`: phase 3's ingest (one checkpoint midway), 16 timed
    batches of 64 queries, the 5,300 queries (ids == brute referent),
    then flushed: answers bitwise equal to `want_flushed`, the flushed
    single-device index's. Then shard 1 down: a partial answer without
    its gids, counted; close, reopen from the WALs: answers bitwise
    equal to the pre-close ones."""
    from repro_torch import obs
    from repro_torch.index import ShardedStreamingIndex, StreamingConfig, faults

    cfg = StreamingConfig(dim=2, delta_capacity=4096, spec=spec, merge_factor=4,
                          storage_dtype="bfloat16", device=str(dev))
    wal_dir = os.path.join(tmp, "sharded")
    sh = ShardedStreamingIndex(cfg, n_shards=N_SHARDS, devices=[dev],
                               wal_dir=wal_dir)

    def checkpoint_midway(b, batches):
        if b == batches // 2:
            sh.checkpoint()

    ing = ingest(sh, pts, after_add=checkpoint_midway)

    def counter(name):
        return obs.snapshot()["counters"].get(name, 0)

    full0 = counter("engine.stack_cache{kind=full_build}")
    incr0 = counter("engine.stack_cache{kind=incremental}")
    lat = []
    for b in range(SHARD_BATCHES):
        off = (b * SHARD_BATCH) % (len(queries) - SHARD_BATCH)
        t0 = time.perf_counter()
        sh.constrained_knn(queries[off:off + SHARD_BATCH], k, r)
        lat.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sh.constrained_knn(queries, k, r)
    t_pass = time.perf_counter() - t0
    stack_full = counter("engine.stack_cache{kind=full_build}") - full0
    stack_incr = counter("engine.stack_cache{kind=incremental}") - incr0
    bd, bg = brute_referent(sh, queries, k, r, dev)
    derr = check_referent(res, bd, bg, "distributed(b) sharded")
    split = span_split(lambda: sh.constrained_knn(queries, k, r))
    log("distributed(b): host split of one pass by span " + json.dumps(split))

    sh.flush()
    t0 = time.perf_counter()
    flushed = sh.constrained_knn(queries, k, r)
    t_flushed = time.perf_counter() - t0
    _same_answers(flushed, want_flushed, "distributed(b) flushed sharded vs "
                  "flushed single-device")
    lat_ms = np.asarray(lat) * 1e3
    st = sh.stats()
    out_b = {
        "n_shards": sh.n_shards, "devices": [str(d) for d in sh.devices],
        "bulk_load_s": ing["bulk_s"],
        "inserts_per_s": ing["inserted"] / ing["insert_s"],
        "deleted": ing["deleted"],
        "batch64_p50_ms": float(np.percentile(lat_ms, 50)),
        "batch64_p99_ms": float(np.percentile(lat_ms, 99)),
        "queries_5300_s": t_pass, "queries_5300_flushed_s": t_flushed,
        "stack_cache_full_builds": stack_full,
        "stack_cache_incremental": stack_incr,
        "query_batches": SHARD_BATCHES + 1,
        "n_live_per_shard": st["n_live_per_shard"],
        "n_segments_per_shard": st["n_segments_per_shard"],
        "max_abs_dist_vs_referent": derr, "host_split": split,
    }
    log(f"distributed(b): {ing['inserted']} inserts over {sh.n_shards} shards at "
        f"{out_b['inserts_per_s']:.0f}/s (WALs on); {SHARD_BATCHES} batches of "
        f"{SHARD_BATCH} p50 {out_b['batch64_p50_ms']:.3f} ms p99 "
        f"{out_b['batch64_p99_ms']:.3f} ms; {len(queries)} queries in {t_pass:.3f} s, "
        f"ids == brute referent; flushed: {t_flushed:.3f} s, bitwise equal to the "
        f"flushed single-device index; engine.stack_cache full builds {stack_full}, "
        f"incremental {stack_incr}")

    # (c) failover, then recovery
    fo0 = counter("shard.failovers{shard=1}")
    rt0 = counter("shard.search_retries{shard=1}")
    with faults.active():
        faults.arm("shard.search", shard=1, exc=faults.InjectedFault)
        t0 = time.perf_counter()
        part = sh.constrained_knn(queries, k, r)
        t_part = time.perf_counter() - t0
    valid = part.gids[part.gids >= 0]
    if not part.partial or not len(valid) or np.any(valid % N_SHARDS == 1):
        raise AssertionError("distributed(c): shard 1 down, the answer is not a "
                             "flagged partial one without its gids")
    for i in range(len(queries)):
        want = [g for g in flushed.gids[i].tolist() if g >= 0 and g % N_SHARDS != 1]
        if part.gids[i][:len(want)].tolist() != want:
            raise AssertionError(f"distributed(c): partial row {i} is not the full "
                                 f"answer without shard 1: {part.gids[i]} vs {want}")
    failovers = counter("shard.failovers{shard=1}") - fo0
    retries = counter("shard.search_retries{shard=1}") - rt0
    if failovers != 1:
        raise AssertionError(f"distributed(c): shard.failovers counted {failovers}")
    live_before = sh.live_gids()
    sh.close()
    t0 = time.perf_counter()
    rec = ShardedStreamingIndex(cfg, n_shards=N_SHARDS, devices=[dev],
                                wal_dir=wal_dir)
    torch.cuda.synchronize()
    t_recover = time.perf_counter() - t0
    if not np.array_equal(rec.live_gids(), live_before):
        raise AssertionError("distributed(c): recovered live gid set differs")
    after = rec.constrained_knn(queries, k, r)
    _same_answers(after, flushed, "distributed(c) recovered vs pre-close")
    rstats = rec.stats()["shards"]
    rec.close()
    out_c = {"partial_query_s": t_part, "failovers": failovers, "retries": retries,
             "recovery_s": t_recover,
             "checkpoint_loads": [p["checkpoint_loads"] for p in rstats],
             "wal_records_replayed": [p["wal_replayed"] for p in rstats],
             "wal_bytes": sum(os.path.getsize(os.path.join(wal_dir, f))
                              for f in os.listdir(wal_dir) if f.endswith(".wal"))}
    log(f"distributed(c): shard 1 down: partial answer in {t_part:.3f} s without "
        f"its gids, the full answer's other ids in order; failovers {failovers}, "
        f"retries {retries}; recovery from {N_SHARDS} WALs in {t_recover:.3f} s "
        f"(checkpoint loads {out_c['checkpoint_loads']}, records replayed "
        f"{out_c['wal_records_replayed']}), {len(queries)} answers bitwise equal "
        f"to the pre-close ones")
    return out_b, out_c


def run_distribution(dev, pts, queries, r, tmp, single):
    """Phase 6: the distributed index on the card, its launches counted
    from 0 over (a)–(c); `single` is phase 3's index (the same ingest),
    flushed and answered first, outside the count."""
    from repro_torch.core import TreeSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_l2 as tk

    k = 10
    spec = TreeSpec.ballstar(leaf_size=32)
    single.flush()
    want_flushed = single.constrained_knn(queries, k, r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    static = run_static(dev, pts, queries, r, k, spec)
    t1 = time.perf_counter()
    out_b, out_c = run_sharded(dev, pts, queries, r, k, spec, tmp, want_flushed)
    torch.cuda.synchronize()
    seconds = {"static_a": t1 - t0, "sharded_bc": time.perf_counter() - t1}
    launches = ops.launch_counts()
    shapes = dict(tk.LAUNCH_SHAPES)
    if launches["leaf_topk"] <= 0 or launches["topk_l2"] <= 0:
        raise AssertionError(f"a kernel of the distributed path never launched: "
                             f"{launches}")
    if not any(key[0] == "topk_l2" and key[2] > 100_000 for key in shapes):
        raise AssertionError("brute_constrained_knn never reached topk_l2 at a "
                             "shard's width")
    summary = {"static": static, "sharded": out_b, "failover_recovery": out_c,
               "launches": launches, "topk_l2_launches_by_q": tk.launches_by_q(),
               "seconds": seconds}
    log(f"distributed: launches {launches}, topk_l2 by Q {tk.launches_by_q()}")
    log("distributed: summary " + json.dumps(summary))
    return launches, shapes, summary


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
    _same_answers(after, before, "recovered vs pre-close answers")
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

    span0 = span_sums(spans)
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
    span1 = span_sums(spans)
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


def check_serve_shapes(dev, pts, queries, r, shapes, launches, label="serve",
                       required=("leaf_topk", "topk_l2")):
    """Phase 5 (b), phase 6 (d) and phase 7 (d): both read-path kernels
    at every call shape a run gave them (`topk_l2.LAUNCH_SHAPES`, read
    when the run ended) against their plain versions on the same inputs,
    bitwise — leaf_topk on random candidates at a dispatch's (R, C, D,
    k', storage), topk_l2 on the run's points and queries (`pts`,
    `queries`, whose D must be the call's) at its (Q, N) — with kernel,
    plain and library times and the bound. These
    launches come after the run's counts were read; each kernel of
    `required` must have been launched by the run. Returns the per-shape
    readings of each kernel."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {"leaf_topk": [], "topk_l2": []}
    for key, n_launch in sorted(shapes.items()):
        if key[0] == "leaf_topk":
            _, rows, c, d, kp, dtype = key
            v = _leaf_case(dev, gen, rows, c, d, kp, dtype, reps=10)
            log(f"{label} kernel leaf_topk[{dtype}] R={rows} C={c} D={d} "
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
                              label=f"{label} kernel ({n_launch} launches)").values()
            out["topk_l2"].append({"k": k, "launches": n_launch, **v})
    for name, rows in out.items():
        checked = sum(row["launches"] for row in rows)
        if checked != launches[name] or (not rows and name in required):
            raise AssertionError(f"{name}: {launches[name]} {label} launches, "
                                 f"{checked} of them at checked shapes")
    return out


# -- phase 7: the kNN-LM serving path --------------------------------------------
KNNLM_ARCH = "qwen2-0.5b"
KNNLM_PARAMS = 494_032_768       # the reference's param_count of qwen2-0.5b
KNNLM_DIM = 32                   # projected keys (examples/knnlm_serve.py)
KNNLM_STORE = (64, 4, 1024)      # datastore: batches x sequences x tokens
KNNLM_GEN = (4, 32, 16)          # batch, prompt, new tokens (the launcher's)
KNNLM_LONG = 2048                # prefill length of (a)'s decode identity
KNNLM_K = 8
# decode steps that look up, mix and add: each lookup takes tens of
# seconds on the card at D = 32 (PERF.md §5), so 3 of the reference
# example's steps, not 16
KNNLM_STEPS = 3
# the reference's tolerance for prefill + decode == forward
# (tests/test_archs_smoke.py); also used for card against CPU, where the
# bf16 products sum in another order on each device
MODEL_TOL = dict(rtol=0.1, atol=0.15)
# device events of a decode step: cuBLAS's and CUTLASS's products, the rest
DECODE_CLASSES = {"matmul": ("gemm", "gemv", "cutlass", "xmma", "nvjet", "Kernel2")}


def _close(got, want, what):
    """`got` within MODEL_TOL of `want` (tensors); the largest |error|."""
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(g, w, err_msg=what, **MODEL_TOL)
    return float(np.abs(g - w).max())


def _live_sq(idx, q, dev):
    """Squared distances of one query to every live point of a
    single-device index, by gid, in the index's own arithmetic (segments
    by the difference form, the delta arena by the expansion form)."""
    from repro_torch.kernels import topk_l2 as tk

    seg_parts, arenas = _live_parts(idx)
    qt = torch.from_numpy(q[None].astype(np.float32)).to(dev)
    out = {}
    for pts, gids in seg_parts:
        p = torch.from_numpy(np.asarray(pts, np.float32)).to(dev)
        sq = tk.leaf_sq(qt, p[None])[0].cpu().numpy()
        out.update(zip(np.asarray(gids).tolist(), sq.tolist()))
    for p, g in arenas:
        sq = tk.expansion_sq(qt, p)[0].cpu().numpy()
        gl = g.cpu().numpy()
        out.update((int(a), b) for a, b in zip(gl, sq) if a >= 0)
    return out


def cs_span(name: str) -> float:
    """Host seconds under one span since the registry's last reset."""
    return span_sums((name,))[name]


def check_lookup(store, queries, nv, nd, ok, k, r, dev, what, evicted=()):
    """A Datastore lookup's (values, distances, valid) against a brute
    scan of the live set: the same valid pattern and distances, and the
    referent's values. The keys hold exact duplicates (every sequence
    that starts with the same tokens gives the same states), whose equal
    squared distances may be ordered either way: where a value differs,
    the referent's neighbour must share its squared distance with other
    live states, one of which holds the lookup's value. No gid of
    `evicted` may be the referent's. Returns (largest distance error,
    rows settled by ties)."""
    bd, bg = brute_referent(store.index, queries, k, r, dev)
    fin = np.isfinite(bd)
    if not (np.array_equal(fin, ok) and np.array_equal(fin, np.isfinite(nd))):
        raise AssertionError(f"{what}: valid pattern differs from the brute referent")
    derr = float(np.abs(nd[fin] - bd[fin]).max()) if fin.any() else 0.0
    if fin.any() and derr > 1e-6 * float(np.abs(bd[fin]).max()):
        raise AssertionError(f"{what}: distances differ from the referent by {derr}")
    if np.isin(bg, np.asarray(evicted, np.int64)).any():
        raise AssertionError(f"{what}: the referent holds an evicted state")
    values = store.values
    want = np.where(fin, values[np.clip(bg, 0, None)], 0)
    tied = 0
    for row in np.nonzero((want != nv).any(1))[0]:
        sq = _live_sq(store.index, queries[row], dev)
        for j in np.nonzero(want[row] != nv[row])[0]:
            group = [g for g, v in sq.items() if v == sq[int(bg[row, j])]]
            if len(group) < 2 or nv[row, j] not in values[group]:
                raise AssertionError(
                    f"{what}: row {row} differs from the brute referent beyond "
                    f"ties: values {nv[row]} vs {want[row]}")
        tied += 1
    return derr, tied


def knnlm_keys(model, cfg, data_cfg, batches, proj):
    """The datastore's (keys, values): each batch's forward logits (bf16,
    B x S x vocab) projected to `proj`'s width one sequence at a time in
    f32 (never the whole batch's logits in f32), and the next tokens."""
    from repro_torch.data import tokens as data_lib
    from repro_torch.models import model as M

    keys, vals = [], []
    for step in range(batches):
        b = data_lib.batch_at(data_cfg, step)
        logits, _ = M.forward(model, torch.from_numpy(b["inputs"]))
        keys += [seq.float() @ proj for seq in logits]
        vals.append(b["labels"].reshape(-1))
        del logits
    return torch.cat(keys).cpu().numpy(), np.concatenate(vals)


def check_knnlm_leaf(dev):
    """leaf_topk at D = 32 at the shape the fused traversal gives it on
    this store when a frontier fills the cap: R = 4 and 16 lanes (a
    decode step's queries, the eviction lookup's class), C = 64 leaves x
    64 slots, k' = k + 8 — bf16 storage and the f32 fallback — against
    the plain version, bitwise, with times and bounds. (c)'s lookups
    overflow the cap and take the classic loop instead (PERF.md §5)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = []
    for rows in (4, 16):
        for dtype in ("bfloat16", "float32"):
            v = _leaf_case(dev, gen, rows, 64 * 64, KNNLM_DIM, KNNLM_K + 8,
                           dtype, reps=10)
            log(f"knnlm kernel leaf_topk[{dtype}] R={rows} C={64 * 64} "
                f"D={KNNLM_DIM} k'={KNNLM_K + 8}: kernel_ms={v['ms']:.5f} "
                f"plain_ms={v['plain_ms']:.4f} bound_ms={v['bound_ms']:.6f}; "
                f"outputs bitwise equal to the plain version")
            out.append({"r": rows, "c": 64 * 64, "d": KNNLM_DIM,
                        "k": KNNLM_K + 8, "dtype": dtype, **v})
    return out


def run_knnlm(dev):
    """Phase 7: qwen2-0.5b at full width with random weights, its
    generation engine and retrieval over the port's Datastore. The
    launcher runs first, outside the count; the launch counts are set to
    0 before (a) and read after (c)."""
    from repro_torch import configs, obs
    from repro_torch.data import tokens as data_lib
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_l2 as tk
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.retrieval import Datastore, knn_interpolate

    out = {}
    t0 = time.perf_counter()
    served = launch_serve.main(["--arch", KNNLM_ARCH, "--retrieval",
                                "--device", str(dev)])
    torch.cuda.empty_cache()
    out["launcher_s"] = time.perf_counter() - t0
    out["launcher_tokens_per_s"] = (served["tokens"].size
                                    / served["seconds"])
    log(f"knnlm launcher: `python -m repro_torch.launch.serve --arch "
        f"{KNNLM_ARCH} --retrieval` ran in {out['launcher_s']:.3f} s")

    ops.reset_launch_counts()
    # (a) the model, and parity
    cfg = configs.get(KNNLM_ARCH)
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if not n_params == M.param_count(cfg) == KNNLM_PARAMS:
        raise AssertionError(f"{n_params} parameters, want {KNNLM_PARAMS}")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    B, S, V = KNNLM_STORE[1], KNNLM_STORE[2], cfg.vocab
    data_cfg = data_lib.DataConfig(vocab=V, seq=S, global_batch=B, seed=0)
    cpu_model = M.Model(cfg, "cpu")
    cpu_model.load_state_dict(model.state_dict())
    x64 = torch.from_numpy(data_lib.batch_at(data_cfg, 98)["inputs"][:1, :64])
    card, _ = M.forward(model, x64)
    t0 = time.perf_counter()
    cpu, _ = M.forward(cpu_model, x64)
    out["cpu_forward64_s"] = time.perf_counter() - t0
    out["cpu_err"] = _close(card, cpu, "64-token logits, card vs CPU")
    out["cpu_argmax_agree"] = float(
        (card.argmax(-1).cpu() == cpu.argmax(-1)).float().mean())
    del cpu_model, cpu, card
    long_cfg = data_lib.DataConfig(vocab=V, seq=KNNLM_LONG + 3, global_batch=1,
                                   seed=0)
    seq = torch.from_numpy(data_lib.batch_at(long_cfg, 97)["inputs"]).to(dev)
    full, _ = M.forward(model, seq)
    logits, cache = M.prefill(model, seq[:, :KNNLM_LONG], KNNLM_LONG + 3)
    errs = [_close(logits[:, -1], full[:, KNNLM_LONG - 1], "prefill vs forward")]
    for i in range(3):
        pos = KNNLM_LONG + i
        logits, cache = M.decode_step(model, cache, seq[:, pos:pos + 1], pos)
        errs.append(_close(logits[:, -1], full[:, pos], f"decode {i} vs forward"))
    out["decode_identity_err"] = max(errs)
    del full, logits, cache
    torch.cuda.empty_cache()
    log(f"knnlm(a): {KNNLM_ARCH} on the card: {n_params:,} parameters "
        f"({weight_bytes / 1e9:.3f} GB of weights), init {out['init_s']:.3f} s; "
        f"64-token logits card vs CPU max |err| {out['cpu_err']:.5f}, argmax "
        f"agree {out['cpu_argmax_agree']:.4f}; prefill({KNNLM_LONG}) + 3 decode "
        f"steps vs forward({KNNLM_LONG + 3}) max |err| "
        f"{out['decode_identity_err']:.5f} (tolerance {MODEL_TOL})")

    # (b) generation
    Bg, Sg, new = KNNLM_GEN
    eng = Engine(cfg, model, cache_len=Sg + new, seed=0, device=dev)
    prompt = data_lib.batch_at(data_cfg, 99)["inputs"][:Bg, :Sg]
    g1, _ = eng.generate(prompt, new)
    cold = dict(eng.last_timing)
    g2, _ = eng.generate(prompt, new)
    warm = dict(eng.last_timing)
    if not np.array_equal(g1, g2):
        raise AssertionError("greedy generation differs between two runs")
    s1, _ = eng.generate(prompt, new, temperature=1.0)
    s2, _ = eng.generate(prompt, new, temperature=1.0)
    if np.array_equal(s1, s2):
        raise AssertionError("two sampled requests drew the same tokens")
    p1, _ = eng.generate(prompt, new, temperature=1.0,
                         generator=torch.Generator(device=dev).manual_seed(7))
    p2, _ = eng.generate(prompt, new, temperature=1.0,
                         generator=torch.Generator(device=dev).manual_seed(7))
    if not np.array_equal(p1, p2):
        raise AssertionError("an explicit generator did not reproduce its draw")
    # one decode step (batch 4) under the profiler: its device events by
    # class, the device's busy time and idle share
    logits, cache = M.prefill(model, torch.from_numpy(prompt).to(dev), Sg + new)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    M.decode_step(model, cache, tok, Sg)
    split = profile_pass(lambda: M.decode_step(model, cache, tok, Sg + 1),
                         classes=DECODE_CLASSES)
    out["decode_profile"] = {key: split[key] for key in (
        "by_class", "pass_host_ms", "device_busy_ms", "device_idle_share",
        "device_events")}
    del logits, cache
    out["prefill_ms"] = 1e3 * warm["prefill_s"]
    out["decode_ms_per_token"] = 1e3 * warm["decode_s"] / new
    out["decode_tokens_per_s"] = Bg * new / warm["decode_s"]
    out["tokens_per_s"] = Bg * new / (warm["prefill_s"] + warm["decode_s"])
    out["cold_prefill_ms"] = 1e3 * cold["prefill_s"]
    out["cold_decode_ms_per_token"] = 1e3 * cold["decode_s"] / new
    log(f"knnlm(b): Engine.generate batch {Bg}, prompt {Sg}, {new} new tokens: "
        f"prefill {out['prefill_ms']:.3f} ms, decode "
        f"{out['decode_ms_per_token']:.3f} ms/token ({out['decode_tokens_per_s']:.1f} "
        f"tokens/s), {out['tokens_per_s']:.1f} tokens/s end to end (first call: "
        f"prefill {out['cold_prefill_ms']:.3f} ms, decode "
        f"{out['cold_decode_ms_per_token']:.3f} ms/token); greedy x2 equal, "
        f"fresh samples differ, a seeded generator reproduces; one decode "
        f"step profiled: " + json.dumps(out["decode_profile"]))

    # (c) retrieval
    proj = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (V, KNNLM_DIM)) / np.sqrt(V)).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys, vals = knnlm_keys(model, cfg, data_cfg, KNNLM_STORE[0], proj)
    out["states_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = Datastore.from_pairs(keys, vals, leaf_size=64, delta_capacity=256,
                                 device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    r = 0.6 * float(np.linalg.norm(keys.std(0)))
    log(f"knnlm(c): {len(keys):,} states ({KNNLM_STORE[0]} batches of "
        f"{B} x {S}) projected to {KNNLM_DIM}-d in {out['states_s']:.3f} s; "
        f"Datastore.from_pairs(leaf_size=64, delta_capacity=256) built in "
        f"{out['build_s']:.3f} s; r = {r:.5f}")
    _, hidden = eng.generate(prompt, KNNLM_STEPS, capture_hidden=True)
    proj_np = proj.cpu().numpy()
    obs.REGISTRY.reset()
    lookup_s, tied, derr, found = [], 0, 0.0, 0
    added, qs = [], []
    for i, states in enumerate(hidden):
        q = (states @ proj_np).astype(np.float32)
        t0 = time.perf_counter()
        nv, nd, ok = store.lookup(q, KNNLM_K, r)
        lookup_s.append(time.perf_counter() - t0)
        e, t = check_lookup(store, q, nv, nd, ok, KNNLM_K, r, dev,
                            f"knnlm lookup {i}")
        derr, tied = max(derr, e), tied + t
        lm = np.exp(states - states.max(-1, keepdims=True))
        lm /= lm.sum(-1, keepdims=True)
        mixed = knn_interpolate(lm, nv, nd, ok, lam=0.3)
        if not np.allclose(mixed.sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"knnlm step {i}: mixed rows do not sum to 1")
        found += int(ok.sum())
        added.append(store.add(q, mixed.argmax(-1)))
        qs.append(q)
    grown = store.n_keys
    n_evicted = store.delete(np.concatenate(added))
    qs = np.concatenate(qs)
    t0 = time.perf_counter()
    nv, nd, ok = store.lookup(qs, KNNLM_K, r)
    evict_s = time.perf_counter() - t0
    e, t = check_lookup(store, qs, nv, nd, ok, KNNLM_K, r, dev, "knnlm evicted",
                        evicted=np.concatenate(added))
    derr, tied = max(derr, e), tied + t
    launches = ops.launch_counts()
    shapes = dict(tk.LAUNCH_SHAPES)
    counters = obs.snapshot()["counters"]
    out.update(lookups=len(hidden), lookup_queries=len(hidden) * Bg,
               lookup_s=lookup_s, lookups_per_s=len(hidden) / sum(lookup_s),
               lookup_queries_per_s=len(hidden) * Bg / sum(lookup_s),
               evicted_lookup_s=evict_s, in_range=found, grown=grown,
               evicted=n_evicted, tied_rows=tied, max_dist_err=derr, r=r,
               fused={key: v for key, v in counters.items()
                      if key.startswith("engine.fused_traversal")},
               phase1_s=cs_span("search.phase1"),
               dispatch_s=cs_span("engine.dispatch"),
               launches={k: v for k, v in launches.items() if v},
               shapes=[list(k) + [v] for k, v in sorted(shapes.items())])
    log(f"knnlm(c): {len(hidden)} decode steps x {Bg} queries, k = {KNNLM_K}: "
        f"lookups {[round(x, 3) for x in lookup_s]} s ({out['lookups_per_s']:.4f} "
        f"lookups/s, {out['lookup_queries_per_s']:.4f} queries/s), {found} "
        f"in-range neighbours, mixed rows sum to 1; memory {len(keys)} -> "
        f"{grown} -> {store.n_keys} states after evicting {n_evicted} (lookup "
        f"of all {len(qs)} queries {evict_s:.3f} s); every lookup == the brute "
        f"referent ({tied} rows settled by exact ties), max |distance err| "
        f"{derr:.3g}; engine dispatches {out['fused']}, host s in dispatch "
        f"{out['dispatch_s']:.3f} / phase 1 {out['phase1_s']:.3f}; launches "
        f"{out['launches']}, by call shape {out['shapes']}")
    return launches, shapes, out, keys, qs, r, store


# -- phase 8: the MoE and MLA layers ------------------------------------------------
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_PARAMS = 15_706_484_224      # the reference's param_count of deepseek-v2-lite-16b
MOE_ACTIVE = 2_661_150_208       # and its active_param_count
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
# 4 of phi3.5-moe's 32 layers: the whole model (41,872,527,360 parameters,
# 83.7 GB in bf16) does not fit one card
PHI_LAYERS = 4
MOE_CUT = 3      # (b): deepseek's dense first layer and its first two MoE layers
# (b), (d): prompt length; an odd token count is one dispatch group, where
# deepseek's capacity is C = 8 (phi3.5-moe's 16), so assignments drop
MOE_SHORT = 63
MOE_LONG = 2048  # (c): prefill length of the decode identity at full depth
MOE_STEPS = 3    # decode steps of (b), (c), (d)
# device events of a decode step: products, the MoE dispatch (the
# routing's sort and cumsum, the one-hot and position scatters and
# gathers, the buffer write, the combine's gather, the expert histogram)
# by kernel name, everything else
MOE_CLASSES = {**DECODE_CLASSES,
               "moe_dispatch": ("sort", "Sort", "scan", "Scan", "scatter",
                                "index", "Histogram")}


def model_view(model, cfg):
    """A model of `cfg` over `model`'s own parameter tensors (no copy):
    `cfg` may keep only the first layers, or change a setting that holds
    no weight (the capacity factor)."""
    from repro_torch.models import model as M

    view = M.Model(cfg, "meta")
    sd = model.state_dict()
    view.load_state_dict({k: sd[k] for k in view.state_dict()}, assign=True)
    return view


def routed(model, fn):
    """fn() with `model`'s MoE calls traced: (fn's result, [(module name,
    its input, the experts chosen (G, Tg·k), which of them were dropped)],
    the tensors on the CPU)."""
    from repro_torch.models import moe

    with moe.routing_trace(model) as calls:
        out = fn()
    return out, [(n, x.cpu(), e.cpu(), d.cpu()) for n, x, e, d in calls]


def pass_bound(model, tokens: int) -> tuple:
    """(bound ms, what bounds it) of one pass of `tokens` tokens (a
    prefill of B x S, or a decode step of B): every weight read once but
    an untied embedding table (one row a token); 2 operations a weight a
    token for every product outside the routed experts (at the tensor
    cores' bf16 rate, the f32 products' few among them: the router, the
    RG-LRU's block-diagonal gates, the xLSTM's gates), and each MoE
    layer's expert products over all its E x G·C capacity rows, which the
    dispatch computes whether they hold a token or not. The attention
    scores and values, the recurrences' state updates and the
    elementwise work are left out, so the bound stays a lower one."""
    from repro_torch.models import moe

    cfg = model.cfg
    routed_params = sum(
        p.numel() for m in model.modules() if isinstance(m, moe.MoE)
        for n, p in m.named_parameters(recurse=False) if n != "router")
    n_moe = sum(isinstance(m, moe.MoE) for m in model.modules())
    untied = hasattr(model, "embed") and not cfg.tied_embeddings
    gathered = model.embed.numel() if untied else 0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_bytes = weight_bytes - gathered * 2 + tokens * cfg.d_model * 2
    ops = 2 * tokens * (sum(p.numel() for p in model.parameters())
                        - gathered - routed_params)
    if n_moe:
        G = moe.n_groups(cfg, tokens)
        C = moe.capacity(cfg, tokens // G)
        ops += n_moe * 2 * 3 * cfg.n_experts * G * C * cfg.d_model * cfg.d_expert
    hbm, peak = envelope()
    t_bytes = n_bytes / hbm
    t_ops = ops / peak[torch.bfloat16]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _token_routes(flat_e, dropped, k):
    """Per token, (its experts, the experts it kept) as sorted tuples."""
    e = flat_e.reshape(-1, k).tolist()
    d = dropped.reshape(-1, k).tolist()
    return [(tuple(sorted(es)), tuple(sorted(x for x, gone in zip(es, ds) if not gone)))
            for es, ds in zip(e, d)]


def short_run(model, x, n: int, steps: int) -> list:
    """forward(x[:, :n]), prefill of the same tokens and `steps` decode
    steps of the next tokens: the first sequence's logits of each, on the
    CPU in f32."""
    from repro_torch.models import model as M

    xs = x.to(model.device)
    out = [M.forward(model, xs[:, :n])[0]]
    logits, cache = M.prefill(model, xs[:, :n], n + steps)
    out.append(logits)
    for i in range(steps):
        logits, cache = M.decode_step(model, cache, xs[:, n + i:n + i + 1], n + i)
        out.append(logits)
    return [o.float().cpu()[0] for o in out]


def card_vs_cpu(card, x, what) -> dict:
    """Phase 8 (b) and (d): `card`'s weights copied to the CPU; on both,
    forward(x[:, :MOE_SHORT]), prefill of the same tokens and MOE_STEPS
    decode steps, every MoE call traced.

    Routing is held where it is well posed, on the same input: each MoE
    call's input on the card, routed again by the CPU's copy of the
    layer, must choose the same experts and drop the same assignments.
    Between the two runs the inputs differ by the rounding of bf16
    products summed in another order, and a near-tie of the router may
    flip a token's experts, which also moves the later tokens' slots and
    so what drops. Such tokens are counted and printed with their logits'
    error and the largest CPU-side probability margin a flip crossed;
    every other token's logits, at every step, must agree within
    MODEL_TOL. Returns the readings."""
    from repro_torch.models import model as M
    from repro_torch.models import moe

    t0 = time.perf_counter()
    cpu = M.Model(card.cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    copy_s = time.perf_counter() - t0
    cfg, n, k = card.cfg, MOE_SHORT, card.cfg.top_k

    got, got_calls = routed(card, lambda: short_run(card, x, n, MOE_STEPS))
    t0 = time.perf_counter()
    want, want_calls = routed(cpu, lambda: short_run(cpu, x, n, MOE_STEPS))
    cpu_s = time.perf_counter() - t0
    if [c[0] for c in got_calls] != [c[0] for c in want_calls]:
        raise AssertionError(f"{what}: MoE calls differ, card vs CPU")
    steps = ["forward", "prefill"] + [f"decode {i}" for i in range(MOE_STEPS)]
    per_step = len(got_calls) // len(steps)
    drops, same_input, flips, margin = [], [], 0, 0.0
    moved = [set() for _ in steps]  # per step, the tokens whose routing differs
    for i, ((name, gx, ge, gd), (_, wx, we, wd)) in enumerate(zip(got_calls, want_calls)):
        layer = cpu.get_submodule(name)
        _, _, fe, slot, C = moe.route(layer, gx, cfg)
        same_input.append((int(gd.sum()), int((slot == C).sum())))
        if not (torch.equal(fe, ge) and torch.equal(slot == C, gd)):
            raise AssertionError(f"{what}: {name} routes the card's input "
                                 f"differently on the CPU")
        drops.append((int(gd.sum()), int(wd.sum())))
        g_routes, w_routes = _token_routes(ge, gd, k), _token_routes(we, wd, k)
        probs = None
        for t, (g, w) in enumerate(zip(g_routes, w_routes)):
            if g == w:
                continue
            moved[i // per_step].add(t)
            if g[0] != w[0]:  # a flip: how far the CPU kept the card's pick below
                flips += 1
                if probs is None:
                    probs = moe.route(layer, wx, cfg)[0].reshape(-1, cfg.n_experts)
                a = sorted(set(g[0]) - set(w[0]))
                b = sorted(set(w[0]) - set(g[0]))
                margin = max(margin, float(probs[t, b].min() - probs[t, a].max()))
    del cpu
    errs, moved_errs, agree = {}, {}, []
    for s, g, w, mv in zip(steps, got, want, moved):
        keep = [t for t in range(g.shape[0]) if t not in mv]
        errs[s] = float((g[keep] - w[keep]).abs().max()) if keep else None
        if mv:
            moved_errs[s] = {"tokens": len(mv), "max_abs_err":
                             float((g[sorted(mv)] - w[sorted(mv)]).abs().max())}
        agree.append((g.argmax(-1) == w.argmax(-1)).float().mean().item())
    agree = float(np.mean(agree))
    out = {"moe_calls": len(got_calls), "dropped_card": sum(d for d, _ in drops),
           "dropped_cpu": sum(d for _, d in drops), "dropped_by_call": drops,
           "same_input_dropped_by_call": same_input, "expert_flips": flips,
           "flip_margin_max": margin, "max_abs_err": errs,
           "routing_moved": moved_errs, "argmax_agree": agree,
           "cpu_copy_s": copy_s, "cpu_s": cpu_s}
    log(f"{what}: card vs CPU, forward / prefill of {n} tokens and {MOE_STEPS} "
        f"decode steps: max |err| over the tokens routed alike "
        f"{json.dumps(errs)}, argmax agree {agree:.4f} over all; "
        f"{len(got_calls)} MoE calls; on the same input (the card's, routed "
        f"again on the CPU) every call chose the same experts and dropped the "
        f"same assignments (dropped, card / CPU, by call {same_input}); between "
        f"the two runs assignments dropped card {out['dropped_card']} / CPU "
        f"{out['dropped_cpu']} (by call {drops}), (token, call) pairs whose "
        f"experts differ {flips}, the largest CPU-side probability margin a "
        f"flip crossed {margin:.3g}; tokens routed differently, by step, "
        f"not held: {json.dumps(moved_errs)}; CPU copy {copy_s:.3f} s, CPU run "
        f"{cpu_s:.3f} s")
    for s, g, w, mv in zip(steps, got, want, moved):
        keep = [t for t in range(g.shape[0]) if t not in mv]
        _close(g[keep], w[keep], f"{what}: {s} logits, card vs CPU")
    return out


def run_moe(dev):
    """Phase 8: deepseek-v2-lite-16b (MLA mixers, MoE FFNs) at full width
    and depth, and phi3.5-moe at full width and 4 of its layers, with
    random weights from seeded generators; the serve launcher last. The
    launch counts are set to 0 before (a) and read after (e). cuBLAS
    sums bf16 products in f32 throughout the phase (no bf16 split-K
    reduction), as the reference's products do."""
    import dataclasses

    from repro_torch import configs, obs
    from repro_torch.data import tokens as data_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve.engine import Engine

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    ops.reset_launch_counts()
    out = {}
    try:
        # (a) deepseek-v2-lite-16b at full width and depth
        cfg = configs.get(MOE_ARCH)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        active = M.active_param_count(cfg)
        if not (n_params == M.param_count(cfg) == MOE_PARAMS and active == MOE_ACTIVE):
            raise AssertionError(f"{n_params:,} parameters ({active:,} active), want "
                                 f"{MOE_PARAMS:,} ({MOE_ACTIVE:,})")
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        out.update(params=n_params, active_params=active,
                   weight_gb=weight_bytes / 1e9, layers=len(model.layers),
                   init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        Bg, Sg, new = KNNLM_GEN
        V = cfg.vocab
        data_cfg = data_lib.DataConfig(vocab=V, seq=MOE_LONG + MOE_STEPS,
                                       global_batch=Bg, seed=0)
        batch = data_lib.batch_at(data_cfg, 0)["inputs"]
        prompt = batch[:, :Sg]
        eng = Engine(cfg, model, cache_len=Sg + new, seed=0, device=dev)
        g1, _ = eng.generate(prompt, new)
        cold = dict(eng.last_timing)
        g2, _ = eng.generate(prompt, new)
        warm = dict(eng.last_timing)
        if not np.array_equal(g1, g2):
            raise AssertionError("deepseek greedy generation differs between two runs")
        out["generate_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        logits, cache = M.prefill(model, torch.from_numpy(prompt).to(dev), Sg + new)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        M.decode_step(model, cache, tok, Sg)
        split = profile_pass(lambda: M.decode_step(model, cache, tok, Sg + 1),
                             classes=MOE_CLASSES)
        del logits, cache
        out["decode_profile"] = {key: split[key] for key in (
            "by_class", "pass_host_ms", "device_busy_ms", "device_idle_share",
            "device_events", "top_events")}
        G = moe.n_groups(cfg, Bg)
        out.update(
            prefill_ms=1e3 * warm["prefill_s"],
            decode_ms_per_token=1e3 * warm["decode_s"] / new,
            decode_tokens_per_s=Bg * new / warm["decode_s"],
            tokens_per_s=Bg * new / (warm["prefill_s"] + warm["decode_s"]),
            cold_prefill_ms=1e3 * cold["prefill_s"],
            cold_decode_ms_per_token=1e3 * cold["decode_s"] / new,
            prefill_bound=pass_bound(model, Bg * Sg),
            decode_bound=pass_bound(model, Bg),
            decode_dispatch={"G": G, "C": moe.capacity(cfg, Bg // G)})
        log(f"moe(a): {MOE_ARCH} on the card, {len(model.layers)} layers, "
            f"{n_params:,} parameters ({active:,} active), "
            f"{out['weight_gb']:.3f} GB of weights, init {out['init_s']:.3f} s "
            f"(peak {out['init_peak_gb']:.3f} GB); Engine.generate batch {Bg}, "
            f"prompt {Sg}, {new} new tokens: prefill {out['prefill_ms']:.3f} ms "
            f"(bound {out['prefill_bound'][0]:.4f} ms, "
            f"{out['prefill_bound'][1]}), decode {out['decode_ms_per_token']:.3f} "
            f"ms/token (bound {out['decode_bound'][0]:.4f} ms, "
            f"{out['decode_bound'][1]}: every expert's weights a step, G = "
            f"{G}, C = {out['decode_dispatch']['C']}), "
            f"{out['decode_tokens_per_s']:.1f} tokens/s decode, "
            f"{out['tokens_per_s']:.1f} end to end (first call: prefill "
            f"{out['cold_prefill_ms']:.3f} ms, decode "
            f"{out['cold_decode_ms_per_token']:.3f} ms/token); greedy x2 equal; "
            f"peak memory {out['generate_peak_gb']:.3f} GB; one decode step "
            f"profiled: " + json.dumps(out["decode_profile"]))

        # (b) card vs CPU: the first MOE_CUT layers, the same weights
        cut = model_view(model, dataclasses.replace(cfg, n_layers=MOE_CUT))
        out["cut_params"] = sum(p.numel() for p in cut.parameters())
        log(f"moe(b): {MOE_ARCH}'s first {MOE_CUT} layers "
            f"({[b.kind for b in cut.layers]}, {out['cut_params']:,} "
            f"parameters), capacity factor {cfg.capacity_factor}: one group of "
            f"{MOE_SHORT} tokens, C = {moe.capacity(cfg, MOE_SHORT)}")
        x = torch.from_numpy(batch[:1, :MOE_SHORT + MOE_STEPS])
        out["cut"] = card_vs_cpu(cut, x, "moe(b)")
        del cut

        # (c) prefill + decode == forward at full depth, no drops
        cf = cfg.n_experts / cfg.top_k
        whole = model_view(model, dataclasses.replace(cfg, capacity_factor=cf))
        seq = torch.from_numpy(batch[:1]).to(dev)
        L = MOE_LONG
        (full, _), fcalls = routed(whole, lambda: M.forward(whole, seq))
        ((logits, cache), pcalls) = routed(
            whole, lambda: M.prefill(whole, seq[:, :L], L + MOE_STEPS))
        errs = [_close(logits[:, -1], full[:, L - 1], "moe(c): prefill vs forward")]
        dcalls = []
        for i in range(MOE_STEPS):
            (logits, cache), c = routed(whole, lambda i=i: M.decode_step(
                whole, cache, seq[:, L + i:L + i + 1], L + i))
            dcalls += c
            errs.append(_close(logits[:, -1], full[:, L + i], f"moe(c): decode {i}"))
        dropped = sum(int(c[3].sum()) for c in fcalls + pcalls + dcalls)
        if dropped:
            raise AssertionError(f"moe(c): {dropped} assignments dropped at "
                                 f"capacity factor {cf}")
        out["identity"] = {"max_abs_err": max(errs), "capacity_factor": cf,
                           "forward_C": moe.capacity(whole.cfg, L + MOE_STEPS),
                           "prefill_G": moe.n_groups(whole.cfg, L)}
        del full, logits, cache, whole
        log(f"moe(c): prefill({L}) + {MOE_STEPS} decode steps vs forward("
            f"{L + MOE_STEPS}) at full depth: max |err| {max(errs):.5f} (tolerance "
            f"{MODEL_TOL}); capacity factor {cf:.6f} = n_experts / top_k (the "
            f"one change to the published config: C >= the tokens of a group, "
            f"so nothing drops — at 1.25 prefill({L}) runs G = "
            f"{moe.n_groups(cfg, L)}, C = {moe.capacity(cfg, L // moe.n_groups(cfg, L))} "
            f"and forward({L + MOE_STEPS}) G = {moe.n_groups(cfg, L + MOE_STEPS)}, C = "
            f"{moe.capacity(cfg, L + MOE_STEPS)}, which drop different tokens, in "
            f"the reference too); dropped assignments 0 in "
            f"{len(fcalls + pcalls + dcalls)} MoE calls")
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()

        # (d) phi3.5-moe at full width, PHI_LAYERS layers
        pcfg = dataclasses.replace(configs.get(PHI_ARCH), n_layers=PHI_LAYERS)
        t0 = time.perf_counter()
        phi = M.init_params(pcfg, torch.Generator(device=dev).manual_seed(1), dev)
        torch.cuda.synchronize()
        phi_init = time.perf_counter() - t0
        phi_params = sum(p.numel() for p in phi.parameters())
        if phi_params != M.param_count(pcfg):
            raise AssertionError(f"phi3.5-moe: {phi_params:,} parameters")
        log(f"moe(d): {PHI_ARCH} at full width, {PHI_LAYERS} of "
            f"{configs.get(PHI_ARCH).n_layers} layers: {phi_params:,} parameters, "
            f"init {phi_init:.3f} s; one group of {MOE_SHORT} tokens, C = "
            f"{moe.capacity(pcfg, MOE_SHORT)}")
        pdata = data_lib.DataConfig(vocab=pcfg.vocab, seq=MOE_SHORT + MOE_STEPS,
                                    global_batch=Bg, seed=1)
        pbatch = data_lib.batch_at(pdata, 0)["inputs"]
        out["phi"] = card_vs_cpu(phi, torch.from_numpy(pbatch[:1]), "moe(d)")
        peng = Engine(pcfg, phi, cache_len=Sg + new, seed=0, device=dev)
        p1, _ = peng.generate(pbatch[:, :Sg], new)
        p2, _ = peng.generate(pbatch[:, :Sg], new)
        if not np.array_equal(p1, p2):
            raise AssertionError("phi3.5-moe greedy generation differs between two runs")
        t = peng.last_timing
        out["phi"].update(
            params=phi_params, init_s=phi_init, prefill_ms=1e3 * t["prefill_s"],
            decode_ms_per_token=1e3 * t["decode_s"] / new,
            tokens_per_s=Bg * new / (t["prefill_s"] + t["decode_s"]),
            decode_bound=pass_bound(phi, Bg))
        log(f"moe(d): Engine.generate batch {Bg}, prompt {Sg}, {new} new tokens: "
            f"prefill {out['phi']['prefill_ms']:.3f} ms, decode "
            f"{out['phi']['decode_ms_per_token']:.3f} ms/token (bound "
            f"{out['phi']['decode_bound'][0]:.4f} ms, "
            f"{out['phi']['decode_bound'][1]}), {out['phi']['tokens_per_s']:.1f} "
            f"tokens/s end to end; greedy x2 equal")
        del phi, peng
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the serve launcher
        obs.REGISTRY.reset()
        t0 = time.perf_counter()
        served = launch_serve.main(["--arch", MOE_ARCH, "--smoke", "--retrieval",
                                    "--device", str(dev)])
        out["launcher_s"] = time.perf_counter() - t0
        launches = ops.launch_counts()
        counters = obs.snapshot()["counters"]
        out.update(launcher_in_range=served["in_range"], launches=launches,
                   launcher_fused={key: v for key, v in counters.items()
                                   if key.startswith("engine.fused_traversal")})
        log(f"moe(e): `python -m repro_torch.launch.serve --arch {MOE_ARCH} --smoke "
            f"--retrieval` ran in {out['launcher_s']:.3f} s ({served['in_range']} "
            f"in-range neighbours); launches over phase 8: {json.dumps(launches)}; "
            f"the launcher's lookup dispatches {json.dumps(out['launcher_fused'])}")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return launches, out


# -- phase 9: the recurrent mixers ------------------------------------------------
RECUR_ARCH = "recurrentgemma-9b"
RECUR_PARAMS = 9_627_095_040     # the reference's param_count of recurrentgemma-9b
XLSTM_ARCH = "xlstm-125m"
XLSTM_PARAMS = 150_253_896       # and of xlstm-125m
RECUR_CUT = 3     # (b): one Griffin unit, (rglru, rglru, attn)
RECUR_SHORT = 63  # (b), (d): prompt length, card vs CPU
RECUR_LONG = 2048  # (c), (d): prefill length of the decode identity
RECUR_STEPS = 3   # decode steps of (b), (c), (d)
# (d): the forward the identity is held against: the mLSTM's chunkwise
# form needs a multiple of its chunk (256), so 9 chunks, of which
# positions RECUR_LONG - 1 .. RECUR_LONG + RECUR_STEPS - 1 are compared
XLSTM_FORWARD = 2304


def model_vs_cpu(card, x, what) -> dict:
    """Phase 9 (b) and (d): `card`'s weights copied to the CPU; on both,
    forward(x[:, :RECUR_SHORT]), prefill of the same tokens and
    RECUR_STEPS decode steps, each step's logits within MODEL_TOL; the
    largest |error| of each and the argmax agreement over all."""
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cpu = M.Model(card.cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    copy_s = time.perf_counter() - t0
    got = short_run(card, x, RECUR_SHORT, RECUR_STEPS)
    t0 = time.perf_counter()
    want = short_run(cpu, x, RECUR_SHORT, RECUR_STEPS)
    cpu_s = time.perf_counter() - t0
    del cpu
    steps = ["forward", "prefill"] + [f"decode {i}" for i in range(RECUR_STEPS)]
    errs = {s: _close(g, w, f"{what}: {s} logits, card vs CPU")
            for s, g, w in zip(steps, got, want)}
    agree = float(np.mean([(g.argmax(-1) == w.argmax(-1)).float().mean().item()
                           for g, w in zip(got, want)]))
    log(f"{what}: card vs CPU, forward / prefill of {RECUR_SHORT} tokens and "
        f"{RECUR_STEPS} decode steps: max |err| {json.dumps(errs)} (tolerance "
        f"{MODEL_TOL}), argmax agree {agree:.4f}; CPU copy {copy_s:.3f} s, CPU run "
        f"{cpu_s:.3f} s")
    return {"max_abs_err": errs, "argmax_agree": agree, "cpu_copy_s": copy_s,
            "cpu_s": cpu_s}


def layerwise_vs_cpu(card, x, what) -> dict:
    """Phase 9 (d): `card`'s weights copied to the CPU, held layer by layer
    on the same input. forward(x[:, :RECUR_SHORT]), prefill of the same
    tokens and RECUR_STEPS decode steps run on the card; every layer's
    input on the card is also fed to the CPU's copy of that layer (each
    device keeps its own prefill cache and decode states), and the two
    outputs, and the logits of the card's last hidden state, must agree
    within MODEL_TOL. End to end the two devices are not held: xlstm-125m
    with random weights carries a one-ulp change of its input through
    the mLSTM's exp input gates and its norm of the memory readout into
    later logits at ~0.5, so the card's and the CPU's whole runs differ
    as much as the CPU's own runs at two thread counts, both printed."""
    from repro_torch.models import model as M

    cfg, n = card.cfg, RECUR_SHORT
    cpu = M.Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    dev = card.device
    xs = x.to(dev)
    errs = {}

    def held(step, got, want, layer):
        err = _close(got, want, f"{what}: {step}, layer {layer}, card vs CPU on the "
                                f"card's input")
        errs[step] = max(errs.get(step, 0.0), err)

    def logits(step, h):
        held(step, M._logits_out(card, h), M._logits_out(cpu, h.cpu()), "logits")

    pos = M._positions(1, n, dev)
    h = M._embed_in(card, xs[:, :n])
    for i, (bc, bp) in enumerate(zip(card.layers, cpu.layers)):
        out = M._apply_block(bc, h, pos, cfg)[0]
        held("forward", out, M._apply_block(bp, h.cpu(), pos.cpu(), cfg)[0], i)
        h = out
    logits("forward", h)
    h = M._embed_in(card, xs[:, :n])
    caches = []
    for i, (bc, bp) in enumerate(zip(card.layers, cpu.layers)):
        out, _, cc = M._apply_block(bc, h, pos, cfg, cache_len=n + RECUR_STEPS)
        want, _, cp = M._apply_block(bp, h.cpu(), pos.cpu(), cfg,
                                     cache_len=n + RECUR_STEPS)
        held("prefill", out, want, i)
        caches.append((cc, cp))
        h = out
    logits("prefill", h)
    for t in range(n, n + RECUR_STEPS):
        step = f"decode {t - n}"
        h = M._embed_in(card, xs[:, t:t + 1])
        for i, ((bc, bp), (cc, cp)) in enumerate(zip(zip(card.layers, cpu.layers), caches)):
            out = M._apply_block(bc, h, None, cfg, cache=cc, pos=t)[0]
            held(step, out, M._apply_block(bp, h.cpu(), None, cfg, cache=cp, pos=t)[0], i)
            h = out
        logits(step, h)
    # unheld: the whole runs, and the CPU's spread between thread counts
    got = short_run(card, x, n, RECUR_STEPS)
    want = short_run(cpu, x, n, RECUR_STEPS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = short_run(cpu, x, n, RECUR_STEPS)
    finally:
        torch.set_num_threads(threads)
    del cpu
    whole = float(max((g - w).abs().max() for g, w in zip(got, want)))
    spread = float(max((a - w).abs().max() for a, w in zip(one, want)))
    agree = float(np.mean([(g.argmax(-1) == w.argmax(-1)).float().mean().item()
                           for g, w in zip(got, want)]))
    log(f"{what}: card vs CPU layer by layer on the card's input ({len(card.layers)} "
        f"layers, forward / prefill of {n} tokens and {RECUR_STEPS} decode steps, "
        f"each layer's output and the logits): max |err| {json.dumps(errs)} "
        f"(tolerance {MODEL_TOL}); whole runs, not held: card vs CPU max |err| "
        f"{whole:.5f}, argmax agree {agree:.4f}; the CPU at 1 against {threads} "
        f"threads max |diff| {spread:.5f}")
    return {"max_abs_err": errs, "whole_max_abs_err": whole, "argmax_agree": agree,
            "cpu_threads_spread": spread}


def decode_identity(model, seq, L, what) -> float:
    """prefill(seq[:, :L]) + RECUR_STEPS decode steps against forward(seq):
    the logits of positions L - 1 .. L + RECUR_STEPS - 1 within MODEL_TOL;
    the largest |error|."""
    from repro_torch.models import model as M

    full, _ = M.forward(model, seq)
    logits, cache = M.prefill(model, seq[:, :L], L + RECUR_STEPS)
    errs = [_close(logits[:, -1], full[:, L - 1], f"{what}: prefill vs forward")]
    for i in range(RECUR_STEPS):
        logits, cache = M.decode_step(model, cache, seq[:, L + i:L + i + 1], L + i)
        errs.append(_close(logits[:, -1], full[:, L + i], f"{what}: decode {i} vs forward"))
    return max(errs)


def generate_twice(cfg, model, prompt, new, dev, what) -> dict:
    """`Engine.generate` of `prompt`, greedy, twice: equal tokens; the
    second run's prefill ms, decode ms per token and tokens/s, and the
    first run's."""
    from repro_torch.serve.engine import Engine

    B, S = prompt.shape
    eng = Engine(cfg, model, cache_len=S + new, seed=0, device=dev)
    g1, _ = eng.generate(prompt, new)
    cold = dict(eng.last_timing)
    g2, _ = eng.generate(prompt, new)
    warm = dict(eng.last_timing)
    if not np.array_equal(g1, g2):
        raise AssertionError(f"{what}: greedy generation differs between two runs")
    return {"prefill_ms": 1e3 * warm["prefill_s"],
            "decode_ms_per_token": 1e3 * warm["decode_s"] / new,
            "decode_tokens_per_s": B * new / warm["decode_s"],
            "tokens_per_s": B * new / (warm["prefill_s"] + warm["decode_s"]),
            "cold_prefill_ms": 1e3 * cold["prefill_s"],
            "cold_decode_ms_per_token": 1e3 * cold["decode_s"] / new}


def run_recurrent(dev):
    """Phase 9: recurrentgemma-9b (RG-LRU and local MQA) at full width and
    depth, and xlstm-125m (mLSTM, sLSTM) whole, with random weights from
    seeded generators; the serve launcher last. The launch counts are set
    to 0 before (a) and read after (e). cuBLAS sums bf16 products in f32
    throughout the phase, as in phase 8."""
    import dataclasses

    from repro_torch import configs, obs
    from repro_torch.data import tokens as data_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as M

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    ops.reset_launch_counts()
    out = {}
    Bg, Sg, new = KNNLM_GEN
    try:
        # (a) recurrentgemma-9b at full width and depth
        cfg = configs.get(RECUR_ARCH)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        if not n_params == M.param_count(cfg) == RECUR_PARAMS:
            raise AssertionError(f"{n_params:,} parameters, want {RECUR_PARAMS:,}")
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        kinds = [b.kind[0] for b in model.layers]
        out.update(params=n_params, weight_gb=weight_bytes / 1e9,
                   layers={k: kinds.count(k) for k in sorted(set(kinds))},
                   init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        data_cfg = data_lib.DataConfig(vocab=cfg.vocab, seq=RECUR_LONG + RECUR_STEPS,
                                       global_batch=Bg, seed=0)
        batch = data_lib.batch_at(data_cfg, 0)["inputs"]
        out.update(generate_twice(cfg, model, batch[:, :Sg], new, dev, "recurrent(a)"))
        out["generate_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        logits, cache = M.prefill(model, torch.from_numpy(batch[:, :Sg]).to(dev), Sg + new)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        M.decode_step(model, cache, tok, Sg)
        split = profile_pass(lambda: M.decode_step(model, cache, tok, Sg + 1),
                             classes=DECODE_CLASSES)
        del logits, cache
        out["decode_profile"] = {key: split[key] for key in (
            "by_class", "pass_host_ms", "device_busy_ms", "device_idle_share",
            "device_events", "top_events")}
        out.update(prefill_bound=pass_bound(model, Bg * Sg),
                   decode_bound=pass_bound(model, Bg))
        log(f"recurrent(a): {RECUR_ARCH} on the card, {len(model.layers)} layers "
            f"{out['layers']}, {n_params:,} parameters, {out['weight_gb']:.3f} GB of "
            f"weights, init {out['init_s']:.3f} s (peak {out['init_peak_gb']:.3f} GB); "
            f"Engine.generate batch {Bg}, prompt {Sg}, {new} new tokens: prefill "
            f"{out['prefill_ms']:.3f} ms (bound {out['prefill_bound'][0]:.4f} ms, "
            f"{out['prefill_bound'][1]}), decode {out['decode_ms_per_token']:.3f} "
            f"ms/token (bound {out['decode_bound'][0]:.4f} ms, "
            f"{out['decode_bound'][1]}), {out['decode_tokens_per_s']:.1f} tokens/s "
            f"decode, {out['tokens_per_s']:.1f} end to end (first call: prefill "
            f"{out['cold_prefill_ms']:.3f} ms, decode "
            f"{out['cold_decode_ms_per_token']:.3f} ms/token); greedy x2 equal; "
            f"peak memory {out['generate_peak_gb']:.3f} GB; one decode step "
            f"profiled: " + json.dumps(out["decode_profile"]))

        # (b) card vs CPU: one Griffin unit, the same weights
        cut = model_view(model, dataclasses.replace(cfg, n_layers=RECUR_CUT))
        log(f"recurrent(b): {RECUR_ARCH}'s first {RECUR_CUT} layers "
            f"({[b.kind for b in cut.layers]}, "
            f"{sum(p.numel() for p in cut.parameters()):,} parameters)")
        x = torch.from_numpy(batch[:1, :RECUR_SHORT + RECUR_STEPS])
        out["cut"] = model_vs_cpu(cut, x, "recurrent(b)")
        del cut

        # (c) prefill + decode == forward at full depth: the local
        # attention's rolling buffer (T = window) wraps at the first decode
        seq = torch.from_numpy(batch[:1]).to(dev)
        out["identity_err"] = decode_identity(model, seq, RECUR_LONG, "recurrent(c)")
        T = M.cache_shapes(cfg, 1, RECUR_LONG + RECUR_STEPS)[2]["k"][0][1]
        log(f"recurrent(c): prefill({RECUR_LONG}) + {RECUR_STEPS} decode steps vs "
            f"forward({RECUR_LONG + RECUR_STEPS}) at full depth, batch 1: max |err| "
            f"{out['identity_err']:.5f} (tolerance {MODEL_TOL}); the attention "
            f"layers' rolling buffer T = {T} wraps at decode position {RECUR_LONG} "
            f"(slot {RECUR_LONG % T}); RG-LRU states and conv windows carried")
        del model, seq
        gc.collect()
        torch.cuda.empty_cache()

        # (d) xlstm-125m whole
        xcfg = configs.get(XLSTM_ARCH)
        t0 = time.perf_counter()
        xl = M.init_params(xcfg, torch.Generator(device=dev).manual_seed(1), dev)
        torch.cuda.synchronize()
        x_init = time.perf_counter() - t0
        x_params = sum(p.numel() for p in xl.parameters())
        if not x_params == M.param_count(xcfg) == XLSTM_PARAMS:
            raise AssertionError(f"xlstm-125m: {x_params:,} parameters")
        xkinds = [b.kind[0] for b in xl.layers]
        log(f"recurrent(d): {XLSTM_ARCH}, {len(xl.layers)} layers "
            f"{ {k: xkinds.count(k) for k in sorted(set(xkinds))} }, {x_params:,} "
            f"parameters, tied embeddings: {xcfg.tied_embeddings}, init {x_init:.3f} s")
        xdata = data_lib.DataConfig(vocab=xcfg.vocab, seq=XLSTM_FORWARD,
                                    global_batch=Bg, seed=1)
        xbatch = data_lib.batch_at(xdata, 0)["inputs"]
        out["xlstm"] = layerwise_vs_cpu(xl, torch.from_numpy(xbatch[:1]), "recurrent(d)")
        t0 = time.perf_counter()
        out["xlstm"]["identity_err"] = decode_identity(
            xl, torch.from_numpy(xbatch[:1]).to(dev), RECUR_LONG, "recurrent(d)")
        torch.cuda.synchronize()
        out["xlstm"]["identity_s"] = time.perf_counter() - t0
        out["xlstm"].update(generate_twice(xcfg, xl, xbatch[:, :Sg], new, dev,
                                           "recurrent(d)"))
        out["xlstm"].update(params=x_params, init_s=x_init,
                            decode_bound=pass_bound(xl, Bg))
        xo = out["xlstm"]
        log(f"recurrent(d): prefill({RECUR_LONG}) + {RECUR_STEPS} decode steps vs "
            f"forward({XLSTM_FORWARD}) (positions {RECUR_LONG - 1}-"
            f"{RECUR_LONG + RECUR_STEPS - 1}): max |err| {xo['identity_err']:.5f} "
            f"({xo['identity_s']:.3f} s); Engine.generate batch {Bg}, prompt {Sg}, "
            f"{new} new tokens: prefill {xo['prefill_ms']:.3f} ms, decode "
            f"{xo['decode_ms_per_token']:.3f} ms/token (bound "
            f"{xo['decode_bound'][0]:.4f} ms, {xo['decode_bound'][1]}), "
            f"{xo['tokens_per_s']:.1f} tokens/s end to end; greedy x2 equal")
        del xl
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the serve launcher
        obs.REGISTRY.reset()
        t0 = time.perf_counter()
        served = launch_serve.main(["--arch", XLSTM_ARCH, "--smoke", "--retrieval",
                                    "--device", str(dev)])
        out["launcher_s"] = time.perf_counter() - t0
        launches = ops.launch_counts()
        counters = obs.snapshot()["counters"]
        out.update(launcher_in_range=served["in_range"], launches=launches,
                   launcher_fused={key: v for key, v in counters.items()
                                   if key.startswith("engine.fused_traversal")})
        log(f"recurrent(e): `python -m repro_torch.launch.serve --arch {XLSTM_ARCH} "
            f"--smoke --retrieval` ran in {out['launcher_s']:.3f} s "
            f"({served['in_range']} in-range neighbours); launches over phase 9: "
            f"{json.dumps(launches)}; the launcher's lookup dispatches "
            f"{json.dumps(out['launcher_fused'])}")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return launches, out


# -- phase 10: training --------------------------------------------------------------
TRAIN_ARCH = KNNLM_ARCH          # qwen2-0.5b, 494,032,768 parameters
TRAIN_BATCH = (4, 2048)          # (a): two attention chunks of 1,024 a row
TRAIN_WARM, TRAIN_TIMED = 2, 5   # (a): warm-up and timed steps
TRAIN_CUT = 3                    # (b): qwen2-0.5b's first 3 layers, full width
TRAIN_CPU_BATCH = (1, 2048)      # (b)
# (b): card against CPU on the same weights and batch. Each gradient
# within a relative Frobenius error of 2e-2 (plus 1e-6 of the global
# gradient norm, for gradients that vanish): bf16 products sum in other
# orders on each device and the backward rounds its cotangents to bf16 at
# every cast (the CPU tests hold the port to the reference at 5e-2). Loss:
# rtol 1e-3. The first AdamW step moves a coordinate by about ±lr by its
# gradient's sign whatever the gradient's size, so where a gradient is at
# the level of the rounding its sign, and the update, is the rounding's.
# Two checks of the update, neither of which reads the card's gradient to
# choose what it compares: (1) the card's AdamW applied to the CPU's
# gradients equals the CPU's update within 1e-5 (relative Frobenius, every
# coordinate of every tensor: the optimizer's arithmetic on the card);
# (2) the card's own update within 1e-2 over the coordinates whose CPU
# gradient is at least TRAIN_SURE of its tensor's RMS (`update_error`), in
# every tensor but those whose gradient vanishes analytically
# (TRAIN_VANISHING: softmax ignores a score shift common to a row's keys,
# so the key bias's gradient is the rounding's alone). The error over all
# coordinates is printed beside it.
TRAIN_GRAD_RTOL, TRAIN_STEP_RTOL, TRAIN_LOSS_RTOL = 2e-2, 1e-2, 1e-3
TRAIN_OPT_RTOL = 1e-5
TRAIN_SURE = 0.1
TRAIN_VANISHING = (".mixer.bk",)
XLSTM_TRAIN = (8, 256)           # (c): examples/train_lm.py's batch and length
XLSTM_RESUME = (6, 3, 4)         # (c): steps, checkpoint every, failure at
XLSTM_LOSS_STEPS = 20            # (c): the loss must fall over these


def train_flops(cfg, batch: int, seq: int, n_params: int) -> float:
    """A training step's work by the usual count: 6 · parameters · tokens
    (forward 2, backward 4) plus the causal attention's score and value
    products, 3 × the forward's 4 · B · H · S² · hd / 2 a layer (the
    causally masked half of each diagonal chunk pair, which the packed
    schedule computes and discards, is not counted). The recomputation of
    remat is not counted either: the rate is the model's, not the run's."""
    attn_layers = sum(1 for mixer, _ in cfg.layer_plan() if mixer == "attn")
    attn = 3 * 4 * batch * cfg.n_heads * seq * seq * cfg.hd / 2 * attn_layers
    return 6.0 * n_params * batch * seq + attn


def rel_err(got, want, mask=None) -> float:
    """||got − want|| / ||want|| (Frobenius), over `mask` where given."""
    if mask is not None:
        got, want = got[mask], want[mask]
    ref = float(want.norm())
    return float((got - want).norm()) / ref if ref else float((got - want).norm())


def update_error(du, dw, gw) -> tuple:
    """(relative Frobenius error of the update du against dw over the
    coordinates whose CPU gradient |gw| is at least TRAIN_SURE of gw's RMS,
    the share of such coordinates). The coordinates are chosen from the
    CPU's side alone."""
    sure = gw.abs() >= TRAIN_SURE * gw.square().mean().sqrt()
    return rel_err(du, dw, sure), float(sure.float().mean())


def _grads(model, batch):
    from repro_torch.models import model as M

    loss, _ = M.loss_fn(model, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


def train_card_vs_cpu(cfg, dev, batch=TRAIN_CPU_BATCH) -> dict:
    """Phase 10 (b): `cfg` (qwen2-0.5b's first layers, tied embedding) with
    f32 masters from one seed, copied to the card; the same `batch` (B, S)
    on both: the loss, every gradient, the card's AdamW on the CPU's
    gradients, and every parameter's first AdamW update, card against CPU,
    within the stated tolerances."""
    import copy

    from repro_torch.data import tokens as data_lib
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt

    cpu = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                        param_dtype=torch.float32)
    card = copy.deepcopy(cpu).to(dev)
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    B, S = batch
    b = data_lib.batch_at(data_lib.DataConfig(vocab=cfg.vocab, seq=S,
                                              global_batch=B, seed=1), 0)
    out = {}
    updates, grads, losses = {}, {}, {}
    ocfg = opt.AdamWConfig(lr=6e-4, warmup_steps=1, total_steps=2)
    for name, model, where in (("cpu", cpu, "cpu"), ("card", card, dev)):
        model.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
        t0 = time.perf_counter()
        losses[name], grads[name] = _grads(model, batch)
        params = dict(model.named_parameters())
        opt.update(ocfg, grads[name], opt.init(params), params)
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
        updates[name] = {n: (p.detach().cpu() - before[n]) for n, p in params.items()}
    # (1) the card's AdamW on the CPU's gradients, from the same weights
    params = {n: w.to(dev, copy=True) for n, w in before.items()}
    opt.update(ocfg, {n: g.to(dev) for n, g in grads["cpu"].items()},
               opt.init(params), params)
    total = float(opt.global_norm(grads["cpu"].values()))
    worst_g, worst_o, worst_u, every, sure = {}, {}, {}, {}, {}
    for n, w in grads["cpu"].items():
        g = grads["card"][n].cpu()
        err = rel_err(g, w)
        if float((g - w).norm()) > TRAIN_GRAD_RTOL * float(w.norm()) + 1e-6 * total:
            raise AssertionError(f"train(b): gradient of {n} differs card vs "
                                 f"CPU by {err:.3e} (relative)")
        worst_g[n] = err
        worst_o[n] = rel_err(params[n].cpu() - before[n], updates["cpu"][n])
        if not worst_o[n] <= TRAIN_OPT_RTOL:
            raise AssertionError(f"train(b): the card's AdamW update of {n} on "
                                 f"the CPU's gradients differs by {worst_o[n]:.3e}")
        every[n] = rel_err(updates["card"][n], updates["cpu"][n])
        if n.endswith(TRAIN_VANISHING):
            continue
        worst_u[n], sure[n] = update_error(updates["card"][n], updates["cpu"][n], w)
        if not worst_u[n] <= TRAIN_STEP_RTOL:
            raise AssertionError(f"train(b): the AdamW update of {n} differs "
                                 f"card vs CPU by {worst_u[n]:.3e} (relative)")
    lerr = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    if not lerr <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train(b): loss {losses['card']} on the card, "
                             f"{losses['cpu']} on the CPU")
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:3])  # noqa: E731
    out.update(loss_card=losses["card"], loss_cpu=losses["cpu"], loss_rel_err=lerr,
               grad_rel_err_max=max(worst_g.values()), grad_worst=top(worst_g),
               opt_rel_err_max=max(worst_o.values()),
               update_rel_err_max=max(worst_u.values()), update_worst=top(worst_u),
               sure_share_min=dict(sorted(sure.items(), key=lambda kv: kv[1])[:3]),
               update_all_coords_worst=top({n: every[n] for n in worst_u}),
               update_all_coords_vanishing={n: e for n, e in every.items()
                                            if n not in worst_u},
               grad_norm=total)
    return out


def run_train(dev):
    """Phase 10: training on the card (no kernel of the port is on this
    path: the reference's flash backward is plain JAX). (a) qwen2-0.5b at
    full width and depth, f32 masters, AdamW, remat "full"; (b) its first
    3 layers card against CPU; (c) xlstm-125m whole, the reference
    example's run: a failure injected and a bitwise resume, under
    deterministic algorithms, then 20 steps whose loss falls; (d) the
    training launcher on the reduced deepseek and recurrentgemma. The
    launch counts are set to 0 before (a) and read after (d)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import tokens as data_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import loop as L
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    ops.reset_launch_counts()
    out = {}
    try:
        # (a) qwen2-0.5b at full width and depth
        cfg = configs.get(TRAIN_ARCH)
        B, S = TRAIN_BATCH
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                              param_dtype=torch.float32).requires_grad_(True)
        state = opt.init(dict(model.named_parameters()))
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != KNNLM_PARAMS or any(p.dtype != torch.float32
                                           for p in model.parameters()):
            raise AssertionError(f"train(a): {n_params:,} parameters, want "
                                 f"{KNNLM_PARAMS:,} f32 masters")
        ocfg = opt.AdamWConfig(lr=6e-4, warmup_steps=TRAIN_WARM,
                               total_steps=TRAIN_WARM + TRAIN_TIMED + 1)
        step = make_train_step(cfg, ocfg)
        data = data_lib.stream(data_lib.DataConfig(vocab=cfg.vocab, seq=S,
                                                   global_batch=B, seed=0),
                               device=dev)
        losses, secs = [], []
        for i in range(TRAIN_WARM + TRAIN_TIMED):
            batch = next(data)
            torch.cuda.synchronize()
            if i == TRAIN_WARM + TRAIN_TIMED - 1:
                # the last step's own peak, which phase 11 (c) holds the
                # dry run's count against
                peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, state, met = step(model, state, batch)
            losses.append(float(met["loss"]))
            secs.append(time.perf_counter() - t0)
        out["step_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["peak_gb"] = max(peak, out["step_peak_bytes"]) / 1e9
        timed = secs[TRAIN_WARM:]
        step_s = float(np.mean(timed))
        flops = train_flops(cfg, B, S, n_params)
        out.update(params=n_params, losses=losses, step_s=timed, step_s_mean=step_s,
                   tokens_per_s=B * S / step_s, flops=flops,
                   bf16_rate_share=flops / step_s / envelope()[1][torch.bfloat16])
        if not (np.isfinite(losses).all()
                and np.mean(losses[TRAIN_WARM:]) < losses[0]):
            raise AssertionError(f"train(a): losses {losses}")
        split = profile_pass(lambda: step(model, state, next(data)),
                             classes=DECODE_CLASSES)
        out["step_profile"] = {key: split[key] for key in (
            "by_class", "pass_host_ms", "device_busy_ms", "device_idle_share",
            "device_events", "top_events")}
        log(f"train(a): {TRAIN_ARCH} on the card, {len(model.layers)} layers, "
            f"{n_params:,} f32 master parameters, AdamW, remat {cfg.remat!r}, "
            f"batch {B} x {S}: init {out['init_s']:.3f} s; losses "
            f"{[round(x, 5) for x in losses]}; step s {[round(x, 4) for x in timed]} "
            f"(mean {step_s:.4f}), {out['tokens_per_s']:.1f} tokens/s, peak "
            f"{out['peak_gb']:.3f} GB (the last step's own "
            f"{out['step_peak_bytes'] / 1e9:.3f} GB); {flops:.4e} FLOP a step = "
            f"{out['bf16_rate_share']:.4f} of the dense bf16 rate; one step "
            f"profiled: {json.dumps(out['step_profile'])}")
        del model, state, step, data, met
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the first layers, card against CPU
        cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT)
        out["card_vs_cpu"] = train_card_vs_cpu(cut, dev)
        log(f"train(b): {TRAIN_ARCH}'s first {TRAIN_CUT} layers, tied "
            f"embedding, batch {TRAIN_CPU_BATCH}, card vs CPU: "
            f"{json.dumps(out['card_vs_cpu'])}")
        gc.collect()
        torch.cuda.empty_cache()

        # (c) xlstm-125m whole: failure, resume, loss
        xcfg = configs.get(XLSTM_ARCH)
        Bx, Sx = XLSTM_TRAIN
        steps, every, fail = XLSTM_RESUME
        quiet = dict(global_batch=Bx, seq=Sx, log_fn=lambda *_: None, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            torch.use_deterministic_algorithms(True)
            try:
                def loop(name, n, **kw):
                    return L.LoopConfig(steps=n, ckpt_every=every, seed=0,
                                        ckpt_dir=os.path.join(tmp, name),
                                        log_every=1000, **kw)
                # one schedule for every run: the 20-step loss run continues
                # the uninterrupted run's checkpoint at step 6
                ocfg = opt.AdamWConfig(lr=6e-4, warmup_steps=20,
                                       total_steps=XLSTM_LOSS_STEPS)
                t0 = time.perf_counter()
                ref = L.train(xcfg, loop("ok", steps), opt_cfg=ocfg, **quiet)
                t_ok = time.perf_counter() - t0
                try:
                    L.train(xcfg, loop("crash", steps, fail_at_step=fail),
                            opt_cfg=ocfg, **quiet)
                    raise AssertionError("train(c): the injected failure did not fire")
                except L.InjectedFailure:
                    pass
                t0 = time.perf_counter()
                res = L.train(xcfg, loop("crash", steps), opt_cfg=ocfg, **quiet)
                t_resume = time.perf_counter() - t0
                resumed = [h["step"] for h in res["history"]]
                same = all(torch.equal(res["params"][n], p)
                           and torch.equal(res["opt"]["m"][n], ref["opt"]["m"][n])
                           and torch.equal(res["opt"]["v"][n], ref["opt"]["v"][n])
                           for n, p in ref["params"].items())
                if resumed != list(range(every, steps)) or not same:
                    raise AssertionError(f"train(c): resume from step {every} not "
                                         f"bitwise equal (steps {resumed})")
                x_params = sum(p.numel() for p in ref["params"].values())
                history = ref["history"]
                del ref, res
                t0 = time.perf_counter()
                run = L.train(xcfg, L.LoopConfig(
                    steps=XLSTM_LOSS_STEPS, ckpt_every=10_000, seed=0, log_every=1000,
                    ckpt_dir=os.path.join(tmp, "ok")), opt_cfg=ocfg, **quiet)
                t_loss = time.perf_counter() - t0
            finally:
                torch.use_deterministic_algorithms(False)
        history += run["history"]
        del run
        if [h["step"] for h in history] != list(range(XLSTM_LOSS_STEPS)):
            raise AssertionError(f"train(c): steps {[h['step'] for h in history]}")
        xl = [h["loss"] for h in history]
        if not (np.isfinite(xl).all() and np.mean(xl[-5:]) < np.mean(xl[:5])):
            raise AssertionError(f"train(c): xlstm losses {xl}")
        out["xlstm"] = {"params": x_params, "ok_s": t_ok, "resume_s": t_resume,
                        "resumed_steps": resumed, "loss_run_s": t_loss,
                        "losses": xl, "first5": float(np.mean(xl[:5])),
                        "last5": float(np.mean(xl[-5:]))}
        log(f"train(c): {XLSTM_ARCH} whole ({x_params:,} parameters), batch "
            f"{Bx} x {Sx}, deterministic algorithms: {steps} steps with a "
            f"checkpoint every {every} in {t_ok:.3f} s; failure injected at step "
            f"{fail}, resumed steps {resumed} in {t_resume:.3f} s: parameters "
            f"and moments bitwise equal to the uninterrupted run's; that run "
            f"continued to {XLSTM_LOSS_STEPS} steps in {t_loss:.3f} s, loss "
            f"{out['xlstm']['first5']:.5f} (first 5) -> {out['xlstm']['last5']:.5f} "
            f"(last 5)")
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the launcher on the reduced MLA + MoE and RG-LRU configs
        out["launcher"] = {}
        for arch in (MOE_ARCH, RECUR_ARCH):
            with tempfile.TemporaryDirectory() as tmp:
                got = launch_train.main([
                    "--arch", arch, "--smoke", "--steps", "4", "--global-batch", "4",
                    "--seq", "64", "--ckpt-every", "2", "--ckpt-dir", tmp,
                    "--device", str(dev)])
            if not np.isfinite(got["losses"]).all():
                raise AssertionError(f"train(d): {arch} losses {got['losses']}")
            out["launcher"][arch] = {"losses": got["losses"], "seconds": got["seconds"]}
        log(f"train(d): the launcher, --smoke on the card (reduced configs: "
            f"neither fits one card for training whole): "
            f"{json.dumps(out['launcher'])}")
        launches = ops.launch_counts()
        log(f"train: kernel launches over (a)-(d) {json.dumps(launches)}")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return launches, out


# -- phase 11: accounting ---------------------------------------------------------
ACCOUNT_DECODE = ("decode_32k", (TRAIN_ARCH, MOE_ARCH, RECUR_ARCH, XLSTM_ARCH))
TUNED_SLOWER = 1.10  # the tuned split may be at most this much slower than today's


def check_tuned_scan(dev, pts, queries, r, shapes=((64, 4096), (5300, 4096)), k=10):
    """Phase 11 (a): topk_l2 at the main path's shapes under the
    autotuner's three best-ranked splits and today's `scan_geometry`
    split: each (sq, gid, slot) bitwise equal to the plain version, eager
    and graph-replayed ms beside the model's prediction; the tuned split
    no more than 10% slower than today's, or today's itself."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import topk_l2 as tk

    out = {}
    for nq, n in shapes:
        q = torch.from_numpy(queries[:nq].astype(np.float32)).to(dev)
        p = torch.from_numpy(pts[:n].astype(np.float32)).to(dev)
        gids = torch.arange(n, device=dev, dtype=torch.int32)
        gids[::7] = -1  # tombstoned arena slots, as phase 2
        r_sq = tk.radius_sq_upper(torch.full((nq,), r, device=dev))
        want = tk.topk_plain(q, p, gids, r_sq, k)
        ranked = at.ranked("topk_l2", nq, n, 2, k)
        tuned = at.choose_plan("topk_l2", nq, n, 2, k, backend="cuda")
        today = tk.scan_geometry(nq, n, k)["split"]
        picks = ranked[:3] + [x for x in ranked[3:] if x["bn"] in (today, tuned["bn"])]
        rows = {}
        for plan in picks:
            bn = plan["bn"]
            got = tk.topk_cuda(q, p, gids, r_sq, k, split=bn)
            torch.cuda.synchronize()
            for what, x, y in zip(("sq", "gid", "slot"), got, want):
                if not torch.equal(x, y):
                    raise AssertionError(f"accounting(a): topk_l2 Q={nq} split {bn} "
                                         f"{what} differs from the plain version")

            def kernel(bn=bn):
                return tk.topk_cuda(q, p, gids, r_sq, k, split=bn)

            rows[bn] = {"rank": ranked.index(plan), "blocks": plan["blocks"],
                        "pred_us": plan["score"] * 1e6, "ms": time_ms(kernel, reps=20),
                        "graph_ms": time_graph_ms(kernel), "today": bn == today,
                        "tuned": bn == tuned["bn"]}
            log(f"accounting(a): topk_l2 Q={nq} N={n} k={k} split {bn} "
                f"(rank {rows[bn]['rank']}{', today' if bn == today else ''}"
                f"{', tuned' if bn == tuned['bn'] else ''}): blocks {plan['blocks']}, "
                f"pred {rows[bn]['pred_us']:.3f} us, eager {rows[bn]['ms']:.5f} ms, "
                f"graph {rows[bn]['graph_ms']:.5f} ms; bitwise equal to the plain version")
        t, d = rows[tuned["bn"]], rows[today]
        if tuned["bn"] != today and (t["ms"] > TUNED_SLOWER * d["ms"]
                                     or t["graph_ms"] > TUNED_SLOWER * d["graph_ms"]):
            raise AssertionError(f"accounting(a): Q={nq}: tuned split {tuned['bn']} "
                                 f"{t} slower than today's {today} {d}")
        out[f"q{nq}"] = {"tuned_split": tuned["bn"], "today_split": today,
                         "candidates": len(ranked), "splits": rows}
    return out


def run_accounting(dev, pts, queries, r, train_out):
    """Phase 11: (a) the tuned topk_l2 split at the main path's shapes;
    (c) the dry run (`launch/dryrun.run_cell`) of phase 10's cell —
    qwen2-0.5b training at 4 x 2,048, remat "full", AdamW — held against
    that step on the card: its counted peak against the last step's
    `max_memory_allocated()` (within 10%), its product FLOPs against
    `train_flops` (1.0–1.5x: remat's second forward and the diagonal
    chunk pairs' masked halves are counted); then one decode_32k cell of
    each family at its published size. (b) ran at the end of phase 3."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun

    out = {"scan": check_tuned_scan(dev, pts, queries, r)}
    B, S = TRAIN_BATCH
    rec = dryrun.run_cell(TRAIN_ARCH, Shape("train_phase10", "train", S, B), "single")
    peak_ratio = rec["peak_bytes"] / train_out["step_peak_bytes"]
    flop_ratio = rec["product_flops_per_device"] / train_out["flops"]
    out["train_cell"] = {"record": rec, "measured_peak_bytes": train_out["step_peak_bytes"],
                         "peak_ratio": peak_ratio, "train_flops": train_out["flops"],
                         "product_flop_ratio": flop_ratio}
    log(f"accounting(c): {dryrun.summary(rec)}")
    log(f"accounting(c): {TRAIN_ARCH} train {B} x {S}: counted peak "
        f"{rec['peak_bytes']:,} B / the step's max_memory_allocated "
        f"{train_out['step_peak_bytes']:,} B = {peak_ratio:.4f}; product FLOPs "
        f"{rec['product_flops_per_device']:.4e} / train_flops "
        f"{train_out['flops']:.4e} = {flop_ratio:.4f}")
    if abs(peak_ratio - 1.0) > 0.10 or not 1.0 <= flop_ratio <= 1.5:
        raise AssertionError(f"accounting(c): peak ratio {peak_ratio}, FLOP ratio "
                             f"{flop_ratio}")
    shape, archs = ACCOUNT_DECODE
    out["decode"] = {}
    for arch in archs:
        rec = dryrun.run_cell(arch, shape, "single")
        if rec.get("skipped") or rec.get("error"):
            raise AssertionError(f"accounting(c): {arch} {shape}: {rec}")
        out["decode"][arch] = {key: rec[key] for key in (
            "ops", "compile_s", "flops_per_device", "product_flops_per_device",
            "hbm_bytes_per_device", "peak_bytes", "fits", "t_compute_s",
            "t_memory_s", "dominant")}
        log(f"accounting(c): {dryrun.summary(rec)}")
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
    seconds = {}  # wall seconds of each phase, its checks included
    t0 = time.perf_counter()

    def lap(phase):
        nonlocal t0
        t1 = time.perf_counter()
        seconds[phase] = t1 - t0
        t0 = t1

    gen = torch.Generator(device=dev).manual_seed(0)
    leaf_variants, leaf_err = check_leaf(dev, gen)
    scan = check_scan(dev, pts, queries, r)
    big_routes, big_checked, big = run_large_k(dev, pts, queries, r)
    lap("kernels")

    launches, single, exported = run_main(dev, pts, queries, r)
    lap("main")
    prim_launches, pair, cov = run_primitives(dev, pts, queries)
    lap("primitives")
    with tempfile.TemporaryDirectory() as tmp:
        rec, direct, _ = run_durable(dev, pts, queries, r, tmp)
        serve_launches, serve, serve_shapes = run_serve(rec, queries, r, direct)
        rec.close()
    served = check_serve_shapes(dev, pts, queries, r, serve_shapes, serve_launches)
    lap("serve")
    with tempfile.TemporaryDirectory() as tmp:
        dist_launches, dist_shapes, dist = run_distribution(
            dev, pts, queries, r, tmp, single)
    del single
    dist_checked = check_serve_shapes(dev, pts, queries, r, dist_shapes,
                                      dist_launches, label="distributed")
    lap("distributed")
    knn_launches, knn_shapes, knn, keys, knn_q, knn_r, store = run_knnlm(dev)
    del store
    torch.cuda.empty_cache()
    # the arena held the decode steps' states (the queries) ahead of the
    # store's keys
    knn_checked = check_serve_shapes(dev, np.concatenate([knn_q, keys]), knn_q,
                                     knn_r, knn_shapes, knn_launches,
                                     label="knnlm", required=("topk_l2",))
    knn_leaf = check_knnlm_leaf(dev)
    del keys
    log("knnlm: summary " + json.dumps(
        {k: v for k, v in knn.items() if k not in ("shapes",)}))
    lap("knnlm")
    gc.collect()  # phase 7's model and store
    torch.cuda.empty_cache()
    moe_launches, moe_out = run_moe(dev)
    log("moe: summary " + json.dumps(moe_out))
    lap("moe")
    gc.collect()  # phase 8's models
    torch.cuda.empty_cache()
    rec_launches, rec_out = run_recurrent(dev)
    log("recurrent: summary " + json.dumps(rec_out))
    lap("recurrent")
    gc.collect()  # phase 9's models
    torch.cuda.empty_cache()
    train_launches, train_out = run_train(dev)
    log("train: summary " + json.dumps(train_out))
    lap("train")
    account = run_accounting(dev, pts, queries, r, train_out)
    log("accounting: summary " + json.dumps({"export": exported, **account}))
    lap("accounting")
    log("phase seconds " + json.dumps(seconds))

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
                                   "shapes": served["leaf_topk"]},
                         "distribution": {"launches": dist_launches["leaf_topk"],
                                          "shapes": dist_checked["leaf_topk"]},
                         "knnlm": {"launches": knn_launches["leaf_topk"],
                                   "shapes": knn_checked["leaf_topk"],
                                   "d32_frontier_cap": knn_leaf},
                         "moe": {"launches": moe_launches["leaf_topk"]},
                         "recurrent": {"launches": rec_launches["leaf_topk"]},
                         "train": {"launches": train_launches["leaf_topk"]}},
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
                "shapes": served["topk_l2"]}, "distribution": {
                "launches": dist_launches["topk_l2"],
                "launches_by_q": dist["topk_l2_launches_by_q"],
                "shapes": dist_checked["topk_l2"]}, "knnlm": {
                "launches": knn_launches["topk_l2"],
                "shapes": knn_checked["topk_l2"]},
                "moe": {"launches": moe_launches["topk_l2"]},
                "recurrent": {"launches": rec_launches["topk_l2"]},
                "train": {"launches": train_launches["topk_l2"]}},
        },
    ]
    # the sort route (k > 1,024) of both top-k kernels, on phase 2 (b)'s
    # path (launches: its k = 2,000 query's, by route)
    for name, replaces in (("leaf_topk", LEAF_REPLACES), ("topk_l2", SCAN_REPLACES)):
        rows = big_checked[name]
        m = max(rows, key=lambda row: row["launches"])
        kernels.append({
            "name": f"{name}_sort", "route": "cuda", "source": LEAF_SRC,
            "replaces": replaces, "launches": big_routes[name]["sort"],
            "max_abs_err": 0.0, "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m.get("library_ms"),
            "variants": {"shapes": rows, "path": big,
                         "list_launches": big_routes[name]["list"]},
        })
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
            "library_ms": m["library_ms"],
            "variants": {**res, "recurrent": {"launches": rec_launches[name]},
                         "train": {"launches": train_launches[name]}},
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
