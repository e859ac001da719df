"""Launch-geometry autotuner of the port's CUDA kernels (a port of the
reference's `kernels/autotune.py`, with the H100's envelope in place of
the TPU's).

The reference chose (bm, bn, bk) block sizes per shape class for its
Pallas kernels. The port's kernels take one launch geometry each, and
this module chooses, per (kernel, pow2 shape class, k, dtype, backend),
among the geometries a kernel really accepts at run time:

  * `topk_l2`: the split scan's arena points a split (`topk_l2.
    scan_geometry`; candidates are whole steps of 32·ppl points, from one
    step to the whole arena, today's default among them). Where k > 32,
    or the query groups outnumber a stream's ticket counters, the arena
    is not split: one candidate;
  * `leaf_topk_l2`: one plan (its 8 warps a block are compiled in);
  * `pairwise_sq_l2`: one plan per route (`pairwise_l2.route`, `_TILES`);
  * `cov_matvec`: one plan (`cov_matvec.geometry`: its sum order follows
    the geometry, so it is not a free knob).

A kernel with one plan still records its decision, so `decisions()`
lists every kernel a run launched. Candidates are ranked by an analytic
model of one call on the card (`score`):

    score = max(steps, padded_flops / peak, stream_bytes / HBM_BW)
            + launches * KERNEL_LAUNCH_S + blocks * LAUNCH_OVERHEAD_S

where `steps` is the time of the scans' warps: the longer of one warp's
dependent steps (its split, then the last block's merge of the split
k-lists) and all warps' steps over the steps the card overlaps. No
result depends on the plan: the (sq, slot) keys are totally ordered, so
a split changes only which block finds a key first
(`topk_l2.topk_plain(split=)` repeats the kernel's split and merge).

Ranking is analytic and cached per shape class, so the hot path never
measures: a cache hit is one dict lookup. `choose_plan(measure=)` times
the top candidates for real and keeps the fastest (benchmarks only).
`REPRO_BLOCK_PLAN=<bq>x<bn>[x<bk>]` pins every decision; a pin a kernel
cannot take resolves through its planner, as a candidate does, and the
plan records the resolved geometry.

Decision fields, with the port's meanings: `bm` queries (rows) a block;
`bn` arena points a split (`topk_l2`), candidates a row (`leaf_topk_l2`),
output columns a tile (`pairwise_sq_l2`) or rows a tile (`cov_matvec`,
whose `bm` is rows a block); `bk` D; `grid` the blocks of each launch;
`vmem_bytes` a block's shared memory; `padded_flops` the arithmetic the
launched grid does, padding included; `stream_bytes` the device-memory
bytes the launches move; `backend` "cuda" or "cpu"; `dtype`
`quantize.dtype_name`'s spelling ("float32", ...).
"""
from __future__ import annotations

import functools
import os
import time
from typing import Callable, Optional

import torch

from .. import obs
from . import cov_matvec as _cm
from . import cuda_lib
from . import pairwise_l2 as _pw
from . import topk_l2 as _tk

# H100 SXM, NVIDIA's data sheet (dense rates, at its 700 W limit): device
# memory 3.35 TB/s; f32 outside the tensor cores 67 TFLOP/s; bf16 on the
# tensor cores with f32 sums 989 TFLOP/s; TF32 495 TFLOP/s. An f32 x f32
# matrix product computed to f32 accuracy by three TF32 products a term
# (the 3xTF32 split) runs at 495 / 3 = 165 TFLOP/s ("f32_product"). 132
# SMs; 227 KB (232,448 B) of shared memory a block.
HBM_BW = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              "f32_product": 495e12 / 3}
SMS = 132
SMEM_BUDGET = _tk._SMEM_MAX

# the launch model's constants, fitted to the split scan's device times
# on one H100 80GB HBM3 at 700 W (chip_smoke PR 15, graph-replayed):
# Q = 5,300, N = 4,096 (one split, 64 steps a warp) 0.0266 ms and Q = 64
# (16 splits of 256) 0.00923 ms
KERNEL_LAUNCH_S = 3.5e-6   # a kernel launch, replayed back to back
LAUNCH_OVERHEAD_S = 2e-9   # a block: its issue, spread over the SMs
STEP_S = 0.12e-6           # one warp's step: 32·ppl points, or 32 merged entries
SM_WARPS = 16              # warps whose steps an SM overlaps at that latency

_CACHE: dict[tuple, dict] = {}


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def shape_class(m: int, n: int, d: int) -> tuple:
    """The pow2 bucket a problem shape tunes under — the same padding
    classes the query engine stacks segments by, so one engine shape
    class always resolves to one cached plan."""
    return (_next_pow2(m), _next_pow2(n), _next_pow2(d))


def parse_block_plan_env(value: Optional[str] = None) -> Optional[tuple]:
    """Parse the `REPRO_BLOCK_PLAN=<bq>x<bn>[x<bk>]` pin (the reference's
    grammar and checks). Returns (bm, bn, bk) with bk defaulted to 512,
    or None when unset. Raises ValueError on malformed values or sizes
    that violate the constraints (pow2 bn, bm a multiple of 8, bk of
    128, all positive)."""
    if value is None:
        value = os.environ.get("REPRO_BLOCK_PLAN", "")
    if not value:
        return None
    parts = value.lower().split("x")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"REPRO_BLOCK_PLAN must be <bq>x<bn> or <bq>x<bn>x<bk>, "
            f"got {value!r}"
        )
    try:
        nums = [int(p) for p in parts]
    except ValueError:
        raise ValueError(f"REPRO_BLOCK_PLAN has non-integer parts: {value!r}")
    bm, bn = nums[0], nums[1]
    bk = nums[2] if len(nums) == 3 else 512
    if bm <= 0 or bn <= 0 or bk <= 0:
        raise ValueError(f"REPRO_BLOCK_PLAN sizes must be positive: {value!r}")
    if bm % 8:
        raise ValueError(
            f"REPRO_BLOCK_PLAN bq must be a multiple of 8 (sublane), "
            f"got {bm}"
        )
    if bn & (bn - 1):
        raise ValueError(
            f"REPRO_BLOCK_PLAN bn must be a power of two (the in-kernel "
            f"selection network sorts along it), got {bn}"
        )
    if bk % 128:
        raise ValueError(
            f"REPRO_BLOCK_PLAN bk must be a multiple of 128 (lane), "
            f"got {bk}"
        )
    return bm, bn, bk


@functools.lru_cache(maxsize=8)
def _pin(value: str) -> Optional[tuple]:
    return parse_block_plan_env(value)


def _steps_time(path_steps: float, warp_steps: float) -> float:
    """Seconds of warps stepping: one warp's dependent steps, or all
    warps' steps over what the card overlaps, whichever is longer."""
    return STEP_S * max(path_steps, warp_steps / (SMS * SM_WARPS))


def score(plan: dict) -> float:
    """Analytic time of one call under `plan` (seconds): the longest of
    its warps' steps, its padded arithmetic and its bytes, plus the cost
    of its launches and blocks."""
    t_comp = plan["padded_flops"] / plan["peak"]
    t_mem = plan["stream_bytes"] / HBM_BW
    return (max(plan["step_s"], t_comp, t_mem)
            + plan["launches"] * KERNEL_LAUNCH_S
            + plan["blocks"] * LAUNCH_OVERHEAD_S)


# -- planners: one resolved plan of a kernel's launch --------------------------
def _topk_plan(m, n, d, k, *, bn=None, itemsize=4, m_cls=None):
    """topk_l2 under a requested split `bn` (arena points; None: today's
    `scan_geometry`). k above the list route's ceiling: the sort route,
    one block a query. `m_cls` (the class's largest Q) decides whether
    the split is possible for every shape of the class."""
    if _tk.route(k) == "sort":
        return {"bm": 1, "bn": n, "bk": d, "grid": (m,), "blocks": m,
                "launches": 1, "padded_flops": m * n * (2 * d + 5),
                "stream_bytes": _tk.block_plan(m, n, d, k)["hbm_bytes"],
                "vmem_bytes": 8 * n if n <= _tk._SORT_SMEM_WIDTH else 0,
                "step_s": _steps_time(-(-n // 256), m * -(-n // 256)),
                "peak": PEAK_FLOPS[torch.float32], "split": None}
    if m_cls is not None and -(-m_cls // _tk._SCAN_WARPS) > cuda_lib.TICKETS:
        bn = None  # some shape of the class has more groups than counters
    geo = _tk.scan_geometry(m, n, k, bn)
    ppl, split, groups, splits = geo["ppl"], geo["split"], geo["groups"], geo["splits"]
    plan = _tk.block_plan(m, n, d, k, split)
    steps = split // (32 * ppl)
    merge = -(-splits * k // 32) if splits > 1 else 0
    warps = groups * _tk._SCAN_WARPS
    records = _tk._pre_records(n, d, geo)
    parts = 2 * 12 * m * splits * k if splits > 1 else 0
    return {
        "bm": _tk._SCAN_WARPS, "bn": split, "bk": d, "grid": plan["grid"],
        "blocks": plan["blocks"], "launches": 2,
        "padded_flops": warps * splits * split * (2 * d + 5),
        # the function's bytes, the pre-pass's records written and read,
        # the split k-lists written and merged
        "stream_bytes": plan["hbm_bytes"] + 2 * records * (16 if d == 2 else 4) + parts,
        "vmem_bytes": _tk._scan_smem(k),
        "step_s": _steps_time(steps + merge, warps * (splits * steps + merge)),
        "peak": PEAK_FLOPS[torch.float32], "split": split,
    }


def _leaf_plan(r, c, d, k, *, itemsize=4, **_):
    """leaf_topk_l2's one plan: a warp a row, 8 a block; the list route
    keeps its survivor buffers in shared memory (csrc/topk_l2.cu
    `launch_leaf_vd`), the sort route a row's keys."""
    plan = _tk.leaf_block_plan(r, c, d, k, itemsize=itemsize)
    if _tk.route(k) == "sort":
        grid, smem = (r,), (8 * c if c <= _tk._SORT_SMEM_WIDTH else 0)
        step_s = _steps_time(-(-c // 256), r * -(-c // 256))
    else:
        per = 16 // (d * itemsize) if d == 2 else 1  # candidates a lane loads
        smem = _tk._LEAF_WARPS * (32 * (per + 1) * 12 if k <= 32 else k * 12)
        grid = (plan["blocks"],)
        steps = -(-c // (32 * per))
        step_s = _steps_time(steps, r * steps)
    return {"bm": _tk._LEAF_WARPS, "bn": c, "bk": d, "grid": grid,
            "blocks": sum(grid), "launches": 1,
            "padded_flops": -(-r // _tk._LEAF_WARPS) * _tk._LEAF_WARPS * c * (3 * d + 2),
            "stream_bytes": plan["hbm_bytes"], "vmem_bytes": smem,
            "step_s": step_s, "peak": PEAK_FLOPS[torch.float32], "split": None}


# the pairwise kernel's shared memory a block, per route (csrc/pairwise_l2.cu:
# the narrow route's q rows, their norms and the staged output rows; the wide
# route's `Wide<T>::kSmem`, the same for both operand types)
def _pairwise_smem(name: str, d: int) -> int:
    if name == "cuda_core":
        return 4 * (64 * d + 64 + 8 * 256)
    return 1024 + 2 * 4 * 128 * 128 + 128 * 136 * 4 + 2 * (64 + 128) * 4 + 128


def _pairwise_plan(m, n, d, k=0, *, itemsize=4, **_):
    plan = _pw.block_plan(m, n, d, itemsize)
    tm, tn = plan["tile"]
    name = plan["route"]
    peak = {"cuda_core": PEAK_FLOPS[torch.float32],
            "wgmma_bf16": PEAK_FLOPS[torch.bfloat16],
            "wgmma_tf32x3": PEAK_FLOPS["f32_product"]}[name]
    tiles = -(-m // tm) * -(-n // tn)
    return {"bm": tm, "bn": tn, "bk": d, "grid": plan["grid"],
            "blocks": plan["blocks"], "launches": len(plan["grid"]),
            "padded_flops": 2 * tiles * tm * tn * d,
            "stream_bytes": plan["hbm_bytes"],
            "vmem_bytes": _pairwise_smem(name, d), "step_s": 0.0,
            "peak": peak, "split": None}


def _cov_plan(n, d, *, itemsize=4):
    rows, blocks, _ = _cm.geometry(n, d)
    plan = _cm.block_plan(n, d, itemsize)
    tile = _cm.tile_rows(d)
    if _cm.route(d) == "wide":
        smem = 4 * d if 4 * d <= 56 * 1024 else 0
    else:  # the cp.async ring of 3 tiles, μ, w and the column sums
        smem = 3 * 4096 * 4 + 4 * (10 * d + tile)
    return {"bm": rows, "bn": tile, "bk": d, "grid": (blocks,),
            "blocks": blocks, "launches": 1,
            "padded_flops": 4 * blocks * rows * d,
            "stream_bytes": plan["hbm_bytes"] + 8 * blocks * d,  # + the partials
            "vmem_bytes": smem, "step_s": 0.0,
            "peak": PEAK_FLOPS[torch.float32], "split": None}


_PLANNERS: dict[str, Callable[..., dict]] = {
    "topk_l2": _topk_plan,
    "leaf_topk_l2": _leaf_plan,
    "pairwise_sq_l2": _pairwise_plan,
    "cov_matvec": lambda m, n, d, k, **kw: _cov_plan(m, d, **kw),
}


def _topk_candidates(n: int, k: int) -> list:
    """Requested splits of topk_l2: whole steps from one step up in
    powers of two, the whole arena, and today's default (None)."""
    if _tk.route(k) == "sort" or k > _tk._REG_K:
        return [None]
    step = 32 * _tk._SCAN_PPL
    out, s = [None], step
    while s < n:
        out.append(s)
        s *= 2
    out.append(-(-n // step) * step)
    return out


def _rank(kernel: str, m: int, n: int, d: int, k: int, itemsize: int = 4,
          m_cls: Optional[int] = None) -> list:
    """Every candidate plan of the shape, deduplicated after resolution,
    within the shared-memory budget, cheapest analytic score first."""
    planner = _PLANNERS[kernel]
    requests = _topk_candidates(n, k) if kernel == "topk_l2" else [None]
    seen, plans = set(), []
    for bn in requests:
        extra = {"bn": bn, "m_cls": m_cls} if kernel == "topk_l2" else {}
        p = planner(m, n, d, k, itemsize=itemsize, **extra)
        key = (p["bm"], p["bn"], p["bk"])
        if key in seen or p["vmem_bytes"] > SMEM_BUDGET:
            continue
        seen.add(key)
        p["score"] = score(p)
        plans.append(p)
    plans.sort(key=lambda p: p["score"])
    return plans


def _record(kernel: str, cls: tuple, k: int, plan: dict) -> None:
    """Publish the decision as labeled gauges + the exportable table."""
    if not obs.REGISTRY.enabled:
        return
    labels = {"kernel": kernel, "cls": "x".join(map(str, cls)), "k": k}
    g = obs.REGISTRY.gauge
    g("autotune.bm", **labels).set(plan["bm"])
    g("autotune.bn", **labels).set(plan["bn"])
    g("autotune.bk", **labels).set(plan["bk"])
    g("autotune.blocks", **labels).set(plan["blocks"])
    g("autotune.pred_us", **labels).set(plan["score"] * 1e6)
    if "measured_us" in plan:
        g("autotune.measured_us", **labels).set(plan["measured_us"])


_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def choose_plan(
    kernel: str,
    m: int,
    n: int,
    d: int,
    k: int = 0,
    *,
    dtype: str = "float32",
    backend: Optional[str] = None,
    measure: Optional[Callable[[dict], float]] = None,
    trials: int = 3,
) -> dict:
    """The (cached) plan of one kernel call shape: (m, n, d) are (Q, N, D)
    of `topk_l2`, (R, C, D) of `leaf_topk_l2`, (M, N, D) of
    `pairwise_sq_l2` and (N, D, D) of `cov_matvec`; `dtype` the streamed
    storage's name; `backend` "cuda" or "cpu" (default: "cuda" where
    there is a card).

    Cache key: (kernel, pow2 shape class, k, dtype, backend, pin,
    measured) — every shape in a class gets the same plan (a split is
    resolved for each call's N at launch). `REPRO_BLOCK_PLAN` replaces
    the ranking (source="env"). Passing `measure` (a callable running one
    call under a candidate plan, returning seconds) re-ranks the top
    `trials` analytic candidates by their best of two runs and keeps the
    fastest (source="measured") — only benchmarks do this."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    pinned = _pin(os.environ.get("REPRO_BLOCK_PLAN", ""))
    cls = shape_class(m, n, d)
    key = (kernel, cls, k, dtype, backend, pinned, measure is not None)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    itemsize = _ITEMSIZE[dtype]
    if pinned is not None:
        extra = {"bn": pinned[1], "m_cls": cls[0]} if kernel == "topk_l2" else {}
        plan = _PLANNERS[kernel](m, n, d, k, itemsize=itemsize, **extra)
        plan["score"] = score(plan)
        plan["source"] = "env"
    else:
        ranked = _rank(kernel, m, n, d, k, itemsize, m_cls=cls[0])
        plan = ranked[0]
        plan["source"] = "analytic"
        if measure is not None:
            best_t = None
            for cand in ranked[:trials]:
                t = min(measure(cand) for _ in range(2))
                cand["measured_us"] = t * 1e6
                if best_t is None or t < best_t:
                    best_t, plan = t, cand
            plan["source"] = "measured"
    _CACHE[key] = plan
    _record(kernel, cls, k, plan)
    return plan


def ranked(kernel: str, m: int, n: int, d: int, k: int = 0, *,
           dtype: str = "float32") -> list:
    """Every candidate plan of one call shape, best first (uncached): what
    a measurement holds against the choice."""
    return _rank(kernel, m, n, d, k, _ITEMSIZE[dtype],
                 m_cls=shape_class(m, n, d)[0])


def decisions() -> dict:
    """Every cached decision of this process, keyed for the
    `BENCH_obs.json` `autotune` section."""
    out = {}
    for (kernel, cls, k, dtype, backend, _pin_, _meas), plan in _CACHE.items():
        key = f"{kernel}/{'x'.join(map(str, cls))}/k{k}/{dtype}/{backend}"
        out[key] = {
            "bm": plan["bm"],
            "bn": plan["bn"],
            "bk": plan["bk"],
            "grid": list(plan["grid"]),
            "blocks": plan["blocks"],
            "padded_flops": plan["padded_flops"],
            "stream_bytes": plan["stream_bytes"],
            "vmem_bytes": plan["vmem_bytes"],
            "pred_us": plan["score"] * 1e6,
            "source": plan["source"],
            **(
                {"measured_us": plan["measured_us"]}
                if "measured_us" in plan
                else {}
            ),
        }
    return out


def reset() -> None:
    """Drop all cached decisions (tests and benchmark isolation)."""
    _CACHE.clear()


def timed(fn: Callable[[], object]) -> float:
    """Seconds of one call of `fn`: between two CUDA events on the
    current stream, waited for, where there is a card; on a machine
    without one the call is synchronous and the host clock times it —
    the `measure` building block of a benchmark."""
    if torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
