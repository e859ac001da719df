"""Fused constrained top-k over L2 distances: CUDA kernels + plain versions.

Port of the reference's `kernels/topk_l2.py` (two Pallas TPU kernels)
and `kernels/ref.py` (their jnp oracles). Each function exists twice
here:

  * a hand-written CUDA kernel (`csrc/topk_l2.cu`), launched by
    `leaf_topk_cuda` / `topk_cuda`, each of which counts its device
    launches in `LAUNCHES` (one per leaf call; two per `topk_cuda` call:
    the |p|² pre-pass and the split scan, whose last block per query
    group merges the split k-lists — it finds itself by an atomic ticket
    in a per-stream counter, `cuda_lib.ticket_counters`). For k above
    `_MAX_K` both take the sort route instead (`route`): one launch of
    `topk_sort_kernel`, a block a row sorting the row's (sq, slot) keys
    (one launch per cut of the rows where the keys need a global
    scratch);
  * a plain PyTorch version (`leaf_topk_plain` / `topk_plain`) that
    repeats the kernel's arithmetic operation by operation — so the two
    agree bitwise — used for CPU tensors and as the kernel's referent
    on the card.

`kernels/ops.py` picks one by the tensors' device: CUDA launches the
kernel or raises, the CPU runs the plain version; nothing falls back.

Selection contract (both functions): candidates are keyed
lexicographically by (squared distance, slot), where slot is the
candidate's column (the DFS visit order of the gathered leaf frontier,
or the arena slot) — exactly the order a stable argsort of the masked
row gives, ties to the lower slot. A candidate is masked (never kept)
when its gid is negative or its squared distance exceeds the squared
radius gate. Outputs are (sq f32, gid i32, slot i32) of width k, with
(+inf, -1, I32_MAX) where fewer than k candidates pass.

Squared-distance selection with two-pass radius refinement (see the
reference module for the full argument): the gate is the
conservatively widened `radius_sq_upper(r)`, and the callers apply the
exact euclidean gate `sqrt(sq) <= r` to the k survivors only.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_lib

I32_MAX = int(np.iinfo(np.int32).max)

# conservative relative slack for the squared radius gate: with
# correctly-rounded f32 ops, sqrt(sq) <= r implies
# sq < (r*r) * (1 + 1.76 * 2^-23); 2^-20 leaves an 8x margin
_R2_SLACK = 1.0 + 2.0**-20

# device launches since the last reset, per kernel: incremented only
# where a kernel is launched (never by the plain versions)
LAUNCHES = {"leaf_topk": 0, "topk_l2": 0}
# device launches since the last reset, by kernel and call shape:
# ("leaf_topk", R, C, D, k, storage dtype) and ("topk_l2", Q, N, D, k)
LAUNCH_SHAPES: dict = {}


def launches_by_q() -> dict:
    """topk_l2's device launches since the last reset, by the call's
    query count (from `LAUNCH_SHAPES`)."""
    out: dict = {}
    for key, n in LAUNCH_SHAPES.items():
        if key[0] == "topk_l2":
            out[key[1]] = out.get(key[1], 0) + n
    return dict(sorted(out.items()))


def launches_by_route() -> dict:
    """Both top-k kernels' device launches since the last reset, by
    selection route (`route` of the call's k, from `LAUNCH_SHAPES`)."""
    out = {name: {"list": 0, "sort": 0} for name in LAUNCHES}
    for key, n in LAUNCH_SHAPES.items():
        out[key[0]][route(key[4])] += n
    return out


_LEAF_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_K = 1024  # k > 32: the selection list lives in shared memory, 12 B an entry
# k above _MAX_K: the sort route (`route`), one block a row sorting the
# row's 8-byte keys, in shared memory up to this width, else in a global
# scratch of at most _SORT_SCRATCH bytes a launch (rows are cut into
# launches to fit it)
_SORT_SMEM_WIDTH = 232_448 // 8
_SORT_SCRATCH = 256 << 20
_SMEM_MAX = 232_448  # shared memory a block may use on Hopper
# warps per block, as csrc/topk_l2.cu launches them
_LEAF_WARPS = 8
_SCAN_WARPS = 8
_REG_K = 32             # k up to this: the register list (any split count)
# topk_l2's split geometry: the scan aims at this many blocks, and splits
# hold at least this many points
_SCAN_TARGET_BLOCKS = 264
_SCAN_MIN_SPLIT = 256
_SCAN_PPL = 2           # arena points a lane a step (k <= 32)
_PNORM_THREADS = 256


def radius_sq_upper(r: torch.Tensor) -> torch.Tensor:
    """Conservatively-rounded squared radius: every candidate whose
    euclidean f32 distance satisfies `sqrt(sq) <= r` also satisfies
    `sq <= radius_sq_upper(r)` (same rounding as the reference)."""
    return r * r * torch.tensor(_R2_SLACK, dtype=r.dtype, device=r.device)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def route(k: int) -> str:
    """The kernels' selection for k: "list" (the per-warp k-lists, k up
    to `_MAX_K`) or "sort" (one block a row sorts its keys, any k)."""
    return "list" if k <= _MAX_K else "sort"


def _blocks(rows: int, per_block: int) -> int:
    return (rows + per_block - 1) // per_block


def scan_geometry(m: int, n: int, k: int) -> dict:
    """The split scan's launch geometry, from (Q, N, k) alone: one warp a
    query, 8 a block, `ppl` points a lane a step, `split` arena points per
    split (whole steps of 32·ppl), `groups` query groups × `splits` splits
    = the scan's grid. Small Q splits the arena so that the grid still
    fills the card (Q = 64, N = 4,096: 8 groups × 16 splits of 256); at
    Q = 5,300 every query's warp scans the whole arena. k > 32 keeps the
    shared-memory list: one point a lane, one split."""
    groups = -(-m // _SCAN_WARPS)
    if k > _REG_K:
        ppl, splits = 1, 1
    else:
        ppl = _SCAN_PPL
        splits = max(1, min(-(-_SCAN_TARGET_BLOCKS // groups),
                            -(-n // _SCAN_MIN_SPLIT)))
    step = 32 * ppl  # a split is whole steps of 32 lanes × ppl points
    split = -(-(-(-n // splits)) // step) * step
    return {"ppl": ppl, "split": split, "groups": groups,
            "splits": -(-n // split)}


def _pre_records(n: int, d: int, geo: dict) -> int:
    """Records the |p|² pre-pass writes: at D = 2 one 16-byte record per
    slot of every whole split and of one step more (the last step's
    prefetch), dead past n; otherwise |p|² of the n points."""
    return geo["splits"] * geo["split"] + 32 * geo["ppl"] if d == 2 else n


def block_plan(m: int, n: int, d: int, k: int) -> dict:
    """Cost of one `topk_l2` call (`topk_cuda`) as the CUDA kernels run
    it: `grid` is the blocks of its two launches — the |p|² pre-pass (one
    thread a point) and the split scan (`scan_geometry`: query groups ×
    arena splits; the last block of each group also merges the group's
    split k-lists) — and `blocks` their sum; `hbm_bytes` is what the
    function must move — q, p, gids and the gate read once, the (Q, k)
    triple written once; `flops` is the function's arithmetic — per
    (query, point) pair the expansion-form dot (2 per dim), |q|²+|p|²,
    2·dot, the subtraction, the clamp and the radius and k-th-key
    compares, plus one |q|² and one |p|² each. Neither the split k-lists
    nor their merge is counted: they are the design's, not the
    function's."""
    geo = scan_geometry(m, n, k)
    grid = (_blocks(_pre_records(n, d, geo), _PNORM_THREADS),
            geo["groups"] * geo["splits"])
    return {
        "grid": grid,
        "blocks": sum(grid),
        "flops": m * n * (2 * d + 5) + 2 * d * (m + n),
        "hbm_bytes": m * d * 4 + n * d * 4 + n * 4 + m * 4 + m * k * 12,
    }


def leaf_block_plan(r: int, c: int, d: int, k: int, *, itemsize: int = 4) -> dict:
    """Cost of one leaf launch (`leaf_topk_cuda`) as the CUDA kernel runs
    it: `blocks` is the grid it launches (one warp per row, 8 per
    block); `hbm_bytes` is what the function must move — each row's q,
    its (c, d) candidates at their STORAGE width `itemsize` (4 = f32,
    2 = bf16, 1 = int8, which also streams a per-candidate f32 scale),
    its gids and gate read once, the (r, k) triple written once;
    `flops` is the difference-form arithmetic per candidate (3 per dim,
    one more for the int8 scale) plus the radius and k-th-key
    compares."""
    scaled = itemsize == 1
    return {
        "blocks": _blocks(r, _LEAF_WARPS),
        "flops": r * c * ((4 if scaled else 3) * d + 2),
        "hbm_bytes": r * d * 4
        + r * c * d * itemsize
        + r * c * 4
        + (r * c * 4 if scaled else 0)
        + r * 4
        + r * k * 12,
    }


# -- plain versions -----------------------------------------------------------
def _select(sq: torch.Tensor, ok: torch.Tensor, gids: torch.Tensor, k: int):
    """k smallest of each row by the (sq, slot) key over the candidates
    that pass `ok`; masked lanes carry (+inf, I32_MAX) and sort after
    every passing one. Two stable sorts give the lexicographic order:
    first passing-before-masked (column order kept), then by sq."""
    rows, width = sq.shape
    first = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)
    key = torch.where(ok, sq, torch.full_like(sq, float("inf")))
    second = torch.argsort(torch.gather(key, 1, first), dim=1, stable=True)
    order = torch.gather(first, 1, second)[:, :k]
    kept = torch.gather(ok, 1, order)
    out_sq = torch.gather(key, 1, order)
    out_g = torch.where(kept, torch.gather(gids, 1, order), -1).to(torch.int32)
    out_s = torch.where(kept, order, I32_MAX).to(torch.int32)
    if out_sq.shape[1] < k:
        pad = k - out_sq.shape[1]
        pad_ = torch.nn.functional.pad
        out_sq = pad_(out_sq, (0, pad), value=float("inf"))
        out_g = pad_(out_g, (0, pad), value=-1)
        out_s = pad_(out_s, (0, pad), value=I32_MAX)
    return out_sq, out_g, out_s


def leaf_sq(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Σ_d (q_d − c_d)² in f32, summed in dimension order with every
    operation rounded on its own (no contraction) — the one reduction
    order the leaf kernel, the traversal's in-loop leaf evaluation and
    the rescore pass all share. q broadcasts against c (..., D)."""
    acc = None
    for dim in range(c.shape[-1]):
        t = q[..., dim] - c[..., dim]
        acc = t * t if acc is None else acc + t * t
    return acc


def _widen(cands: torch.Tensor, cscale) -> torch.Tensor:
    """f32 image of stored candidates: widen, then (int8) one exact f32
    multiply by the per-candidate pow2 scale."""
    c = cands.to(torch.float32)
    if cscale is not None:
        c = c * cscale.to(torch.float32)[:, :, None]
    return c


def leaf_topk_plain(q, cands, cgids, r_sq, k: int, cscale=None):
    """Plain version of the leaf kernel: q (R, D) f32, cands (R, C, D)
    f32 / bf16 / int8 (+ cscale (R, C) f32), cgids (R, C) i32, r_sq (R,)
    the already-squared gate. Returns (sq, gid, slot), each (R, k)."""
    sq = leaf_sq(q[:, None, :], _widen(cands, cscale))
    ok = (cgids >= 0) & (sq <= r_sq[:, None])
    return _select(sq, ok, cgids, k)


def expansion_sq(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared distances in the expansion form
    (|q|² + |p|²) − 2·q·p, every dot product summed in dimension order
    with separately rounded operations, clamped at 0 — the topk_l2
    kernel's arithmetic, step for step."""
    def dot(a, b):
        acc = None
        for dim in range(a.shape[-1]):
            t = a[..., dim] * b[..., dim]
            acc = t if acc is None else acc + t
        return acc

    qn = dot(q, q)[:, None]
    pn = dot(p, p)[None, :]
    qp = dot(q[:, None, :], p[None, :, :])
    return torch.clamp((qn + pn) - 2.0 * qp, min=0.0)


def topk_plain(q, p, gids, r_sq, k: int):
    """Plain version of the shared-points kernel: q (Q, D), p (N, D) f32,
    gids (N,) i32, r_sq (Q,). Returns (sq, gid, slot), each (Q, k)."""
    sq = expansion_sq(q, p)
    g = gids[None, :].expand_as(sq)
    ok = (g >= 0) & (sq <= r_sq[:, None])
    return _select(sq, ok, g, k)


# -- CUDA launches ------------------------------------------------------------
def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _outputs(rows: int, k: int, device):
    return (
        torch.empty((rows, k), dtype=torch.float32, device=device),
        torch.empty((rows, k), dtype=torch.int32, device=device),
        torch.empty((rows, k), dtype=torch.int32, device=device),
    )


def leaf_topk_cuda(q, cands, cgids, r_sq, k: int, cscale=None):
    """Launch the leaf kernel (same contract as `leaf_topk_plain`)."""
    device = cands.device
    rows, c, d = cands.shape
    code = _LEAF_DTYPE_CODES.get(cands.dtype)
    if code is None:
        raise ValueError(f"leaf_topk: unsupported storage {cands.dtype}")
    if (code == 2) != (cscale is not None):
        raise ValueError("leaf_topk: int8 candidates need cscale, others not")
    if k < 1:
        raise ValueError(f"leaf_topk: k={k} < 1")
    _check(q, "q", torch.float32, (rows, d), device)
    _check(cands, "cands", cands.dtype, (rows, c, d), device)
    _check(cgids, "cgids", torch.int32, (rows, c), device)
    _check(r_sq, "r_sq", torch.float32, (rows,), device)
    if cscale is not None:
        _check(cscale, "cscale", torch.float32, (rows, c), device)
    out = _outputs(rows, k, device)
    lib = cuda_lib.library()
    index = device.index
    scale = cscale.data_ptr() if cscale is not None else None
    with cuda_lib.on_device(index):
        stream = cuda_lib.current_stream(index)
        if route(k) == "list":
            err = lib.leaf_topk_launch(
                code, q.data_ptr(), cands.data_ptr(), scale,
                cgids.data_ptr(), r_sq.data_ptr(), rows, c, d, k,
                *(o.data_ptr() for o in out), stream,
            )
            launches = 1
        else:
            err, launches = _sort_launches(
                lambda row0, n, keys: lib.leaf_topk_sort_launch(
                    code, q.data_ptr(), cands.data_ptr(), scale,
                    cgids.data_ptr(), r_sq.data_ptr(), row0, n, c, d, k, keys,
                    *(o.data_ptr() for o in out), stream),
                rows, c, device)
    cuda_lib.raise_on(err, "leaf_topk")
    LAUNCHES["leaf_topk"] += launches
    key = ("leaf_topk", rows, c, d, k, str(cands.dtype).removeprefix("torch."))
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + launches
    return out


def _sort_launches(launch, rows: int, width: int, device):
    """Run the sort route over `rows` rows of `width` candidates:
    `launch(row0, n, keys)` launches rows [row0, row0 + n) with keys in
    shared memory (keys None) where a row fits, else in a global scratch
    of n · width keys, as many rows a launch as `_SORT_SCRATCH` holds.
    Returns (the first nonzero CUDA error or 0, launches made)."""
    if width <= _SORT_SMEM_WIDTH:
        return launch(0, rows, None), 1
    per = max(1, min(rows, _SORT_SCRATCH // (8 * width)))
    keys = torch.empty(per * width, dtype=torch.int64, device=device)
    launches = 0
    for row0 in range(0, rows, per):
        err = launch(row0, min(per, rows - row0), keys.data_ptr())
        launches += 1
        if err:
            return err, launches
    return 0, launches


def _scan_smem(k: int) -> int:
    """Dynamic shared memory of the split scan: per warp either its
    survivor buffer (k <= 32: 64 entries of 12 B) or its k-list (12 B an
    entry); raises where a block cannot hold it."""
    per_warp = 64 * 12 if k <= _REG_K else k * 12
    smem = _SCAN_WARPS * per_warp
    if smem > _SMEM_MAX:
        raise ValueError(f"topk_l2: k={k} exceeds the shared memory")
    return smem


@functools.lru_cache(maxsize=256)
def _scan_launch(m: int, n: int, d: int, k: int):
    """(ppl, split, groups, splits, scratch words) of one `topk_cuda` call,
    kept per shape: the Python that computes them costs microseconds a
    call. Raises where a block cannot hold the k-lists."""
    geo = scan_geometry(m, n, k)
    _scan_smem(k)
    # scratch, one int32 buffer: the pre-pass's records (4 words each),
    # then with splits > 1 the (m, splits, k) split lists (sq, gid, slot)
    pre = 4 * _pre_records(n, d, geo)
    parts = 3 * m * geo["splits"] * k if geo["splits"] > 1 else 0
    return geo["ppl"], geo["split"], geo["groups"], geo["splits"], pre, parts


def topk_cuda(q, p, gids, r_sq, k: int):
    """Launch the shared-points kernels (same contract as `topk_plain`)."""
    device = p.device
    m, d = q.shape
    n = p.shape[0]
    if k < 1:
        raise ValueError(f"topk_l2: k={k} < 1")
    if m == 0 or n == 0 or d == 0:
        raise ValueError(f"topk_l2: empty input Q={m} N={n} D={d}")
    _check(q, "q", torch.float32, (m, d), device)
    _check(p, "p", torch.float32, (n, d), device)
    _check(gids, "gids", torch.int32, (n,), device)
    _check(r_sq, "r_sq", torch.float32, (m,), device)
    if route(k) == "sort":
        return _topk_sort(q, p, gids, r_sq, k)
    ppl, split, groups, splits, pre, parts = _scan_launch(m, n, d, k)
    out = _outputs(m, k, device)
    scratch = torch.empty(pre + parts, dtype=torch.int32, device=device)
    base = scratch.data_ptr()
    part = [base + 4 * (pre + i * m * splits * k) if parts else None
            for i in range(3)]
    lib = cuda_lib.library()
    index = device.index
    with cuda_lib.on_device(index):
        stream = cuda_lib.current_stream(index)
        tickets = (cuda_lib.ticket_counters(index, stream, groups).data_ptr()
                   if splits > 1 else None)
        err = lib.topk_l2_launch(
            q.data_ptr(), p.data_ptr(), gids.data_ptr(), r_sq.data_ptr(),
            m, n, d, k, ppl, split, base, *part, tickets,
            *(o.data_ptr() for o in out), stream,
        )
    cuda_lib.raise_on(err, "topk_l2")
    LAUNCHES["topk_l2"] += 2  # topk_pnorm_kernel, then topk_scan_kernel
    key = ("topk_l2", m, n, d, k)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 2
    return out


def _topk_sort(q, p, gids, r_sq, k: int):
    """`topk_cuda` for k above the list's ceiling: the sort route, one
    launch (or one per scratch-sized cut of the queries)."""
    device = p.device
    m, d = q.shape
    n = p.shape[0]
    out = _outputs(m, k, device)
    lib = cuda_lib.library()
    index = device.index
    with cuda_lib.on_device(index):
        stream = cuda_lib.current_stream(index)
        err, launches = _sort_launches(
            lambda row0, rows, keys: lib.topk_l2_sort_launch(
                q.data_ptr(), p.data_ptr(), gids.data_ptr(), r_sq.data_ptr(),
                row0, rows, n, d, k, keys, *(o.data_ptr() for o in out),
                stream),
            m, n, device)
    cuda_lib.raise_on(err, "topk_l2")
    LAUNCHES["topk_l2"] += launches
    key = ("topk_l2", m, n, d, k)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + launches
    return out
