"""Batched tree search in PyTorch — port of the reference's `search_jax`.

The reference vmaps an explicit-stack `lax.while_loop` per query. Here
every (segment, query) pair of a stacked shape-class batch is one *lane*
of a batched masked-stack loop (`_walk`): each iteration pops one node
from every non-empty lane stack with about a hundred whole-batch tensor
operations, and the loop runs until every stack is empty (checked on
the host every `_SYNC_EVERY` iterations; an emptied lane is a no-op). The
traversal order, pruning rules and node accounting replicate the host
reference exactly:

  pop nearest-first DFS;  D_N = max(D_parent, |q-c| - radius);
  prune when D_N >= D_s (KNN) OR D_N > r (range);
  children pushed only if their ball intersects the range ball.

Two uses of the one loop:

  * classic (`constrained_knn_stacked`): each visited leaf is evaluated
    in the loop and merged into a per-lane sorted k-best;
  * fused phase 1 (`_collect_frontier_stacked`): the same pruning state
    (the k-best VALUES, so D_s evolves identically) but instead of ids
    it records each lane's scanned leaves, in DFS order. Phase 2
    gathers those leaves and evaluates every candidate in ONE launch of
    the leaf kernel (`kernels/ops.leaf_topk_l2[_raw]`).

Fused == classic bitwise inside the port: the loop's leaf evaluation
(`topk_l2.leaf_sq`), the leaf kernel, its plain version and the rescore
pass all sum Σ(q−c)² in one fixed order with separately rounded
operations, and the classic loop's incremental k-best equals the global
top-k of all evaluated candidates keyed by (squared distance, DFS
slot) — the kernel's key. (The reference pins XLA's reduction shape by
padding the feature dim to 128 lanes instead.)

Host syncs are counted on the registry (`search.host_syncs{site=...}`):
the loop's emptiness checks, phase 1's frontier width (`nf_max`) and the
quantized path's containment certificate. Each frontier walk adds its
loop iterations (`search.phase1.iters`, a multiple of `_SYNC_EVERY`),
lanes × iterations (`search.phase1.lane_iters`: the issued work) and the
lanes' pops (`search.phase1.visits`: the useful part, read with the
`nf_max` sync) once, after the loop, while the registry is on.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from ..kernels import ops
from ..kernels import topk_l2 as _tk
from ..query import merge as qmerge
from .types import Tree

# loop iterations between host checks for "every lane stack is empty"
_SYNC_EVERY = 8

_C_SYNC = {
    site: obs.REGISTRY.counter("search.host_syncs", site=site)
    for site in ("loop", "nf_max", "quant_contained")
}
# phase 1's issued and useful work (frontier walks only): loop
# iterations, lanes × iterations, and the lanes' pops (`visits`)
_C_PHASE1 = {
    name: obs.REGISTRY.counter(f"search.phase1.{name}")
    for name in ("iters", "lane_iters", "visits")
}


class DeviceTree(NamedTuple):
    center: torch.Tensor        # (n_nodes, d)
    radius: torch.Tensor        # (n_nodes,)
    child_l: torch.Tensor       # (n_nodes,) i64
    child_r: torch.Tensor       # (n_nodes,) i64
    leaf_of_node: torch.Tensor  # (n_nodes,) i64
    leaf_points: torch.Tensor   # (n_leaves, cap, d)
    leaf_index: torch.Tensor    # (n_leaves, cap) i32


def device_tree(tree: Tree, dtype=torch.float32, device="cuda") -> DeviceTree:
    """Upload a host `Tree`'s search arrays (node ids as i64 so they
    index directly; leaf slots as i32 like every gid tensor)."""
    def put(a, dt):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)

    return DeviceTree(
        center=put(tree.center, dtype),
        radius=put(tree.radius, dtype),
        child_l=put(tree.child_l, torch.int64),
        child_r=put(tree.child_r, torch.int64),
        leaf_of_node=put(tree.leaf_of_node, torch.int64),
        leaf_points=put(tree.leaf_points, dtype),
        leaf_index=put(tree.leaf_index, torch.int32),
    )


def max_depth(tree: Tree) -> int:
    return int(tree.leaf_depths().max())


class KnnResult(NamedTuple):
    indices: torch.Tensor     # (Q, k) original point ids, -1 = no result
    distances: torch.Tensor   # (Q, k) inf where no result
    nodes_visited: torch.Tensor  # (Q,)
    # paper-metric accounting (host-oracle parity): `leaves_visited`
    # counts scanned NON-EMPTY leaves, `points_examined` the live leaf
    # slots whose distance was evaluated
    leaves_visited: Optional[torch.Tensor] = None    # (Q,)
    points_examined: Optional[torch.Tensor] = None   # (Q,)


class StackedResult(NamedTuple):
    gids: torch.Tensor           # (Q, k) merged global ids, -1 = no result
    distances: torch.Tensor      # (Q, k) merged, ascending; inf = none
    nodes_visited: torch.Tensor  # (Q,) summed over the stacked segments
    leaves_visited: Optional[torch.Tensor] = None
    points_examined: Optional[torch.Tensor] = None


def _radius(r, nq: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(r, dtype=dtype, device=device).expand(nq).contiguous()


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Σ_d x_d² in dimension order (the port's one reduction order)."""
    acc = x[..., 0] * x[..., 0]
    for dim in range(1, x.shape[-1]):
        acc = acc + x[..., dim] * x[..., dim]
    return acc


class _Walk(NamedTuple):
    best_sq: torch.Tensor    # (L, k) squared k-best values
    best_i: Optional[torch.Tensor]    # (L, k) local ids (classic only)
    frontier: Optional[torch.Tensor]  # (L, fcap) leaf ranks (collect only)
    nf: Optional[torch.Tensor]        # (L,) true frontier sizes
    visits: torch.Tensor     # (L,)
    leaves: torch.Tensor     # (L,)
    cands: torch.Tensor      # (L,)


def _walk(dts: DeviceTree, queries, r, k: int, stack_size: int,
          fcap: Optional[int] = None) -> _Walk:
    """The batched masked-stack DFS over S stacked segments × Q queries;
    lane l = s·Q + q. `fcap` None runs the classic loop (ids tracked),
    otherwise phase 1 (leaf frontier recorded, up to `fcap` per lane;
    `nf` keeps counting past it so the caller can detect truncation).
    The loop owns every state tensor it writes (fresh allocations), so
    in-place updates never touch a caller's or a snapshot's tensor."""
    s, nn_, dim = dts.center.shape
    nl, cap = dts.leaf_points.shape[1], dts.leaf_points.shape[2]
    nq = queries.shape[0]
    lanes = s * nq
    dev, dtype = dts.center.device, dts.center.dtype
    center = dts.center.reshape(s * nn_, dim)
    radius = dts.radius.reshape(-1)
    child_l = dts.child_l.reshape(-1)
    child_r = dts.child_r.reshape(-1)
    leaf_of_node = dts.leaf_of_node.reshape(-1)
    leaf_points = dts.leaf_points.reshape(s * nl, cap, dim)
    leaf_index = dts.leaf_index.reshape(s * nl, cap)
    seg = torch.arange(s, device=dev).repeat_interleave(nq)
    node_base, leaf_base = seg * nn_, seg * nl
    q = queries.to(dtype).repeat(s, 1)            # (L, d)
    rr = r.to(dtype).repeat(s)                    # (L,)
    r2 = _tk.radius_sq_upper(rr)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    sp = torch.ones(lanes, dtype=torch.int64, device=dev)
    stack_n = torch.zeros((lanes, stack_size), dtype=torch.int64, device=dev)
    stack_b = torch.zeros((lanes, stack_size), dtype=dtype, device=dev)
    best_sq = torch.full((lanes, k), float("inf"), dtype=dtype, device=dev)
    collect = fcap is not None
    if collect:
        frontier = torch.full((lanes, fcap), -1, dtype=torch.int64, device=dev)
        nf = torch.zeros(lanes, dtype=torch.int64, device=dev)
        best_i = None
    else:
        frontier = nf = None
        best_i = torch.full((lanes, k), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros(lanes, dtype=torch.int32, device=dev)
    leaves = torch.zeros(lanes, dtype=torch.int32, device=dev)
    cands = torch.zeros(lanes, dtype=torch.int32, device=dev)

    it = 0
    while True:
        if it % _SYNC_EVERY == 0:
            _C_SYNC["loop"].inc()
            if not bool((sp > 0).any()):
                break
        it += 1
        act = sp > 0
        sp = sp - act.long()
        top = sp[:, None]
        node = stack_n.gather(1, top)[:, 0]
        d_par = stack_b.gather(1, top)[:, 0]
        visits += act
        gnode = node_base + node
        dc = torch.sqrt(_sq_norm(q - center[gnode]))
        d_n = torch.maximum(d_par, dc - radius[gnode])
        # one sqrt per lane recovers the euclidean k-th best: node
        # pruning stays in the euclidean domain like the host oracle
        d_s = torch.sqrt(best_sq[:, k - 1])
        prune = (d_n >= d_s) | (d_n > rr)
        is_leaf = child_l[gnode] < 0
        take_leaf = act & is_leaf & ~prune

        # ---- leaf evaluation (kept only where take_leaf) ----------------
        rank = leaf_of_node[gnode].clamp(min=0)
        li = leaf_index[leaf_base + rank]                   # (L, cap)
        sql = _tk.leaf_sq(q[:, None, :], leaf_points[leaf_base + rank])
        ok = (li >= 0) & (sql <= r2[:, None]) & (sql < best_sq[:, k - 1 :])
        sql = torch.where(ok, sql, inf)
        both = torch.cat([best_sq, sql], dim=1)
        if collect:
            new_sq = torch.sort(both, dim=1).values[:, :k]
        else:
            # stable: the carried k-best wins ties, then lower leaf slots
            # — the reference's topk_sorted + merge_sorted order
            new_sq, order = torch.sort(both, dim=1, stable=True)
            new_sq = new_sq[:, :k]
            ids = torch.cat([best_i, torch.where(ok, li, -1)], dim=1)
            new_i = ids.gather(1, order[:, :k])
            best_i = torch.where(take_leaf[:, None], new_i, best_i)
        best_sq = torch.where(take_leaf[:, None], new_sq, best_sq)
        n_real = (li >= 0).sum(dim=1, dtype=torch.int32)
        leaves += take_leaf & (n_real > 0)
        cands += torch.where(take_leaf, n_real, 0)
        if collect:
            record = take_leaf & (n_real > 0)
            widx = nf.clamp(max=fcap - 1)[:, None]
            cur = frontier.gather(1, widx)[:, 0]
            frontier.scatter_(
                1, widx, torch.where(record & (nf < fcap), rank, cur)[:, None]
            )
            nf += record

        # ---- internal expansion -----------------------------------------
        lc = child_l[gnode].clamp(min=0)
        rc = child_r[gnode].clamp(min=0)
        dcl = torch.sqrt(_sq_norm(q - center[node_base + lc]))
        dcr = torch.sqrt(_sq_norm(q - center[node_base + rc]))
        left_near = dcl <= dcr
        near = torch.where(left_near, lc, rc)
        far = torch.where(left_near, rc, lc)
        gate_near = torch.minimum(dcl, dcr) <= radius[node_base + near] + rr
        gate_far = torch.maximum(dcl, dcr) <= radius[node_base + far] + rr
        expand = act & ~is_leaf & ~prune
        push_far = expand & gate_far
        push_near = expand & gate_near
        # push farther first so the nearer child is popped first
        stack_n.scatter_(1, top, torch.where(push_far, far, node)[:, None])
        stack_b.scatter_(1, top, torch.where(push_far, d_n, d_par)[:, None])
        sp1 = sp + push_far
        idx1 = sp1.clamp(max=stack_size - 1)[:, None]
        stack_n.scatter_(1, idx1, torch.where(
            push_near, near, stack_n.gather(1, idx1)[:, 0])[:, None])
        stack_b.scatter_(1, idx1, torch.where(
            push_near, d_n, stack_b.gather(1, idx1)[:, 0])[:, None])
        sp = sp1 + push_near

    if collect and obs.REGISTRY.enabled:
        _C_PHASE1["iters"].inc(it)
        _C_PHASE1["lane_iters"].inc(lanes * it)
    return _Walk(best_sq, best_i, frontier, nf, visits, leaves, cands)


def _refine(best_sq, best_i, rr):
    """Exact radius refinement of the k survivors (sqrt, `d <= r`)."""
    best_d = torch.sqrt(best_sq)
    okf = best_d <= rr[:, None]
    return (
        torch.where(okf, best_d, torch.full_like(best_d, float("inf"))),
        torch.where(okf, best_i, -1),
    )


def _stack_one(dt: DeviceTree) -> DeviceTree:
    return DeviceTree(*[x[None] for x in dt])


def constrained_knn(dt: DeviceTree, queries, r, k: int,
                    stack_size: int) -> KnnResult:
    """Classic constrained k-NN over one tree; ids are the tree's own
    leaf_index values (original point ids)."""
    rb = _radius(r, queries.shape[0], dt.center.dtype, dt.center.device)
    w = _walk(_stack_one(dt), queries, rb, k, stack_size)
    dist, idx = _refine(w.best_sq, w.best_i, rb)
    return KnnResult(idx, dist, w.visits, w.leaves, w.cands)


def _merge_segments(dd, gg, k: int):
    """Fold the S per-segment sorted k-bests (the classic and fused
    paths share it, so cross-segment tie-breaks are identical)."""
    return qmerge.merge_parts([(dd[s], gg[s]) for s in range(dd.shape[0])], k)


def _map_gids(local, gids):
    """(S, Q, k) local ids -> global ids through each segment's table."""
    s, nq, k = local.shape
    n = gids.shape[1]
    flat = local.reshape(s, nq * k).long().clamp(0, n - 1)
    g = gids.gather(1, flat).reshape(s, nq, k)
    return torch.where(local >= 0, g, -1)


def constrained_knn_stacked_parts(dts: DeviceTree, gids, queries, r, k: int,
                                  stack_size: int):
    """The classic loop over S stacked trees without the fold: the S
    per-tree sorted k-bests, ``distances (S, Q, k)`` and ``global ids
    (S, Q, k)``, and the walk (its counts) — the parts a caller folds
    (`constrained_knn_stacked`; the sharded index, across devices)."""
    s, nq = dts.center.shape[0], queries.shape[0]
    rb = _radius(r, nq, dts.center.dtype, dts.center.device)
    w = _walk(dts, queries, rb, k, stack_size)
    dist, idx = _refine(w.best_sq, w.best_i, rb.repeat(s))
    return dist.reshape(s, nq, k), _map_gids(idx.reshape(s, nq, k), gids), w


def constrained_knn_stacked(dts: DeviceTree, gids, queries, r, k: int,
                            stack_size: int) -> StackedResult:
    """All S same-shape segments in one batched loop: local hits mapped
    to global ids, the S sorted k-bests folded with the unified merge."""
    s, nq = dts.center.shape[0], queries.shape[0]
    dd, gg, w = constrained_knn_stacked_parts(dts, gids, queries, r, k,
                                              stack_size)
    d, g = _merge_segments(dd, gg, k)
    return StackedResult(
        gids=g,
        distances=d,
        nodes_visited=w.visits.reshape(s, nq).sum(0),
        leaves_visited=w.leaves.reshape(s, nq).sum(0),
        points_examined=w.cands.reshape(s, nq).sum(0),
    )


# ---------------------------------------------------------------------------
# Two-phase fused traversal
# ---------------------------------------------------------------------------

FRONTIER_CAP_DEFAULT = 64
QUANT_SLACK_DEFAULT = 8


def frontier_cap_default() -> int:
    """Static per-query leaf-frontier capacity of the fused path
    (`REPRO_FRONTIER_CAP` overrides). Queries whose pruned frontier
    exceeds it fall back to the classic loop — exact either way."""
    return int(os.environ.get("REPRO_FRONTIER_CAP", FRONTIER_CAP_DEFAULT))


def quant_slack_default() -> int:
    """Over-fetch slack of the quantized read path (`REPRO_QUANT_SLACK`
    overrides): the kernel keeps k′ = k + slack survivors for the exact
    f32 rescore."""
    return int(os.environ.get("REPRO_QUANT_SLACK", QUANT_SLACK_DEFAULT))


def _collect_frontier_stacked(dts: DeviceTree, queries, r, k: int,
                              stack_size: int, frontier_cap: int):
    """Phase 1 over all S stacked segments × Q queries: per-(s, q)
    frontier leaf ranks (DFS order, -1 padded), true frontier sizes,
    and the classic traversal's paper-metric counts, each (S, Q, …)."""
    s, nq = dts.center.shape[0], queries.shape[0]
    w = _walk(dts, queries, r, k, stack_size, fcap=frontier_cap)
    shape = (s, nq)
    return (
        w.frontier.reshape(s, nq, frontier_cap),
        w.nf.reshape(shape),
        w.visits.reshape(shape),
        w.leaves.reshape(shape),
        w.cands.reshape(shape),
    )


def _leaf_rows(frontier, n_leaves: int):
    """Flat (segment, leaf) row of every frontier entry (holes clamp to
    leaf 0; their slots are masked by the caller)."""
    s = frontier.shape[0]
    base = torch.arange(s, device=frontier.device)[:, None, None] * n_leaves
    return frontier.clamp(0, n_leaves - 1) + base


def _frontier_gids(leaf_index, gids, frontier, rows):
    """(S·Q, F·cap) global ids of the gathered candidates; holes and
    dead slots -1."""
    s, nq, f = frontier.shape
    cap = leaf_index.shape[2]
    cli = leaf_index.reshape(-1, cap)[rows]                 # (S, Q, F, cap)
    live = (cli >= 0) & (frontier >= 0)[..., None]
    n = gids.shape[1]
    flat = cli.long().clamp(0, n - 1).reshape(s, -1)
    g = gids.gather(1, flat).reshape(cli.shape)
    return torch.where(live, g, -1).reshape(s * nq, f * cap)


def _gather_frontier(dts: DeviceTree, gids, queries, r, frontier):
    """Phase-2 gather: each (segment, query) row's frontier leaves as a
    private (F·cap, d) candidate matrix in DFS order."""
    s, nq, f = frontier.shape
    nl, cap, dim = dts.leaf_points.shape[1:]
    rows = _leaf_rows(frontier, nl)
    cands = dts.leaf_points.reshape(-1, cap, dim)[rows]     # (S,Q,F,cap,d)
    cg = _frontier_gids(dts.leaf_index, gids, frontier, rows)
    qrows = queries.repeat(s, 1)
    rrows = _radius(r, nq, queries.dtype, queries.device).repeat(s)
    return qrows, cands.reshape(s * nq, f * cap, dim), cg, rrows


def _gather_frontier_quantized(leaf_q, leaf_index, gids, frontier, qscale):
    """Phase-2 gather over the QUANTIZED leaf buffer: the same row
    layout as `_gather_frontier` (slots coincide position for position)
    with candidates in their storage dtype; int8 segments broadcast
    their per-leaf scale to a per-candidate (S·Q, F·cap) f32 row."""
    s, nq, f = frontier.shape
    nl, cap, dim = leaf_q.shape[1:]
    rows = _leaf_rows(frontier, nl)
    cq = leaf_q.reshape(-1, cap, dim)[rows].reshape(s * nq, f * cap, dim)
    cg = _frontier_gids(leaf_index, gids, frontier, rows)
    csc = None
    if qscale is not None:
        csc = qscale.reshape(-1)[rows][..., None].expand(s, nq, f, cap)
        csc = csc.reshape(s * nq, f * cap)
    return cq, cg, csc


def _rescore_topk(dts: DeviceTree, frontier, queries, r, gq, slots, k: int):
    """Exact second pass of the quantized read path: gather ONLY the k′
    surviving slots' f32 rows, recompute their squared distances in the
    leaf kernel's own order (`leaf_sq`), and select the final top-k by
    the same (squared, slot) key under the same conservative gate +
    exact euclidean refinement. Given containment (checked by the
    caller) the output equals the f32 kernel over the full gather,
    bitwise. Returns ``(dist (S·Q, k), gids (S·Q, k), sorted_sq
    (S·Q, k′))``."""
    s, nq, f = frontier.shape
    nl, cap, dim = dts.leaf_points.shape[1:]
    kprime = slots.shape[1]
    slc = slots.reshape(s, nq, kprime).long().clamp(0, f * cap - 1)
    rank = frontier.gather(2, slc // cap).clamp(0, nl - 1)
    base = torch.arange(s, device=frontier.device)[:, None, None] * nl
    rows = dts.leaf_points.reshape(-1, cap, dim)[rank + base, slc % cap]
    q32 = queries.to(torch.float32)
    sq = _tk.leaf_sq(q32[None, :, None, :], rows).reshape(s * nq, kprime)
    rrows = _radius(r, nq, torch.float32, queries.device).repeat(s)
    ok = (gq >= 0) & (sq <= _tk.radius_sq_upper(rrows)[:, None])
    skey = torch.where(ok, sq, torch.full_like(sq, float("inf")))
    slkey = torch.where(ok, slots, _tk.I32_MAX)
    gkey = torch.where(ok, gq, -1)
    # lexicographic (sq, slot): stable sort by slot, then stably by sq
    first = torch.argsort(slkey, dim=1, stable=True)
    order = first.gather(1, torch.argsort(skey.gather(1, first), dim=1,
                                          stable=True))
    skey, gkey = skey.gather(1, order), gkey.gather(1, order)
    dd, gg = _refine(skey[:, :k], gkey[:, :k], rrows)
    return dd, gg, skey


def _quant_contained(sq_q, gq, rescored_sq, qerr: float, dim: int, k: int):
    """Host-side containment certificate of the quantized candidate
    set: True iff every row's exact top-k provably survived the
    quantized k′-selection (see the reference for the argument: the
    k-th rescored survivor must be strictly closer than the k′-th kept
    quantized key minus `qerr`, with a dim·2⁻²³ evaluation-slop margin
    on both sides; rows whose k′-window never filled excluded nothing
    that passed the widened gate)."""
    _C_SYNC["quant_contained"].inc()
    sq_q = sq_q.cpu().numpy()
    gq = gq.cpu().numpy()
    rs = rescored_sq.cpu().numpy()
    kprime = sq_q.shape[1]
    window_open = (gq >= 0).sum(axis=1) < kprime
    m = 1.0 + max(dim, 1) * 2.0**-23
    t = np.sqrt(np.maximum(sq_q[:, kprime - 1], 0.0))
    s_k = np.sqrt(np.maximum(rs[:, k - 1], 0.0)) if k <= kprime else np.inf
    gap_ok = s_k * m + qerr < t / m
    return bool(np.all(window_open | gap_ok))


def constrained_knn_stacked_fused(
    dts: DeviceTree,
    gids,
    queries,
    r,
    k: int,
    stack_size: int,
    frontier_cap: int | None = None,
    leaf_q=None,     # (S, L, cap, d) quantized storage
    qscale=None,     # (S, L) f32 int8 per-leaf scales
    qerr: float = 0.0,
) -> StackedResult | None:
    """Two-phase fused traversal over S stacked segments: collect the
    pruned leaf frontier (phase 1), evaluate every surviving candidate
    with one leaf-kernel launch (phase 2), merge across segments.
    Bitwise equal to `constrained_knn_stacked` — results AND counts.

    With `leaf_q` (bf16, or int8 + `qscale`) phase 2 streams the
    quantized buffer: the kernel over-fetches k′ = k + slack survivors
    under a gate widened by `qerr`, `_rescore_topk` recomputes their
    exact f32 distances, and a containment certificate proves the
    quantized set ⊇ the true top-k; when it cannot, the dispatch re-runs
    on the f32 buffer (counted as `quantized.rescore{result=fallback}`).

    Returns None when some lane's frontier overflowed `frontier_cap`:
    the caller falls back to the classic loop."""
    if frontier_cap is None:
        frontier_cap = frontier_cap_default()
    dev = queries.device
    s, nq = dts.center.shape[0], queries.shape[0]
    rb = _radius(r, nq, dts.center.dtype, dev)
    with obs.span("search.phase1"):
        frontier, nf, v, lv, pe = _collect_frontier_stacked(
            dts, queries, rb, k, stack_size, frontier_cap
        )
        _C_SYNC["nf_max"].inc()
        if obs.REGISTRY.enabled and nf.numel():
            # the pops ride on the same device-to-host read
            nf_max, pops = torch.stack([nf.max(), v.sum()]).tolist()
            _C_PHASE1["visits"].inc(pops)
        else:
            nf_max = int(nf.max()) if nf.numel() else 0
    if nf_max > frontier_cap:
        return None
    # shrink the gather to the smallest pow2 that holds the widest
    # frontier
    f_eff = max(1, min(_tk._next_pow2(max(nf_max, 1)), frontier_cap))
    frontier = frontier[..., :f_eff].contiguous()

    dd = gg = None
    if leaf_q is not None:
        kprime = k + max(1, quant_slack_default())
        with obs.span("search.gather"):
            cq, cg, csc = _gather_frontier_quantized(
                leaf_q, dts.leaf_index, gids, frontier, qscale
            )
            qrows = queries.to(torch.float32).repeat(s, 1)
            # widen the gate by the dequant bound so no true in-radius
            # neighbor can fail the quantized in-kernel gate
            rgate = (rb.to(torch.float32) + qerr).repeat(s)
        with obs.span("search.kernel"):
            sq_q, gq, slots = ops.leaf_topk_l2_raw(
                qrows, cq, cg, rgate, kprime, cscale=csc
            )
        with obs.span("search.rescore"):
            dd_q, gg_q, rescored = _rescore_topk(
                dts, frontier, queries, rb, gq, slots, k
            )
            contained = _quant_contained(
                sq_q, gq, rescored, qerr, queries.shape[1], k
            )
        result = "exact" if contained else "fallback"
        obs.REGISTRY.counter("quantized.rescore", result=result).inc()
        if contained:
            dd, gg = dd_q, gg_q
    if dd is None:
        with obs.span("search.gather"):
            qrows, cands, cgids, rrows = _gather_frontier(
                dts, gids, queries, rb, frontier
            )
        with obs.span("search.kernel"):
            dd, gg = ops.leaf_topk_l2(qrows, cands, cgids, rrows, k)
    with obs.span("search.merge"):
        d, g = _merge_segments(dd.reshape(s, nq, k), gg.reshape(s, nq, k), k)
    return StackedResult(
        gids=g,
        distances=d,
        nodes_visited=v.sum(0),
        leaves_visited=lv.sum(0),
        points_examined=pe.sum(0),
    )


def brute_topk(points, queries, k: int, r=float("inf"),
               gids=None) -> KnnResult:
    """Exact constrained k-NN with NO tree: one `topk_l2` scan of
    `points` — the brute referent (ties to the lower slot, (+inf, -1)
    padding)."""
    p = points.to(torch.float32)
    q = queries.to(torch.float32).reshape(-1, p.shape[1])
    g = (
        torch.arange(p.shape[0], dtype=torch.int32, device=p.device)
        if gids is None
        else gids.to(torch.int32)
    )
    d, i = ops.topk_l2(q, p, g, r, k)
    return KnnResult(
        indices=i,
        distances=d,
        nodes_visited=torch.zeros(q.shape[0], dtype=torch.int32, device=p.device),
    )


def search(tree: Tree, queries, k: int, r=np.inf, dtype=torch.float32,
           device="cuda") -> KnnResult:
    """Host tree in, batched search out — a thin adapter over the query
    engine (shape-class padded, dispatched as an S=1 batch)."""
    from ..query import engine as qengine  # lazy: engine imports us
    from ..query.spec import QuerySpec

    return qengine.search_tree(
        tree, queries, QuerySpec(k=k, radius=r, dtype=dtype), device=device
    )
