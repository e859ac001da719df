"""Unified query engine: plan (shape classes) -> stacked traversal ->
single merge. Port of the reference's `query/engine.py`.

This is the one read path: the streaming snapshot search
(`index/search`) and the static-tree convenience (`core/search.search`)
are thin adapters over `execute`/`search_tree`.

Planner: a snapshot's segments are grouped by their power-of-two shape
class (`query/shapes.py`); all S segments of one class are answered by
one stacked dispatch over an (S_pow2, …)-stacked DeviceTree batch
(padded with an all-dead dummy member). The default dispatch is the
fused two-phase traversal (`constrained_knn_stacked_fused`, whose
phase 2 launches the leaf kernel); the classic loop remains as the
`REPRO_FUSED_TRAVERSAL=0` escape hatch and the fallback when a frontier
overflows its cap. The delta arena joins as a degenerate class through
the `topk_l2` kernel. The per-part sorted k-bests are folded with
`query/merge.py`.

The stacked batches are memoized (small LRU) on the segments' content
tokens: a steady read phase re-stacks nothing, and any seal / merge /
tombstone refreshes exactly the tokens it touched.

Instrumentation lives on the obs registry: dispatch and stack-cache
counters, one `obs.span` per execute() stage (plan / stack / dispatch /
delta / merge), and the paper metrics on an active `obs.QueryTrace`.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import search as sj
from ..kernels import ops
from . import merge as qmerge
from . import shapes
from .spec import QuerySpec


class EngineResult(NamedTuple):
    gids: np.ndarray            # (Q, k) global ids, -1 = no result
    distances: np.ndarray       # (Q, k) +inf where no result
    nodes_visited: Optional[np.ndarray]  # (Q,) traversal visits, or None
    leaves_scanned: Optional[np.ndarray] = None
    points_examined: Optional[np.ndarray] = None


# -- instrumentation ---------------------------------------------------------
_C_TRAVERSAL = obs.REGISTRY.counter("engine.dispatches", kind="traversal")
_C_DELTA = obs.REGISTRY.counter("engine.dispatches", kind="delta")
_C_FUSED = obs.REGISTRY.counter("engine.fused_traversal", kind="used")
_C_FUSED_FB = obs.REGISTRY.counter(
    "engine.fused_traversal", kind="overflow_fallback"
)
_C_STACK_FULL = obs.REGISTRY.counter("engine.stack_cache", kind="full_build")
_C_STACK_INCR = obs.REGISTRY.counter("engine.stack_cache", kind="incremental")
_G_SIGNATURES = obs.REGISTRY.gauge("engine.signatures")
_G_STACK_CACHE = obs.REGISTRY.gauge("engine.stack_cache_entries")

# distinct stacked-dispatch signatures ever issued, (shape class, pow2
# member count, query count, k, dtype); the registry holds their count
# (`engine.signatures`), the set itself its own lock. dtype is the
# port's own spelling (`str(torch.float32)`, "torch.float32"), not JAX's
_SIGNATURES: set = set()
_SIG_LOCK = threading.Lock()


def dispatch_count() -> int:
    """ALL device search dispatches (traversal + delta)."""
    return _C_TRAVERSAL.value + _C_DELTA.value


def observed_signatures() -> frozenset:
    """The stacked-dispatch signatures issued so far (see `_SIGNATURES`)."""
    with _SIG_LOCK:
        return frozenset(_SIGNATURES)


def compile_stats() -> dict:
    """Dispatch counters and CUDA kernel launch counts.

    The reference reports jit-cache sizes here; eager PyTorch compiles
    nothing per shape, so the port reports what its runs can show
    instead: how often each hand-written kernel was launched
    (`kernel_launches`, from `kernels.ops.launch_counts()`)."""
    return {
        "kernel_launches": ops.launch_counts(),
        "traversal_dispatches": _C_TRAVERSAL.value,
        "dispatches": dispatch_count(),
    }


# -- planner -----------------------------------------------------------------
class ClassGroup(NamedTuple):
    cls: shapes.ShapeClass
    views: tuple  # SegmentViews of this class, token-sorted


def plan(snapshot) -> List[ClassGroup]:
    """Group a snapshot's live segments by shape class (token-sorted
    within a class so iteration is deterministic)."""
    groups = {}
    for view in snapshot.segments:
        if view.n_live == 0:  # fully tombstoned: nothing to dispatch
            continue
        cls = shapes.shape_class_of(
            view.dtree,
            view.stack_size,
            int(view.gids_dev.shape[0]),
            storage_dtype=view.storage_dtype,
        )
        groups.setdefault(cls, []).append(view)
    return [
        ClassGroup(cls, tuple(sorted(vs, key=lambda v: v.token)))
        for cls, vs in sorted(groups.items())
    ]


# -- stacked-batch cache -----------------------------------------------------
# LRU keyed on (class, cache tag, gid-remap epoch, member-token set); per
# class at most TWO batches are kept — the current one and the most
# recent predecessor an MVCC reader may still alternate with.
_STACK_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_STACK_CACHE_MAX = 16
_STACK_LOCK = threading.Lock()


def stack_stats() -> dict:
    """The stacked-batch cache's refreshes: whole class batches rebuilt
    against single member slots patched."""
    return {
        "full_builds": _C_STACK_FULL.value,
        "incremental_updates": _C_STACK_INCR.value,
    }


class _StackEntry(NamedTuple):
    stacked: sj.DeviceTree  # (S_pow2, …) batch, dummy-padded
    gids: torch.Tensor      # (S_pow2, n) gid table
    slot_tokens: tuple      # token occupying each real (non-dummy) slot
    leaf_q: object = None   # (S_pow2, L, cap, d) storage dtype
    qscale: object = None   # (S_pow2, L) f32


def _patched(t: torch.Tensor, slot: int, value: torch.Tensor) -> torch.Tensor:
    """A copy of `t` with member `slot` replaced. Copy, then write: the
    predecessor batch stays in the cache (and in the hands of readers of
    older snapshots), so it is never written in place."""
    out = t.clone()
    out[slot] = value
    return out


def _incremental_update(
    base: _StackEntry, group: ClassGroup
) -> Optional[_StackEntry]:
    """Patch `base` into the batch for `group` by replacing only the
    members whose token changed (one device copy of the batch plus the
    changed members, no host restack). Applicable when the member count
    is unchanged and at least one slot survives. Returns None when not
    applicable."""
    if len(base.slot_tokens) != len(group.views):
        return None
    old = set(base.slot_tokens)
    fresh = [v for v in group.views if v.token not in old]
    if not fresh or len(fresh) == len(group.views):
        return None  # identical (cache hit upstream) or all-new
    new_tokens = {v.token for v in group.views}
    free = [i for i, t in enumerate(base.slot_tokens) if t not in new_tokens]
    if len(free) != len(fresh):
        return None
    stacked, gids = base.stacked, base.gids
    leaf_q, qscale = base.leaf_q, base.qscale
    slot_tokens = list(base.slot_tokens)
    for s, view in zip(free, fresh):
        stacked = sj.DeviceTree(
            *[
                _patched(getattr(stacked, f), s, getattr(view.dtree, f))
                for f in sj.DeviceTree._fields
            ]
        )
        gids = _patched(gids, s, view.gids_dev)
        if leaf_q is not None:
            leaf_q = _patched(leaf_q, s, view.leaf_q)
            if qscale is not None:
                qscale = _patched(qscale, s, view.qscale)
        slot_tokens[s] = view.token
    return _StackEntry(stacked, gids, tuple(slot_tokens), leaf_q, qscale)


def _full_build(group: ClassGroup, device) -> _StackEntry:
    """A from-scratch stacked batch (token-sorted slots, dummy-padded to
    a pow2 member count). `torch.stack` allocates fresh tensors, so the
    batch shares no storage with any member segment."""
    dummy_dt, dummy_g = shapes.dummy_member(group.cls, device)
    n_pad = shapes.next_pow2(len(group.views)) - len(group.views)
    views = sorted(group.views, key=lambda v: v.token)
    trees = [v.dtree for v in views] + [dummy_dt] * n_pad
    leaf_q = qscale = None
    if group.cls.sdt != "float32":
        dq_lq, dq_sc = shapes.dummy_quantized(group.cls, device)
        leaf_q = torch.stack([v.leaf_q for v in views] + [dq_lq] * n_pad)
        if dq_sc is not None:
            qscale = torch.stack([v.qscale for v in views] + [dq_sc] * n_pad)
    return _StackEntry(
        stacked=sj.DeviceTree(
            *[
                torch.stack([getattr(t, f) for t in trees])
                for f in sj.DeviceTree._fields
            ]
        ),
        gids=torch.stack([v.gids_dev for v in views] + [dummy_g] * n_pad),
        slot_tokens=tuple(v.token for v in views),
        leaf_q=leaf_q,
        qscale=qscale,
    )


def _stacked_views(group: ClassGroup, epoch: int = 0, tag=None) -> _StackEntry:
    """The stacked batch entry for one shape class, memoized on (class,
    tag, gid-remap epoch, member token set)."""
    clskey = (group.cls, tag)
    key = (clskey, epoch, frozenset(v.token for v in group.views))
    with _STACK_LOCK:
        hit = _STACK_CACHE.get(key)
        if hit is not None:
            _STACK_CACHE.move_to_end(key)
            return hit
        base = next(
            (
                _STACK_CACHE[s]
                for s in reversed(_STACK_CACHE)
                if s[0] == clskey
            ),
            None,
        )
    # build outside the lock (two racing builders produce identical
    # content; last insert wins)
    entry = _incremental_update(base, group) if base is not None else None
    incremental = entry is not None
    if entry is None:
        entry = _full_build(group, group.views[0].gids_dev.device)
    (_C_STACK_INCR if incremental else _C_STACK_FULL).inc()
    with _STACK_LOCK:
        same = [s for s in _STACK_CACHE if s[0] == clskey]
        for stale in same[:-1]:  # keep only the most recent predecessor
            del _STACK_CACHE[stale]
        _STACK_CACHE[key] = entry
        while len(_STACK_CACHE) > _STACK_CACHE_MAX:
            _STACK_CACHE.popitem(last=False)
        _G_STACK_CACHE.set(len(_STACK_CACHE))
    return entry


def _fused_enabled() -> bool:
    """The two-phase kernel-leaf traversal is the default read path;
    `REPRO_FUSED_TRAVERSAL=0` is the escape hatch back to the classic
    loop."""
    return os.environ.get("REPRO_FUSED_TRAVERSAL", "1") != "0"


def _dispatch_stacked(
    stacked,
    gids,
    q,
    rb,
    k: int,
    stack_size: int,
    cls,
    leaf_q=None,
    qscale=None,
    qerr: float = 0.0,
):
    _C_TRAVERSAL.inc()
    with _SIG_LOCK:
        _SIGNATURES.add(
            (cls, int(gids.shape[0]), int(q.shape[0]), k, str(q.dtype))
        )
        _G_SIGNATURES.set(len(_SIGNATURES))
    with obs.span("engine.dispatch"):
        # the fused path computes in f32 (its kernel's type); any other
        # traversal dtype (search_tree overrides) takes the classic loop.
        # A frontier-cap overflow returns None: fall back, and count it.
        if _fused_enabled() and q.dtype == torch.float32:
            res = sj.constrained_knn_stacked_fused(
                stacked,
                gids,
                q,
                rb,
                k,
                stack_size,
                leaf_q=leaf_q,
                qscale=qscale,
                qerr=qerr,
            )
            if res is not None:
                _C_FUSED.inc()
                return res
            _C_FUSED_FB.inc()
        return sj.constrained_knn_stacked(stacked, gids, q, rb, k, stack_size)


# -- executor ----------------------------------------------------------------
def execute(snapshot, queries, spec: QuerySpec) -> EngineResult:
    """Exact constrained-KNN over a streaming snapshot (segments∪delta),
    on the snapshot's device."""
    k = spec.k
    # the streaming compute path is f32 end to end; segment STORAGE
    # width is per segment and independent of it
    if spec.dtype != torch.float32:
        raise ValueError(
            "snapshot search compute is float32-only; QuerySpec.dtype "
            "overrides apply to search_tree (segment storage dtype is "
            f"per-segment, got compute {spec.dtype})"
        )
    qt = obs.trace.current_query_trace()
    want_stats = spec.return_visits or qt is not None
    q_host = np.asarray(queries, dtype=np.float32).reshape(-1, snapshot.dim)
    nq = q_host.shape[0]
    if qt is not None:
        qt.set_metric("n_live", snapshot.n_live)
        qt.set_metric("n_segments", len(snapshot.segments))
    if snapshot.n_live == 0:
        # all points tombstoned (or never inserted): answer on the host,
        # zero device dispatches
        zeros = np.zeros(nq, np.int32)
        if qt is not None:
            qt.set_metric("n_classes", 0)
            qt.set_metric("delta_candidates", 0)
            qt.set_metric("nodes_visited", zeros)
            qt.set_metric("leaves_scanned", zeros)
            qt.set_metric("candidates_evaluated", zeros)
        return EngineResult(
            gids=np.full((nq, k), -1, np.int32),
            distances=np.full((nq, k), np.inf, np.float32),
            nodes_visited=zeros if spec.return_visits else None,
            leaves_scanned=zeros if spec.return_visits else None,
            points_examined=zeros if spec.return_visits else None,
        )
    device = snapshot.delta_points.device
    q = torch.from_numpy(q_host).to(device)
    rb = torch.as_tensor(spec.radius, dtype=torch.float32, device=device)
    rb = rb.expand(nq).contiguous()

    parts: List[Tuple[torch.Tensor, torch.Tensor]] = []
    visits = leaves = cands = None
    with obs.span("engine.plan"):
        groups = plan(snapshot)
    for group in groups:
        with obs.span("engine.stack"):
            entry = _stacked_views(group, snapshot.epoch, snapshot.cache_tag)
        res = _dispatch_stacked(
            entry.stacked,
            entry.gids,
            q,
            rb,
            k,
            group.cls.stack_size,
            group.cls,
            leaf_q=entry.leaf_q,
            qscale=entry.qscale,
            # one containment certificate covers the whole stacked
            # dispatch, so it must assume the worst member's bound
            qerr=max((v.qerr for v in group.views), default=0.0),
        )
        parts.append((res.distances, res.gids))
        if want_stats:
            # each pow2-padding dummy contributes exactly one root visit
            # per query; subtract it so accounting matches the real trees
            n_pad = shapes.next_pow2(len(group.views)) - len(group.views)
            gv = res.nodes_visited - n_pad
            visits = gv if visits is None else visits + gv
            lv, pe = res.leaves_visited, res.points_examined
            leaves = lv if leaves is None else leaves + lv
            cands = pe if cands is None else cands + pe
    delta_cands = 0
    if snapshot.delta_n_live > 0:
        from ..index import delta as delta_mod

        _C_DELTA.inc()
        with obs.span("engine.delta"):
            dd, dg = delta_mod.search(
                snapshot.delta_points, snapshot.delta_gids, q, k, rb
            )
        parts.append((dd, dg))
        delta_cands = int(snapshot.delta_n_live)

    with obs.span("engine.merge"):
        d, g = qmerge.merge_parts(parts, k)
        g_host = g.to(torch.int32).cpu().numpy()
        d_host = d.to(torch.float32).cpu().numpy()
    if want_stats:
        def host(x, dtype):
            if x is None:
                return np.zeros(nq, dtype)
            return x.cpu().numpy().astype(dtype)

        visits = host(visits, np.int32)
        leaves = host(leaves, np.int32)
        cands = host(cands, np.int64) + delta_cands
        if qt is not None:
            qt.set_metric("n_classes", len(groups))
            qt.set_metric("delta_candidates", delta_cands)
            qt.set_metric("nodes_visited", visits)
            qt.set_metric("leaves_scanned", leaves)
            qt.set_metric("candidates_evaluated", cands)
    return EngineResult(
        gids=g_host,
        distances=d_host,
        nodes_visited=visits if spec.return_visits else None,
        leaves_scanned=leaves if spec.return_visits else None,
        points_examined=cands if spec.return_visits else None,
    )


def search_tree(tree, queries, spec: QuerySpec, device="cuda") -> sj.KnnResult:
    """Static host tree through the same engine: padded to its shape
    class and dispatched as an S=1 stacked batch."""
    dt = shapes.pad_device_tree(sj.device_tree(tree, spec.dtype, device))
    stack_size = shapes.padded_stack_size(sj.max_depth(tree))
    gids = shapes.pad_gids(
        torch.arange(tree.n_points, dtype=torch.int32, device=device)
    )
    cls = shapes.shape_class_of(dt, stack_size, int(gids.shape[0]))
    q = torch.as_tensor(
        np.asarray(queries).reshape(-1, cls.dim), dtype=spec.dtype
    ).to(device)
    rb = torch.as_tensor(spec.radius, dtype=spec.dtype, device=device)
    rb = rb.expand(q.shape[0]).contiguous()
    stacked = sj.DeviceTree(*[x[None] for x in dt])
    res = _dispatch_stacked(stacked, gids[None], q, rb, spec.k, stack_size, cls)
    return sj.KnnResult(
        indices=res.gids,
        distances=res.distances,
        nodes_visited=res.nodes_visited,
        leaves_visited=res.leaves_visited,
        points_examined=res.points_examined,
    )
