"""Level-synchronous tree construction in PyTorch — port of the
reference's `build_jax`.

Every level of the tree is split in one batched pass over all points
still in play:

  1. per-segment PCA direction by power iteration (segment sums)
  2. projection t = (x - mean[seg]) · w[seg]
  3. the paper's F(t_c) candidate scan as one (M, S) broadcast + segment
     reduction
  4. side bits -> new implicit node ids (complete-tree numbering 2i+1/2i+2)

Determinism on the card: the reference reduces with
`jax.ops.segment_sum/max/min`; the CUDA scatter-adds behind
`index_add_`/`scatter_reduce` use atomics, so float sums (and through
them the PCA direction, the cut and the tree) could change from run to
run. Here the level's points are stably sorted by segment once, and
every segment reduction is `torch.segment_reduce` over that contiguous
layout — each segment summed in one fixed order, no atomics — while
integer counts use `bincount` (exact in any order). Building the same
points twice gives the same tree, bitwise.

The final tree is compacted on the host into the shared `Tree` layout
(numpy arrays), exactly as the reference does.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .types import Tree, TreeSpec, leaf_capacity_for

# conservative outward rounding of every stored radius (the reference's
# `_R_WIDEN`): containment must survive f32 pruning arithmetic and the
# quantized storage's coordinate rounding
_R_WIDEN = np.float32(1.0 + 2.0**-20)


def _segsum(data, lengths):
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0)


def _segmax(data, lengths):
    return torch.segment_reduce(data, "max", lengths=lengths, axis=0)


def _segmin(data, lengths):
    return torch.segment_reduce(data, "min", lengths=lengths, axis=0)


def _rowdot(a, b):
    """Σ_d a_d·b_d per row, in dimension order."""
    acc = a[:, 0] * b[:, 0]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j] * b[:, j]
    return acc


def _normalize(v, fallback):
    """v / |v| per row, keeping `fallback` where |v| is ~0."""
    nrm = torch.sqrt(_rowdot(v, v))[:, None]
    return torch.where(nrm > 1e-12, v / torch.clamp(nrm, min=1e-30), fallback)


def _pca_direction(xc, sseg, lengths, d: int, iters: int):
    """Per-segment first principal component via power iteration, from
    the reference's deterministic start vector."""
    rng = np.random.default_rng(0)
    v0 = rng.standard_normal(d)
    v0 /= np.linalg.norm(v0)
    w = torch.tensor(v0, dtype=xc.dtype, device=xc.device)
    w = w.expand(lengths.shape[0], d).contiguous()
    for _ in range(iters):
        proj = _rowdot(xc, w[sseg])[:, None]
        w = _normalize(_segsum(xc * proj, lengths), w)
    return w


def _seg_argmax(score, sseg, members, lengths, n: int):
    """Lowest original index attaining each segment's max score (the
    index reduction runs in f64, exact for any point count in range:
    segment_reduce takes no integer dtypes)."""
    m = _segmax(score, lengths)
    cand = torch.where(score >= m[sseg], members, n).to(torch.float64)
    return _segmin(cand, lengths).to(torch.int64)


def _ball_axis(xs, sseg, members, x, mean, lengths):
    """Moore's two-farthest-pivot axis, per segment (baseline ball-tree)."""
    n = x.shape[0]
    i_l = _seg_argmax(_rowdot(xs - mean[sseg], xs - mean[sseg]), sseg,
                      members, lengths, n)
    p_l = x[i_l.clamp(0, n - 1)]
    i_r = _seg_argmax(_rowdot(xs - p_l[sseg], xs - p_l[sseg]), sseg,
                      members, lengths, n)
    p_r = x[i_r.clamp(0, n - 1)]
    axis = _normalize(p_r - p_l, torch.zeros_like(p_l))
    t_pivotmid = _rowdot(0.5 * (p_l + p_r), axis)
    return axis, t_pivotmid


def _kd_axis(xs, lengths, d: int):
    """Max-spread coordinate axis, per segment (KD baseline)."""
    spread = _segmax(xs, lengths) - _segmin(xs, lengths)
    dim = torch.argmax(spread, dim=-1)
    return torch.nn.functional.one_hot(dim, d).to(xs.dtype)


def _fscan_threshold(t, sseg, lengths, cnt, spec: TreeSpec):
    """Vectorized F(t_c) scan (paper Algorithm 1 line 6) per segment."""
    s = spec.n_candidates
    t_hi = _segmax(t, lengths)
    t_lo = _segmin(t, lengths)
    rng = t_hi - t_lo
    frac = (torch.arange(s, dtype=t.dtype, device=t.device) + 0.5) / s
    cands = t_lo[:, None] + frac[None, :] * rng[:, None]   # (segs, S)
    below = (t[:, None] < cands[sseg]).to(t.dtype)          # (M, S)
    n1 = _segsum(below, lengths)
    n = cnt[:, None]
    f1 = torch.abs(n - 2.0 * n1) / torch.clamp(n, min=1.0)
    safe_rng = torch.clamp(rng, min=1e-30)[:, None]
    if spec.f2 == "paper":
        f2 = (cands - t_lo[:, None]) / safe_rng
    else:
        mid = 0.5 * (t_lo + t_hi)
        f2 = torch.abs(cands - mid[:, None]) / safe_rng
    alpha = spec.alpha if spec.threshold == "fscan" else 0.0
    choice = torch.argmin(f1 + alpha * f2, dim=-1)
    t_c = cands.gather(1, choice[:, None])[:, 0]
    if spec.threshold == "mid":  # ablation: plain midpoint cut
        t_c = 0.5 * (t_lo + t_hi)
    return t_c, rng


def build(points: np.ndarray, spec: TreeSpec | None = None,
          device="cuda") -> Tree:
    """Batched construction on `device`. Returns the reference's `Tree`
    layout as numpy arrays (ready for `search.device_tree`)."""
    spec = spec or TreeSpec()
    x = torch.from_numpy(np.asarray(points, dtype=np.float32)).to(device)
    n, d = x.shape
    max_levels = max(1, int(math.ceil(math.log2(max(2, n)))) + 2)

    point_node = torch.zeros(n, dtype=torch.int64, device=device)
    frozen = torch.zeros(n, dtype=torch.bool, device=device)

    node_center: Dict[int, np.ndarray] = {}
    node_radius: Dict[int, float] = {}
    node_count: Dict[int, int] = {}
    node_is_leaf: Dict[int, bool] = {}

    for level in range(max_levels):
        base = (1 << level) - 1
        num_segs = 1 << level
        seg = point_node - base
        in_level = ~frozen & (seg >= 0) & (seg < num_segs)
        members = torch.nonzero(in_level)[:, 0]
        if members.numel() == 0:
            break
        # one stable sort by segment per level: every reduction below
        # runs over contiguous segments in original index order
        order = torch.argsort(seg[members], stable=True)
        members = members[order]
        sseg = seg[members]
        lengths = torch.bincount(sseg, minlength=num_segs)
        xs = x[members]
        cnt = lengths.to(x.dtype)

        mean = _segsum(xs, lengths) / torch.clamp(cnt, min=1.0)[:, None]
        xc = xs - mean[sseg]
        r2 = _segmax(_rowdot(xc, xc), lengths)
        radius = torch.sqrt(torch.clamp(r2, min=0.0)) * float(_R_WIDEN)
        exists = lengths > 0

        # --- choose axis ---------------------------------------------------
        if spec.splitter == "ballstar":
            axis = _pca_direction(xc, sseg, lengths, d, spec.power_iters)
            t = _rowdot(xc, axis[sseg])
        elif spec.splitter == "ball":
            axis, t_pivotmid = _ball_axis(xs, sseg, members, x, mean, lengths)
            t = _rowdot(xs, axis[sseg])
        elif spec.splitter == "kd":
            axis = _kd_axis(xs, lengths, d)
            t = _rowdot(xs, axis[sseg])
        else:
            raise ValueError(spec.splitter)

        # --- choose threshold ----------------------------------------------
        t_c, t_range = _fscan_threshold(t, sseg, lengths, cnt, spec)
        if spec.splitter == "ball":
            t_c = t_pivotmid

        splittable = exists & (cnt > spec.leaf_size) & (t_range > 1e-7)
        right = (t < t_c[sseg]) & splittable[sseg]
        n_right = torch.bincount(sseg[right], minlength=num_segs)
        ok = splittable & (n_right > 0) & (n_right < lengths)

        # --- record this level's nodes (host) -------------------------------
        ids = torch.nonzero(exists)[:, 0]
        ids_h = ids.cpu().numpy()
        cnt_h = lengths[ids].cpu().numpy()
        ok_h = ok[ids].cpu().numpy()
        mean_h = mean[ids].cpu().numpy()
        radius_h = radius[ids].cpu().numpy()
        for j, sid in enumerate(ids_h):
            nid = base + int(sid)
            node_center[nid] = mean_h[j]
            node_radius[nid] = float(radius_h[j])
            node_count[nid] = int(cnt_h[j])
            node_is_leaf[nid] = not bool(ok_h[j])

        if not ok_h.any():
            break

        # --- descend ---------------------------------------------------------
        do_split = ok[sseg]
        pn = point_node[members]
        point_node[members] = torch.where(do_split, 2 * pn + 1 + right, pn)
        frozen[members] = ~do_split

    return _compact(
        np.asarray(x.cpu().numpy()), point_node.cpu().numpy(), node_center,
        node_radius, node_count, node_is_leaf, spec,
    )


def _compact(x, pn, node_center, node_radius, node_count, node_is_leaf,
             spec: TreeSpec) -> Tree:
    """Dense BFS arrays + padded leaf buckets from the implicit-id node
    table (host, O(n_nodes)) — the reference's compaction, verbatim."""
    d = x.shape[1]
    implicit_ids = sorted(node_center.keys())
    dense_of = {nid: i for i, nid in enumerate(implicit_ids)}
    n_nodes = len(implicit_ids)
    center = np.stack([node_center[i] for i in implicit_ids])
    radius_arr = np.asarray([node_radius[i] for i in implicit_ids])
    count = np.asarray([node_count[i] for i in implicit_ids], dtype=np.int32)
    child_l = np.full(n_nodes, -1, dtype=np.int32)
    child_r = np.full(n_nodes, -1, dtype=np.int32)
    for nid in implicit_ids:
        if not node_is_leaf[nid]:
            child_l[dense_of[nid]] = dense_of[2 * nid + 1]
            child_r[dense_of[nid]] = dense_of[2 * nid + 2]

    # point ordering: sort by the leaf's slot interval in the complete
    # tree so every node's points are contiguous and nested
    max_level_of = np.asarray(
        [int(math.floor(math.log2(i + 1))) for i in implicit_ids]
    )
    deepest = int(max_level_of.max())
    level_of_leaf = np.floor(np.log2(pn + 1)).astype(np.int64)
    local = pn + 1 - (1 << level_of_leaf)
    slot = local << (deepest - level_of_leaf)
    order = np.argsort(slot, kind="stable").astype(np.int64)
    reordered = x[order]

    start = np.zeros(n_nodes, dtype=np.int32)
    for nid in implicit_ids:
        i = dense_of[nid]
        if child_l[i] >= 0:
            l, r = child_l[i], child_r[i]
            start[l] = start[i]
            start[r] = start[i] + count[l]

    leaf_nodes = np.where(child_l < 0)[0]
    n_leaves = leaf_nodes.shape[0]
    cap = max(
        leaf_capacity_for(spec.leaf_size),
        int(count[leaf_nodes].max()) if n_leaves else 1,
    )
    leaf_points = np.zeros((n_leaves, cap, d), dtype=reordered.dtype)
    leaf_index = np.full((n_leaves, cap), -1, dtype=np.int32)
    leaf_of_node = np.full(n_nodes, -1, dtype=np.int32)
    for rank, node in enumerate(leaf_nodes):
        lo, c = int(start[node]), int(count[node])
        leaf_of_node[node] = rank
        leaf_points[rank, :c] = reordered[lo : lo + c]
        leaf_index[rank, :c] = order[lo : lo + c]

    return Tree(
        center=center,
        radius=radius_arr,
        child_l=child_l,
        child_r=child_r,
        start=start,
        count=count,
        points=reordered,
        perm=order,
        leaf_of_node=leaf_of_node,
        leaf_points=leaf_points,
        leaf_index=leaf_index,
        spec=spec,
    )
