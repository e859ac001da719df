"""Faithful recursive tree construction (host numpy) — the reference
implementation of the paper's Algorithm 1 plus the two baselines it
compares against (Moore's ball-tree, KD-tree). A copy of the reference
package's `core/build_host.py` on the port's own `core/types.py`: it
builds the reference's tree bitwise.

This is the paper-faithful builder that `core.build(backend="host")` and
`StreamingConfig(backend="host")` reach, and the oracle the
level-synchronous device builder (`core/build.py`) and the batched
searcher (`core/search.py`) can be held against.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

from .pca import first_component_host
from .types import Tree, TreeSpec, leaf_capacity_for


def _split_axis(
    pts: np.ndarray, spec: TreeSpec
) -> Tuple[np.ndarray, str, float]:
    """Choose the split axis for a node.

    Returns (unit axis w, threshold_mode, forced_threshold_or_nan).
    """
    if spec.splitter == "ballstar":
        w = first_component_host(pts, iters=spec.power_iters, seed=spec.seed)
        return w, spec.threshold, np.nan
    if spec.splitter == "ball":
        # Moore's ball-tree: pivot_L = farthest from centroid,
        # pivot_R = farthest from pivot_L; points join the nearer pivot.
        # Assignment to the nearer pivot is equivalent to a hyperplane
        # perpendicular to (pivot_R - pivot_L) through their midpoint.
        centroid = pts.mean(axis=0)
        p_l = pts[np.argmax(((pts - centroid) ** 2).sum(axis=1))]
        p_r = pts[np.argmax(((pts - p_l) ** 2).sum(axis=1))]
        w = p_r - p_l
        nrm = np.linalg.norm(w)
        if nrm < 1e-12:
            return np.zeros(pts.shape[1]), "degenerate", np.nan
        w = w / nrm
        t_c = float((0.5 * (p_l + p_r)) @ w)
        return w, "pivotmid", t_c
    if spec.splitter == "kd":
        spread = pts.max(axis=0) - pts.min(axis=0)
        dim = int(np.argmax(spread))
        w = np.zeros(pts.shape[1])
        w[dim] = 1.0
        return w, "median", np.nan
    raise ValueError(f"unknown splitter {spec.splitter!r}")


def fscan_threshold(t: np.ndarray, spec: TreeSpec) -> float:
    """The paper's F(t_c) scan (Algorithm 1, line 6).

    Splits [t_min, t_max] into S sections and evaluates
      F(t_c) = |N2-N1|/N + alpha * f2(t_c)
    at the mean (center) of each section, returning the minimizing t_c.
    """
    n = t.shape[0]
    t_min, t_max = float(t.min()), float(t.max())
    rng = t_max - t_min
    s = np.arange(spec.n_candidates, dtype=np.float64)
    cands = t_min + (s + 0.5) * rng / spec.n_candidates
    n1 = (t[None, :] < cands[:, None]).sum(axis=1)  # X_R = {t < t_c} counts
    f1 = np.abs(n - 2 * n1) / n
    if spec.f2 == "paper":
        f2 = (cands - t_min) / rng
    else:  # "mid" — the intended semantics (see DESIGN.md errata)
        f2 = np.abs(cands - 0.5 * (t_min + t_max)) / rng
    f = f1 + spec.alpha * f2
    return float(cands[int(np.argmin(f))])


def _choose_threshold(
    t: np.ndarray, mode: str, forced: float, spec: TreeSpec
) -> float:
    if mode == "fscan":
        return fscan_threshold(t, spec)
    if mode == "median":
        return float(np.median(t))
    if mode == "mid":
        return float(0.5 * (t.min() + t.max()))
    if mode == "pivotmid":
        return forced
    raise ValueError(f"unknown threshold mode {mode!r}")


def build(points: np.ndarray, spec: TreeSpec | None = None) -> Tree:
    """Build a tree over `points` (N, d) per `spec` (default: ball*-tree)."""
    spec = spec or TreeSpec()
    points = np.asarray(points, dtype=np.float64)
    n, d = points.shape
    assert n >= 1

    order = np.arange(n)
    # node records, appended in BFS order (children ids > parent id)
    centers: List[np.ndarray] = []
    radii: List[float] = []
    child_l: List[int] = []
    child_r: List[int] = []
    starts: List[int] = []
    counts: List[int] = []

    def new_node(lo: int, hi: int) -> int:
        pts = points[order[lo:hi]]
        c = pts.mean(axis=0)
        # conservative outward rounding (see build._R_WIDEN): the
        # stored radius stays an upper bound on max ||p - c|| through
        # f32 pruning arithmetic and quantized leaf storage; computed
        # in f32 so the value survives the device cast bit-for-bit
        r = float(
            np.float32(np.sqrt(((pts - c) ** 2).sum(axis=1).max()))
            * np.float32(1.0 + 2.0**-20)
        )
        centers.append(c)
        radii.append(r)
        child_l.append(-1)
        child_r.append(-1)
        starts.append(lo)
        counts.append(hi - lo)
        return len(centers) - 1

    queue = deque()
    root = new_node(0, n)
    queue.append((root, 0, n))

    while queue:
        node, lo, hi = queue.popleft()
        cnt = hi - lo
        if cnt <= spec.leaf_size:
            continue
        pts = points[order[lo:hi]]
        w, mode, forced = _split_axis(pts, spec)
        if mode == "degenerate":
            continue  # all points identical: stays a leaf
        t = pts @ w
        if float(t.max() - t.min()) < 1e-12:
            continue  # no separating direction: stays a leaf
        t_c = _choose_threshold(t, mode, forced, spec)
        right = t < t_c  # paper: X_R = {t < t_c}, X_L = {t >= t_c}
        n_r = int(right.sum())
        if n_r == 0 or n_r == cnt:
            # threshold outside the data (possible for fscan candidates on
            # skewed t) — fall back to a balanced cut along the same axis.
            half = cnt // 2
            sel = np.argsort(t, kind="stable")
            right = np.zeros(cnt, dtype=bool)
            right[sel[:half]] = True
        # stable partition: left block first, preserving order inside blocks
        idx = order[lo:hi]
        order[lo:hi] = np.concatenate([idx[~right], idx[right]])
        n_l = cnt - int(right.sum())
        l_id = new_node(lo, lo + n_l)
        r_id = new_node(lo + n_l, hi)
        child_l[node], child_r[node] = l_id, r_id
        queue.append((l_id, lo, lo + n_l))
        queue.append((r_id, lo + n_l, hi))

    center = np.asarray(centers)
    radius = np.asarray(radii)
    cl = np.asarray(child_l, dtype=np.int32)
    cr = np.asarray(child_r, dtype=np.int32)
    start = np.asarray(starts, dtype=np.int32)
    count = np.asarray(counts, dtype=np.int32)
    reordered = points[order]

    # -- padded leaf buckets ------------------------------------------------
    leaf_nodes = np.where(cl < 0)[0]
    n_leaves = leaf_nodes.shape[0]
    cap = max(leaf_capacity_for(spec.leaf_size), int(count[leaf_nodes].max()))
    leaf_points = np.zeros((n_leaves, cap, d), dtype=np.float64)
    leaf_index = np.full((n_leaves, cap), -1, dtype=np.int32)
    leaf_of_node = np.full(center.shape[0], -1, dtype=np.int32)
    for rank, node in enumerate(leaf_nodes):
        lo, c = int(start[node]), int(count[node])
        leaf_of_node[node] = rank
        leaf_points[rank, :c] = reordered[lo : lo + c]
        leaf_index[rank, :c] = order[lo : lo + c]

    return Tree(
        center=center,
        radius=radius,
        child_l=cl,
        child_r=cr,
        start=start,
        count=count,
        points=reordered,
        perm=order,
        leaf_of_node=leaf_of_node,
        leaf_points=leaf_points,
        leaf_index=leaf_index,
        spec=spec,
    )
