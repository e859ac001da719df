"""Host (numpy) reference search algorithms with instrumentation (a copy
of the reference package's `core/search_host.py` on the port's own
`core/types.py`).

Implements, faithfully to the paper:
  - `range_search`      (§4.1)
  - `knn_search`        (§4.2, Liu et al. — the baseline search)
  - `constrained_knn`   (§4.3, Algorithm 2 — the paper's contribution)

Every search returns a `SearchStats` carrying the result set plus the
instrumentation the paper's experiments report (nodes visited per query).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List

import numpy as np

from .types import Tree


@dataclasses.dataclass
class SearchStats:
    indices: np.ndarray  # original point ids, sorted by distance
    distances: np.ndarray
    nodes_visited: int = 0
    leaves_visited: int = 0
    points_examined: int = 0


def _leaf_scan(tree: Tree, node: int, q: np.ndarray):
    lo = int(tree.start[node])
    c = int(tree.count[node])
    pts = tree.points[lo : lo + c]
    d = np.sqrt(((pts - q) ** 2).sum(axis=1))
    idx = tree.perm[lo : lo + c]
    return d, idx


def _finalize(heap: List, k: int | None = None) -> SearchStats:
    # heap holds (-dist, original_index)
    items = sorted(((-nd, i) for nd, i in heap))
    dist = np.asarray([d for d, _ in items])
    idx = np.asarray([i for _, i in items], dtype=np.int64)
    if k is not None:
        dist, idx = dist[:k], idx[:k]
    return SearchStats(indices=idx, distances=dist)


def range_search(tree: Tree, q: np.ndarray, r: float) -> SearchStats:
    """All points with ||x - q|| <= r (paper §4.1)."""
    q = np.asarray(q, dtype=np.float64)
    out_d, out_i = [], []
    stats = SearchStats(indices=None, distances=None)
    stack = [0]
    while stack:
        node = stack.pop()
        stats.nodes_visited += 1
        dc = np.linalg.norm(q - tree.center[node])
        if dc > tree.radius[node] + r:
            continue  # query ball does not intersect the node ball
        if tree.child_l[node] < 0:
            stats.leaves_visited += 1
            d, idx = _leaf_scan(tree, node, q)
            stats.points_examined += d.shape[0]
            m = d <= r
            out_d.extend(d[m].tolist())
            out_i.extend(idx[m].tolist())
        else:
            stack.append(int(tree.child_l[node]))
            stack.append(int(tree.child_r[node]))
    o = np.argsort(out_d, kind="stable")
    stats.indices = np.asarray(out_i, dtype=np.int64)[o]
    stats.distances = np.asarray(out_d)[o]
    return stats


def knn_search(tree: Tree, q: np.ndarray, k: int) -> SearchStats:
    """K nearest neighbors (paper §4.2, the Liu et al. algorithm).

    A node is expanded iff D_N < D_s, where
      D_N = max(D_parent, |q - center| - radius)   (lower bound on any
                                                    member's distance)
      D_s = distance of the current K-th best (inf while |P| < K).
    Children are visited nearer-first.
    """
    q = np.asarray(q, dtype=np.float64)
    heap: List = []  # max-heap via (-dist, idx)
    stats = SearchStats(indices=None, distances=None)

    def d_s() -> float:
        return -heap[0][0] if len(heap) >= k else np.inf

    def visit(node: int, d_parent: float):
        stats.nodes_visited += 1
        dc = float(np.linalg.norm(q - tree.center[node]))
        d_n = max(d_parent, dc - float(tree.radius[node]))
        if d_n >= d_s():
            return
        if tree.child_l[node] < 0:
            stats.leaves_visited += 1
            d, idx = _leaf_scan(tree, node, q)
            stats.points_examined += d.shape[0]
            for di, ii in zip(d, idx):
                if di < d_s():
                    heapq.heappush(heap, (-di, int(ii)))
                    if len(heap) > k:
                        heapq.heappop(heap)
            return
        l, r = int(tree.child_l[node]), int(tree.child_r[node])
        dl = np.linalg.norm(q - tree.center[l])
        dr = np.linalg.norm(q - tree.center[r])
        first, second = (l, r) if dl <= dr else (r, l)
        visit(first, d_n)
        visit(second, d_n)

    visit(0, 0.0)
    return _stats_merge(stats, _finalize(heap, k))


def constrained_knn(
    tree: Tree,
    q: np.ndarray,
    k: int,
    r: float,
    prune: str = "or",
) -> SearchStats:
    """Range-constrained KNN (paper §4.3, Algorithm 2).

    Returns the (at most) K nearest points within distance r of q, visiting
    a node only if it could both (a) improve the current K-best list and
    (b) intersect the query range ball.

    `prune="or"` is the sound combined prune (skip if D_N >= D_s OR the
    node ball misses the range ball); `prune="and"` reproduces the
    pseudocode's literal ∧ (kept for ablation — see DESIGN.md errata).
    """
    q = np.asarray(q, dtype=np.float64)
    heap: List = []
    stats = SearchStats(indices=None, distances=None)

    def d_s() -> float:
        return -heap[0][0] if len(heap) >= k else np.inf

    def visit(node: int, d_parent: float):
        stats.nodes_visited += 1
        dc = float(np.linalg.norm(q - tree.center[node]))
        d_n = max(d_parent, dc - float(tree.radius[node]))
        knn_prune = d_n >= d_s()
        range_prune = d_n > r  # no member can be within the range ball
        skip = (knn_prune and range_prune) if prune == "and" else (
            knn_prune or range_prune
        )
        if skip:
            return
        if tree.child_l[node] < 0:
            stats.leaves_visited += 1
            d, idx = _leaf_scan(tree, node, q)
            stats.points_examined += d.shape[0]
            for di, ii in zip(d, idx):
                if di <= r and di < d_s():
                    heapq.heappush(heap, (-di, int(ii)))
                    if len(heap) > k:
                        heapq.heappop(heap)
            return
        l, rr = int(tree.child_l[node]), int(tree.child_r[node])
        dl = float(np.linalg.norm(q - tree.center[l]))
        dr = float(np.linalg.norm(q - tree.center[rr]))
        # Algorithm 2 lines 14/16: recurse into a child only if its ball
        # intersects the range ball (d_child <= radius(child) + r).
        order = ((dl, l), (dr, rr)) if dl <= dr else ((dr, rr), (dl, l))
        for d_child, child in order:
            if d_child <= float(tree.radius[child]) + r:
                visit(child, d_n)

    visit(0, 0.0)
    return _stats_merge(stats, _finalize(heap, k))


def leaf_frontier(tree: Tree, q: np.ndarray, k: int, r: float) -> List[int]:
    """Oracle for the fused traversal's phase 1: the leaf RANKS
    (`tree.leaf_of_node`) of every scanned non-empty leaf of
    `constrained_knn` (prune="or"), in DFS visit order — exactly the
    list the device traversal's phase 1 (`core/search.py`) records."""
    q = np.asarray(q, dtype=np.float64)
    heap: List = []
    frontier: List[int] = []

    def d_s() -> float:
        return -heap[0][0] if len(heap) >= k else np.inf

    def visit(node: int, d_parent: float):
        dc = float(np.linalg.norm(q - tree.center[node]))
        d_n = max(d_parent, dc - float(tree.radius[node]))
        if d_n >= d_s() or d_n > r:
            return
        if tree.child_l[node] < 0:
            d, idx = _leaf_scan(tree, node, q)
            if d.shape[0]:
                frontier.append(int(tree.leaf_of_node[node]))
            for di, ii in zip(d, idx):
                if di <= r and di < d_s():
                    heapq.heappush(heap, (-di, int(ii)))
                    if len(heap) > k:
                        heapq.heappop(heap)
            return
        l, rr = int(tree.child_l[node]), int(tree.child_r[node])
        dl = float(np.linalg.norm(q - tree.center[l]))
        dr = float(np.linalg.norm(q - tree.center[rr]))
        order = ((dl, l), (dr, rr)) if dl <= dr else ((dr, rr), (dl, l))
        for d_child, child in order:
            if d_child <= float(tree.radius[child]) + r:
                visit(child, d_n)

    visit(0, 0.0)
    return frontier


def knn_then_filter(tree: Tree, q: np.ndarray, k: int, r: float) -> SearchStats:
    """The baseline the paper compares against in Table 2: run the plain
    Liu et al. KNN search (no range pruning), then filter by the range."""
    st = knn_search(tree, q, k)
    m = st.distances <= r
    st.indices = st.indices[m]
    st.distances = st.distances[m]
    return st


def _stats_merge(stats: SearchStats, res: SearchStats) -> SearchStats:
    res.nodes_visited = stats.nodes_visited
    res.leaves_visited = stats.leaves_visited
    res.points_examined = stats.points_examined
    return res
