"""Array-of-structs tree representation (copied from the reference
package so the port imports nothing of it).

A tree over N points in R^d is stored as flat arrays (device friendly — no
pointers chased at runtime, every leaf owns a contiguous slice of the
reordered point storage):

  center[n_nodes, d]   ball center (centroid of member points)
  radius[n_nodes]      max distance from center to a member point
  child_l[n_nodes]     left child node id, -1 for leaves
  child_r[n_nodes]     right child node id, -1 for leaves
  start[n_nodes]       offset of the node's points in `points`
  count[n_nodes]       number of points in the node
  points[N, d]         the data points, reordered so each node is contiguous
  perm[N]              points[i] == original_points[perm[i]]

Leaf buckets (padded, fixed-shape — required for batched jit traversal):

  leaf_of_node[n_nodes]          leaf rank or -1
  leaf_points[n_leaves, cap, d]  padded copies of each leaf's points
  leaf_index[n_leaves, cap]      original point index (or -1 padding)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

Array = Any  # np.ndarray or torch.Tensor


@dataclasses.dataclass
class TreeSpec:
    """Configuration for building a tree."""

    leaf_size: int = 32
    # splitter: how the cut axis is chosen per node.
    #   "ballstar" — first principal component (the paper's contribution)
    #   "ball"     — Moore's two-farthest-points axis (baseline ball-tree)
    #   "kd"       — max-spread coordinate axis (KD-tree baseline)
    splitter: str = "ballstar"
    # threshold: how the cut offset along the axis is chosen.
    #   "fscan"  — minimize F(t_c) over S candidates (paper, ball*-tree)
    #   "mid"    — midpoint of projections (classic ball-tree behaviour:
    #               assignment to nearer pivot == midpoint cut of the pivot
    #               axis)
    #   "median" — balanced median cut (KD-tree)
    threshold: str = "fscan"
    alpha: float = 0.3  # workload-awareness weight on f2 (paper's alpha)
    n_candidates: int = 32  # S — candidate offsets for the F(t_c) scan
    f2: str = "mid"  # "mid" (intended semantics) | "paper" (verbatim formula)
    power_iters: int = 16  # power-iteration steps for the PCA direction
    seed: int = 0

    @staticmethod
    def ballstar(**kw) -> "TreeSpec":
        return TreeSpec(splitter="ballstar", threshold="fscan", **kw)

    @staticmethod
    def ball(**kw) -> "TreeSpec":
        return TreeSpec(splitter="ball", threshold="mid", **kw)

    @staticmethod
    def kd(**kw) -> "TreeSpec":
        return TreeSpec(splitter="kd", threshold="median", **kw)


@dataclasses.dataclass
class Tree:
    """Built tree (host numpy arrays; the builder returns numpy)."""

    center: Array
    radius: Array
    child_l: Array
    child_r: Array
    start: Array
    count: Array
    points: Array
    perm: Array
    leaf_of_node: Array
    leaf_points: Array
    leaf_index: Array
    spec: Optional[TreeSpec] = None

    @property
    def n_nodes(self) -> int:
        return int(self.center.shape[0])

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def dim(self) -> int:
        return int(self.points.shape[1])

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_points.shape[0])

    @property
    def leaf_capacity(self) -> int:
        return int(self.leaf_points.shape[1])

    def is_leaf(self) -> Array:
        return self.child_l < 0

    # -- depth statistics used by the paper's Fig 5 / Table 1 ---------------
    def leaf_depths(self) -> np.ndarray:
        """Depth of every leaf (root = 0). Host-side."""
        child_l = np.asarray(self.child_l)
        child_r = np.asarray(self.child_r)
        depth = np.zeros(self.n_nodes, dtype=np.int64)
        out = []
        # children always have larger ids than parents (both builders append
        # children after parents), so a single forward pass suffices.
        for node in range(self.n_nodes):
            l, r = child_l[node], child_r[node]
            if l < 0:
                out.append(depth[node])
            else:
                depth[l] = depth[node] + 1
                depth[r] = depth[node] + 1
        return np.asarray(out)

    def average_depth(self) -> float:
        """Average root→leaf path length (paper §5.1)."""
        return float(self.leaf_depths().mean())

    def average_point_depth(self) -> float:
        """Leaf depth averaged over points (weights leaves by occupancy)."""
        counts = np.asarray(self.count)[np.asarray(self.child_l) < 0]
        return float((self.leaf_depths() * counts).sum() / counts.sum())


def leaf_capacity_for(leaf_size: int) -> int:
    """Padded leaf bucket capacity: next power of two >= 2*leaf_size.

    A split is only performed when count > leaf_size, and each side of a
    split always receives at least one point, so a leaf holds at most
    leaf_size points when created by count <= leaf_size... however the
    midpoint/fscan cuts can leave up to count-1 points on one side just
    above the stop threshold. We therefore stop splitting at
    count <= leaf_size and cap pathological splits by forcing at least one
    point per side; the max leaf occupancy is then `leaf_size` for normal
    stops. Degenerate nodes (all points identical) also become leaves and
    may exceed leaf_size; those are clamped by re-checking at build time.
    The padded capacity is rounded up for alignment-friendly gathers.
    """
    cap = 1
    while cap < max(2, leaf_size):
        cap *= 2
    return cap
