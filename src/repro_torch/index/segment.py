"""Immutable ball*-tree segments and the size-tiered merge policy.

A segment is one sealed delta (or the product of a merge): a ball*-tree
built once with the level-synchronous builder (`core/build.py`) and
never restructured. Mutability is layered on top:

  * delete — a tombstone sets the point's slot in the device
    ``leaf_index`` to -1 (in a CLONE: snapshots and stacked engine
    batches may hold the old tensor). The traversal treats negative
    slots as padding; centers/radii stay unchanged, which keeps every
    pruning bound conservative, so search stays exact.
  * merge — when `merge_factor` segments accumulate in one size class,
    their live points are rebuilt into one larger segment. This is where
    tombstones are physically purged.

Size classes are geometric in the delta capacity, so a point takes part
in O(log_factor N) rebuilds over its lifetime.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.build import build as build_tree
from ..core import search as sj
from ..core.types import Tree, TreeSpec
from ..kernels import quantize
from ..query import shapes

# Monotonic content token: stamped at every seal/merge AND refreshed by
# every tombstone, so a token names one immutable version of a
# segment's device tensors (the engine's stacked-batch cache key).
_TOKENS = itertools.count()


@dataclasses.dataclass(frozen=True)
class Segment:
    tree: Tree                 # host tree (kept for rebuilds / inspection)
    dtree: sj.DeviceTree       # device tensors, pow2 shape-class padded;
    #                            leaf_index carries tombstones
    stack_size: int            # pow2 shape-class stack bound
    gids: np.ndarray           # (n,) i64: local original id -> global id
    gids_dev: torch.Tensor     # (n_pow2,) i32 on-device id map, -1 padded
    slot_of_local: np.ndarray  # (n, 2) i32: local id -> (leaf rank, slot)
    live: np.ndarray           # (n,) bool host mask (False = tombstoned)
    token: int                 # unique id of this device-tensor version
    n_dead: int = 0
    # quantized leaf storage (the fused traversal's phase-2 stream),
    # encoded once at seal/merge from the PADDED leaf buffer
    leaf_q: object = None          # (L, cap, d) storage dtype or None
    qscale: object = None          # (L,) f32 per-leaf scales (int8) or None
    qerr: float = 0.0              # seal-time euclidean dequant bound
    storage_dtype: str = "float32"

    @staticmethod
    def from_points(
        points: np.ndarray,
        gids: np.ndarray,
        spec: TreeSpec,
        storage_dtype: str = "float32",
        device="cuda",
    ) -> "Segment":
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        tree = build_tree(points, spec, device=device)
        li = np.asarray(tree.leaf_index)
        slot_of_local = np.full((n, 2), -1, np.int32)
        ranks, slots = np.nonzero(li >= 0)
        slot_of_local[li[ranks, slots]] = np.stack([ranks, slots], 1)
        dtree = shapes.pad_device_tree(sj.device_tree(tree, device=device))
        leaf_q, qscale, qerr = quantize.quantize_leaves(
            dtree.leaf_points, storage_dtype
        )
        return Segment(
            tree=tree,
            dtree=dtree,
            stack_size=shapes.padded_stack_size(sj.max_depth(tree)),
            gids=np.asarray(gids, np.int64),
            gids_dev=shapes.pad_gids(
                torch.as_tensor(np.asarray(gids).astype(np.int32)).to(device)
            ),
            slot_of_local=slot_of_local,
            live=np.ones(n, bool),
            token=next(_TOKENS),
            leaf_q=leaf_q,
            qscale=qscale,
            qerr=qerr,
            storage_dtype=quantize.check_dtype(storage_dtype),
        )

    @property
    def n_points(self) -> int:
        return int(self.gids.shape[0])

    @property
    def n_live(self) -> int:
        return self.n_points - self.n_dead

    def tombstone(self, local_ids: np.ndarray) -> "Segment":
        """Mask `local_ids` out of the device leaf buckets: the write goes
        into a clone of leaf_index, so holders of the old one (snapshots,
        stacked batches) never see it."""
        local_ids = np.asarray(local_ids, np.int64)
        rs = torch.as_tensor(self.slot_of_local[local_ids]).long()
        leaf_index = self.dtree.leaf_index.clone()
        rs = rs.to(leaf_index.device)
        leaf_index[rs[:, 0], rs[:, 1]] = -1
        live = self.live.copy()
        live[local_ids] = False
        return dataclasses.replace(
            self,
            dtree=self.dtree._replace(leaf_index=leaf_index),
            live=live,
            token=next(_TOKENS),  # new tensor version: invalidate caches
            n_dead=self.n_dead + len(local_ids),
        )

    def live_points(self):
        """Live (points, gids) in the segment's original insertion order."""
        pts, _, _ = self.host_rows()
        return pts[self.live], self.gids[self.live]

    def host_rows(self):
        """ALL rows — (points f32, gids i64, live bool mask) — in the
        segment's original insertion order."""
        inv = np.empty(self.n_points, np.int64)
        inv[np.asarray(self.tree.perm)] = np.arange(self.n_points)
        orig = np.asarray(self.tree.points)[inv]
        return orig, self.gids, self.live


def tier_of(n_live: int, base: int, factor: int) -> int:
    """Geometric size class: tier t covers [base·factor^t, base·factor^(t+1))."""
    if n_live <= 0:
        return 0
    return max(0, int(math.floor(math.log(max(n_live, 1) / base, factor))))


def plan_merges(
    segments: Sequence[Segment], base: int, factor: int
) -> List[List[int]]:
    """Indices of segment groups due for compaction under size-tiering:
    any tier holding >= factor segments merges all of them. One round;
    the caller loops because a merge can cascade into the next tier."""
    by_tier: Dict[int, List[int]] = {}
    for i, s in enumerate(segments):
        by_tier.setdefault(tier_of(s.n_live, base, factor), []).append(i)
    return [ids for _, ids in sorted(by_tier.items()) if len(ids) >= factor]


def merge_segments(
    segments: Sequence[Segment],
    spec: TreeSpec,
    storage_dtype: str = "float32",
    device="cuda",
) -> Segment | None:
    """Rebuild the union of live points as one segment (purges
    tombstones). Returns None when every point in the group is dead.
    Merges re-encode from the exact f32 points, so quantization error
    never compounds across generations."""
    parts = [s.live_points() for s in segments]
    pts = np.concatenate([p for p, _ in parts])
    gids = np.concatenate([g for _, g in parts])
    if len(pts) == 0:
        return None
    return Segment.from_points(
        pts, gids, spec, storage_dtype=storage_dtype, device=device
    )
