"""Distributed ball*-tree (port of the reference's `core/distributed.py`).

Scatter-gather sharding: the point set is split into shards, each shard
builds a LOCAL ball*-tree over its slice, and a query runs the
constrained-NN traversal in every shard; the global k-best is the fold
of the shards' local k-bests (k (distance, id) pairs per query each)
with the engine's sorted merge. Exact: the union of per-shard k-bests
contains the global k-best.

The reference runs one JAX controller with `shard_map` over a `data`
mesh axis and an `all_gather` + merge epilogue. Here one process owns
every shard: the mesh becomes a list of torch devices, shards go
round-robin over them, the shards that share a device run as ONE
stacked walk (`core/search.constrained_knn_stacked_parts`, the shards
as members of the stack, each with its gid table `offset + local`), and
the (S, Q, k) parts are copied to the first device and folded in shard
order — the all_gather + merge. With one card, every shard sits on it.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..query import merge as qmerge
from . import build_host
from . import search as sj
from .build import build as _build_torch
from .types import Tree, TreeSpec


class ShardGroup(NamedTuple):
    """The shards that live on one device, stacked for one walk."""

    device: torch.device
    shards: Tuple[int, ...]    # shard ids, ascending
    stacked: sj.DeviceTree     # (len(shards), …) padded trees
    gids: torch.Tensor         # (len(shards), n) i32: offset[s] + local id


@dataclasses.dataclass
class ShardedIndex:
    devices: List[torch.device]  # one per shard (round-robin placement)
    trees: List[Tree]            # host handles (one per shard)
    groups: List[ShardGroup]     # per device, its shards stacked
    stack_size: int
    shard_offsets: np.ndarray    # original-id offset per shard

    @property
    def n_shards(self) -> int:
        return len(self.trees)


def device_list(devices) -> List[torch.device]:
    """A device, a device name, or a sequence of either, as a list."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("need at least one device")
    return out


def _placement(devices, n_shards) -> List[torch.device]:
    devs = device_list(devices)
    n = int(n_shards or len(devs))
    if n < 1:
        raise ValueError("need n_shards >= 1")
    return [devs[s % len(devs)] for s in range(n)]


def build_sharded(
    points: np.ndarray,
    devices="cuda",
    spec: TreeSpec | None = None,
    n_shards: int | None = None,
    backend: str = "torch",
) -> ShardedIndex:
    """Shard points (`n_shards`, default one per device), build one local
    tree per shard with `backend` ("torch": on the shard's device) and
    stack the trees of each device."""
    placed = _placement(devices, n_shards)
    spec = spec or TreeSpec.ballstar()
    n = points.shape[0]
    per = n // len(placed)
    trees, offsets = [], []
    for s, dev in enumerate(placed):
        lo = s * per
        hi = n if s == len(placed) - 1 else lo + per
        if backend == "torch":
            trees.append(_build_torch(points[lo:hi], spec, device=dev))
        elif backend == "host":
            trees.append(build_host.build(points[lo:hi], spec))
        else:
            raise ValueError(f"unknown backend {backend!r}")
        offsets.append(lo)
    return from_trees(trees, offsets, placed)


def from_trees(trees: Sequence[Tree], offsets, devices) -> ShardedIndex:
    """A `ShardedIndex` over built per-shard trees: shard s holds
    original ids offsets[s] + its local ids, and lives on devices[s]."""
    trees = list(trees)
    devices = device_list(devices)
    if len(devices) != len(trees) or len(offsets) != len(trees):
        raise ValueError("one device and one offset per tree")
    offsets = np.asarray(offsets, np.int64)
    host = _stack_trees(trees)
    n_ids = max(t.n_points for t in trees)
    groups = []
    for dev in dict.fromkeys(devices):  # first-use order, no repeats
        rows = [s for s, d in enumerate(devices) if d == dev]
        stacked = sj.DeviceTree(*[
            torch.from_numpy(np.ascontiguousarray(getattr(host, f)[rows])).to(dev)
            for f in sj.DeviceTree._fields
        ])
        gids = torch.from_numpy(
            (offsets[rows, None] + np.arange(n_ids)[None]).astype(np.int32)
        ).to(dev)
        groups.append(ShardGroup(dev, tuple(rows), stacked, gids))
    stack_size = max(int(t.leaf_depths().max()) for t in trees) + 3
    return ShardedIndex(
        devices=devices,
        trees=trees,
        groups=groups,
        stack_size=stack_size,
        shard_offsets=offsets,
    )


def _pad_to(a: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


def _stack_trees(trees: List[Tree]) -> sj.DeviceTree:
    """Host (numpy) stack of the trees' search arrays, padded to a common
    node count, leaf count and leaf capacity with the reference's fills:
    centers 1e30, radius 0, children -1, leaf_index -1."""
    n_nodes = max(t.n_nodes for t in trees)
    n_leaves = max(t.n_leaves for t in trees)
    cap = max(t.leaf_capacity for t in trees)
    d = trees[0].dim

    def prep(t: Tree):
        lp = np.zeros((n_leaves, cap, d), np.float32)
        lp[: t.n_leaves, : t.leaf_capacity] = t.leaf_points
        li = np.full((n_leaves, cap), -1, np.int32)
        li[: t.n_leaves, : t.leaf_capacity] = t.leaf_index
        return sj.DeviceTree(
            center=_pad_to(np.asarray(t.center, np.float32), n_nodes, 1e30),
            radius=_pad_to(np.asarray(t.radius, np.float32), n_nodes, 0.0),
            child_l=_pad_to(np.asarray(t.child_l, np.int64), n_nodes, -1),
            child_r=_pad_to(np.asarray(t.child_r, np.int64), n_nodes, -1),
            leaf_of_node=_pad_to(np.asarray(t.leaf_of_node, np.int64), n_nodes, -1),
            leaf_points=lp,
            leaf_index=li,
        )

    parts = [prep(t) for t in trees]
    return sj.DeviceTree(
        *[np.stack([getattr(p, f) for p in parts]) for f in sj.DeviceTree._fields]
    )


def fold(parts, k: int, device):
    """The all_gather + merge epilogue: every shard's sorted (distances,
    global ids) k-best copied to `device`, folded in shard order."""
    moved = [(d.to(device), g.to(device=device, dtype=torch.int32))
             for d, g in parts]
    return qmerge.merge_parts(moved, k)


def _queries_on(devices, queries: np.ndarray) -> dict:
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    return {dev: q.to(dev) for dev in dict.fromkeys(devices)}


def constrained_knn(index: ShardedIndex, queries: np.ndarray, k: int, r):
    """Exact global constrained-KNN via shard-local search + merge.
    Returns (global indices (Q, k), distances (Q, k)) as numpy."""
    q_host = np.asarray(queries, np.float32).reshape(-1, index.trees[0].dim)
    q_on = _queries_on(index.devices, q_host)
    parts = [None] * index.n_shards
    for grp in index.groups:
        dd, gg, _ = sj.constrained_knn_stacked_parts(
            grp.stacked, grp.gids, q_on[grp.device], r, k, index.stack_size
        )
        for j, s in enumerate(grp.shards):
            parts[s] = (dd[j], gg[j])
    dist, idx = fold(parts, k, index.devices[0])
    return idx.cpu().numpy(), dist.cpu().numpy()


def brute_constrained_knn(
    points: np.ndarray,
    devices,
    queries: np.ndarray,
    k: int,
    r,
    n_shards: int | None = None,
):
    """Distributed brute-force baseline: no tree. The points are padded
    to an even split over `n_shards` (default one per device; padded
    slots carry gid -1, which the kernel's liveness mask drops); each
    shard streams its slice once through the `topk_l2` kernel
    (`core/search.brute_topk`) and the shards' k-bests are folded as in
    `constrained_knn`. Returns (global indices (Q, k), distances (Q, k))."""
    placed = _placement(devices, n_shards)
    n_sh = len(placed)
    n, dim = points.shape
    per = (n + n_sh - 1) // n_sh
    pts = np.zeros((per * n_sh, dim), np.float32)
    pts[:n] = points
    gids = np.full(per * n_sh, -1, np.int32)
    gids[:n] = np.arange(n, dtype=np.int32)
    q_on = _queries_on(placed, np.asarray(queries, np.float32).reshape(-1, dim))
    parts = []
    for s, dev in enumerate(placed):
        sl = slice(s * per, (s + 1) * per)
        res = sj.brute_topk(
            torch.from_numpy(pts[sl]).to(dev), q_on[dev], k, r,
            gids=torch.from_numpy(gids[sl]).to(dev),
        )
        parts.append((res.distances, res.indices))
    dist, idx = fold(parts, k, placed[0])
    return idx.cpu().numpy(), dist.cpu().numpy()


__all__ = [
    "ShardGroup",
    "ShardedIndex",
    "brute_constrained_knn",
    "build_sharded",
    "constrained_knn",
    "device_list",
    "fold",
    "from_trees",
]
