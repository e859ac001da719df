"""Carry tree state across from the reference package.

`tree_from_reference` takes a `Tree` built by either package (its fields
numpy arrays — both builders return numpy) and returns the port's own
`Tree`, so tests can run the reference and the port on the SAME tree
and compare paper-metric counts exactly. No import of the reference is
needed: the fields are read by name. `sharded_index_from_reference`
does the same for the reference's `distributed.ShardedIndex`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core import distributed as _distributed
from .core import search as _search
from .core.types import Tree, TreeSpec

_ARRAY_FIELDS = (
    "center", "radius", "child_l", "child_r", "start", "count", "points",
    "perm", "leaf_of_node", "leaf_points", "leaf_index",
)


def tree_from_reference(tree) -> Tree:
    """The port's `Tree` holding copies of `tree`'s numpy fields."""
    spec = getattr(tree, "spec", None)
    if spec is not None:
        spec = TreeSpec(**{
            f.name: getattr(spec, f.name) for f in dataclasses.fields(TreeSpec)
        })
    return Tree(
        **{f: np.array(getattr(tree, f)) for f in _ARRAY_FIELDS}, spec=spec
    )


def device_tree(tree, device="cuda", dtype=None) -> _search.DeviceTree:
    """Upload a tree of either package as the port's `DeviceTree`."""
    import torch

    return _search.device_tree(
        tree_from_reference(tree), dtype or torch.float32, device
    )


def sharded_index_from_reference(index, device="cuda") -> _distributed.ShardedIndex:
    """The port's `ShardedIndex` over the reference's per-shard host trees
    and shard offsets, every shard on `device` (a device, or a list of
    them for round-robin placement)."""
    devs = _distributed.device_list(device)
    trees = [tree_from_reference(t) for t in index.trees]
    return _distributed.from_trees(
        trees,
        np.asarray(index.shard_offsets, np.int64),
        [devs[s % len(devs)] for s in range(len(trees))],
    )
