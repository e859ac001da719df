"""Power-of-two shape classes for segment device arrays.

Rounding every segment axis — node count, leaf count, gid table, stack
depth — up to a power of two buckets all segments into at most log2(N)
*shape classes*: all segments of a class are answered by one stacked
dispatch, and the stacked batch can be patched member by member.
Padding is correctness-free by construction: padded nodes are
unreachable (no child pointer ever aims at them), padded leaf rows are
never ranked, padded leaf slots carry index -1 (the tombstone/padding
sentinel), and extra stack slots are simply never used.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import search as sj
from ..kernels import quantize


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


class ShapeClass(NamedTuple):
    """Shape of one segment's device arrays (the stacking key)."""

    n_nodes: int     # pow2-padded node count
    n_leaves: int    # pow2-padded leaf count
    cap: int         # leaf capacity (fixed by the TreeSpec, not padded)
    dim: int
    stack_size: int  # pow2-padded DFS stack bound
    n_gids: int      # pow2-padded gid-table length
    sdt: str = "float32"  # leaf coordinate STORAGE dtype: segments with
    #                       different storage widths never stack


def shape_class_of(
    dtree, stack_size: int, n_gids: int, storage_dtype: str = "float32"
) -> ShapeClass:
    return ShapeClass(
        n_nodes=int(dtree.center.shape[0]),
        n_leaves=int(dtree.leaf_points.shape[0]),
        cap=int(dtree.leaf_points.shape[1]),
        dim=int(dtree.center.shape[1]),
        stack_size=int(stack_size),
        n_gids=int(n_gids),
        sdt=str(storage_dtype),
    )


def padded_stack_size(depth: int) -> int:
    """Pow2 bucket of the DFS stack bound (depth+2 plus one slack)."""
    return next_pow2(depth + 3)


def _pad_axis0(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    out = torch.full((n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    out[: a.shape[0]] = a
    return out


def pad_device_tree(dt: sj.DeviceTree) -> sj.DeviceTree:
    """Pad node/leaf axes to the next power of two (shape-class form)."""
    n_nodes = next_pow2(int(dt.center.shape[0]))
    n_leaves = next_pow2(int(dt.leaf_points.shape[0]))
    return sj.DeviceTree(
        center=_pad_axis0(dt.center, n_nodes, 0.0),
        radius=_pad_axis0(dt.radius, n_nodes, 0.0),
        child_l=_pad_axis0(dt.child_l, n_nodes, -1),
        child_r=_pad_axis0(dt.child_r, n_nodes, -1),
        leaf_of_node=_pad_axis0(dt.leaf_of_node, n_nodes, -1),
        leaf_points=_pad_axis0(dt.leaf_points, n_leaves, 0.0),
        leaf_index=_pad_axis0(dt.leaf_index, n_leaves, -1),
    )


def pad_gids(gids_dev: torch.Tensor) -> torch.Tensor:
    """Pad the local-id -> gid table to pow2 with -1 (never selected:
    the traversal only reports leaf_index entries >= 0, all < n)."""
    return _pad_axis0(gids_dev, next_pow2(int(gids_dev.shape[0])), -1)


def dummy_member(cls: ShapeClass, device, dtype=torch.float32):
    """An all-dead member used to pad a stacked class batch to a pow2
    segment count: its root is a leaf whose slots are all -1, so a
    traversal pops exactly one node, finds no candidates, and stops."""
    def full(shape, fill, dt):
        return torch.full(shape, fill, dtype=dt, device=device)

    nn_, nl, cap, dim = cls.n_nodes, cls.n_leaves, cls.cap, cls.dim
    dt = sj.DeviceTree(
        center=full((nn_, dim), 0.0, dtype),
        radius=full((nn_,), 0.0, dtype),
        child_l=full((nn_,), -1, torch.int64),
        child_r=full((nn_,), -1, torch.int64),
        leaf_of_node=full((nn_,), -1, torch.int64),
        leaf_points=full((nl, cap, dim), 0.0, dtype),
        leaf_index=full((nl, cap), -1, torch.int32),
    )
    return dt, full((cls.n_gids,), -1, torch.int32)


def dummy_quantized(cls: ShapeClass, device):
    """The quantized side buffers of a dummy member: an all-zeros
    (L, cap, d) leaf buffer in the class's storage dtype, plus all-one
    scales when the dtype carries per-leaf scales (int8)."""
    if cls.sdt == "float32":
        return None, None
    leaf_q = torch.zeros(
        (cls.n_leaves, cls.cap, cls.dim),
        dtype=quantize.torch_dtype(cls.sdt),
        device=device,
    )
    qscale = (
        torch.ones((cls.n_leaves,), dtype=torch.float32, device=device)
        if cls.sdt == "int8"
        else None
    )
    return leaf_q, qscale
