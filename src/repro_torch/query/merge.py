"""The single top-k merge used by every read path.

Every search part (a stacked shape-class batch, a delta-arena scan)
reports its candidates as an ascending-sorted (distance, id) list.
Merging two sorted lists does not need an argsort of the
concatenation: the merged position of each element is its own rank
plus its rank in the other list, which is a pair of broadcast
comparisons and one scatter. `merge_parts` folds this pairwise merge
over any number of parts (tree reduction, truncating to k between
rounds, which preserves exactness: top-k of a union is the top-k of
per-part top-ks).

Stability: on ties, elements of the first argument win (and within one
part, lower positions win) — the same order a stable argsort of the
concatenation would produce. `torch.topk` promises no order among
ties, so the unsorted selection (`topk_sorted`) is a stable sort.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def topk_sorted(d: torch.Tensor, i: torch.Tensor, k: int):
    """Ascending smallest-k of *unsorted* candidates along the last axis.

    Returns tensors of width min(k, m). Ties pick the lower slot first
    (stable sort), matching a stable argsort."""
    kk = min(k, d.shape[-1])
    vals, pos = torch.sort(d, dim=-1, stable=True)
    return vals[..., :kk], torch.gather(i, -1, pos[..., :kk])


def topk_vals(d: torch.Tensor, k: int) -> torch.Tensor:
    """Ascending smallest-k VALUES of unsorted candidates along the last
    axis — the index-free sibling of `topk_sorted`."""
    kk = min(k, d.shape[-1])
    return torch.sort(d, dim=-1).values[..., :kk]


def _cross_positions(da: torch.Tensor, db: torch.Tensor):
    """Merged positions: a[j] lands at j + |{b < a[j]}|, b[j] at
    j + |{a <= b[j]}| — the <, <= split makes the two position sets
    disjoint and the merge stable (a before equal b)."""
    ka, kb = da.shape[-1], db.shape[-1]
    pos_a = torch.arange(ka, device=da.device) + (
        db.unsqueeze(-2) < da.unsqueeze(-1)
    ).sum(-1)
    pos_b = torch.arange(kb, device=db.device) + (
        da.unsqueeze(-2) <= db.unsqueeze(-1)
    ).sum(-1)
    return pos_a, pos_b


def _scatter_merged(out, shape, pos_a, va, pos_b, vb):
    """out[..., pos_a[j]] = va[j] and out[..., pos_b[j]] = vb[j], with
    every operand broadcast to the common batch shape."""
    for pos, val in ((pos_a, va), (pos_b, vb)):
        tail = pos.shape[-1:]
        out.scatter_(-1, pos.expand(shape + tail), val.expand(shape + tail))
    return out


def merge_sorted_vals(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """`merge_sorted` for values only."""
    pos_a, pos_b = _cross_positions(da, db)
    shape = torch.broadcast_shapes(da.shape[:-1], db.shape[:-1])
    out = da.new_zeros(shape + (da.shape[-1] + db.shape[-1],))
    return _scatter_merged(out, shape, pos_a, da, pos_b, db)


def merge_sorted(
    da: torch.Tensor, ia: torch.Tensor, db: torch.Tensor, ib: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two ascending-sorted candidate lists along the last axis by
    cross-ranks (see `_cross_positions`). Works for any matching
    leading batch shape."""
    pos_a, pos_b = _cross_positions(da, db)
    shape = torch.broadcast_shapes(da.shape[:-1], db.shape[:-1])
    width = (da.shape[-1] + db.shape[-1],)
    out_d = _scatter_merged(da.new_zeros(shape + width), shape, pos_a, da, pos_b, db)
    out_i = _scatter_merged(ia.new_zeros(shape + width), shape, pos_a, ia, pos_b, ib)
    return out_d, out_i


def pad_to_k(d: torch.Tensor, i: torch.Tensor, k: int):
    """Right-pad a sorted candidate list to width k with (+inf, -1)."""
    m = d.shape[-1]
    if m >= k:
        return d[..., :k], i[..., :k]
    return (
        torch.nn.functional.pad(d, (0, k - m), value=float("inf")),
        torch.nn.functional.pad(i, (0, k - m), value=-1),
    )


def merge_parts(
    parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k over per-part sorted k-bests (tree fold)."""
    if not parts:
        raise ValueError("merge_parts needs at least one part")
    todo: List[Tuple[torch.Tensor, torch.Tensor]] = list(parts)
    while len(todo) > 1:
        nxt = []
        for j in range(0, len(todo) - 1, 2):
            d, i = merge_sorted(*todo[j], *todo[j + 1])
            nxt.append((d[..., :k], i[..., :k]))
        if len(todo) % 2:
            nxt.append(todo[-1])
        todo = nxt
    return pad_to_k(*todo[0], k)
