"""Snapshot search: a thin adapter over the unified query engine.

The engine groups the snapshot's segments by pow2 shape class, answers
each class in one stacked dispatch, scans the delta arena with the
`topk_l2` kernel, and folds everything with the sorted-merge primitive —
exact because every live point belongs to exactly one part.

An all-tombstoned (or empty) snapshot short-circuits on the host: all
-1 gids, zero device dispatches.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .snapshot import Snapshot


class StreamResult(NamedTuple):
    gids: np.ndarray       # (Q, k) global point ids, -1 = no result
    distances: np.ndarray  # (Q, k) inf where no result
    partial: bool = False  # sharded serving's degraded-mode flag


def constrained_knn(
    snap: Snapshot, queries: np.ndarray, k: int, r
) -> StreamResult:
    """Exact constrained-KNN over the snapshot's live point set."""
    from ..query import QuerySpec
    from ..query import engine as qengine

    res = qengine.execute(snap, queries, QuerySpec(k=k, radius=r))
    return StreamResult(
        gids=np.asarray(res.gids, np.int64),
        distances=np.asarray(res.distances, np.float32),
    )

