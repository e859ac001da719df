"""Device-resident delta buffer: the mutable tier-0 of the streaming index.

A fixed-capacity (capacity, d) tensor lives on the device; `append`
writes new points into the next free slots and `tombstone` marks slots
dead by setting their global id to -1. The buffer is small (a few
thousand points), so it is searched *exhaustively* with the `topk_l2`
kernel: one launch streams the arena once, masks dead and never-filled
slots in-kernel, and emits only the (Q, k) sorted answer.

Copy-on-write: a `Snapshot` may hold the current `points`/`gids`
tensors, so every update writes into a fresh clone and the clone
becomes the new front; the old tensors stay exactly as the snapshot saw
them. (The reference keeps a private back pair so that a TPU append can
scatter in place into a donated buffer; an arena of this size clones in
microseconds on the card, so the port keeps one pair and copies.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class DeltaBuffer:
    points: torch.Tensor  # (capacity, d) f32 — what snapshots see
    gids: torch.Tensor    # (capacity,) i32 global id; -1 = empty or dead
    size: int             # append cursor (slots ever used)
    n_dead: int = 0       # tombstoned slots among the first `size`

    @staticmethod
    def empty(capacity: int, dim: int, device="cuda") -> "DeltaBuffer":
        return DeltaBuffer(
            points=torch.zeros((capacity, dim), dtype=torch.float32,
                               device=device),
            gids=torch.full((capacity,), -1, dtype=torch.int32,
                            device=device),
            size=0,
        )

    @property
    def capacity(self) -> int:
        return int(self.points.shape[0])

    @property
    def dim(self) -> int:
        return int(self.points.shape[1])

    @property
    def free(self) -> int:
        return self.capacity - self.size

    @property
    def n_live(self) -> int:
        return self.size - self.n_dead

    def append(self, pts: np.ndarray, gids: np.ndarray) -> "DeltaBuffer":
        """Write `pts` into the next free slots (into clones: snapshots
        keep the old tensors). Caller checks `free`."""
        m = int(pts.shape[0])
        if m > self.free:  # raise, not assert: must survive python -O
            raise ValueError(f"delta overflow: {m} points, {self.free} free")
        lo, hi = self.size, self.size + m
        dev = self.points.device
        points = self.points.clone()
        points[lo:hi] = torch.as_tensor(
            np.asarray(pts, np.float32)).to(dev)
        g = self.gids.clone()
        g[lo:hi] = torch.as_tensor(np.asarray(gids).astype(np.int32)).to(dev)
        return dataclasses.replace(self, points=points, gids=g, size=hi)

    def tombstone(self, slots: np.ndarray) -> "DeltaBuffer":
        """Mark slots dead (into a clone of the gid tensor). The locator
        pops each gid exactly once, so every slot here was live."""
        slots = np.asarray(slots, np.int64)
        g = self.gids.clone()
        g[torch.as_tensor(slots).to(g.device)] = -1
        return dataclasses.replace(
            self, gids=g, n_dead=self.n_dead + len(slots)
        )

    def live(self):
        """Host copy of live (points, gids) in insertion order."""
        g = self.gids[: self.size].cpu().numpy()
        p = self.points[: self.size].cpu().numpy()
        m = g >= 0
        return p[m], g[m].astype(np.int64)


def search(points, gids, queries, k: int, r):
    """Exact constrained-KNN over the delta arena via the `topk_l2`
    kernel: one streaming scan of the arena, selection in-kernel.
    Returns (distances (Q, k), gids (Q, k)) ascending in the
    `query/merge` convention (ties to the lower arena slot), with
    +inf / -1 where fewer than k live points fall within radius r."""
    if obs.REGISTRY.enabled:
        obs.REGISTRY.counter("delta.searches").inc()
        obs.REGISTRY.counter("delta.query_rows").inc(int(queries.shape[0]))
    return ops.topk_l2(queries, points, gids, r, k)
