"""Versioned read views: MVCC by copy-on-write device tensors.

Every mutation of the streaming index (`add`, `delete`, seal, merge)
bumps a version counter and REPLACES the device tensors it touches: a
write goes into a fresh clone (delta appends and tombstones, segment
tombstones) or a freshly built segment, never into a tensor a published
state holds. A `Snapshot` therefore only has to *reference* the current
tensors: a reader holding a snapshot keeps searching the exact point set
that existed at capture time while the writer races ahead. (The
reference gets this for free from JAX's immutable arrays; in PyTorch the
copy-before-write rule is what provides it.)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SegmentView:
    """The read-only slice of a segment that search needs on device."""

    dtree: object         # core.search.DeviceTree (pow2 shape-class
    #                       padded; leaf_index holds tombstones)
    stack_size: int
    gids_dev: torch.Tensor  # (n_pow2,) i32 local original id -> global id
    n_live: int
    token: int            # unique id of this tensor version — the query
    #                       engine's stacked-batch cache key
    leaf_q: object = None   # quantized leaf storage (None for f32)
    qscale: object = None
    qerr: float = 0.0
    storage_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """A consistent, immutable view of (segments ∪ delta) at `version`."""

    version: int
    n_live: int
    segments: Tuple[SegmentView, ...]
    delta_points: torch.Tensor  # (capacity, d)
    delta_gids: torch.Tensor    # (capacity,) i32, -1 = empty/dead
    delta_size: int             # append cursor at capture time
    delta_n_live: int           # live (non-tombstoned) delta points
    epoch: int = 0              # gid-remap epoch at capture
    cache_tag: object = None    # per-index tag of the engine's cache key

    @property
    def n_parts(self) -> int:
        """Independent search partitions (segments + non-empty delta)."""
        return len(self.segments) + (1 if self.delta_size else 0)

    @property
    def dim(self) -> int:
        return int(self.delta_points.shape[1])
