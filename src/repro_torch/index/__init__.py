"""Streaming mutable constrained-NN index: LSM-tiered ball*-tree segments
with a device-resident delta buffer (port of the reference's `index`).

    writes ──> delta arena (device, fixed capacity, exhaustive scan by
               the `topk_l2` kernel)
        seal ──> immutable ball*-tree segment (`core/build.py`)
            merge ──> geometric size-tiered compaction (rebuild, purge
                      tombstones)
    deletes ──> tombstones: leaf-slot masks in the owning segment's
                device `leaf_index`, purged at compaction
    reads ──> versioned `Snapshot` (copy-on-write tensors = MVCC); exact
              top-k merge over segments ∪ delta

Each live point lives in exactly one part, each part's constrained-KNN
is exact over its own live points, and the merge of per-part k-bests is
exact — so search equals a fresh static build over the live set.

Durability: a write-ahead log (`wal`) and atomic checkpoints
(`checkpoint`) in the reference's file formats, and the deterministic
fault injection (`faults`) that drives their crash tests. Sharding waits
for a later slice.
"""
from . import checkpoint, faults, wal  # noqa: F401
from .delta import DeltaBuffer  # noqa: F401
from .search import StreamResult, constrained_knn, knn  # noqa: F401
from .segment import Segment, merge_segments, plan_merges, tier_of  # noqa: F401
from .snapshot import SegmentView, Snapshot  # noqa: F401
from .streaming import StreamingConfig, StreamingIndex  # noqa: F401
from .tombstones import TombstoneLog  # noqa: F401
from .wal import WriteAheadLog  # noqa: F401
