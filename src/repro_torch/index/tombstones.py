"""Global-id bookkeeping: assignment, location, and the tombstone log.

Every point inserted into the streaming index gets a monotonically
increasing global id (gid) that survives seals and merges — it is the
stable handle callers use to delete and the id unified search reports.
The locator maps each *live* gid to where its bytes currently are:

    gid -> (DELTA, slot)       still in the device delta arena
    gid -> (segment_uid, local) in segment `segment_uid` at local index

Segment uids are allocation-order integers that never get reused, so a
stale snapshot can keep naming segments the writer has since merged
away. Deletion drops the gid from the locator and counts it in the log;
the physical masks (delta gid slots, segment leaf_index entries) are
applied by the caller, and the bytes are reclaimed at the next merge.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

DELTA = -1  # sentinel "segment uid" for points still in the delta arena


class TombstoneLog:
    def __init__(self) -> None:
        self._loc: Dict[int, Tuple[int, int]] = {}
        self.next_gid = 0
        self.n_deleted = 0
        # version epoch: bumped whenever segment membership is REMAPPED
        # (merges/compactions move gids between holders). Downstream
        # gid-keyed caches — the query engine's stacked batches, the
        # Datastore's values arena — compare epochs instead of diffing
        # the whole locator to learn "your gid->location map is stale".
        self._epoch = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    def bump_epoch(self) -> None:
        self._epoch += 1

    # -- id assignment ------------------------------------------------------
    def assign(self, n: int) -> np.ndarray:
        # device-side gid arrays (delta gids, Segment.gids_dev) are i32;
        # fail loudly before a cast could wrap instead of returning
        # aliased ids (a raise, not an assert: survives python -O)
        if self.next_gid + n >= 2**31:
            raise OverflowError("global-id space (int32) exhausted")
        gids = np.arange(self.next_gid, self.next_gid + n, dtype=np.int64)
        self.next_gid += n
        return gids

    # -- placement ----------------------------------------------------------
    def place_delta(self, gids: np.ndarray, slots: np.ndarray) -> None:
        # .tolist() yields Python ints (dict keys must match pop's lookups)
        # and dict.update beats a per-point interpreted loop on the seal path
        g = np.asarray(gids, np.int64).tolist()
        s = np.asarray(slots, np.int64).tolist()
        self._loc.update(zip(g, ((DELTA, si) for si in s)))

    def place_segment(
        self, seg_uid: int, gids: np.ndarray, locals_: np.ndarray
    ) -> None:
        g = np.asarray(gids, np.int64).tolist()
        l = np.asarray(locals_, np.int64).tolist()
        self._loc.update(zip(g, ((seg_uid, li) for li in l)))

    # -- deletion -----------------------------------------------------------
    def pop(self, gids: Iterable[int]) -> Dict[int, List[Tuple[int, int]]]:
        """Remove gids from the live map; group them by holder.

        Returns {seg_uid (or DELTA): [(slot/local, gid), ...]}. Unknown or
        already-deleted gids are ignored (idempotent deletes).
        """
        grouped: Dict[int, List[Tuple[int, int]]] = {}
        for g in np.asarray(list(gids), np.int64):
            loc = self._loc.pop(int(g), None)
            if loc is None:
                continue
            holder, pos = loc
            grouped.setdefault(holder, []).append((pos, int(g)))
            self.n_deleted += 1
        return grouped

    # -- queries ------------------------------------------------------------
    def __contains__(self, gid: int) -> bool:
        return int(gid) in self._loc

    @property
    def n_live(self) -> int:
        return len(self._loc)

    def live_gids(self) -> np.ndarray:
        return np.fromiter(self._loc.keys(), np.int64, len(self._loc))
