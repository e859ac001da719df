"""ShardedStreamingIndex: the streaming LSM sharded over devices (port of
the reference's `index/sharded.py`).

Each shard is a complete `StreamingIndex` — its own delta arena, segment
set, tombstone log, and (optionally) WAL — placed on one device: the
reference's 1-D ``data`` mesh becomes a list of torch devices, and the
shards go round-robin over it (with one card, every shard sits on it;
with ``device="cpu"``, on the CPU). Global ids are assigned at THIS
layer in insertion order, i.e. the very ids a single-device index would
assign for the same operation sequence, and points are routed
round-robin (``shard = gid % n_shards``), so shard sizes stay balanced
to within one point per batch and a sharded index is comparable
bit-for-bit against an unsharded one over any randomized interleave of
operations.

Search fans out, then folds:

  1. every shard's snapshot runs through the query engine
     (`query/engine.execute`) on its own device, one shard after another
     on the host (as the reference dispatches them); shards stamp their
     snapshots with a distinct ``cache_tag`` so same-shape-class batches
     from different shards occupy different buckets of the engine's
     stacked-batch LRU instead of evicting each other;
  2. per-shard LOCAL ids are translated to global ids on the host via
     the layer's append-only local→global tables;
  3. the per-shard sorted k-bests are copied to the first shard's device
     and folded there with the engine's merge (`query/merge.merge_parts`)
     — the reference's all_gather + merge (span ``shard.fold``). Exact:
     every live point lives in exactly one shard, each shard's k-best is
     exact over its own points, and the union of per-shard k-bests holds
     the global k-best.

One process owns every shard, as one JAX controller does in the
reference: no `torch.distributed` ranks.

Recovery: with ``wal_dir`` set every shard writes its own WAL
(``shard{s:03d}.wal``) and checkpoint, and this layer stamps each
add/bulk_load record's ``meta`` with the chunk's global ids. A restart
recovers each shard in its `StreamingIndex` constructor (checkpoint +
WAL-tail replay) and rebuilds the global↔local translation here from the
shard's replayed meta stream (`StreamingIndex.wal_metas`). The files are
the reference's: either package recovers the other's directory.

Degraded mode: per-shard search dispatches run under a `FailoverPolicy`
— transient failures are retried with exponential backoff, a shard that
stays down is skipped with the query's result flagged ``partial=True``
and the failover counted on the obs registry, and only an all-shard
failure raises. The fault-injection site ``shard.search`` drives exactly
these paths deterministically.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import distributed
from ..query import engine as qengine
from ..query.spec import QuerySpec
from . import faults
from . import search as search_mod
from .snapshot import Snapshot
from .streaming import StreamingConfig, StreamingIndex


@dataclasses.dataclass(frozen=True)
class FailoverPolicy:
    """Degraded-mode search policy: a failing shard dispatch is retried
    with exponential backoff, then — when `enabled` — skipped, with the
    query's result flagged ``partial=True`` and the skip counted on the
    obs registry (``shard.failovers``). Disabled, the failure propagates
    to the caller after the retries (strict mode); a query only ever
    raises in degraded mode when EVERY shard fails."""

    enabled: bool = True
    max_retries: int = 2
    backoff_s: float = 0.005
    backoff_multiplier: float = 2.0


def data_devices(n_shards: int) -> Optional[List[torch.device]]:
    """The first `n_shards` CUDA devices, or None when the process has
    fewer (the shards then share the devices it has)."""
    if torch.cuda.device_count() < n_shards:
        return None
    return [torch.device("cuda", i) for i in range(n_shards)]


class ShardedSnapshot(NamedTuple):
    """Consistent-enough multi-shard read view: per-shard MVCC
    snapshots (each individually torn-free) plus the local→global
    translation tables frozen at capture."""

    shards: Tuple[Snapshot, ...]
    g_of: Tuple[np.ndarray, ...]  # g_of[s][local_gid] = global gid

    @property
    def n_live(self) -> int:
        return sum(s.n_live for s in self.shards)


class ShardedStreamingIndex:
    def __init__(
        self,
        config: StreamingConfig,
        n_shards: Optional[int] = None,
        devices=None,
        wal_dir: Optional[str] = None,
        failover: Optional[FailoverPolicy] = None,
    ) -> None:
        self.failover = failover if failover is not None else FailoverPolicy()
        if devices is not None:
            devs = distributed.device_list(devices)
            n_shards = n_shards or len(devs)
        self.n_shards = int(n_shards or max(1, torch.cuda.device_count()))
        if self.n_shards < 1:
            raise ValueError("need n_shards >= 1")
        if devices is None:
            # CPU on request; otherwise a card per shard where there are
            # enough, else round-robin over the cards there are (none:
            # the configured device, whose first tensor then raises)
            if torch.device(config.device).type == "cpu":
                devs = [torch.device("cpu")]
            else:
                devs = (
                    data_devices(self.n_shards)
                    or [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                    or [torch.device(config.device)]
                )
        self._devices = [devs[s % len(devs)] for s in range(self.n_shards)]
        self._lock = threading.RLock()
        if wal_dir:
            os.makedirs(wal_dir, exist_ok=True)

        self.config = config
        self._shards: List[StreamingIndex] = []
        for s in range(self.n_shards):
            sub_cfg = dataclasses.replace(
                config,
                wal_path=(
                    os.path.join(wal_dir, f"shard{s:03d}.wal")
                    if wal_dir
                    else None
                ),
                device=str(self._devices[s]),
            )
            sub = StreamingIndex(sub_cfg)  # replays its WAL if any
            sub.cache_tag = ("shard", id(self), s)
            self._shards.append(sub)

        # append-only local→global tables + the inverse locator; both
        # cover every id EVER assigned (deletes are tombstones)
        self._g_of: List[List[int]] = [[] for _ in range(self.n_shards)]
        self._g_arr: List[np.ndarray] = [
            np.empty(0, np.int64) for _ in range(self.n_shards)
        ]
        self._local_of: Dict[int, int] = {}
        self._next_gid = 0
        if wal_dir:
            self._recover_translation()

    def _recover_translation(self) -> None:
        """Rebuild global↔local tables from each shard's replayed meta
        stream (`StreamingIndex.wal_metas`: the checkpoint-restored
        prefix plus the WAL-tail replay, in the shard's local-id
        assignment order)."""
        for s, sub in enumerate(self._shards):
            for meta in sub.wal_metas:
                if meta is None:
                    raise ValueError(
                        "sharded WAL record lacks global-gid meta; "
                        "was this log written by a bare StreamingIndex?"
                    )
                self._register(s, np.asarray(meta, np.int64))
        if any(len(g) for g in self._g_of):
            self._next_gid = max(
                int(g[-1]) for g in self._g_of if len(g)
            ) + 1

    def _register(self, s: int, global_gids: np.ndarray) -> None:
        base = len(self._g_of[s])
        self._g_of[s].extend(int(g) for g in global_gids)
        for i, g in enumerate(global_gids):
            self._local_of[int(g)] = base + i

    def _g_table(self, s: int) -> np.ndarray:
        if len(self._g_arr[s]) != len(self._g_of[s]):
            self._g_arr[s] = np.asarray(self._g_of[s], np.int64)
        return self._g_arr[s]

    # -- introspection -------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def n_live(self) -> int:
        return sum(sub.n_live for sub in self._shards)

    @property
    def shards(self) -> Tuple[StreamingIndex, ...]:
        return tuple(self._shards)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Each shard's device."""
        return tuple(self._devices)

    def live_gids(self) -> np.ndarray:
        """Sorted global ids of the live points — what an unsharded index
        over the same op sequence reports."""
        parts = [self._g_table(s)[sub.live_gids()]
                 for s, sub in enumerate(self._shards)]
        return np.sort(np.concatenate(parts))

    def live_points(self):
        """All live (points, gids) sorted by GLOBAL gid — identical to
        what an unsharded index over the same op sequence reports."""
        parts_p, parts_g = [], []
        for s, sub in enumerate(self._shards):
            pts, local_g = sub.live_points()
            parts_p.append(pts)
            parts_g.append(self._g_table(s)[local_g])
        pts = np.concatenate(parts_p)
        gids = np.concatenate(parts_g)
        order = np.argsort(gids, kind="stable")
        return pts[order], gids[order]

    def stats(self) -> dict:
        per = [sub.stats() for sub in self._shards]
        return {
            "n_shards": self.n_shards,
            "n_live": self.n_live,
            "n_live_per_shard": [p["n_live"] for p in per],
            "n_segments_per_shard": [p["n_segments"] for p in per],
            "shards": per,
        }

    # -- write path (routes to shards, assigns GLOBAL gids) ------------------
    def _route(self, points: np.ndarray, method: str) -> np.ndarray:
        pts = np.asarray(points, np.float32).reshape(-1, self.dim)
        with self._lock:
            gids = np.arange(
                self._next_gid, self._next_gid + len(pts), dtype=np.int64
            )
            self._next_gid += len(pts)
            for s, sub in enumerate(self._shards):
                mask = (gids % self.n_shards) == s
                if not mask.any():
                    continue
                getattr(sub, method)(pts[mask], meta=gids[mask])
                self._register(s, gids[mask])
        return gids

    def add(self, points: np.ndarray) -> np.ndarray:
        return self._route(points, "add")

    def bulk_load(self, points: np.ndarray) -> np.ndarray:
        return self._route(points, "bulk_load")

    def delete(self, gids: np.ndarray) -> int:
        g = np.atleast_1d(np.asarray(gids, np.int64))
        n = 0
        with self._lock:
            for s, sub in enumerate(self._shards):
                mine = g[g % self.n_shards == s]
                locs = [
                    self._local_of[int(x)]
                    for x in mine
                    if int(x) in self._local_of
                ]
                if locs:
                    n += sub.delete(np.asarray(locs, np.int64))
        return n

    def flush(self) -> None:
        with self._lock:
            for sub in self._shards:
                sub.flush()

    def compact(self) -> None:
        with self._lock:
            for sub in self._shards:
                sub.compact()

    def maintain(self) -> bool:
        changed = False
        for sub in self._shards:
            changed |= sub.maintain()
        return changed

    def checkpoint(self) -> bool:
        """Checkpoint every shard (each truncates its own WAL). True if
        any shard published one (False on volatile shards)."""
        ok = False
        with self._lock:
            for sub in self._shards:
                ok |= sub.checkpoint()
        return ok

    def start_background_compaction(self, interval: float = 0.05) -> None:
        for sub in self._shards:
            sub.start_background_compaction(interval)

    def stop_background_compaction(self) -> None:
        for sub in self._shards:
            sub.stop_background_compaction()

    def close(self) -> None:
        for sub in self._shards:
            sub.close()

    # -- read path -----------------------------------------------------------
    def snapshot(self) -> ShardedSnapshot:
        with self._lock:
            return ShardedSnapshot(
                shards=tuple(sub.snapshot() for sub in self._shards),
                g_of=tuple(
                    self._g_table(s) for s in range(self.n_shards)
                ),
            )

    def _search_shard(self, s: int, sub_snap: Snapshot, q, spec):
        """One shard's engine dispatch with the failover retry loop.
        `faults.fire` is INSIDE the loop, so a transient injected fault
        (`times=1`) clears on retry exactly like a real flaky device."""
        pol = self.failover
        attempts = 1 + max(0, pol.max_retries)
        delay = pol.backoff_s
        for attempt in range(attempts):
            try:
                faults.fire("shard.search", shard=s)
                return qengine.execute(sub_snap, q, spec)
            except Exception:
                if attempt + 1 >= attempts:
                    raise
                obs.REGISTRY.counter("shard.search_retries", shard=s).inc()
                time.sleep(delay)
                delay *= pol.backoff_multiplier

    def constrained_knn(
        self, queries: np.ndarray, k: int, r
    ) -> search_mod.StreamResult:
        """Exact constrained-KNN over all shards' live points.

        Degraded mode (`FailoverPolicy.enabled`, the default): a shard
        whose dispatch keeps failing after the retry budget is skipped
        — its skip is counted (``shard.failovers``) and the result is
        flagged ``partial=True`` — instead of failing the whole query.
        Only when EVERY shard fails does the query raise."""
        snap = self.snapshot()
        q = np.asarray(queries, np.float32).reshape(-1, self.dim)
        spec = QuerySpec(k=k, radius=r)
        parts_d, parts_g = [], []
        failed = 0
        last_err: Optional[BaseException] = None
        for s, sub_snap in enumerate(snap.shards):
            try:
                res = self._search_shard(s, sub_snap, q, spec)
            except Exception as e:
                if not self.failover.enabled:
                    raise
                failed += 1
                last_err = e
                obs.REGISTRY.counter("shard.failovers", shard=s).inc()
                continue
            local = np.asarray(res.gids, np.int64)
            glob = np.full_like(local, -1)
            valid = local >= 0
            glob[valid] = snap.g_of[s][local[valid]]
            parts_d.append(np.asarray(res.distances, np.float32))
            parts_g.append(glob)
        if not parts_d:
            raise RuntimeError(
                f"all {self.n_shards} shards failed"
            ) from last_err
        partial = failed > 0
        if partial:
            obs.REGISTRY.counter("shard.partial_queries").inc()
        d, g = self._fold(parts_d, parts_g, k)
        return search_mod.StreamResult(
            gids=np.asarray(g, np.int64),
            distances=np.asarray(d, np.float32),
            partial=partial,
        )

    def knn(self, queries: np.ndarray, k: int) -> search_mod.StreamResult:
        return self.constrained_knn(queries, k, np.inf)

    # -- cross-shard fold ----------------------------------------------------
    def _fold(self, parts_d, parts_g, k: int):
        """Fold the surviving shards' sorted k-bests (host arrays, in
        shard order) into the global k-best on the first shard's device.
        Global gids stay < 2^31, so the i32 merge lanes are safe."""
        if len(parts_d) == 1:
            return parts_d[0], parts_g[0]
        with obs.span("shard.fold"):
            parts = [
                (torch.from_numpy(d), torch.from_numpy(g.astype(np.int32)))
                for d, g in zip(parts_d, parts_g)
            ]
            d, g = distributed.fold(parts, k, self._devices[0])
            return d.cpu().numpy(), g.cpu().numpy()


__all__ = [
    "FailoverPolicy",
    "ShardedSnapshot",
    "ShardedStreamingIndex",
    "data_devices",
]
