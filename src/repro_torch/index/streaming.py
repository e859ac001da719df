"""StreamingIndex: the mutable constrained-NN index (LSM over ball*-trees).

Port of the reference's `index/streaming.py` on PyTorch tensors.

Write path:
  add     -> append into the device delta arena; when the arena fills it
             is *sealed*: its live points are built into a fresh
             immutable ball*-tree segment (`core/build.py`).
  delete  -> tombstone by global id: a leaf-slot mask in the owning
             segment (or a dead gid slot in the delta), applied at search
             time, physically purged by compaction.
  merge   -> size-tiered policy: whenever `merge_factor` segments share
             a geometric size class, they are rebuilt into one; a
             half-dead segment is rebuilt alone.

Read path: `snapshot()` captures a versioned, immutable view; searches
run against a snapshot, so concurrent readers are never torn by writer
progress (every write goes into fresh tensors, see `snapshot.py`).

Concurrency: every public mutator computes its result on locals and
publishes it with ONE reference assignment (`self._state = ...`);
mutators serialize on a writer lock, so a background compaction thread
(`start_background_compaction`) can run merges off the write path
(`defer_merges` + `maintain()`).

Durability (the reference's WAL and checkpoints) waits for a later
slice: a config with `wal_path` raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..core.types import TreeSpec
from ..kernels import quantize
from . import search as search_mod
from .delta import DeltaBuffer
from .segment import Segment, merge_segments, plan_merges, tier_of
from .snapshot import SegmentView, Snapshot
from .tombstones import DELTA, TombstoneLog


@dataclasses.dataclass
class StreamingConfig:
    dim: int
    delta_capacity: int = 1024
    spec: Optional[TreeSpec] = None   # default: TreeSpec.ballstar()
    merge_factor: int = 4             # size-tiered fanout (>= 2)
    purge_fraction: float = 0.5       # rebuild a segment once this dead
    # sealed-segment coordinate storage width (the default read path is
    # quantized): "bfloat16" halves phase-2 stream bytes with results
    # still bitwise those of f32 storage; "int8" quarters them;
    # "float32" opts out. REPRO_STORAGE_DTYPE overrides.
    storage_dtype: Optional[str] = None
    # write-ahead log: not ported yet (ROADMAP queue 1)
    wal_path: Optional[str] = None
    # skip inline merging in add/delete/flush; merges then run only via
    # maintain() — typically from the background compaction thread
    defer_merges: bool = False
    # where the index's tensors live and its kernels run
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.spec is None:
            self.spec = TreeSpec.ballstar()
        if self.storage_dtype is None:
            self.storage_dtype = os.environ.get(
                "REPRO_STORAGE_DTYPE", "bfloat16"
            )
        quantize.check_dtype(self.storage_dtype)
        if self.merge_factor < 2:
            raise ValueError("geometric tiering needs merge_factor >= 2")
        if self.delta_capacity < 1:
            raise ValueError("delta_capacity must be >= 1")
        if self.wal_path is not None:
            raise NotImplementedError("WAL/checkpoint: ROADMAP queue 1")


@dataclasses.dataclass(frozen=True)
class _State:
    """Everything a reader needs, behind one atomically-swapped ref.
    The segments dict is copy-on-write: never mutated after publish."""

    version: int
    delta: DeltaBuffer
    segments: Dict[int, Segment]


_INSTANCE_IDS = itertools.count()


class StreamingIndex:
    def __init__(self, config: StreamingConfig) -> None:
        self.config = config
        self.log = TombstoneLog()
        self._next_uid = 0
        self._state = _State(
            version=0, delta=self._empty_delta(), segments={}
        )
        self._write_lock = threading.RLock()
        self._bg_thread: Optional[threading.Thread] = None
        self._bg_stop = threading.Event()
        # opaque tag mixed into the query engine's stacked-batch cache key
        self.cache_tag: Optional[object] = None
        lbl = {"index": f"idx{next(_INSTANCE_IDS)}"}
        reg = obs.REGISTRY
        self._c_inserts = reg.counter("index.inserts", **lbl)
        self._c_deletes = reg.counter("index.deletes", **lbl)
        self._c_seals = reg.counter("index.seals", **lbl)
        self._c_sealed_points = reg.counter("index.sealed_points", **lbl)
        self._c_merges = {
            kind: reg.counter("index.merges", kind=kind, **lbl)
            for kind in ("tiered", "purge")
        }
        self._c_segments_merged = reg.counter("index.segments_merged", **lbl)
        self._c_compactions = reg.counter("index.compactions", **lbl)
        self._c_bulk_loads = reg.counter("index.bulk_loads", **lbl)
        self._c_maintenance = reg.counter("index.maintenance_runs", **lbl)
        self._g_version = reg.gauge("index.version", **lbl)
        self._g_n_live = reg.gauge("index.n_live", **lbl)
        self._g_n_segments = reg.gauge("index.n_segments", **lbl)
        self._g_delta_fill = reg.gauge("index.delta_fill", **lbl)
        self._g_delta_occupancy = reg.gauge("index.delta_occupancy", **lbl)
        self._g_garbage = reg.gauge("index.tombstone_garbage_ratio", **lbl)

    def _empty_delta(self) -> DeltaBuffer:
        cfg = self.config
        return DeltaBuffer.empty(cfg.delta_capacity, cfg.dim, cfg.device)

    def _new_segment(self, pts, gids) -> Segment:
        cfg = self.config
        return Segment.from_points(
            pts, gids, cfg.spec, storage_dtype=cfg.storage_dtype,
            device=cfg.device,
        )

    # -- introspection -------------------------------------------------------
    @property
    def version(self) -> int:
        return self._state.version

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def n_live(self) -> int:
        return self.log.n_live

    @property
    def delta(self) -> DeltaBuffer:
        return self._state.delta

    @property
    def segments(self) -> List[Segment]:
        return list(self._state.segments.values())

    def live_gids(self) -> np.ndarray:
        return np.sort(self.log.live_gids())

    def live_points(self):
        """Host copy of all live (points, gids), sorted by gid — the point
        set a fresh static build would index (the exactness referent)."""
        state = self._state
        parts = [s.live_points() for s in state.segments.values()]
        parts.append(state.delta.live())
        pts = np.concatenate([p for p, _ in parts])
        gids = np.concatenate([g for _, g in parts])
        order = np.argsort(gids, kind="stable")
        return pts[order], gids[order]

    def stats(self) -> dict:
        cfg = self.config
        state = self._state
        segs = list(state.segments.values())
        n_total = sum(s.n_points for s in segs) + state.delta.size
        n_dead = sum(s.n_dead for s in segs) + state.delta.n_dead
        return {
            "version": state.version,
            "n_live": self.n_live,
            "n_deleted": self.log.n_deleted,
            "n_segments": len(segs),
            "n_dead_in_segments": sum(s.n_dead for s in segs),
            "delta_fill": state.delta.size,
            "delta_capacity": cfg.delta_capacity,
            "tiers": sorted(
                tier_of(s.n_live, cfg.delta_capacity, cfg.merge_factor)
                for s in segs
            ),
            "inserts": self._c_inserts.value,
            "deletes": self._c_deletes.value,
            "seals": self._c_seals.value,
            "sealed_points": self._c_sealed_points.value,
            "tiered_merges": self._c_merges["tiered"].value,
            "purge_merges": self._c_merges["purge"].value,
            "segments_merged": self._c_segments_merged.value,
            "compactions": self._c_compactions.value,
            "bulk_loads": self._c_bulk_loads.value,
            "maintenance_runs": self._c_maintenance.value,
            "tombstone_garbage_ratio": (
                n_dead / n_total if n_total else 0.0
            ),
        }

    # -- write path ----------------------------------------------------------
    # Every mutator updates self.log eagerly while building its new state
    # on locals; if anything raises before _commit, _recover_log rederives
    # the log from the still-published state.

    def add(self, points: np.ndarray) -> np.ndarray:
        """Insert points; returns their assigned global ids."""
        pts = np.asarray(points, np.float32).reshape(-1, self.config.dim)
        with self._write_lock:
            try:
                gids = self.log.assign(len(pts))
                delta, segments = self._begin()
                i = 0
                while i < len(pts):
                    take = min(delta.free, len(pts) - i)
                    if take:
                        slots = np.arange(delta.size, delta.size + take)
                        chunk_g = gids[i : i + take]
                        delta = delta.append(pts[i : i + take], chunk_g)
                        self.log.place_delta(chunk_g, slots)
                        i += take
                    if delta.free == 0:
                        delta, segments = self._seal_delta(delta, segments)
                self._c_inserts.inc(len(pts))
                self._commit(delta, segments)
            except BaseException:
                self._recover_log()
                raise
        return gids

    def bulk_load(self, points: np.ndarray) -> np.ndarray:
        """Build one segment directly from a batch (the LSM bulk path —
        skips the delta arena and any intermediate merges)."""
        pts = np.asarray(points, np.float32).reshape(-1, self.config.dim)
        with self._write_lock:
            try:
                gids = self.log.assign(len(pts))
                delta, segments = self._begin()
                if len(pts):
                    self._install(segments, self._new_segment(pts, gids))
                    delta, segments = self._maybe_compact(delta, segments)
                self._c_bulk_loads.inc()
                self._c_inserts.inc(len(pts))
                self._commit(delta, segments)
            except BaseException:
                self._recover_log()
                raise
        return gids

    def delete(self, gids: np.ndarray) -> int:
        """Tombstone points by global id; returns how many were live."""
        g = np.atleast_1d(np.asarray(gids, np.int64))
        with self._write_lock:
            try:
                grouped = self.log.pop(g)
                if not grouped:
                    return 0
                delta, segments = self._begin()
                n = 0
                for holder, pairs in grouped.items():
                    pos = np.asarray([p for p, _ in pairs], np.int64)
                    n += len(pos)
                    if holder == DELTA:
                        delta = delta.tombstone(pos)
                    else:
                        segments[holder] = segments[holder].tombstone(pos)
                delta, segments = self._maybe_compact(delta, segments)
                self._c_deletes.inc(n)
                self._commit(delta, segments)
            except BaseException:
                self._recover_log()
                raise
        return n

    def flush(self) -> None:
        """Seal a partially-filled delta into a segment."""
        with self._write_lock:
            try:
                delta, segments = self._begin()
                if delta.size:
                    delta, segments = self._seal_delta(delta, segments)
                    self._commit(delta, segments)
            except BaseException:
                self._recover_log()
                raise

    def compact(self) -> None:
        """Full compaction: everything live into one fresh segment; all
        tombstones purged, delta drained."""
        with self._write_lock:
            try:
                pts, gids = self.live_points()
                segments: Dict[int, Segment] = {}
                if len(pts):
                    self._install(segments, self._new_segment(pts, gids))
                self._c_compactions.inc()
                self.log.bump_epoch()  # full remap: every gid moved holders
                self._commit(self._empty_delta(), segments)
            except BaseException:
                self._recover_log()
                raise

    # -- background maintenance ----------------------------------------------
    def maintain(self) -> bool:
        """Run pending size-tiered / purge merges NOW, regardless of
        `defer_merges`. Returns whether anything was merged."""
        with self._write_lock:
            try:
                delta, segments = self._begin()
                before = set(segments)
                delta2, segments2 = self._maybe_compact(
                    delta, segments, force=True
                )
                if delta2 is delta and set(segments2) == before:
                    return False
                self._c_maintenance.inc()
                self._commit(delta2, segments2)
            except BaseException:
                self._recover_log()
                raise
            return True

    def start_background_compaction(self, interval: float = 0.05) -> None:
        """Run `maintain()` on a daemon thread whenever there is merge
        work, polling every `interval` seconds when idle."""
        if self._bg_thread is not None:
            return
        self._bg_stop.clear()

        def _loop() -> None:
            while not self._bg_stop.is_set():
                try:
                    changed = self.maintain()
                except Exception:
                    changed = False  # log was recovered; retry later
                if not changed:
                    self._bg_stop.wait(interval)

        self._bg_thread = threading.Thread(
            target=_loop, name="repro-torch-compaction", daemon=True
        )
        self._bg_thread.start()

    def stop_background_compaction(self) -> None:
        if self._bg_thread is None:
            return
        self._bg_stop.set()
        self._bg_thread.join()
        self._bg_thread = None

    def close(self) -> None:
        """Stop the background thread. The index stays usable for reads."""
        self.stop_background_compaction()

    # -- read path -----------------------------------------------------------
    def snapshot(self) -> Snapshot:
        state = self._state  # single deref: the whole view, atomically
        return Snapshot(
            version=state.version,
            n_live=sum(s.n_live for s in state.segments.values())
            + state.delta.n_live,
            segments=tuple(
                SegmentView(
                    dtree=s.dtree,
                    stack_size=s.stack_size,
                    gids_dev=s.gids_dev,
                    n_live=s.n_live,
                    token=s.token,
                    leaf_q=s.leaf_q,
                    qscale=s.qscale,
                    qerr=s.qerr,
                    storage_dtype=s.storage_dtype,
                )
                for s in state.segments.values()
            ),
            delta_points=state.delta.points,
            delta_gids=state.delta.gids,
            delta_size=state.delta.size,
            delta_n_live=state.delta.n_live,
            epoch=self.log.epoch,
            cache_tag=self.cache_tag,
        )

    def constrained_knn(self, queries, k: int, r) -> search_mod.StreamResult:
        return search_mod.constrained_knn(self.snapshot(), queries, k, r)

    # -- internals (operate on locals; publish only via _commit) -------------
    def _begin(self) -> Tuple[DeltaBuffer, Dict[int, Segment]]:
        state = self._state
        return state.delta, dict(state.segments)

    def _recover_log(self) -> None:
        """Rederive the locator from the last published state after an
        aborted mutation (failure path only)."""
        state = self._state
        log = TombstoneLog()
        log.next_gid = self.log.next_gid
        log._epoch = self.log.epoch + 1
        for uid, seg in state.segments.items():
            locals_ = np.nonzero(seg.live)[0]
            log.place_segment(uid, seg.gids[locals_], locals_)
        g = state.delta.gids[: state.delta.size].cpu().numpy()
        slots = np.nonzero(g >= 0)[0]
        log.place_delta(g[slots], slots)
        log.n_deleted = log.next_gid - log.n_live
        self.log = log

    def _commit(self, delta: DeltaBuffer, segments: Dict[int, Segment]) -> None:
        state = _State(
            version=self._state.version + 1, delta=delta, segments=segments
        )
        self._state = state
        if obs.REGISTRY.enabled:
            segs = state.segments.values()
            n_live = sum(s.n_live for s in segs) + delta.n_live
            n_dead = sum(s.n_dead for s in segs) + delta.n_dead
            n_total = sum(s.n_points for s in segs) + delta.size
            self._g_version.set(state.version)
            self._g_n_live.set(n_live)
            self._g_n_segments.set(len(state.segments))
            self._g_delta_fill.set(delta.size)
            self._g_delta_occupancy.set(delta.size / delta.capacity)
            self._g_garbage.set(n_dead / n_total if n_total else 0.0)

    def _install(self, segments: Dict[int, Segment], seg: Segment) -> None:
        uid = self._next_uid
        self._next_uid += 1
        segments[uid] = seg
        self.log.place_segment(uid, seg.gids, np.arange(seg.n_points))

    def _seal_delta(self, delta, segments):
        pts, gids = delta.live()
        delta = self._empty_delta()
        if len(pts):
            self._install(segments, self._new_segment(pts, gids))
            self._c_seals.inc()
            self._c_sealed_points.inc(len(pts))
        return self._maybe_compact(delta, segments)

    def _maybe_compact(self, delta, segments, force: bool = False):
        cfg = self.config
        if cfg.defer_merges and not force:
            return delta, segments
        while True:
            # drop fully-dead segments outright
            for uid in [u for u, s in segments.items() if s.n_live == 0]:
                del segments[uid]
            uids = list(segments.keys())
            segs = [segments[u] for u in uids]
            groups = plan_merges(segs, cfg.delta_capacity, cfg.merge_factor)
            kind = "tiered"
            # a mostly-dead segment is rebuilt alone to purge its garbage
            if not groups:
                solo = [
                    [i]
                    for i, s in enumerate(segs)
                    if s.n_dead > cfg.purge_fraction * s.n_points
                ]
                groups = solo[:1]
                kind = "purge"
            if not groups:
                return delta, segments
            for group in groups:
                merged = merge_segments(
                    [segs[i] for i in group],
                    cfg.spec,
                    storage_dtype=cfg.storage_dtype,
                    device=cfg.device,
                )
                for i in group:
                    del segments[uids[i]]
                if merged is not None:
                    self._install(segments, merged)
                self._c_merges[kind].inc()
                self._c_segments_merged.inc(len(group))
            # gids just moved holders: a new remap epoch fences caches
            self.log.bump_epoch()
