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

Durability: with `wal_path` set, every mutator appends its logical
operation to a write-ahead log (`index/wal.py`) BEFORE applying it, and
constructing an index over an existing log recovers it: the newest
intact checkpoint (`index/checkpoint.py`), then the log records after
the sequence it covers, replayed through the same mutators — same gids,
same live set, same results (the device builder is deterministic, so a
rebuilt segment is bitwise the one it replaces). Each record carries the
epoch observed at append time and recovery fences the rebuilt log's
epoch to at least the last durable value. The files hold numpy arrays
and Python values only, in the reference's format: either package
recovers the other's files.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.types import TreeSpec
from ..kernels import quantize
from . import checkpoint as checkpoint_mod
from . import faults
from . import search as search_mod
from . import wal as wal_mod
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
    # tree builder for seals and merges: "torch" (the level-synchronous
    # builder on `device`) or "host" (the recursive numpy builder)
    backend: str = "torch"
    purge_fraction: float = 0.5       # rebuild a segment once this dead
    # sealed-segment coordinate storage width (the default read path is
    # quantized): "bfloat16" halves phase-2 stream bytes with results
    # still bitwise those of f32 storage; "int8" quarters them;
    # "float32" opts out. REPRO_STORAGE_DTYPE overrides.
    storage_dtype: Optional[str] = None
    # write-ahead log file: mutations are appended before being applied
    # and replayed on construction over an existing file (crash
    # recovery). None = volatile index (the default). wal_sync adds an
    # fsync per record for true crash-consistency (slower).
    wal_path: Optional[str] = None
    wal_sync: bool = False
    # skip inline merging in add/delete/flush; merges then run only via
    # maintain() — typically from the background compaction thread
    defer_merges: bool = False
    # checkpoint shadowing the WAL (None = "<wal_path>.ckpt"). With
    # auto_checkpoint, every merge/compaction point (maintain() that
    # merged, compact()) snapshots the state and truncates the log to the
    # ops after it; checkpoint() does it on demand.
    checkpoint_path: Optional[str] = None
    auto_checkpoint: bool = True
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
        if self.backend not in ("torch", "host"):
            raise ValueError(
                f"unknown backend {self.backend!r}: 'torch' or 'host'"
            )


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
        self._c_wal_records = reg.counter("index.wal_records", **lbl)
        self._c_wal_replayed = reg.counter("index.wal_replayed", **lbl)
        self._c_checkpoints = reg.counter("wal.checkpoints", **lbl)
        self._c_ckpt_loads = reg.counter("wal.checkpoint_loads", **lbl)
        self._c_wal_truncated = reg.counter("wal.records_truncated", **lbl)
        self._wal: Optional[wal_mod.WriteAheadLog] = None
        # host metas of every add/bulk_load ever applied, in gid
        # assignment order (the WAL's meta stream, kept across WAL
        # truncation by the checkpoint)
        self.wal_metas: List[object] = []
        self._ckpt_path: Optional[str] = None
        if config.wal_path:
            self._recover(config)

    def _recover(self, config: StreamingConfig) -> None:
        """Recovery IS construction: load the newest intact checkpoint
        (if any), replay the intact log records AFTER the sequence it
        covers through the mutators that wrote them (`_wal` is still
        None, so nothing is logged again), fence the epoch, then resume
        appending."""
        self._ckpt_path = (
            config.checkpoint_path
            or checkpoint_mod.default_path(config.wal_path)
        )
        ckpt_seq = 0
        loaded = checkpoint_mod.load(self._ckpt_path)
        if loaded is not None:
            payload, ckpt_seq = loaded
            self._restore_checkpoint(payload)
            self._c_ckpt_loads.inc()
        max_epoch = 0
        n_applied = 0
        for i, (op, fields) in enumerate(wal_mod.replay(config.wal_path)):
            seq = wal_mod.record_seq(fields, i + 1)
            fields.pop("_seq", None)
            if seq <= ckpt_seq:
                # covered by the checkpoint: the crash window between its
                # publish and the log's truncation must never apply twice
                continue
            max_epoch = max(max_epoch, int(fields.pop("_epoch", 0)))
            self._apply_wal_record(op, fields)
            n_applied += 1
        if n_applied:
            self._c_wal_replayed.inc(n_applied)
        # the fence also covers epoch bumps of aborted mutations, which
        # were recorded but cannot be replayed
        if self.log.epoch < max_epoch:
            self.log._epoch = max_epoch
        self._wal = wal_mod.WriteAheadLog(config.wal_path, sync=config.wal_sync)
        # a freshly truncated log holds no records: resume the sequence
        # from the checkpoint, never below already-covered numbers
        self._wal.last_seq = max(self._wal.last_seq, ckpt_seq)

    def _empty_delta(self) -> DeltaBuffer:
        cfg = self.config
        return DeltaBuffer.empty(cfg.delta_capacity, cfg.dim, cfg.device)

    def _new_segment(self, pts, gids) -> Segment:
        cfg = self.config
        return Segment.from_points(
            pts, gids, cfg.spec, backend=cfg.backend,
            storage_dtype=cfg.storage_dtype, device=cfg.device,
        )

    # -- introspection -------------------------------------------------------
    @property
    def version(self) -> int:
        return self._state.version

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def device(self) -> torch.device:
        """The device the index's tensors live on (with its index)."""
        return self._state.delta.points.device

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
            "wal_records": self._c_wal_records.value,
            "wal_replayed": self._c_wal_replayed.value,
            "wal_records_truncated": self._c_wal_truncated.value,
            "checkpoints": self._c_checkpoints.value,
            "checkpoint_loads": self._c_ckpt_loads.value,
            "maintenance_runs": self._c_maintenance.value,
            "tombstone_garbage_ratio": (
                n_dead / n_total if n_total else 0.0
            ),
        }

    # -- write path ----------------------------------------------------------
    # Every mutator updates self.log eagerly while building its new state
    # on locals; if anything raises before _commit, _recover_log rederives
    # the log from the still-published state. Mutators hold the writer
    # lock end to end and append their op to the WAL (if configured)
    # before touching anything.

    def _wal_append(self, op: str, **fields) -> None:
        if self._wal is not None:
            # the epoch observed at append time: the recovery fence keeps
            # Snapshot.epoch monotone across restarts
            self._wal.append(op, _epoch=self.log.epoch, **fields)
            self._c_wal_records.inc()

    def _apply_wal_record(self, op: str, fields: dict) -> None:
        if op == "add":
            self.add(fields["points"], meta=fields.get("meta"))
        elif op == "bulk_load":
            self.bulk_load(fields["points"], meta=fields.get("meta"))
        elif op == "delete":
            self.delete(fields["gids"])
        elif op == "flush":
            self.flush()
        elif op == "compact":
            self.compact()
        else:
            raise ValueError(f"unknown WAL record op {op!r}")

    def add(self, points: np.ndarray, meta=None) -> np.ndarray:
        """Insert points; returns their assigned global ids. `meta` is an
        opaque host blob persisted with the WAL record only (it does not
        affect the index)."""
        pts = np.asarray(points, np.float32).reshape(-1, self.config.dim)
        with self._write_lock:
            self._wal_append("add", points=pts, meta=meta)
            # mirror the meta stream on the host (during replay too) so it
            # outlives WAL truncation through the checkpoint
            if self.config.wal_path:
                self.wal_metas.append(meta)
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

    def bulk_load(self, points: np.ndarray, meta=None) -> np.ndarray:
        """Build one segment directly from a batch (the LSM bulk path —
        skips the delta arena and any intermediate merges)."""
        pts = np.asarray(points, np.float32).reshape(-1, self.config.dim)
        with self._write_lock:
            self._wal_append("bulk_load", points=pts, meta=meta)
            if self.config.wal_path:
                self.wal_metas.append(meta)
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
            self._wal_append("delete", gids=g)
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
            self._wal_append("flush")
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
            self._wal_append("compact")
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
            # the WAL's whole history is now one sealed state
            self._auto_checkpoint()

    # -- background maintenance ----------------------------------------------
    def maintain(self) -> bool:
        """Run pending size-tiered / purge merges NOW, regardless of
        `defer_merges`. Returns whether anything was merged.

        Not WAL-logged: merges are derived state. With deferred merges
        the segment layout after a replay may differ from the pre-crash
        one; search results are exact either way."""
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
            self._auto_checkpoint()
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
        """Stop the background thread and close the WAL file. The index
        stays usable for reads."""
        self.stop_background_compaction()
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    # -- checkpointing -------------------------------------------------------
    def checkpoint(self) -> bool:
        """Atomically publish a checkpoint of the current logical state
        and truncate the WAL to the records after it. Returns False on a
        volatile index (no WAL — including mid-replay, so a replayed
        `compact` record never recurses into checkpointing)."""
        if self._wal is None:
            return False
        with self._write_lock:
            seq = self._wal.last_seq
            checkpoint_mod.write(
                self._ckpt_path, self._checkpoint_payload(), seq
            )
            # past the rename the checkpoint is durable; a crash below
            # leaves a longer log whose covered prefix recovery skips
            dropped = self._wal.truncate_through(seq)
            self._c_checkpoints.inc()
            if dropped:
                self._c_wal_truncated.inc(dropped)
            faults.fire("checkpoint.step", step="done")
            return True

    def _auto_checkpoint(self) -> None:
        if self._wal is not None and self.config.auto_checkpoint:
            self.checkpoint()

    def _checkpoint_payload(self) -> dict:
        """The logical state as host data (numpy arrays and Python
        values, never tensors: the reference reads it too). Segments are
        stored as their FULL row sets (original insertion order + live
        mask): the builder is deterministic, so rebuild + re-tombstone
        reproduces the exact device tensors and recovery stays bitwise
        equal to a full-log replay."""
        state = self._state
        segs = []
        for uid in sorted(state.segments):
            pts, gids, live = state.segments[uid].host_rows()
            segs.append(
                (uid, np.asarray(pts, np.float32),
                 np.asarray(gids, np.int64), np.asarray(live, bool))
            )
        d = state.delta
        return {
            "dim": self.config.dim,
            "version": state.version,
            "next_gid": self.log.next_gid,
            "n_deleted": self.log.n_deleted,
            "epoch": self.log.epoch,
            "next_uid": self._next_uid,
            "segments": segs,
            # raw arena rows incl. dead slots (gid -1), so the rebuilt
            # arena is slot-for-slot the live one
            "delta_pts": d.points[: d.size].cpu().numpy().astype(np.float32),
            "delta_gids": d.gids[: d.size].cpu().numpy().astype(np.int64),
            "delta_n_dead": int(d.n_dead),
            "wal_metas": list(self.wal_metas),
        }

    def _restore_checkpoint(self, payload: dict) -> None:
        """Rebuild state from a checkpoint payload (construction time
        only: runs before the WAL tail is replayed)."""
        cfg = self.config
        if int(payload["dim"]) != cfg.dim:
            raise ValueError(
                f"checkpoint dim {payload['dim']} != config dim {cfg.dim}"
            )
        segments: Dict[int, Segment] = {}
        for uid, pts, gids, live in payload["segments"]:
            gids = np.asarray(gids, np.int64)
            live = np.asarray(live, bool)
            seg = self._new_segment(np.asarray(pts, np.float32), gids)
            dead = np.nonzero(~live)[0]
            if len(dead):
                seg = seg.tombstone(dead)
            segments[int(uid)] = seg
            locals_ = np.nonzero(live)[0]
            self.log.place_segment(int(uid), gids[locals_], locals_)
        delta = self._empty_delta()
        dp = np.asarray(payload["delta_pts"], np.float32)
        dg = np.asarray(payload["delta_gids"], np.int64)
        if len(dp):
            # dead slots ride along with gid -1, keeping slot numbering
            # (and so the locator and search masks) exact
            delta = delta.append(dp, dg)
        nd = int(payload["delta_n_dead"])
        if nd:
            delta = dataclasses.replace(delta, n_dead=nd)
        slots = np.nonzero(dg >= 0)[0]
        if len(slots):
            self.log.place_delta(dg[slots], slots)
        self.log.next_gid = int(payload["next_gid"])
        self.log.n_deleted = int(payload["n_deleted"])
        self.log._epoch = int(payload["epoch"])
        self._next_uid = int(payload["next_uid"])
        self.wal_metas = list(payload["wal_metas"])
        self._state = _State(
            version=int(payload["version"]), delta=delta, segments=segments
        )

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

    def knn(self, queries, k: int) -> search_mod.StreamResult:
        return search_mod.knn(self.snapshot(), queries, k)

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
                    backend=cfg.backend,
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
