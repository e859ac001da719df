"""Atomic index checkpoints: bound the WAL, bound recovery time (a copy of
the reference package's `index/checkpoint.py`; the two packages read each
other's checkpoints).

A checkpoint is a crc-manifested host snapshot of the streaming index's
logical state at one WAL sequence number: every sealed segment's point
rows (original insertion order + live mask, so the deterministic
builder reproduces the exact same device tree, tombstones included),
the delta arena's raw rows, the gid bookkeeping, and the WAL metas the
sharded layer needs for its local→global translation. Recovery becomes
*load checkpoint + replay tail* instead of replay-everything, and the
WAL is truncated to the ops after the checkpoint — so both the log size
and the restart time are bounded by the write traffic since the last
merge/compaction point, not by the index's lifetime.

File format (single file, atomically replaced)::

    [7-byte magic][u64 seq][u32 crc32 of blob][u64 blob length][blob]

where blob = pickle(payload). The write protocol is the standard
atomic-publish dance — write ``<path>.tmp``, flush, fsync, rename over
``<path>``, fsync the parent directory — so a crash at ANY step leaves
either the previous checkpoint or the new one, never a torn hybrid:
the rename is the commit point, and `load` ignores stale tmp files and
rejects short/corrupt manifests (falling back to full-log replay).
Every step is a `faults.fire("checkpoint.step", ...)` site, which is
how the crash-at-every-step recovery sweep drives this code.
"""
from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Optional, Tuple

from . import faults
from .wal import fsync_dir

_MAGIC = b"RCKPT1\n"
_HDR = struct.Struct("<QIQ")  # (covered wal seq, crc32 of blob, blob length)


def default_path(wal_path: str) -> str:
    """The checkpoint that shadows a given WAL file."""
    return wal_path + ".ckpt"


def write(path: str, payload: dict, seq: int) -> None:
    """Atomically publish `payload` as the checkpoint covering WAL
    records 1..`seq`."""
    faults.fire("checkpoint.step", step="serialize")
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    hdr = _MAGIC + _HDR.pack(seq, zlib.crc32(blob), len(blob))
    tmp = path + ".tmp"
    faults.fire("checkpoint.step", step="tmp_open")
    with open(tmp, "wb") as f:
        f.write(hdr)
        # split the body write so the sweep exercises a genuinely torn
        # tmp file (header on disk, payload half-written)
        f.write(blob[: len(blob) // 2])
        faults.fire("checkpoint.step", step="tmp_write")
        f.write(blob[len(blob) // 2 :])
        f.flush()
        faults.fire("checkpoint.step", step="tmp_sync")
        os.fsync(f.fileno())
    faults.fire("checkpoint.step", step="rename")
    os.replace(tmp, path)  # the commit point
    faults.fire("checkpoint.step", step="dir_sync")
    fsync_dir(path)


def load(path: str) -> Optional[Tuple[dict, int]]:
    """The latest durable checkpoint as (payload, covered_seq), or None
    when there is none (missing / torn / checksum-failing — recovery
    then replays the whole log, which is always safe)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        os.unlink(tmp)  # a crash mid-write; rename never committed it
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC) + _HDR.size)
        if len(head) < len(_MAGIC) + _HDR.size:
            return None
        if head[: len(_MAGIC)] != _MAGIC:
            return None
        seq, crc, length = _HDR.unpack(head[len(_MAGIC) :])
        blob = f.read(length)
    if len(blob) < length or zlib.crc32(blob) != crc:
        return None
    try:
        payload = pickle.loads(blob)
    except Exception:
        return None
    return payload, int(seq)


__all__ = ["default_path", "load", "write"]
