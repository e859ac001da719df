"""Write-ahead log for the streaming index: host-side durability (a copy
of the reference package's `index/wal.py`; the two packages read each
other's logs).

The device-side LSM is volatile — delta arenas and segments die with
the process. The WAL makes the *logical* mutation stream durable
instead of the physical state: every public mutator appends one record
(op name + payloads) BEFORE applying, and recovery replays the records
through the same mutators, rebuilding the index deterministically.
Replaying the log therefore reproduces the exact live point set, the
exact gid assignment (gids are handed out in record order), and — with
inline merges (the default) — even the exact segment layout, so
post-recovery search results are bit-identical to pre-crash results.

Format: a 6-byte magic header, then length-prefixed records::

    [u32 length][u32 crc32][pickle((op, fields))]

Torn tails are expected (the process can die mid-append): replay stops
cleanly at the first short or checksum-failing record and reports how
many bytes it trusted, so the writer can truncate the garbage before
appending again. Records are pickled host data (numpy arrays, scalars,
small metadata blobs) — never device tensors.

Each record also carries the tombstone-log epoch observed at append
time (stamped by the index, see `streaming.py`), so a recovered index
can fence its epoch to at least the last durably-recorded value and
`Snapshot.epoch` never moves backward across a restart.

Checkpointing (`index/checkpoint.py`) bounds the log: every record is
additionally stamped with a monotone sequence number (``_seq``, 1-based
over the log's whole logical history — it survives truncation), a
checkpoint manifests the sequence it covers, and `truncate_through`
atomically rewrites the file keeping only the records AFTER that
sequence (tmp + fsync + rename + parent-dir fsync). Recovery then skips
any surviving record whose seq the checkpoint already covers, so the
"checkpoint written but log not yet truncated" crash window can never
double-apply an operation. Durability of the *names*: the parent
directory is fsynced when a log file is created or replaced, so the
file itself survives a crash, not just its contents.
"""
from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import IO, Iterator, List, Tuple

from . import faults

_MAGIC = b"RWAL1\n"
_HDR = struct.Struct("<II")  # (payload length, crc32 of payload)


def fsync_dir(path: str) -> None:
    """fsync the directory containing `path`, making a just-created or
    just-renamed entry durable (POSIX: creating/renaming a file only
    becomes crash-safe once its *directory* reaches disk)."""
    d = os.path.dirname(os.path.abspath(path))
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_frame(f: IO[bytes], op: str, fields: dict) -> None:
    blob = pickle.dumps((op, fields), protocol=pickle.HIGHEST_PROTOCOL)
    f.write(_HDR.pack(len(blob), zlib.crc32(blob)) + blob)


def record_seq(fields: dict, position: int) -> int:
    """A record's sequence number: the stamped ``_seq`` when present,
    else its 1-based position (logs written before seq stamping were
    never truncated, so position IS history order)."""
    return int(fields.get("_seq", position))


class WriteAheadLog:
    """Append-only record writer (one per index instance).

    Opening an existing log seeks past its valid prefix and truncates
    any torn tail, so a crash mid-append never corrupts later records.
    """

    def __init__(self, path: str, sync: bool = False) -> None:
        self.path = path
        self._sync = sync
        # a crash mid-truncation may leave a stale tmp sibling; it was
        # never the live log (rename is the commit point), drop it
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            os.unlink(tmp)
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self.last_seq = 0
        if not fresh:
            # drop a torn tail before appending after it, and resume
            # the sequence from the last intact record
            records, valid = scan(path)
            with open(path, "r+b") as f:
                f.truncate(valid)
            if records:
                self.last_seq = record_seq(records[-1][1], len(records))
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
            fsync_dir(path)  # the file NAME must survive a crash too

    def append(self, op: str, **fields) -> None:
        faults.fire("wal.append", op=op)
        fields["_seq"] = self.last_seq + 1
        _write_frame(self._f, op, fields)
        self._f.flush()
        if self._sync:
            os.fsync(self._f.fileno())
        self.last_seq += 1

    def truncate_through(self, seq: int) -> int:
        """Atomically drop every record with sequence <= `seq` (the
        prefix a checkpoint made redundant). tmp + fsync + rename +
        dir fsync, so a crash at any step leaves either the old log or
        the new one — never a torn hybrid. Returns how many records
        were dropped."""
        records, _ = scan(self.path)
        kept = [
            (op, fields)
            for i, (op, fields) in enumerate(records)
            if record_seq(fields, i + 1) > seq
        ]
        dropped = len(records) - len(kept)
        tmp = self.path + ".tmp"
        self._f.close()
        try:
            faults.fire("checkpoint.step", step="wal_tmp_open")
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                for i, (op, fields) in enumerate(kept):
                    # re-stamp nothing: the surviving records keep their
                    # original _seq, so the sequence stays history-global
                    _write_frame(f, op, fields)
                    if i == 0:
                        faults.fire("checkpoint.step", step="wal_tmp_write")
                f.flush()
                faults.fire("checkpoint.step", step="wal_tmp_sync")
                os.fsync(f.fileno())
            faults.fire("checkpoint.step", step="wal_rename")
            os.replace(tmp, self.path)
            faults.fire("checkpoint.step", step="wal_dir_sync")
            fsync_dir(self.path)
        finally:
            # reopen whatever file now lives at the path — on an
            # injected crash mid-way that is still the OLD intact log
            # (rename is atomic), and recovery's seq skip covers the
            # not-yet-truncated prefix
            self._f = open(self.path, "ab")
        return dropped

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def scan(path: str) -> Tuple[List[Tuple[str, dict]], int]:
    """All intact records plus the byte offset of the valid prefix.

    Stops (silently) at the first torn or checksum-failing record — the
    WAL contract is that everything BEFORE the tear is trustworthy and
    everything after it never finished committing.
    """
    records: List[Tuple[str, dict]] = []
    if not os.path.exists(path):
        return records, 0
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            return records, 0
        valid = f.tell()
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break
            length, crc = _HDR.unpack(hdr)
            blob = f.read(length)
            if len(blob) < length or zlib.crc32(blob) != crc:
                break
            try:
                op, fields = pickle.loads(blob)
            except Exception:
                break
            records.append((op, fields))
            valid = f.tell()
    return records, valid


def replay(path: str) -> Iterator[Tuple[str, dict]]:
    """Iterate the intact records of a log (see `scan`)."""
    records, _ = scan(path)
    return iter(records)


__all__ = [
    "WriteAheadLog",
    "fsync_dir",
    "record_seq",
    "replay",
    "scan",
]
