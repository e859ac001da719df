"""Deterministic fault injection: the chaos layer of the serving stack
(a copy of the reference package's `index/faults.py`, counting on the
port's `obs` registry).

Production code exposes *sites* — named points on the failure surface —
by calling ``fire(site, **labels)``:

    ``shard.search``      one shard's per-query engine dispatch
                          (labels: shard; the sharded index is not
                          ported yet, so nothing fires it here)
    ``frontend.dispatch`` one frontend batch dispatch
    ``wal.append``        one WAL record append
    ``checkpoint.step``   every durability step of a checkpoint write
                          (labels: step — tmp_write, tmp_sync, rename,
                          dir_sync, wal truncation steps, …)

When nothing is armed, ``fire`` is one module-attribute read and a
branch — cheap enough to leave in every hot path. Tests and the chaos
bench arm *rules* against those sites:

    with faults.active():
        faults.arm("shard.search", shard=1, exc=faults.InjectedFault)
        ...                       # every shard-1 search now raises
        faults.arm("frontend.dispatch", sleep=0.05)       # slow, not dead
        faults.arm("checkpoint.step", after=3, times=1,
                   exc=faults.InjectedCrash)  # die at the 4th write step

Rules are deterministic: `after` skips the first N matching hits,
`times` bounds how often the rule fires, and probabilistic rules draw
from their own seeded `numpy` Generator, so a failing chaos run replays
exactly. `hits(site)` counts encounters whether or not anything fired —
the crash-at-every-step harness first counts a clean run's steps, then
arms one crash per ordinal:

    n = faults.count_steps(lambda: idx.checkpoint(), "checkpoint.step")
    for k in range(n):
        with faults.active():
            faults.arm("checkpoint.step", after=k, times=1,
                       exc=faults.InjectedCrash)
            with pytest.raises(faults.InjectedCrash):
                idx.checkpoint()
        recover_and_verify()

The module also carries the WAL corruption helpers (`tear_last_frame`,
`corrupt_frame`) used to fabricate torn/bit-flipped frames on disk —
the failure mode `wal.scan` must absorb.

Every injected fault is counted on the obs registry
(``faults.injected{site=...}``) so chaos runs are observable in
``obs.snapshot()`` like any other traffic.
"""
from __future__ import annotations

import contextlib
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import obs


class InjectedFault(RuntimeError):
    """A transient injected failure (retryable: backoff + retry may
    clear it, e.g. a shard search that fails `times=1`)."""

    retryable = True


class InjectedCrash(RuntimeError):
    """An injected process death. Raised out of a durability step to
    model the process dying with the filesystem in whatever state the
    preceding steps left it; the test then *recovers from the files
    alone*, exactly like a restart would."""

    retryable = False


class _Rule:
    __slots__ = (
        "site", "match", "after", "times", "exc", "sleep", "p", "_rng",
        "hits", "fired",
    )

    def __init__(
        self,
        site: str,
        match: Dict[str, str],
        after: int,
        times: Optional[int],
        exc: Optional[Callable[[], BaseException]],
        sleep: float,
        p: float,
        seed: int,
    ) -> None:
        self.site = site
        self.match = match
        self.after = after
        self.times = times
        self.exc = exc
        self.sleep = sleep
        self.p = p
        self._rng = np.random.default_rng(seed) if p < 1.0 else None
        self.hits = 0
        self.fired = 0

    def matches(self, site: str, labels: Dict[str, str]) -> bool:
        if site != self.site:
            return False
        return all(labels.get(k) == v for k, v in self.match.items())


class FaultInjector:
    """Thread-safe rule registry. One process-wide instance (`INJECTOR`)
    is consulted by every instrumented site; independent instances exist
    only for tests of the injector itself."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []
        self._site_hits: Dict[str, int] = {}
        # fast path: fire() reads this once and returns; only
        # arm()/reset() toggle it (under the lock)
        self.enabled = False

    # -- arming --------------------------------------------------------------
    def arm(
        self,
        site: str,
        *,
        exc: Optional[Callable[[], BaseException]] = None,
        sleep: float = 0.0,
        after: int = 0,
        times: Optional[int] = None,
        p: float = 1.0,
        seed: int = 0,
        **match,
    ) -> _Rule:
        """Install a rule at `site`. `exc` (an exception factory/class)
        raises, `sleep` delays, both count; `after` skips the first N
        matching hits, `times` caps firings, `p`+`seed` make the rule
        probabilistic but replayable. Extra kwargs must equal the
        labels the site fires with (stringified)."""
        rule = _Rule(
            site,
            {k: str(v) for k, v in match.items()},
            after,
            times,
            exc,
            float(sleep),
            float(p),
            seed,
        )
        with self._lock:
            self._rules.append(rule)
            self.enabled = True
        return rule

    def disarm(self, rule: _Rule) -> None:
        with self._lock:
            if rule in self._rules:
                self._rules.remove(rule)
            self.enabled = bool(self._rules)

    def reset(self) -> None:
        with self._lock:
            self._rules.clear()
            self._site_hits.clear()
            self.enabled = False

    # -- the production-code surface -----------------------------------------
    def fire(self, site: str, **labels) -> None:
        """Called by instrumented code at a failure site. No-op unless a
        rule is armed; otherwise may sleep and/or raise per the rules."""
        if not self.enabled:
            return
        lab = {k: str(v) for k, v in labels.items()}
        to_sleep = 0.0
        to_raise: Optional[BaseException] = None
        with self._lock:
            self._site_hits[site] = self._site_hits.get(site, 0) + 1
            for rule in self._rules:
                if not rule.matches(site, lab):
                    continue
                rule.hits += 1
                if rule.hits <= rule.after:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule._rng is not None and rule._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                to_sleep = max(to_sleep, rule.sleep)
                if rule.exc is not None and to_raise is None:
                    to_raise = rule.exc()
        if to_sleep > 0.0 or to_raise is not None:
            obs.REGISTRY.counter("faults.injected", site=site).inc()
        if to_sleep > 0.0:
            time.sleep(to_sleep)
        if to_raise is not None:
            raise to_raise

    def hits(self, site: str) -> int:
        """Encounters of `site` since the last reset() — counted while
        armed, fired or not (the step-counting substrate)."""
        with self._lock:
            return self._site_hits.get(site, 0)


INJECTOR = FaultInjector()

# module-level conveniences bound to the process-wide injector
arm = INJECTOR.arm
disarm = INJECTOR.disarm
reset = INJECTOR.reset
fire = INJECTOR.fire
hits = INJECTOR.hits


@contextlib.contextmanager
def active():
    """Scope for a chaos experiment: rules armed inside are guaranteed
    gone on exit, so a failing test never leaks faults into the next."""
    try:
        yield INJECTOR
    finally:
        INJECTOR.reset()


def count_steps(fn: Callable[[], object], site: str) -> int:
    """Run `fn` once with counting armed and report how many times it
    crossed `site` — the domain of the crash-at-every-step sweep."""
    with active():
        # a pure-counting rule: never fires, but keeps `enabled` true
        arm(site, times=0)
        fn()
        return hits(site)


# -- on-disk WAL corruption helpers ------------------------------------------
# These fabricate the torn/corrupt frames `wal.scan` must absorb. They
# duplicate the frame geometry (magic + [u32 len][u32 crc][blob]) on
# purpose: the point is to damage files *without* going through the
# writer under test.
_WAL_MAGIC = b"RWAL1\n"
_HDR = struct.Struct("<II")


def _frame_offsets(path: str) -> List[int]:
    """Byte offset of every intact frame in a WAL file."""
    offsets: List[int] = []
    with open(path, "rb") as f:
        if f.read(len(_WAL_MAGIC)) != _WAL_MAGIC:
            return offsets
        while True:
            off = f.tell()
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return offsets
            length, crc = _HDR.unpack(hdr)
            blob = f.read(length)
            if len(blob) < length or zlib.crc32(blob) != crc:
                return offsets
            offsets.append(off)


def tear_last_frame(path: str) -> int:
    """Truncate the file mid-way through its final frame (a crash during
    append). Returns the number of intact frames left."""
    offsets = _frame_offsets(path)
    if not offsets:
        return 0
    last = offsets[-1]
    with open(path, "r+b") as f:
        f.seek(0, 2)
        end = f.tell()
        f.truncate(last + max(1, (end - last) // 2))
    return len(offsets) - 1


def corrupt_frame(path: str, index: int = -1) -> None:
    """Flip one payload byte of frame `index` (checksum now fails, so
    scan treats the frame — and everything after it — as garbage)."""
    offsets = _frame_offsets(path)
    off = offsets[index]
    with open(path, "r+b") as f:
        f.seek(off + _HDR.size)
        b = f.read(1)
        f.seek(off + _HDR.size)
        f.write(bytes([b[0] ^ 0xFF]))


__all__ = [
    "FaultInjector",
    "INJECTOR",
    "InjectedCrash",
    "InjectedFault",
    "active",
    "arm",
    "corrupt_frame",
    "count_steps",
    "disarm",
    "fire",
    "hits",
    "reset",
    "tear_last_frame",
]
