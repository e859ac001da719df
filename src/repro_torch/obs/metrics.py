"""Process-wide metrics registry: labeled counters, gauges, histograms.

This is the accounting substrate of the repo. The paper's central
evidence is itself an accounting claim (ball*-tree visits fewer nodes
and computes fewer distances than ball-tree), so the registry treats
those quantities as first-class: every layer — the query engine, the
streaming index, the CUDA kernels, the serving datastore, the train
loop — publishes into one process-wide `Registry`, and `snapshot()`
round-trips the whole thing through `BENCH_obs.json` (see `obs/export`).

Design constraints, in order:

  * **thread-safe and exact** — counters are incremented under a
    per-metric lock; concurrent writers can never lose increments (a
    plain `x += 1` is LOAD/ADD/STORE under the GIL and races). The
    query engine's dispatch accounting feeds exact-count test
    assertions, so "approximately right under threads" is not enough.
  * **near-zero overhead when disabled** — every mutation first reads
    one attribute (`Registry.enabled`); a disabled registry costs one
    attribute load + branch per call site, no lock, no allocation.
  * **mergeable histograms** — fixed log2 bucket edges (2^-27 … 2^30,
    the same for every histogram ever created), so histograms from
    different processes / runs / shards merge by adding bucket counts
    and percentile estimates stay valid after the merge. The buckets
    cover ~7 ns latencies up to 1e9-count paper metrics.

Metric identity is `(name, sorted labels)`. Handles are stable: a
metric object returned by `counter()` remains registered after
`reset()` (reset zeroes in place rather than discarding), so hot paths
may cache handles at import time without ever going stale.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Optional, Tuple

# fixed log2 bucket ladder shared by EVERY histogram (mergeability):
# bucket i counts values v with 2^(i-1+LOG2_LO) < v <= 2^(i+LOG2_LO);
# bucket 0 also absorbs v <= 2^LOG2_LO, the last bucket absorbs +inf
LOG2_LO = -27
LOG2_HI = 30
N_BUCKETS = LOG2_HI - LOG2_LO + 1


def bucket_of(v: float) -> int:
    """Fixed log2 bucket index of a value (same ladder for all
    histograms, so bucket counts are directly addable)."""
    if not v > 0.0:
        return 0
    if math.isinf(v):
        return N_BUCKETS - 1
    # ceil(log2(v)) without float-log rounding trouble: frexp gives
    # v = frac * 2^exp with frac in [0.5, 1); v <= 2^(exp-1) iff frac==0.5
    frac, exp = math.frexp(v)
    edge = exp if frac > 0.5 else exp - 1
    return max(0, min(N_BUCKETS - 1, edge - LOG2_LO))


def bucket_upper(i: int) -> float:
    """Inclusive upper edge of bucket i (the percentile estimate)."""
    return float(2.0 ** (i + LOG2_LO))


class Counter:
    """Monotonic counter. `inc` is atomic (per-metric lock)."""

    __slots__ = ("_registry", "_lock", "_value")

    def __init__(self, registry: "Registry") -> None:
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_registry", "_value")

    def __init__(self, registry: "Registry") -> None:
        self._registry = registry
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._registry.enabled:
            return
        self._value = float(v)  # single STORE: atomic under the GIL

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _snapshot(self):
        return self._value


class Histogram:
    """Fixed-log2-bucket histogram: O(1) observe, mergeable percentiles.

    `unit` is annotation only (seconds, nodes, bytes, …) but required by
    the bench schema checker, so every exported histogram says what it
    measures.
    """

    __slots__ = ("_registry", "_lock", "_counts", "_count", "_sum", "unit")

    def __init__(self, registry: "Registry", unit: str = "1") -> None:
        self._registry = registry
        self._lock = threading.Lock()
        self._counts = [0] * N_BUCKETS
        self._count = 0
        self._sum = 0.0
        self.unit = unit

    def observe(self, v: float) -> None:
        if not self._registry.enabled:
            return
        i = bucket_of(float(v))
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += float(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """Upper bucket edge at percentile p in [0, 100] (<= one log2
        bucket of overestimate; 0.0 for an empty histogram)."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        target = max(1, math.ceil(total * p / 100.0))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return bucket_upper(i)
        return bucket_upper(N_BUCKETS - 1)

    def merge_from(self, other: "Histogram") -> None:
        """Add another histogram's buckets into this one (the log2
        ladder is process-global, so bucket counts are addable)."""
        with other._lock:
            counts = list(other._counts)
            count, s = other._count, other._sum
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum += s

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * N_BUCKETS
            self._count = 0
            self._sum = 0.0

    def _snapshot(self):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        out = {
            "unit": self.unit,
            "count": total,
            "sum": s,
            "buckets": [
                [i + LOG2_LO, c] for i, c in enumerate(counts) if c
            ],  # [log2 upper edge, count] — sparse, mergeable
        }
        if total:
            for p in (50, 95, 99):
                out[f"p{p}"] = self.percentile(p)
        return out


_LabelsKey = Tuple[Tuple[str, str], ...]


def _fmt_key(name: str, labels: _LabelsKey) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Registry:
    """Get-or-create registry of labeled metrics.

    One process-wide instance (`REGISTRY`) serves the whole repo;
    independent registries exist only for tests. Identity is
    `(name, sorted(labels))`; asking for an existing name with a
    different metric kind raises.
    """

    def __init__(self, enabled: bool = True) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, _LabelsKey], object] = {}
        self.enabled = enabled

    # -- switches ------------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        """Stop recording. Existing values are kept (and still visible
        in `snapshot()`); every mutation becomes a cheap no-op."""
        self.enabled = False

    # -- get-or-create -------------------------------------------------------
    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(self, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {_fmt_key(*key)!r} is {type(m).__name__}, "
                    f"requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, unit: str = "1", **labels) -> Histogram:
        h = self._get(Histogram, name, labels, unit=unit)
        if unit != "1" and h.unit == "1":
            h.unit = unit  # late unit annotation wins over the default
        return h

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Zero every metric IN PLACE (for tests). Handles cached by hot
        paths stay registered — they are zeroed, never orphaned."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()

    def snapshot(self) -> dict:
        """One JSON-serializable dict of everything: the round-trip
        payload of `BENCH_obs.json` (see `obs/export`)."""
        with self._lock:
            items = sorted(
                self._metrics.items(), key=lambda kv: _fmt_key(*kv[0])
            )
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), m in items:
            key = _fmt_key(name, labels)
            if isinstance(m, Counter):
                out["counters"][key] = m._snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][key] = m._snapshot()
            else:
                out["histograms"][key] = m._snapshot()
        return out

    def find(self, name: str, **labels):
        """The metric registered under (name, labels), or None."""
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            return self._metrics.get(key)


# the process-wide registry every instrumented layer publishes into
REGISTRY = Registry()


def enabled() -> bool:
    return REGISTRY.enabled


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "bucket_of",
    "bucket_upper",
    "enabled",
    "reset",
    "snapshot",
    "N_BUCKETS",
    "LOG2_LO",
    "LOG2_HI",
]
