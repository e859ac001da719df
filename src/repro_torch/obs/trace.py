"""Spans and per-query traces.

`span(name)` is the one timing primitive: a context manager that (1)
measures host wall time into the registry histogram ``span.<name>`` and
(2) wraps the body in `torch.profiler.record_function`, so the *same*
span names show up on the host timeline of a `torch.profiler.profile`
trace — one vocabulary for host timing and device profiling. When the registry is disabled and no query trace is active,
`span` is a near-free passthrough (one attribute read, no clock call).
`observe_since(name, starts)` writes the same histogram for intervals
that began on another thread (a request's wait in a queue): each ends
now, on the calling thread.

`QueryTrace` records one engine call end to end: the host seconds of
each stage (plan → stack → dispatch → delta → merge) plus the
device-derived paper metrics (nodes visited, leaves scanned, distance
candidates evaluated) that the paper's Tables 2/Fig 6 accounting is
built on. It is thread-local: the engine discovers the active trace via
`current_query_trace()`, so instrumentation needs no plumbing through
call signatures:

    with QueryTrace() as qt:
        res = engine.execute(snapshot, queries, spec)
    qt.summary()   # stages, per-query metrics, pruned fraction

Attaching a device profile around the same region is one more context
manager: ``with torch.profiler.profile(...) as prof: ...`` — the span
annotations appear inside it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, Optional

import numpy as np

from . import metrics

_TLS = threading.local()


def current_query_trace() -> Optional["QueryTrace"]:
    return getattr(_TLS, "query_trace", None)


def _annotation(name: str):
    """torch.profiler.record_function: host-side, a cheap no-op unless a
    profiler is recording."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, registry: Optional[metrics.Registry] = None, **labels):
    """Time a block into histogram ``span.<name>`` (seconds) and expose
    it to torch profiles under the same name. Stage durations also land on
    the active `QueryTrace`, if any."""
    reg = registry or metrics.REGISTRY
    qt = current_query_trace()
    if not reg.enabled and qt is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        with _annotation(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        if reg.enabled:
            reg.histogram(f"span.{name}", unit="s", **labels).observe(dt)
        if qt is not None:
            qt.record_stage(name, dt)


def observe_since(name: str, starts: Iterable[float],
                  registry: Optional[metrics.Registry] = None, **labels) -> None:
    """Observe ``now - t`` for each `time.perf_counter()` time in
    `starts` into histogram ``span.<name>``, the one `span` writes: an
    interval whose start was stamped elsewhere and whose end is this
    call. With the registry disabled: one attribute read, no clock call."""
    reg = registry or metrics.REGISTRY
    if not reg.enabled:
        return
    now = time.perf_counter()
    h = reg.histogram(f"span.{name}", unit="s", **labels)
    for t in starts:
        h.observe(now - t)


class QueryTrace:
    """Per-call trace of one engine query: stage timings + paper metrics.

    stages   {span name: cumulative host seconds within this trace}
    metrics  {metric name: per-query np.ndarray or scalar} — populated
             by the engine (`nodes_visited`, `leaves_scanned`,
             `candidates_evaluated` per query; `n_live`, `n_segments`,
             `n_classes`, `delta_candidates` scalars)
    """

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}
        self.metrics: Dict[str, object] = {}
        self._prev = None

    # -- context ------------------------------------------------------------
    def __enter__(self) -> "QueryTrace":
        self._prev = current_query_trace()
        _TLS.query_trace = self
        return self

    def __exit__(self, *exc) -> None:
        _TLS.query_trace = self._prev
        return None

    # -- recording (engine-facing) ------------------------------------------
    def record_stage(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def set_metric(self, name: str, value) -> None:
        self.metrics[name] = value

    # -- reading ------------------------------------------------------------
    def summary(self) -> dict:
        """JSON-friendly digest: stage seconds, total/mean per-query
        paper metrics, and the pruned fraction (share of live points
        whose distance was never evaluated — the paper's pruning
        effectiveness in one number)."""
        out: dict = {"stages_s": dict(self.stages), "metrics": {}}
        for name, v in self.metrics.items():
            a = np.asarray(v)
            if a.ndim == 0:
                out["metrics"][name] = float(a)
            else:
                out["metrics"][name] = {
                    "total": int(a.sum()),
                    "mean": float(a.mean()),
                    "p50": float(np.percentile(a, 50)),
                    "p95": float(np.percentile(a, 95)),
                    "max": int(a.max()),
                }
        n_live = float(np.asarray(self.metrics.get("n_live", 0)))
        cand = self.metrics.get("candidates_evaluated")
        if n_live > 0 and cand is not None:
            mean_cand = float(np.asarray(cand).mean())
            out["pruned_fraction"] = 1.0 - mean_cand / n_live
        return out


__all__ = ["QueryTrace", "current_query_trace", "observe_since", "span"]
