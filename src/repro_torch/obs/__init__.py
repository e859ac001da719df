"""Unified observability layer (port of the reference package's `obs`).

One process-wide substrate for the accounting every other subsystem
needs: `metrics` (thread-safe labeled counters / gauges / mergeable
log2-bucket histograms) and `trace` (host spans that double as
`torch.profiler` annotations, plus the per-engine-call `QueryTrace`
carrying the paper's nodes-visited / distance-evaluation metrics).
The reference's `export` module waits for a later slice (it reads the
block autotuner, which is not ported yet).

Instrumented layers: `query/engine.py` (dispatch/stack-cache
accounting, stage spans, per-query paper metrics), `core/search.py`
(phase spans and host-sync counts), `index/streaming.py` and
`index/delta.py` (write-path counters, occupancy/garbage gauges), and
`kernels/ops.py` (per-call block/bytes/FLOP accounting).
"""
from . import metrics, trace
from .metrics import REGISTRY, Registry, reset, snapshot
from .trace import QueryTrace, span

__all__ = [
    "REGISTRY",
    "Registry",
    "QueryTrace",
    "metrics",
    "reset",
    "snapshot",
    "span",
    "trace",
]
