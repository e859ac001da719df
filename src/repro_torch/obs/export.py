"""Export the registry: JSON payloads (`BENCH_obs.json`) + human tables (a
port of the reference's `obs/export.py`).

The JSON shape is the bench-artifact convention the reference's
`benchmarks/check_bench_schema.py` validates:

    {
      "section": "obs",
      "generated_unix": ...,
      "obs": {
        "counters":   {"engine.dispatches{kind=traversal}": 123, ...},
        "gauges":     {"index.delta_occupancy{index=idx0}": 0.4, ...},
        "histograms": {"span.serve.search": {"unit": "s", "count": ...,
                       "sum": ..., "buckets": [[log2_edge, n], ...],
                       "p50": ..., "p95": ..., "p99": ...}, ...}
      },
      "autotune": {"<kernel>/<shape-class>/k<k>/<dtype>/<backend>":
                   {"bm": ..., "bn": ..., "bk": ..., "grid": [...],
                    "blocks": ..., "pred_us": ..., "source": ...}, ...},
      "quantized": {"<storage dtype>":
                    {"storage_dtype": ..., "bytes_quantized": ...,
                     "bytes_f32_equiv": ..., "reduction_factor": ...,
                     "rescore_exact": ..., "rescore_fallback": ...}, ...}
    }

`autotune` holds the port's launch plans (`kernels/autotune.decisions`,
whose fields carry the port's meanings). Histogram buckets are sparse
``[log2 upper edge, count]`` pairs on the process-global log2 ladder, so
artifacts from different runs / shards merge by adding counts per edge.
"""
from __future__ import annotations

import json
import time
from typing import Optional

from . import metrics


def to_payload(registry: Optional[metrics.Registry] = None) -> dict:
    reg = registry or metrics.REGISTRY
    # the autotuner's cached launch plans ride along, so every obs
    # artifact records which geometry produced its numbers; imported here
    # because kernels.ops imports obs
    from ..kernels import autotune

    return {
        "section": "obs",
        "generated_unix": time.time(),
        "obs": reg.snapshot(),
        "autotune": autotune.decisions(),
        "quantized": quantized_summary(reg),
    }


def quantized_summary(registry: Optional[metrics.Registry] = None) -> dict:
    """Per storage dtype: bytes streamed by the quantized leaf scans
    (`leaf_topk_l2_raw`, at the candidates' storage width with the int8
    scale), the f32-equivalent bytes of the same calls, their ratio, and
    the rescore certificate outcomes (exact vs whole-dispatch f32
    fallback)."""
    reg = registry or metrics.REGISTRY
    counters = reg.snapshot()["counters"]
    out = {}
    for key, val in counters.items():
        if not key.startswith("quantized.stream_bytes{"):
            continue
        dt = key[len("quantized.stream_bytes{dtype="): -1]
        f32 = counters.get(f"quantized.f32_stream_bytes{{dtype={dt}}}", 0)
        out[dt] = {
            "storage_dtype": dt,
            "bytes_quantized": int(val),
            "bytes_f32_equiv": int(f32),
            "reduction_factor": (f32 / val) if val else 0.0,
            "rescore_exact": int(
                counters.get("quantized.rescore{result=exact}", 0)
            ),
            "rescore_fallback": int(
                counters.get("quantized.rescore{result=fallback}", 0)
            ),
        }
    return out


def dump_json(path: str, registry: Optional[metrics.Registry] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_payload(registry), f, indent=1)
    return path


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def table(snap: Optional[dict] = None) -> str:
    """Human-readable dump of a registry snapshot (or the live one)."""
    snap = snap if snap is not None else metrics.snapshot()
    lines = []
    if snap["counters"]:
        lines.append("== counters ==")
        w = max(map(len, snap["counters"]))
        for k, v in snap["counters"].items():
            lines.append(f"  {k:<{w}}  {v}")
    if snap["gauges"]:
        lines.append("== gauges ==")
        w = max(map(len, snap["gauges"]))
        for k, v in snap["gauges"].items():
            lines.append(f"  {k:<{w}}  {v:.6g}")
    if snap["histograms"]:
        lines.append("== histograms ==")
        for k, h in snap["histograms"].items():
            mean = h["sum"] / h["count"] if h["count"] else 0.0
            pct = (
                f"  p50={h['p50']:.3g} p95={h['p95']:.3g} p99={h['p99']:.3g}"
                if h["count"]
                else ""
            )
            lines.append(
                f"  {k} [{h['unit']}]  n={h['count']} mean={mean:.3g}{pct}"
            )
    return "\n".join(lines) if lines else "(registry empty)"


__all__ = [
    "dump_json",
    "load_json",
    "table",
    "to_payload",
    "quantized_summary",
]
