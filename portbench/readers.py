"""Helpers the metric readers (`metrics/<name>.py`) share."""
from __future__ import annotations

import math

from . import roofline


def nearest_rank(values, pct: float) -> float:
    """The pct-th percentile by nearest rank: the smallest value with at
    least pct% of all values at or below it (no interpolation)."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, math.ceil(pct / 100.0 * len(vals)) - 1)]


def per_batch(ctx, spans=(), counters=(), scale=1.0):
    """Span seconds and counter values accrued in the window, summed,
    times `scale`, per query batch of the window (None without a
    registry or a batch)."""
    reg, win = ctx.registry, ctx.window
    n = win.get("batches") or len(win.get("query_batch_s", ()))
    if reg is None or not n:
        return None
    total = sum(reg["span_s"].get(s, 0.0) for s in spans)
    total += sum(reg["counters"].get(c, 0) for c in counters)
    return total * scale / n


def kernel_roofline(ctx, kernel: str):
    """Sum of the calls' least times (the benchmark's own operation and
    byte formulas at the card's peaks) over the sum of their device
    times, in %, for the wrapped calls of `kernel` in the profiled slice
    whose device time was read (None where there was none)."""
    tr = ctx.trace
    if tr is None:
        return None
    bound = dev = 0.0
    for i, call in enumerate(tr["calls"]):
        if call[0] != kernel or i not in tr["call_device_s"]:
            continue
        bound += roofline.bound_s(*roofline.FORMULAS[kernel](*call[1:]))
        dev += tr["call_device_s"][i]
    return 100.0 * bound / dev if dev > 0 else None


def idle_pct(ctx):
    """Share of the profiled slice in which nothing ran on the device."""
    tr = ctx.trace
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
