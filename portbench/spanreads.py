"""Window sums of the program's spans and counters for the readers of
metrics that an older program lacks: where the program never made the
span or the counter, the reader gets None and returns nothing, never a
zero it did not measure."""
from __future__ import annotations


def total(table: dict, name: str):
    """Sum over `name` and each labelled `name{...}` of a window table
    (`span_s` or `counters` of `harness.registry_delta`); None where the
    table has neither."""
    keys = [key for key in table if key == name or key.startswith(name + "{")]
    return sum(table[key] for key in keys) if keys else None


def write_ms_per_1k(ctx, span: str):
    """Host ms of `span` per 1,000 updates of the window. A program with
    the write path's spans (`index.add`, `index.delete`) that never
    opened `span` in the window spent 0 ms in it; one without them reads
    nothing."""
    reg, w = ctx.registry, ctx.window
    if reg is None or not w.get("updates"):
        return None
    s = reg["span_s"]
    if total(s, "index.add") is None and total(s, "index.delete") is None:
        return None
    return (total(s, span) or 0.0) * 1e3 / (w["updates"] / 1e3)


def lane_occupancy(ctx):
    """% of phase 1's issued lane-iterations that popped a node:
    100 × search.phase1.visits / search.phase1.lane_iters."""
    reg = ctx.registry
    if reg is None:
        return None
    c = reg["counters"]
    pops, issued = total(c, "search.phase1.visits"), total(c, "search.phase1.lane_iters")
    return 100.0 * pops / issued if pops is not None and issued else None
