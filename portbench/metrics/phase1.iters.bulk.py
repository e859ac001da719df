"""phase1.iters.bulk: iterations of phase 1's loop a query batch, summed
over the batch's frontier walks (search.phase1.iters; each walk's count
is a multiple of the 8 iterations between its emptiness checks)."""
from portbench.spanreads import total


def read(ctx):
    reg, n = ctx.registry, ctx.window.get("batches")
    if reg is None or not n:
        return None
    iters = total(reg["counters"], "search.phase1.iters")
    return iters / n if iters is not None else None
