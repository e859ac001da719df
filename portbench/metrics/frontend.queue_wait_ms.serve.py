"""frontend.queue_wait_ms.serve: host ms a request waited in the
frontend's admission queue, from its submit to the start of the dispatch
that took it (span.serve.frontend.queue_wait), over the requests
submitted in the window (serve.frontend.requests)."""
from portbench.spanreads import total


def read(ctx):
    reg = ctx.registry
    if reg is None:
        return None
    wait = total(reg["span_s"], "serve.frontend.queue_wait")
    n = reg["counters"].get("serve.frontend.requests", 0)
    return wait * 1e3 / n if wait is not None and n else None
