"""frontend.respond_ms.serve: host ms the frontend's responder spent on
one dispatch's answers, copying them to the host and resolving the
requests' futures (span.serve.frontend.respond), over the window's
dispatches (the sum of serve.frontend.dispatches{qclass})."""
from portbench.spanreads import total


def read(ctx):
    reg = ctx.registry
    if reg is None:
        return None
    respond = total(reg["span_s"], "serve.frontend.respond")
    disp = total(reg["counters"], "serve.frontend.dispatches")
    return respond * 1e3 / disp if respond is not None and disp else None
