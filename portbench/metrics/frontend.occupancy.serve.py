"""frontend.occupancy.serve: requests submitted to the frontend over the
batches it dispatched in the window (serve.frontend.requests over the
sum of serve.frontend.dispatches{qclass})."""


def read(ctx):
    reg = ctx.registry
    if reg is None:
        return None
    c = reg["counters"]
    disp = sum(v for key, v in c.items() if key.startswith("serve.frontend.dispatches{"))
    return c.get("serve.frontend.requests", 0) / disp if disp else None
