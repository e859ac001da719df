"""engine.dispatch_ms.serve: host ms of span.engine.dispatch (the stacked
traversals of one engine call) per frontend dispatch in the window."""


def read(ctx):
    reg = ctx.registry
    if reg is None:
        return None
    c = reg["counters"]
    disp = sum(v for key, v in c.items() if key.startswith("serve.frontend.dispatches{"))
    return reg["span_s"].get("engine.dispatch", 0.0) * 1e3 / disp if disp else None
