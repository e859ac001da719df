"""engine.self_ms.bulk: host ms a query batch in the engine's own stages
(span.engine.plan, .stack, .delta, .merge)."""
from portbench.readers import per_batch


def read(ctx):
    return per_batch(ctx, spans=("engine.plan", "engine.stack", "engine.delta",
                                 "engine.merge"), scale=1e3)
