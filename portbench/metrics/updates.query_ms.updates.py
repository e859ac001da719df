"""updates.query_ms.updates: mean host ms of the window's query batches
(64 queries) between the update batches."""


def read(ctx):
    t = ctx.window.get("query_batch_s")
    return 1e3 * sum(t) / len(t) if t else None
