"""queries_per_s: every query answered in the window, over the
window's seconds (its last batch included to its end)."""


def read(ctx):
    w = ctx.window
    if "batches" not in w or not w["seconds"]:
        return None
    return (w["queries"] - w["failed"]) / w["seconds"]
