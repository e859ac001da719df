"""write.ms_per_1k.updates: host ms in StreamingIndex.delete and .add
(the harness's own timers) per 1,000 updates in the window: delta
appends, seals, tier merges, purge rebuilds and WAL appends."""


def read(ctx):
    w = ctx.window
    if "add_s" not in w or not w["updates"]:
        return None
    return (w["add_s"] + w["delete_s"]) * 1e3 / (w["updates"] / 1e3)
