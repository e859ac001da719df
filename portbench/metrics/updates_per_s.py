"""updates_per_s: every acknowledged update (one delete and one
insert) over the window's seconds; the interleaved query batches are part
of the window's time."""


def read(ctx):
    w = ctx.window
    if "acked" not in w or not w["seconds"]:
        return None
    return w["acked"] / w["seconds"]
