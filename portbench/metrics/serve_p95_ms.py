"""serve_p95_ms: the 95th percentile (nearest rank) of the latency of
every request due in the window, each from its scheduled send time to
its reply. A request that failed, was refused or never answered counts
as slower than any reply: it reads the whole wait, window and drain."""
from portbench.readers import nearest_rank


def read(ctx):
    w = ctx.window
    if "latency_ms" not in w:
        return None
    cap = (w["seconds"] + w["wait_s"]) * 1e3 + 1.0
    lat = [x if x < float("inf") else cap for x in w["latency_ms"].tolist()]
    return nearest_rank(lat, 95.0)
