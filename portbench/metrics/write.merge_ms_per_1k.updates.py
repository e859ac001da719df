"""write.merge_ms_per_1k.updates: host ms in span.index.merge, every kind
(tiered merges and purge rebuilds, `core/build`), per 1,000 updates in
the window."""
from portbench.spanreads import write_ms_per_1k


def read(ctx):
    return write_ms_per_1k(ctx, "index.merge")
