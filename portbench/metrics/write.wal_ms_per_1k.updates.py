"""write.wal_ms_per_1k.updates: host ms in span.index.wal_append (one
write-ahead log record a mutation, `index/wal`) per 1,000 updates in the
window."""
from portbench.spanreads import write_ms_per_1k


def read(ctx):
    return write_ms_per_1k(ctx, "index.wal_append")
