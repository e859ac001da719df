"""phase1.syncs.bulk: host syncs of the walk's emptiness checks a query
batch (search.host_syncs{site=loop})."""
from portbench.readers import per_batch


def read(ctx):
    return per_batch(ctx, counters=("search.host_syncs{site=loop}",))
