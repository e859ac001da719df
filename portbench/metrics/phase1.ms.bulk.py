"""phase1.ms.bulk: host ms a query batch in phase 1 of the search, the
pruned walk that collects each query's leaf frontier (span.search.phase1)."""
from portbench.readers import per_batch


def read(ctx):
    return per_batch(ctx, spans=("search.phase1",), scale=1e3)
