"""phase2.ms.bulk: host ms a query batch in phase 2 of the search: the
frontier gather, the leaf kernel and the exact rescore
(span.search.gather, .kernel, .rescore)."""
from portbench.readers import per_batch


def read(ctx):
    return per_batch(ctx, spans=("search.gather", "search.kernel", "search.rescore"),
                     scale=1e3)
