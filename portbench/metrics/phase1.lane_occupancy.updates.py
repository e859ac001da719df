"""phase1.lane_occupancy.updates: % of phase 1's issued work that was
useful in the window's 64-query batches between update batches: the
lanes' pops (search.phase1.visits) over lanes × loop iterations
(search.phase1.lane_iters)."""
from portbench.spanreads import lane_occupancy


def read(ctx):
    return lane_occupancy(ctx)
