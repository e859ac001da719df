"""phase1.lane_occupancy.bulk: % of phase 1's issued work that was
useful in the window's 5,300-query batches: the lanes' pops
(search.phase1.visits) over lanes × loop iterations
(search.phase1.lane_iters); a lane whose stack emptied rides along until
the deepest lane ends."""
from portbench.spanreads import lane_occupancy


def read(ctx):
    return lane_occupancy(ctx)
