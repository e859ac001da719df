"""leaf_topk_roofline.bulk: the leaf top-k kernel entries
(ops.leaf_topk_l2_raw, ops.leaf_topk_l2) in the profiled batch: the sum
of each call's least time by the benchmark's formulas over the device time
of everything launched inside the calls, in %."""
from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "leaf_topk")
