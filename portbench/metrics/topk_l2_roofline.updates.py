"""topk_l2_roofline.updates: the delta-arena scan (ops.topk_l2) in the
profiled update cycle: the sum of each call's least time by the
benchmark's formulas over the device time of everything launched inside
the calls, in %."""
from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "topk_l2")
