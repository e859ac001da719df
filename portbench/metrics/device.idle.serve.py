"""device.idle.serve: % of the profiled slice in which no operation ran
on the device: 1 - union of the device's intervals / the slice's wall time."""
from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
