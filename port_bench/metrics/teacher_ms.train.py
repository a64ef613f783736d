"""Device-busy ms a step in the guidance (asd_guidance and the three teachers):
the `teacher` range."""
from port_bench.lib.readers import range_ms

RANGES = ("teacher",)


def read(ctx):
    return range_ms(ctx, RANGES)
