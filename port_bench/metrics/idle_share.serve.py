"""Share of the traced window in which no operation ran on the device, in %."""
from port_bench.lib.readers import idle_share


def read(ctx):
    return idle_share(ctx)
