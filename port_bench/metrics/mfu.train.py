"""The work the configuration requires (the reference's count: products only,
recompute left out) times the calls completed, over the traced window and the 989
TFLOP/s dense bf16 peak, in %."""
from port_bench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
