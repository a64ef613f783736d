"""Device-busy ms a step in the student (space_generator, unet, vae under the
trainer): the `generator_forward` and `generator_backward` ranges."""
from port_bench.lib.readers import range_ms

RANGES = ("generator_forward", "generator_backward")


def read(ctx):
    return range_ms(ctx, RANGES)
