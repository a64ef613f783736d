"""Device-busy ms a prompt in the denoise layer (space_generator.denoise -> unet,
attention, lora, unet_blocks): the `denoise` range."""
from port_bench.lib.readers import range_ms

RANGES = ("denoise",)


def read(ctx):
    return range_ms(ctx, RANGES)
