"""Device-busy ms a prompt in the decode layer (models/vae.py): the `vae_decode` range."""
from port_bench.lib.readers import range_ms

RANGES = ("vae_decode",)


def read(ctx):
    return range_ms(ctx, RANGES)
