"""Device-busy ms a prompt in the field and mesh layer (ops/field_grid.py,
ops/isosurface.py, colour): the `field_grid`, `marching_cubes` and `colorize` ranges."""
from port_bench.lib.readers import range_ms

RANGES = ("field_grid", "marching_cubes", "colorize")


def read(ctx):
    return range_ms(ctx, RANGES)
