"""Device-busy ms a step in the renderers (models/renderers, ops/rasterize.py,
ops/ray.py, ops/hashgrid.py): the `render_1st`, `render_2nd`, `render_backward_1st` and
`render_backward_2nd` ranges."""
from port_bench.lib.readers import range_ms

RANGES = ("render_1st", "render_2nd", "render_backward_1st", "render_backward_2nd")


def read(ctx):
    return range_ms(ctx, RANGES)
