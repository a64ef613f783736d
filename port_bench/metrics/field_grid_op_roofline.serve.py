"""Share of the roofline of the field-grid op, in %: the least time of the reference's
field-grid sites over the device-busy time inside the program's `fused_field_grid`
spans (ops/field_grid.py: `_prep` and the kernel), whatever kernel implements it."""
from port_bench.lib.spans import op_roofline


def read(ctx):
    return op_roofline(ctx, "field_grid", "fused_field_grid")
