"""Share of the roofline of the field-grid kernel (csrc/field_grid.cu), in %: the
least time of the reference's field-grid sites over the device time of the kernels whose
symbols are FIELD_GRID_KERNELS."""
from port_bench.lib.readers import FIELD_GRID_KERNELS, roofline


def read(ctx):
    return roofline(ctx, "field_grid", FIELD_GRID_KERNELS)
