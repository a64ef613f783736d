"""Share of the roofline of the attention op, in %: the least time of the reference's
attention sites over the device-busy time inside the program's `flash_attention` spans
(ops/flash_attention.py `attention`: the kernel, the copies to its layout and the
einsum route), whatever kernel implements it."""
from port_bench.lib.spans import op_roofline


def read(ctx):
    return op_roofline(ctx, "attention", "flash_attention")
