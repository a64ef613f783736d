"""Share of the roofline of the flash-attention kernels (csrc/flash_attn_fwd.cu,
flash_attn_bwd.cu), in %: the least time of the reference's attention sites over the
device time of the kernels whose symbols are FLASH_KERNELS."""
from port_bench.lib.readers import FLASH_KERNELS, roofline


def read(ctx):
    return roofline(ctx, "attention", FLASH_KERNELS)
