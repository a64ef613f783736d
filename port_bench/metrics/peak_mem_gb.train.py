"""Peak device memory allocated over the window (torch.cuda.max_memory_allocated
after a reset at the window's start), in GB."""


def read(ctx):
    b = ctx.get("peak_window_bytes")
    return b / 1e9 if b else None
