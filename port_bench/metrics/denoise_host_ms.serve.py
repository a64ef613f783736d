"""Host ms a prompt in the denoise layer: Σ (end − start) of the program's `denoise`
spans in the traced window (utils/profiling.py), beside `denoise_ms.serve`'s device-busy
time; a traced window's host times carry the trace's own cost."""
from port_bench.lib.spans import host_ms


def read(ctx):
    return host_ms(ctx, "denoise")
