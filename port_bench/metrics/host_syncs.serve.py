"""Blocking host-device synchronisations a prompt: the program's count (`syncs`,
utils/profiling.py: torch's sync debug mode, each warning on the innermost span) summed
over the traced window's requests."""
from port_bench.lib.spans import counted


def read(ctx):
    return counted(ctx, "syncs")
