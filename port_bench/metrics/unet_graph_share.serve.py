"""Share of the student UNet's calls in the serving DDIM loop that replayed a piecewise
CUDA graph, in %: 100 × `unet_graph_calls` ÷ (`unet_graph_calls` + `unet_eager_calls`),
the program's counts on its `ddim_step` spans (pipelines/triplaneturbo_text_to_3d.py
`denoise_latents`), summed over the traced window's requests; None where the program
counts neither."""
from port_bench.lib.spans import counted


def read(ctx):
    graph, eager = counted(ctx, "unet_graph_calls"), counted(ctx, "unet_eager_calls")
    if graph is None or eager is None or graph + eager <= 0:
        return None
    return 100.0 * graph / (graph + eager)
