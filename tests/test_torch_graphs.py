"""The piecewise CUDA graph of the student UNet (``utils/cuda_graphs.py``) on the CPU:
where it cannot engage, and the attention op's break hook.

* On the CPU the pipeline's denoise runs eagerly, keeps no graph, and counts
  ``unet_eager_calls`` 4 and ``unet_graph_calls`` 0 a call on its ``ddim_step`` spans.
* ``can_capture`` refuses a CPU tensor, under grad or not.
* With no capture active, ``attention`` is the op it always was, on both routes.
* While a capture is active, ``attention`` hands the op and its inputs to the graph's
  ``split`` and returns what that gives.

The card's side (ε against the eager call, the pieces, the spans and the trace of a
graphed call) is in ``tests/test_torch_gpu.py``.
"""

import math
from collections import Counter

import numpy as np
import pytest
import torch

from triplaneturbo_torch.models.clip_text import CLIPTextConfig
from triplaneturbo_torch.ops import flash_attention as fa
from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline
from triplaneturbo_torch.utils import cuda_graphs, profiling

TINY_SG = dict(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
               attention_head_dim=8, vae_block_out_channels=(16, 32), vae_layers_per_block=1,
               output_dim=8, training_type="self_lora_rank_4-cross_lora_rank_4-locon_rank_4")
TINY_TEXT = dict(vocab_size=49408, width=32, layers=2, heads=4, intermediate=64, max_length=77)
PIPE_KW = dict(latent_resolution=8, isosurface_resolution=24, max_verts=8192, max_faces=16384)


@pytest.fixture(scope="module")
def pipe():
    return TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cpu", seed=0, space_generator_overrides=TINY_SG,
        text_config=CLIPTextConfig(**TINY_TEXT), **PIPE_KW)


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def _latents(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(1, 6, 8, 8, 4))
                            .astype(np.float32))


def test_denoise_stays_eager_on_the_cpu(pipe):
    with profiling.recording():
        pipe("a hamburger", latents=_latents(0))
        pipe("a wooden chair", latents=_latents(1))
    assert pipe._unet_graphs == {}
    recs = profiling.spans()
    roots = [r.id for r in recs if r.parent is None]
    assert len(roots) == 2
    for rid in roots:
        counts = Counter()
        for r in recs:
            if r.request == rid:
                counts.update(r.counts)
        assert counts["unet_eager_calls"] == pipe.cfg.num_inference_steps == 4
        assert counts["unet_graph_calls"] == 0 and "unet_graph_calls" in counts
    steps = [r for r in recs if r.name == "ddim_step"]
    assert len(steps) == 8
    assert all(r.counts == {"unet_graph_calls": 0, "unet_eager_calls": 1} for r in steps)
    # the eager UNet keeps its own spans
    assert sum(r.name == "unet.down" for r in recs) == 8


def test_can_capture_refuses_the_cpu():
    x = torch.zeros(2)
    assert not cuda_graphs.can_capture(x)
    with torch.no_grad():
        assert not cuda_graphs.can_capture(x)
    assert cuda_graphs.active is None


@pytest.mark.parametrize("L,Lk,D", [(128, 77, 64), (256, 256, 64), (40, 40, 64), (128, 64, 32)])
def test_attention_without_a_capture_is_the_op(L, Lk, D):
    """Both routes: the kernels' (its plain version on the CPU) for ``D`` in their head
    sizes and ``L >= 128``, the einsum path otherwise; the result as before, a
    ``[B, L, H, D]`` view of the op's own output."""
    assert cuda_graphs.active is None
    gen = torch.Generator().manual_seed(L + Lk + D)
    q, k, v = (torch.randn(2, n, 3, D, generator=gen) for n in (L, Lk, Lk))
    got = fa.attention(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    assert got.shape == (2, L, 3, D)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, fa._attention(q, k, v))


def test_attention_breaks_the_graph_while_one_is_captured(monkeypatch):
    """While a graph is captured, the op goes to its ``split`` (which ends the piece,
    runs the op and begins the next one) with the op and its inputs, unchanged."""
    calls = []

    class Capture:
        def split(self, op, *args):
            calls.append((op, args))
            return torch.full((1,), 7.0)

    q = torch.randn(1, 128, 2, 64)
    monkeypatch.setattr(cuda_graphs, "active", Capture())
    out = fa.attention(q, q * 2, q * 3)
    assert out.tolist() == [7.0] and len(calls) == 1
    op, args = calls[0]
    assert op is fa._attention and args[0] is q and len(args) == 3
    monkeypatch.setattr(cuda_graphs, "active", None)
    assert torch.equal(fa.attention(*args), op(*args))
