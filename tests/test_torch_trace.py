"""The port's tracer (``utils/profiling.py``) on the CPU, over a tiny pipeline.

* **Off**, a call records nothing and only the six stages enter ``record_function``.
* **On** (``recording()``), spans nest under the right parent and every span of one
  call carries that call's request id, which differs from call to call.
* Under ``torch.profiler``, each span's ``[start_ns, end_ns]`` on ``time.time_ns()``
  encloses the profiler's own event of that name: the two share a clock.
* A count lands on the innermost open span.
* ``count_flops(...).by_range`` is split by the six stages alone, as before the spans.
* Under the benchmark's ``TracedWindow``, every span is a balanced pair of marks.

The card's side (the device clock, the sync count, CUDA-graph capture) is in
``tests/test_torch_gpu.py``.
"""

import contextlib
from collections import Counter, defaultdict, deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from triplaneturbo_torch.models.clip_text import CLIPTextConfig
from triplaneturbo_torch.models.geometry.triplane_field import TriplaneField
from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline
from triplaneturbo_torch.utils import flops, profiling

TINY_SG = dict(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
               attention_head_dim=8, vae_block_out_channels=(16, 32), vae_layers_per_block=1,
               output_dim=8, training_type="self_lora_rank_4-cross_lora_rank_4-locon_rank_4")
TINY_TEXT = dict(vocab_size=49408, width=32, layers=2, heads=4, intermediate=64, max_length=77)
PIPE_KW = dict(latent_resolution=8, isosurface_resolution=24, max_verts=8192, max_faces=16384)
STAGES = ("text_encoder", "denoise", "vae_decode", "field_grid", "marching_cubes", "colorize")
FINE = ("ddim_step", "unet.down", "unet.mid", "unet.up", "flash_attention", "fused_field_grid")


@pytest.fixture(scope="module")
def pipe():
    return TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cpu", seed=0, space_generator_overrides=TINY_SG,
        text_config=CLIPTextConfig(**TINY_TEXT), **PIPE_KW)


@pytest.fixture
def fused(monkeypatch):
    """The field grid through ``fused_field_grid`` (its plain version on CPU tensors),
    as on the card."""
    monkeypatch.setattr(TriplaneField, "_can_fuse_grid", lambda self, device: True)


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def _latents(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(1, 6, 8, 8, 4))
                            .astype(np.float32))


def test_off_records_nothing_and_enters_only_the_stages(pipe, fused, monkeypatch):
    assert not profiling.tracing()
    entered = []

    @contextlib.contextmanager
    def record_function(name):
        entered.append(name)
        yield

    monkeypatch.setattr(profiling, "record_function", record_function)
    pipe("a hamburger", latents=_latents())
    assert profiling.spans() == []
    assert entered == list(STAGES)


def test_spans_nest_and_share_one_request_a_call(pipe, fused):
    with profiling.recording():
        assert profiling.tracing()
        pipe("a hamburger", latents=_latents(0))
        pipe("a wooden chair", latents=_latents(1))
    assert not profiling.tracing()
    recs = profiling.spans()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["pipeline", "pipeline"]
    assert len({r.request for r in roots}) == 2
    assert all(r.request == r.id for r in roots)
    for r in recs:
        root = r
        while root.parent is not None:
            root = by_id[root.parent]
        assert r.request == root.id and r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    parents = defaultdict(set)
    for r in recs:
        parents[r.name].add(by_id[r.parent].name if r.parent else None)
    assert all(parents[s] == {"pipeline"} for s in STAGES)
    assert parents["ddim_step"] == {"denoise"}
    assert parents["unet.down"] == parents["unet.mid"] == parents["unet.up"] == {"ddim_step"}
    # the UNet's transformer blocks sit in its three loops; the VAE's mid attention in decode
    assert parents["flash_attention"] == {"unet.down", "unet.mid", "unet.up", "vae_decode"}
    assert parents["fused_field_grid"] == {"field_grid"}
    n = Counter(r.name for r in recs if r.request == roots[0].id)
    assert n["ddim_step"] == pipe.cfg.num_inference_steps == n["unet.mid"]
    assert all(n[s] == 1 for s in STAGES) and n["fused_field_grid"] == 1


def test_spans_enclose_the_profilers_events(pipe, fused):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        pipe("a hamburger", latents=_latents())
    recs = profiling.spans()
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in STAGES + FINE + ("pipeline",):
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert set(events) == set(STAGES + FINE + ("pipeline",))
    for name, evs in events.items():
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        assert len(mine) == len(evs), name
        for (s0, s1), (e0, e1) in zip(mine, sorted(evs)):
            assert s0 <= e0 and e1 <= s1, (name, s0, e0, e1, s1)


def test_a_count_lands_on_the_innermost_span():
    with profiling.recording():
        with profiling.span("outer") as outer:
            profiling.count("n")
            with profiling.span("inner") as inner:
                profiling.count("n", 2)
                profiling.count("m")
            profiling.count("n")
    assert outer.counts == {"n": 2} and inner.counts == {"n": 2, "m": 1}
    assert inner.parent == outer.id and inner.request == outer.request == outer.id
    profiling.count("n")  # no span open: nothing
    assert outer.counts == {"n": 2}
    assert [r.name for r in profiling.spans()] == ["inner", "outer"]


def test_off_a_span_is_nothing_and_a_stage_is_a_record_function():
    with profiling.span("x") as rec:
        assert rec is None
    assert isinstance(profiling.stage("y"), torch.autograd.profiler.record_function)
    assert profiling.spans() == []


def test_the_kept_spans_are_bounded(monkeypatch):
    monkeypatch.setattr(profiling._TRACER, "kept", deque(maxlen=3))
    with profiling.recording():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [r.name for r in profiling.spans()] == ["s2", "s3", "s4"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_flops_by_range_is_by_stage_alone(pipe, fused):
    lat = _latents()
    _, c = flops.count_flops(pipe, "a hamburger", latents=lat)
    assert set(c.by_range) == set(STAGES) - {"marching_cubes"}  # marching cubes has no products
    assert sum(c.by_range.values()) == c.total
    with torch.no_grad():
        text = pipe.encode_prompt(["a hamburger"])
        _, denoise = flops.count_flops(pipe.denoise_latents, text, lat)
        x0 = pipe.denoise_latents(text, lat)
        _, decode = flops.count_flops(pipe.geometry.decode, x0)
    assert c.by_range["denoise"] == denoise.total > 0
    assert c.by_range["vae_decode"] == decode.total > 0
    assert profiling.spans() == []


def test_traced_window_marks_every_span(pipe, fused):
    from port_bench.lib.trace import TracedWindow

    tw = TracedWindow(torch.device("cpu")).start()
    try:
        tw.begin()
        pipe("a hamburger", latents=_latents())
        tw.end()
    finally:
        tw.stop()
    assert profiling.record_function is torch.profiler.record_function
    log = tw.marks.log
    assert log[0] == ("window", "enter") and log[-1] == ("window", "exit")
    stack = []
    for label, kind in log[1:-1]:
        if kind == "enter":
            stack.append(label)
        else:
            assert stack.pop() == label
    assert not stack
    entered = Counter(label for label, kind in log[1:-1] if kind == "enter")
    assert set(entered) == set(STAGES + FINE + ("pipeline",))
    assert entered["pipeline"] == 1 and entered["ddim_step"] == pipe.cfg.num_inference_steps
    assert len(profiling.spans()) == sum(entered.values())
    assert tw.summary().window_s > 0
