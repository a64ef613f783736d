"""The FLOP count of ``utils/flops.py`` on the CPU: the kernels' reports, the shapes,
the JAX package's count, and a step.

* **The kernels.** Each wrapper, taking its card route on CPU tensors with the ctypes
  call stubbed out, reports exactly what ``FlopCounterMode`` counts of its plain
  version at the same shapes, forward and backward (for every set of inputs that needs
  a gradient), at three shapes each; the einsum path of ``attention`` (head sizes the
  kernels do not take) counts 4·B·H·L·Lk·D forward and 8·B·H·L·Lk·D backward.
* **The shapes.** The tiny pipeline's UNet forward and VAE decode count exactly the sum,
  over the modules that ran, of 2·N·Hₒ·Wₒ·Cₒ·Cᵢ·k²/groups a convolution, 2·tokens·in·out
  a linear layer or adapter product, and 4·BH·L·Lk·D an attention.
* **The JAX package.** The tiny pipeline's count equals XLA's ``cost_analysis`` of the
  JAX ``_generate_one_from_key_jit`` plus (steps − 1) UNet steps within 5 %: XLA counts
  the body of the DDIM ``scan`` once, the port counts every step it runs.
* **Both routes.** A kernel-taking tiny pipeline's prompt and a tiny staged training
  step count the same integer on the CPU route and on the kernel route (simulated on
  the CPU: every wrapper takes its card branch, the launch replaced by the plain
  version computed outside the count).
* **The step.** ``step_cost_flops`` takes one real step (staged and monolithic) and
  counts a backward at least twice its forward programs. Its ratio to the JAX
  trainer's count is printed by ``tools/flops_against_jax.py`` and not held: the JAX
  programs hold loops, whose bodies XLA counts once.
"""

import contextlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from test_torch_pipeline import PIPE_KW, PROMPT, TINY_SG, TINY_TEXT
from test_torch_train_step import step_inputs, tiny_config
from triplaneturbo_tpu.models.clip_text import CLIPTextConfig as JaxTextConfig
from triplaneturbo_tpu.models.clip_text import CLIPTextEncoder as JaxTextEncoder
from triplaneturbo_tpu.models.geometry.space_generator import (
    SpaceGeneratorConfig as JaxSGConfig,
)
from triplaneturbo_tpu.models.geometry.triplane_geometry import (
    TriplaneGeometry as JaxGeometry,
)
from triplaneturbo_tpu.models.geometry.triplane_geometry import (
    TriplaneGeometryConfig as JaxGeometryConfig,
)
from triplaneturbo_tpu.models.networks import MLPConfig as JaxMLPConfig
from triplaneturbo_tpu.models.schedulers import SchedulerConfig as JaxSchedulerConfig
from triplaneturbo_tpu.models.schedulers import make_schedule as jax_make_schedule
from triplaneturbo_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from triplaneturbo_tpu.pipelines.triplaneturbo_text_to_3d import (
    TriplaneTurboPipelineConfig as JaxPipelineConfig,
)
from triplaneturbo_tpu.pipelines.triplaneturbo_text_to_3d import (
    TriplaneTurboTextTo3DPipeline as JaxPipeline,
)
from triplaneturbo_torch.models import attention as attention_module
from triplaneturbo_torch.models.clip_text import CLIPTextConfig
from triplaneturbo_torch.models.geometry import triplane_field
from triplaneturbo_torch.models.lora import LoRAAdapter, PlaneLoRAAdapter
from triplaneturbo_torch.ops import field_grid as fg
from triplaneturbo_torch.ops import flash_attention as fa
from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline
from triplaneturbo_torch.systems.builder import build_system
from triplaneturbo_torch.utils import flops

torch.set_num_threads(2)

STEPS = 4
KERNELS = ("flash_attn_fwd", "flash_attn_fwd_stats", "flash_attn_bwd_dq", "flash_attn_bwd_dkdv",
           "field_grid")
# a tiny student whose level-0 attention (6 planes x 8² tokens, one 64-wide head) and
# cross-attention take the flash kernels, and whose field takes the field grid
KERNEL_SG = dict(TINY_SG, block_out_channels=(64, 64), attention_head_dim=64)
KERNEL_PIPE_KW = dict(PIPE_KW, isosurface_resolution=16)


def _plain_count(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


@contextlib.contextmanager
def card_route_on_cpu(monkeypatch):
    """Every wrapper takes its card branch on CPU tensors: the launches run (checks,
    counters, FLOP reports) with the ctypes call stubbed, and their outputs are filled
    with the plain versions' results, computed outside the count."""
    monkeypatch.setattr(fa, "_call", lambda *a, **k: None)
    launch, launch_dq, launch_dkdv = fa._launch, fa._launch_dq, fa._launch_dkdv

    def fwd(q, k, v, return_stats=False):
        got = launch(q, k, v, return_stats)
        with flops.counted_as(None), torch.no_grad():
            want = fa.flash_attention_reference(q, k, v, return_stats)
        for g, w in zip(got if return_stats else (got,), want if return_stats else (want,)):
            g.copy_(w)
        return got

    def plain_bwd(q, k, v, g, lse, delta):
        with flops.counted_as(None), torch.no_grad():
            scale = 1.0 / math.sqrt(q.shape[-1])
            s = torch.einsum("bld,bkd->blk", q.float(), k.float()) * scale
            p = torch.exp(s - lse[..., None])
            ds = p * (torch.einsum("bld,bkd->blk", g.float(), v.float()) - delta[..., None])
            return (torch.einsum("blk,bkd->bld", ds, k.float()) * scale,
                    torch.einsum("blk,bld->bkd", ds, q.float()) * scale,
                    torch.einsum("blk,bld->bkd", p, g.float()))

    def dq(q, k, v, g, lse, delta, products=2):
        out = launch_dq(q, k, v, g, lse, delta, products)
        out.copy_(plain_bwd(q, k, v, g, lse, delta)[0])
        return out

    def dkdv(q, k, v, g, lse, delta, products=2):
        dk, dv = launch_dkdv(q, k, v, g, lse, delta, products)
        _, want_k, want_v = plain_bwd(q, k, v, g, lse, delta)
        dk.copy_(want_k)
        dv.copy_(want_v)
        return dk, dv

    def flash(q, k, v):  # flash_attention's CUDA branch
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return fa._FlashAttention.apply(q, k, v)
        return fa._launch(q, k, v)

    def field_launch(a_xy, a_xz, a_zy, w2blk, w3t, radius, bias_r):
        fg.LAUNCHES += 1
        with flops.counted_as(None), torch.no_grad():
            return fg.field_grid_split_tf32_reference(a_xy, a_xz, a_zy, w2blk, w3t, radius,
                                                      bias_r)

    def fused(m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d, radius, bias_r, concat):
        inputs = (m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d)  # fused_field_grid's CUDA branch
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            return fg._FusedFieldGrid.apply(float(radius), float(bias_r), bool(concat), *inputs)
        return fg._prep_and_launch(inputs, radius, bias_r, concat)

    can_fuse = triplane_field.TriplaneField._can_fuse_grid
    monkeypatch.setattr(fa, "_launch", fwd)
    monkeypatch.setattr(fa, "_launch_dq", dq)
    monkeypatch.setattr(fa, "_launch_dkdv", dkdv)
    monkeypatch.setattr(fa, "flash_attention", flash)
    monkeypatch.setattr(fg, "_launch", field_launch)
    monkeypatch.setattr(triplane_field, "fused_field_grid", fused)
    monkeypatch.setattr(triplane_field.TriplaneField, "_can_fuse_grid",
                        lambda self, device: can_fuse(self, torch.device("cuda")))
    yield


# -- the kernels ------------------------------------------------------------------------

NEEDS = [(True, True, True), (True, False, False), (False, True, True), (False, False, True)]


@pytest.mark.parametrize("BH, L, Lk, D", [(2, 130, 77, 64), (3, 128, 200, 64), (1, 64, 40, 512)])
def test_kernel_wrappers_report_their_plain_count(BH, L, Lk, D, monkeypatch):
    gen = torch.Generator().manual_seed(L)
    q, k, v = (torch.randn((BH, n, D), generator=gen) for n in (L, Lk, Lk))
    g = torch.randn((BH, L, D), generator=gen)
    monkeypatch.setattr(fa, "_call", lambda *a, **kw: None)
    n = 2 * BH * L * Lk * D  # one of attention's products
    plain = _plain_count(lambda: fa.flash_attention_reference(q, k, v))
    assert plain == 2 * n
    for stats, name in ((False, "flash_attn_fwd"), (True, "flash_attn_fwd_stats")):
        _, c = flops.count_flops(fa._launch, q, k, v, stats)
        assert c.total == c.by_kernel[name] == plain and c.kernel_share() == 1.0
    for needs in NEEDS:
        leaves = [t.clone().requires_grad_(r) for t, r in zip((q, k, v), needs)]
        plain = _plain_count(lambda: fa.flash_attention_reference(*leaves).backward(g))
        _, c = flops.count_flops(lambda: fa._FlashAttention.apply(*leaves).backward(g))
        assert c.total == plain == n * (2 + (needs[0] or needs[1]) + sum(needs)), needs
        assert c.by_kernel["flash_attn_bwd_dq"] + c.by_kernel["flash_attn_bwd_dkdv"] == plain - 2 * n
    # the einsum path of the dispatcher (a head size the kernels do not take) is the same
    # code on both routes
    B, H = 1, BH
    q4, k4, v4 = (t.reshape(B, H, -1, D).transpose(1, 2)[..., :24].contiguous()
                  for t in (q, k, v))
    _, c = flops.count_flops(fa.attention, q4, k4, v4)
    assert c.total == 4 * B * H * L * Lk * 24 and not c.by_kernel
    leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
    _, c = flops.count_flops(lambda: fa.attention(*leaves).sum().backward())
    assert c.total == 12 * B * H * L * Lk * 24


@pytest.mark.parametrize("R, C, concat", [(8, 4, False), (16, 8, True), (12, 3, False)])
def test_field_grid_reports_its_plain_count(R, C, concat, monkeypatch):
    gen = torch.Generator().manual_seed(R)
    planes = [torch.randn((R, R, C), generator=gen) for _ in range(3)]
    cin = 3 * C if concat else C
    ws = [torch.randn(s, generator=gen) * 0.3
          for s in ((cin, 64), (64, 64), (64, 1), (cin, 64), (64, 64), (64, 3))]
    monkeypatch.setattr(fg, "_launch", lambda a_xy, a_xz, a_zy, w2, w3, r, b: (
        torch.zeros((R,) * 3), torch.zeros((3,) + (R,) * 3)))
    plain = _plain_count(lambda: fg.field_grid_reference(*planes, *ws, 1.0, 0.5, concat))
    assert plain == fg.field_grid_flops(planes[2], *ws) == sum(
        2 * R ** 3 * w.shape[0] * w.shape[1] for w in ws)
    _, c = flops.count_flops(fg._prep_and_launch, (*planes, *ws), 1.0, 0.5, concat)
    assert c.total == c.by_kernel["field_grid"] == plain  # _prep's einsums dropped
    gs = torch.randn((R,) * 3, generator=gen)
    gd = torch.randn((3,) + (R,) * 3, generator=gen)
    for needs in ((True,) * 9, (False,) * 3 + (True,) * 6, (True,) * 3 + (False,) * 6):
        leaves = [t.clone().requires_grad_(r) for t, r in zip((*planes, *ws), needs)]

        def plain_step():
            sdf, de = fg.field_grid_reference(*leaves, 1.0, 0.5, concat)
            torch.autograd.backward((sdf, de), (gs, gd))

        def card_step():
            sdf, de = fg._FusedFieldGrid.apply(1.0, 0.5, concat, *leaves)
            torch.autograd.backward((sdf, de), (gs, gd))

        want = _plain_count(plain_step)
        _, c = flops.count_flops(card_step)
        assert c.total == want and c.by_kernel["field_grid"] == plain, needs


# -- the shapes and the JAX package -------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pipe():
    return TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cpu", seed=0, space_generator_overrides=TINY_SG,
        text_config=CLIPTextConfig(**TINY_TEXT), **PIPE_KW)


def _shape_count(module, fn):
    """``fn()`` with every convolution, linear layer and LoRA product of ``module`` and
    every attention recorded; returns the FLOPs their shapes give."""
    total = [0]
    hooks = []

    def conv(m, inp, out):
        N, Co, Ho, Wo = out.shape
        total[0] += 2 * N * Ho * Wo * Co * (m.in_channels // m.groups) * math.prod(m.kernel_size)

    def linear(m, inp, out):
        total[0] += 2 * inp[0].numel() // m.in_features * m.in_features * m.out_features

    def lora(m, inp, out):
        x = inp[0]
        tokens = x.numel() // x.shape[-1]
        total[0] += 2 * tokens * m.rank * (x.shape[-1] + out.shape[-1])

    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            hooks.append(mod.register_forward_hook(conv))
        elif isinstance(mod, nn.Linear):
            hooks.append(mod.register_forward_hook(linear))
        elif isinstance(mod, (LoRAAdapter, PlaneLoRAAdapter)):
            hooks.append(mod.register_forward_hook(lora))
    dispatch = attention_module.attention_dispatch

    def attention(q, k, v):
        B, L, H, D = q.shape
        total[0] += 4 * B * H * L * k.shape[1] * D
        return dispatch(q, k, v)

    attention_module.attention_dispatch = attention
    try:
        fn()
    finally:
        attention_module.attention_dispatch = dispatch
        for h in hooks:
            h.remove()
    return total[0]


def test_unet_and_decode_count_what_their_shapes_give(tiny_pipe):
    geo = tiny_pipe.geometry
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.normal(size=(1, 6, 8, 8, 4)).astype(np.float32))
    text = torch.from_numpy(rng.normal(size=(1, 77, 32)).astype(np.float32))
    with torch.no_grad():
        for fn in (lambda: geo.denoise(lat, text, 999), lambda: geo.decode(lat)):
            _, c = flops.count_flops(fn)
            assert c.total == _shape_count(geo, fn) > 0
            assert set(c.by_op) <= {"aten.mm", "aten.addmm", "aten.bmm", "aten.convolution"}


def _jax_tiny_pipeline():
    """The JAX pipeline at the tiny sizes with its parameters as shapes only
    (``jax.eval_shape`` of the inits), as ``from_pretrained`` builds it."""
    cfg = JaxPipelineConfig(field_chunk=4096, **PIPE_KW)
    tcfg = JaxTextConfig(**TINY_TEXT)
    geo = JaxGeometry(JaxGeometryConfig(
        n_feature_dims=cfg.n_feature_dims, sdf_bias=cfg.sdf_bias,
        sdf_bias_params=cfg.sdf_bias_params, rotate_planes=cfg.rotate_planes,
        split_channels=cfg.split_channels, geo_interpolate=cfg.geo_interpolate,
        tex_interpolate=cfg.tex_interpolate,
        isosurface_deformable_grid=cfg.isosurface_deformable_grid, radius=cfg.radius,
        space_generator=JaxSGConfig(dtype_str=cfg.dtype_str, **TINY_SG), mlp=JaxMLPConfig()))
    text = JaxTextEncoder(tcfg)
    key = jax.random.PRNGKey(0)
    gparams = jax.eval_shape(lambda k: geo.init(
        k, jnp.zeros((1, 6, 8, 8, 4)), jnp.zeros((1, 77, tcfg.width)), jnp.zeros(()),
        jnp.zeros((1, 8, 3)), method=geo.init_all), key)
    tparams = jax.eval_shape(lambda k: text.init(k, jnp.zeros((1, 77), jnp.int32)), key)
    return JaxPipeline(cfg=cfg, geometry=geo, geometry_params=gparams, text_encoder=text,
                       text_params=tparams, tokenizer=JaxTokenizer(),
                       schedule=jax_make_schedule(JaxSchedulerConfig())), gparams, tparams


def test_pipeline_count_against_the_jax_cost_analysis(tiny_pipe):
    """XLA's ``cost_analysis`` counts the body of a ``while`` loop once, and the JAX
    pipeline runs its DDIM steps as one ``lax.scan``: its count holds one UNet step of
    the four. The port counts each step it runs, so its count is the JAX one plus three
    UNet steps, within 5 % (the rest: XLA counts the elementwise work, which
    ``FlopCounterMode`` leaves out, and the port's field grid and colors are counted on
    their own shapes)."""
    jpipe, gparams, tparams = _jax_tiny_pipeline()
    ids = jnp.asarray(jpipe.tokenizer.batch_encode([PROMPT]))
    analysis = jpipe._generate_one_from_key_jit.lower(
        gparams, tparams, ids, jax.random.PRNGKey(0)).compile().cost_analysis()
    if isinstance(analysis, (list, tuple)):
        analysis = analysis[0]
    jax_flops = float(analysis["flops"])

    lat = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 6, 8, 8, 4))
                           .astype(np.float32))
    _, c = flops.count_flops(tiny_pipe, PROMPT, latents=lat)
    text = tiny_pipe.encode_prompt([PROMPT])
    with torch.no_grad():
        _, step = flops.count_flops(tiny_pipe.geometry.denoise, lat, text, 999)
    assert c.by_range["denoise"] == STEPS * step.total
    assert sum(c.by_range.values()) == c.total
    assert set(c.by_range) == {"text_encoder", "denoise", "vae_decode", "field_grid",
                               "colorize"}  # marching cubes runs no product
    want = jax_flops + (STEPS - 1) * step.total
    print(json.dumps({"port_flops": c.total, "port_by_stage": c.by_range,
                      "port_one_unet_step": step.total, "xla_flops": jax_flops,
                      "port_over_xla_plus_missing_steps": c.total / want}))
    assert abs(c.total - want) <= 0.05 * want, (c.total, jax_flops, step.total)


# -- both routes -------------------------------------------------------------------------


def _kernel_pipe():
    return TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cpu", seed=0, space_generator_overrides=KERNEL_SG,
        text_config=CLIPTextConfig(**TINY_TEXT), **KERNEL_PIPE_KW)


def test_card_route_counts_what_the_cpu_route_counts_for_a_prompt(monkeypatch):
    pipe = _kernel_pipe()
    lat = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 6, 8, 8, 4))
                           .astype(np.float32))
    cpu_out, cpu = flops.count_flops(pipe, PROMPT, latents=lat)
    assert not cpu.by_kernel
    with card_route_on_cpu(monkeypatch):
        card_out, card = flops.count_flops(pipe, PROMPT, latents=lat)
    assert card.total == cpu.total and card.by_range == cpu.by_range
    assert set(card.by_kernel) == {"flash_attn_fwd", "field_grid"}
    assert 0 < card.kernel_share() < 1
    np.testing.assert_allclose(card_out["latents"].numpy(), cpu_out["latents"].numpy(),
                               atol=1e-4)


def _tiny_trainer(auto_grad: bool, sg=None):
    cfg = tiny_config(auto_grad)
    if sg is not None:
        cfg["system"]["geometry"]["space_generator_config"].update(sg)
    return build_system(cfg, device="cpu")


def _step_args():
    batch_list, embeds = step_inputs(0)
    text = {k: torch.tensor(np.asarray(v)) for k, v in embeds.items()}
    return batch_list, text


def test_card_route_counts_what_the_cpu_route_counts_for_a_step(monkeypatch):
    batch_list, text = _step_args()
    counts = {}
    for route in ("cpu", "card"):
        trainer = _tiny_trainer(True, dict(block_out_channels=[64, 64], attention_head_dim=64))
        with card_route_on_cpu(monkeypatch) if route == "card" else contextlib.nullcontext():
            counts[route] = trainer.step_cost_flops(batch_list, text,
                                                    torch.Generator().manual_seed(1))
        monkeypatch.undo()
    assert counts["card"].total == counts["cpu"].total
    assert counts["card"].by_range == counts["cpu"].by_range
    assert set(counts["card"].by_kernel) == set(KERNELS), counts["card"].by_kernel


@pytest.fixture(scope="module")
def staged_count():
    batch_list, text = _step_args()
    trainer = _tiny_trainer(True)
    count = trainer.step_cost_flops(batch_list, text, torch.Generator().manual_seed(1))
    return trainer, count


def _forward_programs(count):
    r = count.by_range
    return r["generator_forward"] + r["render_1st"] + r["render_2nd"]


def test_step_cost_flops_takes_a_staged_step_and_counts_its_backward(staged_count):
    trainer, count = staged_count
    assert trainer.global_step == 1 and trainer.optimizer.adan.count == 1
    r = count.by_range
    backward = r["render_backward_1st"] + r["render_backward_2nd"] + r["generator_backward"]
    assert _forward_programs(count) > 0 and backward >= 2 * _forward_programs(count), r
    assert r["teacher"] > 0 and sum(r.values()) == count.total


def test_step_cost_flops_takes_a_monolithic_step(staged_count):
    """One graph over the parts, each under ``torch.utils.checkpoint``: its forward,
    the forward again in the backward, and the backward, so more than twice the staged
    step's forward programs (the same parts' generator and renders)."""
    batch_list, text = _step_args()
    trainer = _tiny_trainer(False)
    count = trainer.step_cost_flops(batch_list, text, torch.Generator().manual_seed(1))
    assert trainer.global_step == 1 and trainer.optimizer.adan.count == 1
    assert count.total > 2 * _forward_programs(staged_count[1])
