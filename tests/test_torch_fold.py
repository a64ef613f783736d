"""The student's frozen adapters folded into its base weights (``models/lora.py``
``Fold``), against the adapters run as they are, on the CPU.

The pipeline folds only where ``utils/cuda_graphs.py`` ``can_capture`` holds (on the
card), so these tests engage a ``Fold`` directly:

* a shared-LoCon ``AdaptedConv`` (stride 1 and 2, with and without ``up``'s bias), an
  ``Attention`` with a vanilla cross-LoRA and one with a hexa self-LoRA (``lora_out`` on
  the output projection, two items of six planes, joint self-attention), and the student
  ``Decoder``: f32 within 1e-5 of the unfolded forward's largest value; bf16 no farther
  from the f32 forward than twice the unfolded bf16 forward;
* a parameter written after a folded call shows in the next folded call; a GroupNorm
  runs on its own parameters, with no copy to refold;
* engagements nest: the outermost entry refolds, inner ones do nothing, and the fold
  stays on until the outermost exit;
* with grad on, an engaged fold changes nothing: the output is bit-equal to the
  unfolded one and the adapters take their gradients;
* the per-plane (hexa) LoCon is not folded and runs as it is; ``state_dict`` is
  unchanged by a fold.

The card's side (the full-width pipeline folded and graphed, a reload between two
graphed calls) is in ``tests/test_torch_gpu.py``.
"""

from dataclasses import replace

import pytest
import torch

from triplaneturbo_torch.models.attention import AdapterSpec, Attention
from triplaneturbo_torch.models.lora import Fold
from triplaneturbo_torch.models.unet import UNet2DConditionModel, sd21_student_config
from triplaneturbo_torch.models.unet_blocks import AdaptedConv, GroupNorm, ResnetBlock2D
from triplaneturbo_torch.models.vae import CastConv2d, Decoder, student_vae_config

F32_TOL = 1e-5
# bf16: the fold rounds the summed weight once where the adapter path rounds its f32
# branch's output before the add; each is one bf16 rounding (2^-9 relative) of like
# terms, so neither route may sit more than twice as far from the f32 forward
BF16_FACTOR = 2.0


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _randomize(module, seed):
    """Every parameter random and nonzero, the adapters' ``up`` included, so that each
    adapter adds; values rounded to bf16, so that an f32 and a bf16 copy hold the same."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan_in = p[0].numel() if p.ndim > 1 else 100
            scale = (0.3 if ".up" in name or name.startswith("up") else 1.0) / fan_in ** 0.5
            p.copy_((torch.randn(p.shape, generator=gen) * scale).bfloat16())
    return module


def _call(module, args, fold=None):
    with torch.no_grad():
        if fold is None:
            return module(*args)
        with fold.engaged():
            return module(*args)


def _check_fold(make, args, dtype):
    """``make(dtype)`` folded against unfolded: f32 within F32_TOL; bf16 against the
    f32 module's forward."""
    module = make(dtype)
    cast = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    plain = _call(module, cast)
    folded = _call(module, cast, Fold(module))
    assert torch.isfinite(folded).all() and plain.abs().max() > 0
    if dtype == torch.float32:
        assert _rel(folded, plain) <= F32_TOL, _rel(folded, plain)
        return
    ref = make(torch.float32)
    ref.load_state_dict(module.state_dict())
    want = _call(ref, args)
    assert _rel(folded, want) <= BF16_FACTOR * _rel(plain, want), (_rel(folded, want),
                                                                  _rel(plain, want))


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("locon_bias", [False, True])
def test_folded_locon_conv_matches_the_adapter(dtype, stride, locon_bias):
    def make(dt):
        return _randomize(AdaptedConv(8, 12, stride=stride, locon_type="vanilla_v1",
                                      locon_rank=4, locon_bias=locon_bias, dtype=dt), 1)

    x = torch.randn(3, 8, 9, 9, generator=torch.Generator().manual_seed(2))
    _check_fold(make, (x,), dtype)


SPEC = AdapterSpec(self_lora_type="hexa_v1", cross_lora_type="vanilla", self_rank=4,
                   cross_rank=4, n_planes=6, joint_self_attention=True, joint_group=6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["cross_vanilla", "self_hexa"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_folded_attention_matches_the_adapters(dtype, kind, with_bias):
    cross = kind == "cross_vanilla"
    spec = replace(SPEC, with_bias=with_bias)

    def make(dt):
        return _randomize(Attention(16, 2, 8, cross_attention_dim=12 if cross else None,
                                    out_bias=True, adapters=spec, dtype=dt), 3)

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(12, 10, 16, generator=gen)  # two items of six planes
    ctx = torch.randn(12, 5, 12, generator=gen)
    _check_fold(make, (x, ctx) if cross else (x,), dtype)
    assert len(Fold(make(dtype)).sites) == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_folded_student_decoder_matches(dtype):
    def make(dt):
        cfg = replace(student_vae_config(output_dim=8, rank=4,
                                         dtype_str={torch.float32: "float32",
                                                    torch.bfloat16: "bfloat16"}[dt]),
                      block_out_channels=(16, 32), layers_per_block=1)
        return _randomize(Decoder(cfg), 5)

    z = torch.randn(6, 4, 8, 8, generator=torch.Generator().manual_seed(6))
    _check_fold(make, (z,), dtype)
    # every conv (the resnets' and upsamples' with their LoCon, the retrofit cast to bf16),
    # the mid attention (basic LoRA) and every GroupNorm (the channels-last kernels'
    # plain versions on the CPU)
    dec = make(dtype)
    sites = Fold(dec).sites
    for kind, n in ((Attention, 1), (AdaptedConv, 15), (GroupNorm, 14), (CastConv2d, 1)):
        assert sum(isinstance(m, kind) for m in sites) == n
        assert sum(isinstance(m, kind) for m in dec.modules()) == n


@pytest.mark.parametrize("dtype", DTYPES)
def test_folded_resnet_block_matches(dtype):
    """A block with the time embedding and a shortcut: folded, conv1's bias and the time
    embedding are norm2's shift, and conv2's and the shortcut's biases come with the
    residual."""
    def make(dt):
        return _randomize(ResnetBlock2D(32, 64, time_emb_dim=16, locon_type="vanilla_v1",
                                        locon_rank=4, dtype=dt), 15)

    gen = torch.Generator().manual_seed(16)
    _check_fold(make, (torch.randn(2, 32, 6, 6, generator=gen),
                       torch.randn(2, 16, generator=gen)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_folded_student_unet_matches(dtype):
    def make(dt):
        cfg = replace(sd21_student_config(rank=4, dtype_str={torch.float32: "float32",
                                                            torch.bfloat16: "bfloat16"}[dt]),
                      block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
                      attention_head_dim=8)
        return _randomize(UNet2DConditionModel(cfg), 17)

    gen = torch.Generator().manual_seed(18)
    x = torch.randn(6, 8, 8, 4, generator=gen)
    ctx = torch.randn(6, 7, 32, generator=gen)
    _check_fold(make, (x, torch.full((6,), 499), ctx), dtype)


def test_a_parameter_written_after_a_folded_call_shows_in_the_next():
    conv = _randomize(AdaptedConv(8, 12, locon_type="vanilla_v1", locon_rank=4), 7)
    fold = Fold(conv)
    x = torch.randn(2, 8, 6, 6, generator=torch.Generator().manual_seed(8))
    first = _call(conv, (x,), fold)
    kept = fold.sites[0].folded[0]
    for p in (conv.locon.up.weight, conv.conv.bias):
        with torch.no_grad():
            p.copy_(p * 2.0 + 0.01)
        got = _call(conv, (x,), fold)
        assert not torch.equal(got, first)
        assert _rel(got, _call(conv, (x,))) <= F32_TOL
        first = got
    assert fold.sites[0].folded[0] is kept  # refolded in place
    assert not fold.refresh()  # nothing written since


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_folded_group_norm_runs_on_its_own_parameters(dtype):
    """Folded, a GroupNorm keeps no copy of its scale and shift: a refold copies
    nothing, and a write into them shows in the next call."""
    norm = _randomize(GroupNorm(4, 16, eps=1e-6, dtype=dtype), 19)
    fold = Fold(norm)
    x = torch.randn(2, 16, 5, 5, generator=torch.Generator().manual_seed(20)).to(dtype)
    first = _call(norm, (x,), fold)
    assert fold.sites[0].folded[0] is norm.weight and fold.sites[0].folded[1] is norm.bias
    assert not fold.refresh()
    with torch.no_grad():
        norm.bias.add_(0.5)
    got = _call(norm, (x,), fold)
    assert not torch.equal(got, first)
    assert torch.equal(got, _call(norm, (x,)))
    assert not fold.refresh()  # the write was picked up, and the refold wrote nothing


def test_a_nested_engagement_refolds_once_and_holds_until_the_outermost_exit():
    conv = _randomize(AdaptedConv(8, 12, locon_type="vanilla_v1", locon_rank=4), 21)
    fold = Fold(conv)
    refreshes = []
    real = fold.refresh

    def refresh():
        refreshes.append(real())
        return refreshes[-1]

    fold.refresh = refresh
    with fold.engaged():
        with fold.engaged():
            assert fold.on
        assert fold.on  # the inner exit leaves the fold on
        with torch.no_grad():
            conv.conv.bias.add_(1.0)  # an inner entry does not refold for this
        with fold.engaged():
            assert fold.on
    assert not fold.on
    assert refreshes == [True]
    assert fold.refresh()  # the write waits for the next outermost entry


def test_with_grad_the_adapters_run_as_before():
    attn = _randomize(Attention(16, 2, 8, adapters=SPEC), 9)
    conv = _randomize(AdaptedConv(8, 12, locon_type="vanilla_v1", locon_rank=4), 10)
    gen = torch.Generator().manual_seed(11)
    x, xc = torch.randn(6, 10, 16, generator=gen), torch.randn(2, 8, 6, 6, generator=gen)
    for module, inp in ((attn, x), (conv, xc)):
        plain = module(inp)
        fold = Fold(module)
        with fold.engaged():
            got = module(inp)
        assert torch.equal(got, plain)
        got.square().sum().backward()
        adapters = [p for n, p in module.named_parameters() if "lora" in n or "locon" in n]
        assert adapters and all(p.grad is not None and p.grad.abs().max() > 0
                                for p in adapters)


def test_hexa_locon_is_not_folded_and_state_dict_is_unchanged():
    conv = _randomize(AdaptedConv(8, 12, locon_type="hexa_v1", locon_rank=4, n_planes=6), 12)
    x = torch.randn(6, 8, 5, 5, generator=torch.Generator().manual_seed(13))
    fold = Fold(conv)
    assert fold.sites == []
    assert torch.equal(_call(conv, (x,), fold), _call(conv, (x,)))
    dec = _randomize(Decoder(replace(student_vae_config(output_dim=8, rank=4),
                                     block_out_channels=(16, 32), layers_per_block=1)), 14)
    keys = list(dec.state_dict())
    _call(dec, (torch.randn(6, 4, 4, 4),), Fold(dec))
    assert list(dec.state_dict()) == keys
