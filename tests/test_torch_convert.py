"""The port's checkpoint converters against the JAX package's, on the CPU.

``triplaneturbo_torch/utils/convert_torch.py`` keeps its own numpy copy of the
key mapping: each of the eight converters must give the JAX function's output
dict (the same keys, every array bit for bit) on the same synthetic tiny state
dict. ``tools/reference_layout.py`` (the inverse, which ``chip_smoke.py`` writes
the reference's files with) must agree key for key and bit for bit with the JAX
tests' own inverse helpers. At full width, from shapes alone, every parameter of
the student, the OpenCLIP-H text tower and the three teachers must be reached
through the converters with no unmatched key and no shape mismatch.
"""

import functools
import re
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import test_convert_torch as jt  # the JAX tests' inverse helpers
from triplaneturbo_tpu.models.unet import UNet2DConditionModel as JaxUNet
from triplaneturbo_tpu.models.unet import UNetConfig as JaxUNetConfig
from triplaneturbo_tpu.models.vae import AutoencoderKL as JaxVAE
from triplaneturbo_tpu.models.vae import VAEConfig as JaxVAEConfig
from triplaneturbo_tpu.models.geometry.triplane_geometry import (
    TriplaneGeometry as JaxGeometry,
    TriplaneGeometryConfig as JaxGeometryConfig,
)
from triplaneturbo_tpu.models.geometry.space_generator import (
    SpaceGeneratorConfig as JaxSpaceGeneratorConfig,
)
from triplaneturbo_tpu.utils import convert_torch as J
from triplaneturbo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from triplaneturbo_torch.models.geometry.space_generator import SpaceGeneratorConfig
from triplaneturbo_torch.models.geometry.triplane_geometry import (
    TriplaneGeometry,
    TriplaneGeometryConfig,
)
from triplaneturbo_torch.models.unet import (
    UNet2DConditionModel,
    UNetConfig,
    mvdream_config,
    richdreamer_config,
    sd21_teacher_config,
)
from triplaneturbo_torch.models.vae import AutoencoderKL, AutoencoderKLEncoder, VAEConfig
from triplaneturbo_torch.tools import reference_layout as ref
from triplaneturbo_torch.utils import convert_torch as T
from triplaneturbo_torch.utils.weights import _torch_leaf, named_to_flax_tree

TINY = dict(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=16,
            attention_head_dim=8)
TINY_VAE = dict(block_out_channels=(16, 32), layers_per_block=1)
TINY_SG = dict(jt.TINY_SG)
N_BLOCKS, L = 2, 1


@torch.no_grad()
def _randomize(module, seed):
    rng = np.random.default_rng(seed)
    for p in module.parameters():
        p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    return module


def _numpy(state):
    return {k: v.float().numpy() for k, v in state.items()}


def _assert_same(got, want):
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))[:10]
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), k


@pytest.fixture(scope="module")
def tiny():
    unet = _randomize(UNet2DConditionModel(UNetConfig(camera_dim=16, **TINY)), 0)
    decoder = _randomize(AutoencoderKL(VAEConfig(**TINY_VAE)), 1)
    encoder = _randomize(AutoencoderKLEncoder(VAEConfig(**TINY_VAE)), 2)
    text = _randomize(CLIPTextEncoder(CLIPTextConfig(vocab_size=64, width=32, layers=2, heads=4,
                                                     intermediate=64)), 3)
    geometry = _randomize(TriplaneGeometry(TriplaneGeometryConfig(
        space_generator=SpaceGeneratorConfig(**TINY_SG))), 4)
    return dict(unet=unet, decoder=decoder, encoder=encoder, text=text, geometry=geometry)


def _vae_state(tiny):
    return _numpy({**ref.vae_state(tiny["decoder"]), **ref.vae_state(tiny["encoder"])})


def _legacy_attn_names(state):
    """The older diffusers VAE attention naming (query/key/value/proj_attn)."""
    names = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    out = {}
    for k, v in state.items():
        for new, old in names.items():
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
        out[k] = v
    return out


def _ldm_state(tiny):
    return _numpy(ref.ldm_teacher_state(tiny["unet"], tiny["encoder"], ema=True))


CASES = {
    "convert_unet": (lambda t: _numpy(ref.unet_state(t["unet"])), dict(n_blocks=N_BLOCKS,
                                                                        layers_per_block=L)),
    "convert_vae": (_vae_state, dict(n_blocks=N_BLOCKS, layers_per_block=L)),
    "convert_vae_legacy_attention": (lambda t: _legacy_attn_names(_vae_state(t)),
                                     dict(n_blocks=N_BLOCKS, layers_per_block=L)),
    "convert_clip_text": (lambda t: _numpy(ref.clip_text_state(t["text"])), dict(n_layers=2)),
    "convert_adapters": (lambda t: _numpy(ref.adapter_state(t["geometry"])), {}),
    "extract_ema": (_ldm_state, {}),
    "ldm_unet_to_diffusers": (lambda t: J.extract_ema(_ldm_state(t)),
                              dict(n_blocks=N_BLOCKS, layers_per_block=L)),
    "ldm_vae_to_diffusers": (_ldm_state, dict(n_blocks=N_BLOCKS)),
    "convert_ldm_teacher": (_ldm_state, dict(n_blocks=N_BLOCKS, layers_per_block=L)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_matches_jax_bit_for_bit(tiny, case):
    make, kw = CASES[case]
    name = case.replace("_legacy_attention", "")
    src = make(tiny)
    got, want = getattr(T, name)(dict(src), **kw), getattr(J, name)(dict(src), **kw)
    if name == "convert_ldm_teacher":
        assert set(got) == set(want) == {"unet", "vae"}
        assert got["unet"] and got["vae"]
        _assert_same(got["unet"], want["unet"])
        _assert_same(got["vae"], want["vae"])
    else:
        assert len(want) > 0
        _assert_same(got, want)


def _shapes(init, *args, **kw):
    """A flax module's parameter tree as numpy zeros, from its shapes alone (no init)."""
    shapes = jax.eval_shape(functools.partial(init, **kw), jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)["params"]


def _jax_unet_flat(cfg_kw):
    unet = JaxUNet(JaxUNetConfig(**cfg_kw))
    return _shapes(unet.init, jnp.zeros((4, 8, 8, 4)), jnp.zeros((4,)), jnp.zeros((4, 7, 16)),
                   jnp.zeros((4, 16)))


def _port_flat(module, like):
    """The module's parameters laid out as the flax tree ``like``, flattened."""
    named = {n: p.detach() for n, p in module.named_parameters()}
    return flatten_dict(named_to_flax_tree(named, like), sep="/")


def test_reference_layout_unet_matches_the_jax_inverse(tiny):
    like = _jax_unet_flat(dict(camera_dim=16, **TINY))
    flat = _port_flat(tiny["unet"], like)
    assert set(ref.flax_paths(tiny["unet"])) == set(flat)  # the naming's own inverse
    want = {jt._inverse_unet_name(p): jt._torch_layout(p, a) for p, a in flat.items()}
    _assert_same(_numpy(ref.unet_state(tiny["unet"])), want)
    ldm = {"model.diffusion_model." + jt._diffusers_to_ldm_unet_key(
        jt._inverse_unet_name(p), N_BLOCKS, L, attn_down=lambda i: i < N_BLOCKS - 1,
        attn_up=lambda i: i > 0): jt._torch_layout(p, a) for p, a in flat.items()}
    _assert_same(_numpy(ref.ldm_teacher_state(tiny["unet"], ema=False)), ldm)


def test_reference_layout_vae_matches_the_jax_inverse(tiny):
    vae = JaxVAE(JaxVAEConfig(**TINY_VAE))
    dec = _shapes(vae.init, jnp.zeros((1, 4, 4, 4)), method=vae.decode)
    enc = _shapes(vae.init, jnp.zeros((1, 8, 8, 3)), method=vae.encode)
    # the decoder's last conv is the student's retrofit, which the backbone file leaves out
    dec = {k: v for k, v in dec.items() if k != "decoder"} | {
        "decoder": {k: v for k, v in dec["decoder"].items()
                    if k not in ("conv_out", "conv_out_retrofit")}}
    for module, like in ((tiny["decoder"], dec), (tiny["encoder"], enc)):
        flat = {p: a for p, a in flatten_dict(like, sep="/").items()}
        ported = {p: a for p, a in _port_flat(module, like).items()}
        want = {jt._inverse_vae_name(p): jt._torch_layout(p, a) for p, a in ported.items()}
        assert set(ported) == set(flat)
        _assert_same(_numpy(ref.vae_state(module)), want)
    # the encoder in the LDM layout, attention projections as 1x1 convs
    ported = _port_flat(tiny["encoder"], enc)
    want = {}
    for p, a in ported.items():
        dkey = jt._inverse_vae_name(p)
        arr = jt._torch_layout(p, a)
        if re.search(r"attentions\.0\.to_(q|k|v)\.weight$|attentions\.0\.to_out\.0\.weight$",
                     dkey):
            arr = arr[:, :, None, None]
        want["first_stage_model." + jt._inverse_vae_ldm_name(dkey, N_BLOCKS)] = arr
    got = {k: v for k, v in ref.ldm_teacher_state(tiny["unet"], tiny["encoder"], ema=False).items()
           if k.startswith("first_stage_model.")}
    _assert_same(_numpy(got), want)


def test_reference_layout_adapters_match_the_jax_synthesizer():
    """``_synthesize_torch_adapter_state`` draws each adapter leaf from one generator in
    the tree's order: the port geometry given the same leaves writes the same dict."""
    geometry = JaxGeometry(JaxGeometryConfig(space_generator=JaxSpaceGeneratorConfig(**TINY_SG)))
    flat = flatten_dict(_shapes(geometry.init, jnp.zeros((1, 6, 8, 8, 4)), jnp.zeros((1, 7, 16)),
                                jnp.zeros(()), jnp.zeros((1, 8, 3)), method=geometry.init_all),
                        sep="/")
    paths = {k: v for k, v in flat.items()
             if re.search("lora|locon|retrofit", k) or k.startswith("field/")}
    want = jt._synthesize_torch_adapter_state(paths)
    rng = np.random.RandomState(0)
    port = TriplaneGeometry(TriplaneGeometryConfig(space_generator=SpaceGeneratorConfig(**TINY_SG)))
    named = dict(port.named_parameters())
    with torch.no_grad():
        for path, leaf in paths.items():
            name, arr = _torch_leaf(path, rng.randn(*leaf.shape).astype(np.float32))
            named[name].copy_(torch.from_numpy(arr))
    _assert_same(_numpy(ref.adapter_state(port)), want)


def test_reference_layout_clip_text_round_trips_through_the_jax_converter(tiny):
    from triplaneturbo_tpu.models.clip_text import CLIPTextConfig as JaxCLIPTextConfig
    from triplaneturbo_tpu.models.clip_text import CLIPTextEncoder as JaxCLIPTextEncoder

    enc = JaxCLIPTextEncoder(JaxCLIPTextConfig(vocab_size=64, width=32, layers=2, heads=4,
                                               intermediate=64))
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    new, loaded, mismatched = J.apply_flat_to_tree(
        J.convert_clip_text(_numpy(ref.clip_text_state(tiny["text"])), n_layers=2), params)
    assert not mismatched and len(loaded) == len(flatten_dict(params["params"]))
    want = _port_flat(tiny["text"], params["params"])
    got = flatten_dict(jax.tree_util.tree_map(np.asarray, new["params"]), sep="/")
    _assert_same(got, want)


def test_apply_flat_to_module_checks_shapes_and_casts():
    lin = torch.nn.Linear(3, 2, dtype=torch.bfloat16)
    w = np.arange(6, dtype=np.float32).reshape(3, 2)  # flax [in, out]
    loaded, bad = T.apply_flat_to_module({"kernel": w, "bias": np.ones(2, np.float32),
                                          "norm/scale": np.ones(2, np.float32),
                                          "other/kernel": np.zeros((2, 2), np.float32)}, lin)
    assert loaded == ["weight", "bias"]
    assert bad == ["norm/scale: not in module", "other/kernel: not in module"]
    assert lin.weight.dtype == torch.bfloat16
    assert torch.equal(lin.weight.float(), torch.from_numpy(w.T.copy()))
    _, bad = T.apply_flat_to_module({"kernel": np.zeros((2, 3), np.float32)}, lin)
    assert bad == ["kernel: ckpt(3, 2) != module(2, 3)"]


def _zero_stride(state):
    return {k: np.broadcast_to(np.zeros((), np.float32), tuple(v.shape)) for k, v in state.items()}


def test_full_width_coverage_from_shapes_alone():
    """The released model's student (SD-2.1 UNet, retrofit VAE decoder with
    ``output_dim`` 64, f32 adapters and field MLPs, bf16 backbone), the OpenCLIP-H text
    tower and the three teachers with their VAE encoders, all on the meta device:
    reference-layout names with zero-stride arrays go through the converters into
    ``apply_flat_to_module``; every parameter is reached, no key is unmatched, every
    shape matches, and nothing of full size is allocated."""
    tracemalloc.start()
    with torch.device("meta"):
        geometry = TriplaneGeometry(TriplaneGeometryConfig(
            space_generator=SpaceGeneratorConfig(dtype_str="bfloat16")))
        text = CLIPTextEncoder(CLIPTextConfig())
        teachers = {kind: (UNet2DConditionModel(cfg("bfloat16")),
                           AutoencoderKLEncoder(VAEConfig(dtype_str="bfloat16"))
                           if kind in ("mv", "sd") else None)
                    for kind, cfg in (("mv", mvdream_config), ("rd", richdreamer_config),
                                      ("sd", sd21_teacher_config))}
    sg = geometry.space_generator
    runs = [
        (geometry, T.convert_unet(_zero_stride(ref.unet_state(sg.unet))), "space_generator/unet/"),
        (geometry, T.convert_vae(_zero_stride(ref.vae_state(sg.vae))), "space_generator/vae/"),
        (geometry, T.convert_adapters(_zero_stride(ref.adapter_state(geometry))), ""),
        (text, T.convert_clip_text(_zero_stride(ref.clip_text_state(text))), ""),
    ]
    for kind, (unet, vae) in teachers.items():
        if kind == "sd":  # diffusers
            runs += [(unet, T.convert_unet(_zero_stride(ref.unet_state(unet))), ""),
                     (vae, T.convert_vae(_zero_stride(ref.vae_state(vae))), "")]
        else:  # LDM with EMA shadows
            out = T.convert_ldm_teacher(_zero_stride(ref.ldm_teacher_state(unet, vae)))
            runs.append((unet, out["unet"], ""))
            if vae is not None:
                runs.append((vae, out["vae"], ""))
            else:
                assert not out["vae"]
    reached = {}
    for module, flat, prefix in runs:
        assert flat
        loaded, mismatched = T.apply_flat_to_module(flat, module, prefix)
        assert not mismatched, mismatched[:10]
        assert len(loaded) == len(flat)
        reached.setdefault(id(module), set()).update(loaded)
    modules = [geometry, text] + [m for pair in teachers.values() for m in pair if m is not None]
    n_params = 0
    for m in modules:
        names = {n for n, _ in m.named_parameters()}
        assert reached[id(m)] == names, sorted(names - reached[id(m)])[:10]
        n_params += sum(p.numel() for p in m.parameters())
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert n_params > 3_900_000_000  # student, text tower and three teachers
    assert peak < 256 * 2 ** 20, peak  # f32 weights would take 15 GiB
