"""The port's per-plane LoCon ("hexa_v1", ``PlaneLoConAdapter``) against the JAX package.

The JAX adapter is an ``nn.vmap`` of ``LoConAdapter`` over the planes with its
parameters stacked on a leading axis of 6; the port folds the planes into the
channels and runs two grouped convolutions. The flax parameters (every ``up`` leaf
drawn nonzero, so that the delta is not zero) are bridged into the port with
``load_flax_params``; inputs come from numpy. The tiny pipelines start from the
port's weights laid out as the JAX trees, so that the JAX pipeline's flax init need
not compile.

Tolerances, f32 on both sides: the adapter and ``AdaptedConv`` atol 1e-5 / rtol 1e-4;
the tiny student UNet and the tiny pipeline atol 1e-4 (as
``tests/test_torch_pipeline.py``: a UNet sums over many more terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import PIPE_KW, PROMPT, TINY_SG, TINY_TEXT, nonzero_adapters
from triplaneturbo_tpu.models.clip_text import CLIPTextConfig as JaxCLIPTextConfig
from triplaneturbo_tpu.models.lora import PlaneLoConAdapter as JaxPlaneLoCon
from triplaneturbo_tpu.models.unet_blocks import AdaptedConv as JaxAdaptedConv
from triplaneturbo_tpu.pipelines.triplaneturbo_text_to_3d import (
    TriplaneTurboTextTo3DPipeline as JaxPipeline,
)
from triplaneturbo_torch.models.clip_text import CLIPTextConfig
from triplaneturbo_torch.models.lora import PlaneLoConAdapter
from triplaneturbo_torch.models.unet_blocks import AdaptedConv
from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline
from triplaneturbo_torch.utils.weights import (
    flax_tree_to_named,
    init_random_,
    load_flax_params,
    named_to_flax_tree,
)

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
MODEL_ATOL = 1e-4
HEXA_SG = {**TINY_SG, "locon_type": "hexa_v1"}


def _nhwc_to_port(x):
    """[B, P, H, W, C] -> the port's [B * P, C, H, W]."""
    B, P, H, W, C = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.reshape(B * P, H, W, C).transpose(0, 3, 1, 2)))


def _port_to_nhwc(y, B, P):
    y = y.detach().numpy().transpose(0, 2, 3, 1)
    return y.reshape(B, P, *y.shape[1:])


@pytest.mark.parametrize("k, stride, pad, bias", [(3, 1, 1, False), (3, 2, 1, True),
                                                  (1, 1, 0, False)])
def test_plane_locon_adapter_matches(k, stride, pad, bias):
    B, P, H, W, C, out, r = 2, 6, 8, 8, 5, 7, 3
    x = np.random.default_rng(0).normal(size=(B, P, H, W, C)).astype(np.float32)
    jmod = JaxPlaneLoCon(out, n_planes=P, rank=r, kernel_size=(k, k), strides=(stride, stride),
                         padding=pad, with_bias=bias)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tree = nonzero_adapters(jax.tree_util.tree_map(np.asarray, params), np.random.default_rng(2))
    if bias:
        tree["params"]["planes"]["up"]["bias"] = np.random.default_rng(3).normal(
            size=(P, out)).astype(np.float32)
    assert tree["params"]["planes"]["down"]["kernel"].shape == (P, k, k, C, r)
    want = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))

    mine = PlaneLoConAdapter(C, out, n_planes=P, rank=r, kernel_size=k, stride=stride,
                             padding=pad, with_bias=bias)
    load_flax_params(mine, tree["params"])
    got = _port_to_nhwc(mine(_nhwc_to_port(x)), B, P)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    # the bridge back gives the flax tree bit for bit
    back = named_to_flax_tree({n: p for n, p in mine.named_parameters()}, tree["params"])
    for path, arr in flax_tree_to_named(tree["params"]).items():
        np.testing.assert_array_equal(flax_tree_to_named(back)[path], arr)


@pytest.mark.parametrize("k, stride, pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_adapted_conv_hexa_matches(k, stride, pad):
    B, P, H, W, C, out = 1, 6, 8, 8, 4, 6
    x = np.random.default_rng(4).normal(size=(B * P, H, W, C)).astype(np.float32)
    jmod = JaxAdaptedConv(out, kernel_size=(k, k), strides=(stride, stride), padding=pad,
                          locon_type="hexa_v1", locon_rank=2, n_planes=P)
    params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
    tree = nonzero_adapters(jax.tree_util.tree_map(np.asarray, params), np.random.default_rng(6))
    want = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                                 0.7))

    mine = AdaptedConv(C, out, kernel_size=k, stride=stride, padding=pad, locon_type="hexa_v1",
                       locon_rank=2, n_planes=P)
    load_flax_params(mine, tree["params"])
    mine.locon.planes["up"].weight.data *= 0.7  # the JAX lora_scale, folded into up
    got = mine(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), want,
                               atol=ATOL, rtol=RTOL)


def test_plane_locon_init_and_dtype():
    """Kaiming-uniform ``down`` (bound sqrt(6 / (k k C))), zero ``up``, f32 parameters; a
    bf16 input is computed in f32 and cast back."""
    mine = PlaneLoConAdapter(8, 4, n_planes=6, rank=3)
    init_random_(mine, torch.Generator().manual_seed(0))
    down = mine.planes["down"].weight.detach()
    bound = float(np.sqrt(6.0 / (3 * 3 * 8)))
    assert down.dtype == torch.float32 and down.shape == (18, 8, 3, 3)
    assert float(down.abs().max()) <= bound and float(down.abs().max()) > 0.8 * bound
    assert float(mine.planes["up"].weight.detach().abs().max()) == 0.0
    y = mine(torch.randn(12, 8, 5, 5, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (12, 4, 5, 5)
    assert float(y.detach().float().abs().max()) == 0.0
    with pytest.raises(ValueError, match="6-plane"):
        mine(torch.randn(5, 8, 5, 5))


def _shapes_only(fn):
    """Stands in for ``jax.jit`` around the JAX pipeline's two flax inits: their
    parameters as zeros of the right shapes (``jax.eval_shape``), so nothing compiles."""
    def shapes(*args):
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      jax.eval_shape(fn, *args))

    return shapes


@pytest.fixture(scope="module")
def hexa_pipes():
    """The tiny JAX and port pipelines with ``hexa_v1`` on the same weights: the port's
    drawn by ``init_random_`` (the flax initializers), laid out as the JAX pipeline's
    trees with ``named_to_flax_tree``, every adapter ``up`` then drawn nonzero, and the
    trees loaded into the port with ``load_flax_params``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _shapes_only)
        shapes = JaxPipeline.from_pretrained(
            None, space_generator_overrides=HEXA_SG, text_config=JaxCLIPTextConfig(**TINY_TEXT),
            field_chunk=4096, **PIPE_KW)
    tpipe = TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cpu", space_generator_overrides=HEXA_SG,
        text_config=CLIPTextConfig(**TINY_TEXT), **PIPE_KW)
    rng = np.random.default_rng(0)
    trees = {}
    for name, module, like in (("geometry", tpipe.geometry, shapes.geometry_params),
                               ("text", tpipe.text_encoder, shapes.text_params)):
        tree = named_to_flax_tree(dict(module.named_parameters()), like["params"])
        trees[name] = nonzero_adapters({"params": tree}, rng)
        load_flax_params(module, trees[name]["params"])
    # built again outside the patch: the pipeline jits its stages in __init__
    jpipe = JaxPipeline(
        cfg=shapes.cfg, geometry=shapes.geometry, text_encoder=shapes.text_encoder,
        tokenizer=shapes.tokenizer, schedule=shapes.schedule,
        geometry_params=jax.tree_util.tree_map(jnp.asarray, trees["geometry"]),
        text_params=jax.tree_util.tree_map(jnp.asarray, trees["text"]))
    return jpipe, tpipe


def test_hexa_student_unet_matches(hexa_pipes):
    jpipe, tpipe = hexa_pipes
    names = [n for n, _ in tpipe.geometry.named_parameters() if ".locon.planes." in n]
    assert names and all(n.startswith("space_generator.unet.") for n in names)
    rng = np.random.default_rng(1)
    noisy = rng.normal(size=(1, 6, 8, 8, 4)).astype(np.float32)
    text = rng.normal(size=(1, 77, 32)).astype(np.float32)
    je = jax.jit(lambda p, x, c: jpipe.geometry.apply(p, x, c, jnp.asarray(499),
                                                      method=jpipe.geometry.denoise))(
        jpipe.geometry_params, jnp.asarray(noisy), jnp.asarray(text))
    te = tpipe.geometry.denoise(torch.from_numpy(noisy), torch.from_numpy(text), 499)
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je), atol=MODEL_ATOL)


def test_hexa_pipeline_matches(hexa_pipes):
    jpipe, tpipe = hexa_pipes
    lat = np.random.default_rng(3).normal(size=(1, 6, 8, 8, 4)).astype(np.float32)
    jout = jpipe(PROMPT, latents=jnp.asarray(lat))
    tout = tpipe(PROMPT, latents=torch.from_numpy(lat))
    np.testing.assert_allclose(tout["latents"].numpy(), np.asarray(jout["latents"]),
                               atol=MODEL_ATOL)
    np.testing.assert_allclose(tout["space_cache"].numpy(), np.asarray(jout["space_cache"]),
                               atol=MODEL_ATOL)
    jm, tm = jout["mesh"][0], tout["mesh"][0]
    np.testing.assert_array_equal(tm.t_mask.numpy(), np.asarray(jm.t_mask))
    assert int(tm.t_mask.sum()) > 0
