"""The JAX package's flax ``msgpack`` files in the port and the port's out, on the CPU.

``triplaneturbo_torch/utils/msgpack_io.py`` is held byte for byte against
``flax.serialization.to_bytes`` (the tiny pipeline's geometry and text trees, the
port's own trees of torch tensors, a tree of bf16, f16, int32 and bool leaves with
numpy scalars and a complex, and a chunked leaf with the chunk size patched small on
both sides), and its reader against ``msgpack_restore`` bit for bit. Across the
packages: the JAX ``load_params`` reads a port-written ``geometry.msgpack`` bit-equal;
a directory of the JAX ``save_params`` loads through the port's ``from_pretrained``,
and its prompt matches the JAX pipeline's within ``tests/test_torch_pipeline.py``'s
tolerance (1e-4); ``{kind}_teacher.msgpack`` and ``clip_scorer.msgpack`` go both ways
(their trees shaped by ``jax.eval_shape`` of the JAX inits, so nothing compiles);
``system.weights=.../geometry.msgpack`` drives the launcher's ``--validate``; and
a file that leaves a parameter random, or does not fit, raises.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_pipeline import PIPE_KW, PROMPT, TINY_SG, TINY_TEXT, nonzero_adapters
from triplaneturbo_tpu.models.clip_text import CLIPTextConfig as JaxTextConfig
from triplaneturbo_tpu.models.clip_text import CLIPTextEncoder as JaxTextEncoder
from triplaneturbo_tpu.models.clip_vision import CLIPVisionConfig as JaxVisionConfig
from triplaneturbo_tpu.models.clip_vision import CLIPVisionEncoder as JaxVisionEncoder
from triplaneturbo_tpu.models.unet import UNet2DConditionModel as JaxUNet
from triplaneturbo_tpu.models.unet import mvdream_config as jax_mvdream_config
from triplaneturbo_tpu.models.unet import richdreamer_config as jax_richdreamer_config
from triplaneturbo_tpu.models.vae import AutoencoderKL as JaxVAE
from triplaneturbo_tpu.models.vae import VAEConfig as JaxVAEConfig
from triplaneturbo_tpu.pipelines.triplaneturbo_text_to_3d import (
    TriplaneTurboTextTo3DPipeline as JaxPipeline,
)
from triplaneturbo_tpu.utils import checkpoint as jckpt
from triplaneturbo_torch import launch
from triplaneturbo_torch.evaluation.clipscore import CLIPScorer, save_scorer
from triplaneturbo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from triplaneturbo_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline
from triplaneturbo_torch.systems.builder import build_system, build_teacher
from triplaneturbo_torch.utils import checkpoint as C
from triplaneturbo_torch.utils import msgpack_io as M
from triplaneturbo_torch.utils.config import load_config
from triplaneturbo_torch.utils.weights import (
    flax_tree_to_named,
    init_random_,
    module_to_flax_tree,
    named_to_flax_tree,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # tests/test_torch_pipeline.py's, f32 on both sides
TEACHER = dict(block_out_channels=(16, 32), layers_per_block=1, attention_head_dim=8,
               cross_attention_dim=32)
TEACHER_VAE = dict(block_out_channels=(8, 16), layers_per_block=1)
TINY_VISION = dict(image_size=64, patch_size=16, width=64, layers=2, heads=4, intermediate=128,
                   projection_dim=32)
TINY_CLIP_TEXT = dict(width=32, layers=2, heads=4, intermediate=64)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _numpy_tree(tree):
    """A tree of torch tensors as numpy, bf16 as ml_dtypes' (what the JAX package
    holds), in its key order (``jax.tree_util.tree_map`` sorts the keys)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return tree.detach().cpu().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return _np(tree)


def _assert_bit_equal(got, want, path="root"):
    """Trees equal leaf for leaf: same structure, dtype names and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(got, torch.Tensor):  # bf16 comes back as torch
        assert got.dtype == torch.bfloat16, path
        got = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, type(want)) or isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """The tiny JAX pipeline with nonzero adapters, its weights saved by the JAX
    ``save_params`` into a directory, and the port's pipeline from that directory."""
    jpipe = JaxPipeline.from_pretrained(
        None, space_generator_overrides=TINY_SG, text_config=JaxTextConfig(**TINY_TEXT),
        field_chunk=4096, **PIPE_KW)
    rng = np.random.default_rng(0)
    geo = nonzero_adapters(jpipe.geometry_params, rng)
    txt = nonzero_adapters(jpipe.text_params, rng)
    jpipe.geometry_params = jax.tree_util.tree_map(jnp.asarray, geo)
    jpipe.text_params = jax.tree_util.tree_map(jnp.asarray, txt)
    d = tmp_path_factory.mktemp("jax_dir")
    jckpt.save_params(str(d / "geometry.msgpack"), jpipe.geometry_params)
    jckpt.save_params(str(d / "text_encoder.msgpack"), jpipe.text_params)
    tpipe = TriplaneTurboTextTo3DPipeline.from_pretrained(
        str(d), device="cpu", seed=5, space_generator_overrides=TINY_SG,
        text_config=CLIPTextConfig(**TINY_TEXT), **PIPE_KW)
    return jpipe, tpipe, geo, txt


def _mixed_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
            "h": rng.normal(size=(4,)).astype(np.float16),
            "i": {"idx": rng.integers(-9, 2 ** 20, size=(2, 3)).astype(np.int32),
                  "mask": np.array([True, False, True]),
                  "empty": np.zeros((0, 2), np.float32), "scalar_array": np.array(2.5)},
            "np_scalars": {"f": np.float32(1.25), "i": np.int64(-3), "b": np.bool_(True)},
            "complex": 1.5 - 2.0j, "py": {"int": 70000, "neg": -200, "small": 7,
                                          "float": 0.1, "none": None, "flag": False,
                                          "s": "x" * 40, "u": "é"},
            "many": {f"k{i}": np.full((i,), i, np.float32) for i in range(17)}}


@pytest.mark.parametrize("case", ["geometry", "text", "mixed", "chunked"])
def test_encoder_writes_flax_bytes_and_decoder_reads_them(case, request, monkeypatch):
    if case == "chunked":  # a 63-element leaf in chunks of 16 f32 elements, both sides
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 64)
        rng = np.random.default_rng(4)
        tree = {"params": {"big": rng.normal(size=(7, 9)).astype(np.float32),
                           "bf": rng.normal(size=(40,)).astype(ml_dtypes.bfloat16),
                           "small": np.arange(3, dtype=np.float32)}}
    elif case == "mixed":
        tree = _mixed_tree()
    else:
        _, tpipe, geo, txt = request.getfixturevalue("pipes")
        tree = geo if case == "geometry" else txt
        module = tpipe.geometry if case == "geometry" else tpipe.text_encoder
        # the port's own tree of torch tensors writes what flax writes for it
        port = {"params": module_to_flax_tree(module)}
        assert M.dumps(port) == serialization.to_bytes(_numpy_tree(port))
    data = serialization.to_bytes(tree)
    assert M.dumps(tree) == data
    got = M.loads(data)
    _assert_bit_equal(got, serialization.msgpack_restore(data))
    if case == "chunked":
        assert b"__msgpack_chunked_array__" in data
        _assert_bit_equal(got, tree)


def test_port_layout_is_the_jax_tree_and_jax_reads_port_files(pipes, tmp_path):
    jpipe, tpipe, geo, txt = pipes
    for module, tree, template in ((tpipe.geometry, geo, jpipe.geometry_params),
                                   (tpipe.text_encoder, txt, jpipe.text_params)):
        port = module_to_flax_tree(module)
        # flax_tree_to_named inverts it, and it is the JAX tree, path for path
        named = flax_tree_to_named(port)
        params = dict(module.named_parameters())
        assert set(named) == set(params)
        for n, p in params.items():
            assert np.array_equal(named[n], _np(p)), n
        path = str(tmp_path / "weights.msgpack")
        C.save_params(path, module)
        restored = jckpt.load_params(path, template)
        _assert_bit_equal(_numpy_tree(restored), tree)


def test_port_serves_a_jax_written_directory(pipes):
    jpipe, tpipe, geo, txt = pipes
    for module, tree in ((tpipe.geometry, geo), (tpipe.text_encoder, txt)):
        named = flax_tree_to_named(tree["params"])
        for n, p in module.named_parameters():
            assert np.array_equal(_np(p), named[n]), n
    lat = np.random.default_rng(3).normal(size=(1, 6, 8, 8, 4)).astype(np.float32)
    jout = jpipe(PROMPT, latents=jnp.asarray(lat))
    tout = tpipe(PROMPT, latents=torch.from_numpy(lat))
    for k in ("latents", "space_cache"):
        np.testing.assert_allclose(_np(tout[k]), np.asarray(jout[k]), atol=ATOL)
    jm, tm = jout["mesh"][0], tout["mesh"][0]
    np.testing.assert_array_equal(_np(tm.t_mask), np.asarray(jm.t_mask))
    assert int(_np(tm.t_mask).sum()) > 0
    np.testing.assert_array_equal(_np(tm.t_pos_idx), np.asarray(jm.t_pos_idx))
    np.testing.assert_allclose(_np(tm.v_pos), np.asarray(jm.v_pos), atol=ATOL)
    vm = np.asarray(jm.v_mask)
    np.testing.assert_allclose(_np(tm.v_rgb)[vm], np.asarray(jm.v_rgb)[vm], atol=ATOL)


def _zeros_like_shapes(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)


def _jax_teacher_like(kind):
    """The JAX teacher's parameter trees (unet, vae or None) as zeros, from
    ``jax.eval_shape`` of the JAX builder's inits at the tiny sizes."""
    from dataclasses import replace

    ucfg = replace({"mv": jax_mvdream_config, "rd": jax_richdreamer_config}[kind]("float32"),
                   **TEACHER)
    unet = JaxUNet(ucfg)
    n = ucfg.adapters.joint_group if ucfg.adapters.joint_self_attention else 1
    x = jnp.zeros((n, 8, 8, 4))
    ctx = jnp.zeros((n, 77, ucfg.cross_attention_dim))
    cam = jnp.zeros((n, ucfg.camera_dim)) if ucfg.camera_dim else None
    key = jax.random.PRNGKey(0)
    ulike = _zeros_like_shapes(jax.eval_shape(
        lambda k: unet.init(k, x, jnp.zeros((n,)), ctx, cam), key))
    if kind == "rd":
        return ulike, None
    vae = JaxVAE(JaxVAEConfig(**TEACHER_VAE))
    vlike = _zeros_like_shapes(jax.eval_shape(
        lambda k: vae.init(k, jnp.zeros((1, 32, 32, 3)), method=vae.encode), key))
    return ulike, vlike


@pytest.mark.parametrize("kind", ["mv", "rd"])
def test_teacher_msgpack_goes_both_ways(kind, tmp_path):
    sizes = {**TEACHER, **{f"vae_{k}": v for k, v in TEACHER_VAE.items()}} if kind == "mv" \
        else dict(TEACHER)
    src = build_teacher(kind, torch.Generator().manual_seed(1), sizes, "bfloat16", "cpu")
    ulike, vlike = _jax_teacher_like(kind)
    # the JAX tool's file: {"unet": params, "vae": params or {}} in the JAX tree's order
    flat = {"unet": {"params": named_to_flax_tree(
        {n: p.float() for n, p in src.unet.named_parameters()}, ulike["params"])},
        "vae": {} if vlike is None else {"params": named_to_flax_tree(
            {n: p.float() for n, p in src.vae.named_parameters()}, vlike["params"])}}
    jax_file = str(tmp_path / f"{kind}_teacher.msgpack")
    with open(jax_file, "wb") as f:
        f.write(serialization.to_bytes(jax.tree_util.tree_map(
            lambda a: a.astype(ml_dtypes.bfloat16), flat)))
    dst = build_teacher(kind, torch.Generator().manual_seed(2), sizes, "bfloat16", "cpu",
                        ckpt_path=jax_file)
    got = C.load_teacher_params(jax_file, dst.unet, dst.vae)
    assert not got["unet"][1] and ("vae" in got) == (kind == "mv")
    for a, b in ((dst.unet, src.unet), (dst.vae, src.vae)):
        if a is not None:
            for (n, p), q in zip(a.named_parameters(), b.parameters()):
                assert p.dtype == torch.bfloat16 and torch.equal(p, q), n
    # the port's file, read by the JAX reader into the JAX templates
    port_file = C.save_teacher(str(tmp_path / "port" / f"{kind}_teacher.msgpack"),
                               src.unet, src.vae)
    uj, vj = jckpt.load_teacher_params(port_file, ulike, vlike)
    _assert_bit_equal(jax.tree_util.tree_map(np.asarray, uj),
                      _numpy_tree({"params": module_to_flax_tree(src.unet)}))
    if kind == "mv":
        _assert_bit_equal(jax.tree_util.tree_map(np.asarray, vj),
                          _numpy_tree({"params": module_to_flax_tree(src.vae)}))


class _TinyScorer(CLIPScorer):
    """``CLIPScorer`` at tiny sizes: random towers from ``seed``."""

    def __init__(self, seed: int = 0, device="cpu"):
        gen = torch.Generator().manual_seed(seed)
        vision = CLIPVisionEncoder(CLIPVisionConfig(**TINY_VISION))
        text = CLIPTextEncoder(CLIPTextConfig(**TINY_CLIP_TEXT))
        init_random_(vision, gen)
        init_random_(text, gen)
        super().__init__(vision=vision, text=text, seed=seed, device=device)


def test_scorer_msgpack_goes_both_ways(tmp_path):
    src = _TinyScorer(seed=7)
    key = jax.random.PRNGKey(0)
    size = TINY_VISION["image_size"]
    vlike = _zeros_like_shapes(jax.eval_shape(
        JaxVisionEncoder(JaxVisionConfig(**TINY_VISION)).init, key,
        jnp.zeros((1, size, size, 3))))
    tlike = _zeros_like_shapes(jax.eval_shape(
        JaxTextEncoder(JaxTextConfig(**TINY_CLIP_TEXT)).init, key,
        jnp.zeros((1, 77), jnp.int32)))
    tree = {"vision": {"params": named_to_flax_tree(dict(src.vision.named_parameters()),
                                                    vlike["params"])},
            "text": {"params": named_to_flax_tree(dict(src.text.named_parameters()),
                                                  tlike["params"])},
            "text_projection": _np(src.text_projection)}
    jax_file = tmp_path / "clip_scorer.msgpack"
    jax_file.write_bytes(serialization.to_bytes(tree))
    dst = _TinyScorer.from_checkpoint(str(jax_file), seed=0, device="cpu")
    img = torch.linspace(0, 1, 2 * 32 * 32 * 3).reshape(2, 32, 32, 3)
    assert torch.equal(dst.image_features(img), src.image_features(img))
    assert torch.equal(dst.text_features(["a cat"]), src.text_features(["a cat"]))
    port_file = save_scorer(str(tmp_path / "port" / "clip_scorer.msgpack"), src)
    with open(port_file, "rb") as f:
        restored = serialization.from_bytes({"vision": vlike, "text": tlike,
                                             "text_projection": tree["text_projection"]},
                                            f.read())
    _assert_bit_equal(jax.tree_util.tree_map(np.asarray, restored),
                      jax.tree_util.tree_map(np.asarray, tree))


def test_launcher_validates_from_a_jax_layout_geometry_msgpack(tmp_path):
    """``last/geometry.msgpack`` as the JAX launcher's ``save_params`` writes it (the
    geometry's ``{"params": tree}`` through ``flax.serialization.to_bytes``) drives
    ``--validate`` through ``system.weights``."""
    cfg_path = os.path.join(REPO, "configs", "smoke_tiny.yaml")
    src = build_system(load_config(cfg_path), seed=3, device="cpu")
    with torch.no_grad():  # nonzero adapters, so that the file differs from seed 0's init
        for n, p in src.geometry.named_parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(9)))
    weights = tmp_path / "trial" / "last" / "geometry.msgpack"
    weights.parent.mkdir(parents=True)
    weights.write_bytes(serialization.to_bytes(
        _numpy_tree({"params": module_to_flax_tree(src.geometry)})))
    lib = tmp_path / "lib"
    lib.mkdir()
    (lib / "tiny.json").write_text(json.dumps({"train": ["a red chair"], "val": ["a green frog"],
                                               "test": ["a wooden crate"]}))
    extras = {"trial_dir": str(tmp_path / "trial"), "exp_root_dir": str(tmp_path / "exp"),
              "data.prompt_library_dir": str(lib), "data.prompt_library": "tiny",
              "data.n_val_views": 2, "system.weights": str(weights)}
    trainer = launch.main(["--config", cfg_path, "--device", "cpu", "--validate",
                           *[f"{k}={v}" for k, v in extras.items()]])
    for (n, p), q in zip(trainer.geometry.named_parameters(), src.geometry.parameters()):
        assert torch.equal(p, q), n
    saved = os.listdir(tmp_path / "trial" / "save")
    assert "it0-val-0-grid.png" in saved


def test_strict_raises_on_a_file_that_leaves_a_parameter_random(pipes, tmp_path):
    """A ``.msgpack`` must fit its module as ``load_state_dict`` holds a ``.pt``: a
    parameter the file leaves random, a leaf of another shape and a leaf with no place
    each raise, in ``load_params`` (``from_pretrained``, ``system.weights``) and in the
    teacher's reader."""
    _, tpipe, _, _ = pipes
    tree = {"params": module_to_flax_tree(tpipe.text_encoder)}
    dropped = tree["params"].pop("final_layer_norm")
    path = str(tmp_path / "text_encoder.msgpack")
    C.save_msgpack(path, tree)
    enc = CLIPTextEncoder(CLIPTextConfig(**TINY_TEXT))
    with pytest.raises(ValueError, match="final_layer_norm.weight"):
        C.load_params(path, enc)
    tree["params"]["final_layer_norm"] = {k: v[:-1] for k, v in dropped.items()}
    C.save_msgpack(path, tree)
    with pytest.raises(ValueError, match="mismatch"):
        C.load_params(path, enc)
    tree["params"]["final_layer_norm"] = dict(dropped, extra=dropped["bias"])
    C.save_msgpack(path, tree)
    with pytest.raises(ValueError, match="mismatch"):
        C.load_params(path, enc)
    tree["params"]["final_layer_norm"] = dropped
    C.save_msgpack(path, tree)
    C.load_params(path, enc)
    for (n, p), q in zip(enc.named_parameters(), tpipe.text_encoder.parameters()):
        assert torch.equal(p, q), n
    # a teacher file whose UNet lacks a leaf
    sizes = {**TEACHER, **{f"vae_{k}": v for k, v in TEACHER_VAE.items()}}
    src = build_teacher("mv", torch.Generator().manual_seed(1), sizes, "bfloat16", "cpu")
    teacher = {"unet": C.flax_params(src.unet), "vae": C.flax_params(src.vae)}
    teacher["unet"]["params"].pop("conv_out")
    tpath = C.save_msgpack(str(tmp_path / "mv_teacher.msgpack"), teacher)
    with pytest.raises(ValueError, match="conv_out"):
        C.load_teacher_params(tpath, src.unet, src.vae)
