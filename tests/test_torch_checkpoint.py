"""The port's checkpoint loaders against the JAX package's, on the CPU.

Reference-layout files are written from port modules with random weights
(``tools/reference_layout.py``). Two routes read each: route A is the port's
loader; route B the JAX package's loader (``load_torch_adapter``,
``load_teacher_params``, the converters) followed by the ``load_flax_params``
bridge into a port module. Every loaded leaf must be equal in both, and to its
source, bit for bit, with ``strict`` on. Covered: the adapter ``.pth``; an
SD-2.1-base diffusers directory plus the adapter through
``tools/convert_checkpoints.py`` (every geometry parameter), and the pipeline it
loads, whose fixed latents give the JAX pipeline's mesh; a diffusers teacher
directory; LDM ``.ckpt`` / ``.pt`` files whose EMA shadows win; a bare UNet dict;
the port's own ``{kind}_teacher.pt``; ``build_system`` with ``system.weights=*.pth``
and ``*_ckpt_path``; missing and truncated flax msgpack files, which raise (the files
themselves are ``tests/test_torch_msgpack.py``'s).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.models.clip_text import CLIPTextConfig as JaxCLIPTextConfig
from triplaneturbo_tpu.pipelines.triplaneturbo_text_to_3d import (
    TriplaneTurboTextTo3DPipeline as JaxPipeline,
)
from triplaneturbo_tpu.systems.builder import build_teacher as jax_build_teacher
from triplaneturbo_tpu.utils import checkpoint as JC
from triplaneturbo_tpu.utils import convert_torch as J
from triplaneturbo_torch.models.clip_text import CLIPTextConfig
from triplaneturbo_torch.models.vae import AutoencoderKLEncoder, VAEConfig
from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline
from triplaneturbo_torch.systems.builder import build_system, build_teacher
from triplaneturbo_torch.tools import convert_checkpoints as tool
from triplaneturbo_torch.tools import reference_layout as ref
from triplaneturbo_torch.utils import checkpoint as C
from triplaneturbo_torch.utils.config import load_config
from triplaneturbo_torch.utils.weights import load_flax_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SG = dict(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
               attention_head_dim=8, vae_block_out_channels=(16, 32), vae_layers_per_block=1,
               output_dim=8, training_type="self_lora_rank_4-cross_lora_rank_4-locon_rank_4")
TINY_TEXT = dict(vocab_size=49408, width=32, layers=2, heads=4, intermediate=64, max_length=77)
PIPE_KW = dict(latent_resolution=8, isosurface_resolution=24, max_verts=8192, max_faces=16384)
TEACHER = dict(block_out_channels=(16, 32), layers_per_block=1, attention_head_dim=8,
               cross_attention_dim=32)
SIZES = {"mv": {**TEACHER, "vae_block_out_channels": (8, 16), "vae_layers_per_block": 1},
         "rd": dict(TEACHER),
         "sd": {**TEACHER, "vae_block_out_channels": (8, 16), "vae_layers_per_block": 1}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_leaves_equal(names, *modules):
    """Each named parameter bit-equal across ``modules`` (dtype included)."""
    assert names
    params = [dict(m.named_parameters()) for m in modules]
    for n in names:
        first = params[0][n]
        for other in params[1:]:
            assert other[n].dtype == first.dtype and torch.equal(other[n], first), n


@torch.no_grad()
def _nonzero_adapters(module, seed):
    """Every LoRA / LoCon ``up`` drawn at random, so that the adapters contribute."""
    gen = torch.Generator().manual_seed(seed)
    for n, p in module.named_parameters():
        if re.search(r"\.up(\.weight)?$", n):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return module


def _port_pipe(seed, path=None):
    return TriplaneTurboTextTo3DPipeline.from_pretrained(
        path, seed=seed, device="cpu", space_generator_overrides=TINY_SG,
        text_config=CLIPTextConfig(**TINY_TEXT), **PIPE_KW)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The source pipeline (seed 0, adapters made nonzero), its SD-base directory (with
    the encoder, quant convs and 3-channel ``conv_out`` a real SD VAE has and the
    student lacks), its adapter ``.pth``, and the JAX pipeline of the same sizes."""
    d = tmp_path_factory.mktemp("ckpt")
    src = _port_pipe(0)
    _nonzero_adapters(src.geometry, 1)
    sd = ref.write_diffusers_dir(str(d / "sd21"), src.geometry.space_generator.unet,
                                 src.geometry.space_generator.vae, src.text_encoder)
    vae_bin = os.path.join(sd, "vae", "diffusion_pytorch_model.bin")
    vae = torch.load(vae_bin)
    extra = AutoencoderKLEncoder(VAEConfig(block_out_channels=TINY_SG["vae_block_out_channels"],
                                           layers_per_block=1))
    vae.update(ref.vae_state(extra))
    vae["decoder.conv_out.weight"] = torch.randn(3, 16, 3, 3)
    vae["decoder.conv_out.bias"] = torch.zeros(3)
    vae["post_quant_conv.weight"] = vae["post_quant_conv.weight"].clone()
    torch.save(vae, vae_bin)
    pth = ref.write_adapter(str(d / "triplane_turbo_sd_v1.pth"), src.geometry)
    jpipe = JaxPipeline.from_pretrained(
        None, space_generator_overrides=TINY_SG, text_config=JaxCLIPTextConfig(**TINY_TEXT),
        field_chunk=4096, **PIPE_KW)
    return dict(dir=d, src=src, sd=sd, pth=pth, jpipe=jpipe)


def _jax_student(files):
    """Route B for the student: the JAX converters onto the JAX trees (keys the tree
    lacks dropped, as the JAX tool does), then the JAX adapter loader."""
    jpipe = files["jpipe"]
    geo = jpipe.geometry_params
    for sub, conv, prefix in (("unet", J.convert_unet, "space_generator/unet/"),
                              ("vae", J.convert_vae, "space_generator/vae/")):
        flat = conv(JC._torch_state_numpy(
            os.path.join(files["sd"], sub, "diffusion_pytorch_model.bin")), n_blocks=2,
            layers_per_block=1)
        from flax.traverse_util import flatten_dict

        have = set(flatten_dict(geo["params"], sep="/"))
        flat = {k: v for k, v in flat.items() if prefix + k in have}
        geo, _, mismatched = J.apply_flat_to_tree(flat, geo, prefix=prefix)
        assert not mismatched
    geo = JC.load_torch_adapter(files["pth"], geo, strict=True)
    state = JC._torch_state_numpy(os.path.join(files["sd"], "text_encoder", "pytorch_model.bin"))
    txt, _, mismatched = J.apply_flat_to_tree(J.convert_clip_text(state, n_layers=2),
                                              jpipe.text_params)
    assert not mismatched
    return geo, txt


def test_adapter_pth_routes_agree(files):
    a = _port_pipe(5).geometry
    loaded, mismatched = C.load_torch_adapter(files["pth"], a, strict=True)
    assert not mismatched
    adapters = {n for n, _ in a.named_parameters()
                if any(t in n for t in ("lora", "locon", "retrofit")) or n.startswith("field.")}
    assert set(loaded) == adapters
    geo = JC.load_torch_adapter(files["pth"], files["jpipe"].geometry_params, strict=True)
    b = _port_pipe(6).geometry
    load_flax_params(b, _np_tree(geo)["params"])
    _assert_leaves_equal(loaded, a, b, files["src"].geometry)


def test_sd_base_and_adapter_convert_to_every_geometry_parameter(files, tmp_path):
    out = str(tmp_path)
    pipe = _port_pipe(7)
    stats = tool.convert_student(files["pth"], files["sd"], out, strict=True, pipe=pipe)
    n = len(list(pipe.geometry.parameters()))
    assert stats["params"] == n and stats["loaded"] == n and stats["not_loaded"] == 0
    assert stats["mismatched"] == 0 and stats["dropped"] > 0  # the SD VAE's encoder, conv_out
    text = tool.convert_text_encoder(files["sd"], out, strict=True, pipe=pipe)
    assert text["not_loaded"] == 0 and text["mismatched"] == 0
    geo, txt = _jax_student(files)
    b = _port_pipe(8)
    load_flax_params(b.geometry, _np_tree(geo)["params"])
    load_flax_params(b.text_encoder, _np_tree(txt)["params"])
    src = files["src"]
    for name, module in (("geometry", "geometry"), ("text_encoder", "text_encoder")):
        saved = torch.load(os.path.join(out, f"{name}.pt"), weights_only=True)
        for k, v in getattr(b, module).state_dict().items():
            assert torch.equal(saved[k], v) and torch.equal(
                saved[k], getattr(src, module).state_dict()[k]), k


def test_from_pretrained_directory_gives_the_jax_pipeline_mesh(files, tmp_path):
    out = str(tmp_path)
    pipe = _port_pipe(9)
    tool.convert_student(files["pth"], files["sd"], out, strict=True, pipe=pipe)
    tool.convert_text_encoder(files["sd"], out, strict=True, pipe=pipe)
    tool.write_config(out, files["sd"])
    tpipe = _port_pipe(11, out)  # a seed of its own: every weight must come from the files
    src = files["src"]
    for module in ("geometry", "text_encoder"):
        want = getattr(src, module).state_dict()
        for k, v in getattr(tpipe, module).state_dict().items():
            assert torch.equal(v, want[k]), k

    jpipe = files["jpipe"]
    geo, txt = _jax_student(files)
    jpipe.geometry_params, jpipe.text_params = geo, txt
    lat = np.random.default_rng(3).normal(size=(1, 6, 8, 8, 4)).astype(np.float32)
    prompt = "a photo of a hamburger"
    jout = jpipe(prompt, latents=jnp.asarray(lat))
    tout = tpipe(prompt, latents=torch.from_numpy(lat))
    # the serving parity tolerance of tests/test_torch_pipeline.py
    np.testing.assert_allclose(tout["latents"].numpy(), np.asarray(jout["latents"]), atol=1e-4)
    np.testing.assert_allclose(tout["space_cache"].numpy(), np.asarray(jout["space_cache"]),
                               atol=1e-4)
    jm, tm = jout["mesh"][0], tout["mesh"][0]
    np.testing.assert_array_equal(tm.t_mask.numpy(), np.asarray(jm.t_mask))
    np.testing.assert_array_equal(tm.v_mask.numpy(), np.asarray(jm.v_mask))
    assert int(tm.t_mask.sum()) > 0
    np.testing.assert_array_equal(tm.t_pos_idx.numpy(), np.asarray(jm.t_pos_idx))
    np.testing.assert_allclose(tm.v_pos.numpy(), np.asarray(jm.v_pos), atol=1e-4)
    vm = np.asarray(jm.v_mask)
    np.testing.assert_allclose(tm.v_rgb.numpy()[vm], np.asarray(jm.v_rgb)[vm], atol=1e-4)
    # an adapter .pth alone loads over the backbone the modules hold
    apipe = _port_pipe(0, files["pth"])
    _assert_leaves_equal([n for n, _ in apipe.geometry.named_parameters()], apipe.geometry,
                         src.geometry)


def _teacher(kind, seed):
    return build_teacher(kind, torch.Generator().manual_seed(seed), SIZES[kind], "float32", "cpu")


_JAX_TEACHERS = {}


def _jax_teacher(kind):
    """The JAX teacher's parameter trees (the templates its loader fills), built once."""
    if kind not in _JAX_TEACHERS:
        _JAX_TEACHERS[kind] = jax_build_teacher(kind, jax.random.PRNGKey(0), dict(SIZES[kind]),
                                                "float32")
    return _JAX_TEACHERS[kind]


def _jax_route(kind, path, port, with_vae=True):
    """Route B: the JAX loader (strict) on ``path``, bridged into the bundle ``port``."""
    jb = _jax_teacher(kind)
    ju, jv = JC.load_teacher_params(path, jb.unet_params, jb.vae_params if with_vae else None,
                                    n_blocks=2, layers_per_block=1, strict=True)
    load_flax_params(port.unet, _np_tree(ju)["params"])
    if with_vae and jv is not None:
        load_flax_params(port.vae, _np_tree(jv)["params"])
    return port


def _teacher_routes(kind, path, with_vae=True):
    """Route A (the port's loader, strict) and route B on ``path``; returns both
    bundles and what A loaded."""
    a = _teacher(kind, 21)
    vae_a = a.vae if with_vae else None
    got = C.load_teacher_params(path, a.unet, vae_a, n_blocks=2, layers_per_block=1, strict=True)
    return a, _jax_route(kind, path, _teacher(kind, 22), with_vae), got


def _write_teacher(case, tmp_path):
    kind = case.split("-")[0]
    src = _teacher(kind, 20)
    if case == "sd-diffusers":
        path = ref.write_diffusers_dir(str(tmp_path / "sd"), unet=src.unet, vae=src.vae)
    elif case == "mv-ldm-ckpt":  # Lightning wrapper, the weights in the EMA shadows
        path = str(tmp_path / "mv.ckpt")
        torch.save({"state_dict": ref.ldm_teacher_state(src.unet, src.vae), "epoch": 3}, path)
    elif case == "rd-ldm-pt":  # a bare LDM dict with EMA shadows, no first stage
        path = str(tmp_path / "rd.pt")
        torch.save(ref.ldm_teacher_state(src.unet), path)
    else:  # a bare diffusers UNet dict
        path = str(tmp_path / "unet.bin")
        torch.save(ref.unet_state(src.unet), path)
    return src, path


@pytest.mark.parametrize("case", ["sd-diffusers", "mv-ldm-ckpt", "rd-ldm-pt", "sd-bare-unet"])
def test_teacher_routes_agree(case, tmp_path):
    kind = case.split("-")[0]
    src, path = _write_teacher(case, tmp_path)
    with_vae = case != "sd-bare-unet"
    a, b, got = _teacher_routes(kind, path, with_vae)
    assert set(got["unet"][0]) == {n for n, _ in a.unet.named_parameters()}
    assert not got["unet"][1]
    _assert_leaves_equal(got["unet"][0], a.unet, b.unet, src.unet)
    if a.vae is not None and case != "sd-bare-unet":
        assert set(got["vae"][0]) == {n for n, _ in a.vae.named_parameters()}
        _assert_leaves_equal(got["vae"][0], a.vae, b.vae, src.vae)
    if case == "mv-ldm-ckpt":  # the model.* entries are zeros: equal to the source, the shadows won
        assert float(a.unet.conv_in.conv.weight.abs().max()) > 0


def test_teacher_vae_leaves_out_a_whole_vaes_decoder(tmp_path):
    """A real LDM teacher checkpoint holds the whole first stage; the teacher keeps the
    encoder, so the decoder half is left out and strict still holds."""
    src = _teacher("mv", 30)
    from triplaneturbo_torch.models.vae import AutoencoderKL

    state = ref.ldm_teacher_state(src.unet, src.vae)
    dec = AutoencoderKL(VAEConfig(block_out_channels=(8, 16), layers_per_block=1))
    for k, v in ref.vae_state(dec).items():
        state["first_stage_model." + ref.ldm_vae_key(k, 2)] = v
    path = str(tmp_path / "mv.pt")
    torch.save(state, path)
    a = _teacher("mv", 31)
    got = C.load_teacher_params(path, a.unet, a.vae, 2, 1, strict=True)
    _assert_leaves_equal([n for n, _ in a.vae.named_parameters()], a.vae, src.vae)
    assert not got["vae"][1]


def test_port_teacher_pt_from_the_tool(tmp_path):
    src, path = _write_teacher("mv-ldm-ckpt", tmp_path)
    stats = tool.convert_teacher("mv", path, str(tmp_path), strict=True, dtype_str="float32",
                                 device="cpu", sizes=SIZES["mv"])
    for part in ("unet", "vae"):
        assert stats[part]["not_loaded"] == 0 and stats[part]["mismatched"] == 0
    own = str(tmp_path / "mv_teacher.pt")
    loaded = build_teacher("mv", torch.Generator().manual_seed(40), SIZES["mv"], "float32", "cpu",
                           ckpt_path=own)
    for mine, theirs in ((loaded.unet, src.unet), (loaded.vae, src.vae)):
        _assert_leaves_equal([n for n, _ in mine.named_parameters()], mine, theirs)
    # RichDreamer has no VAE: its file holds an empty one
    rd_src, rd_path = _write_teacher("rd-ldm-pt", tmp_path)
    tool.convert_teacher("rd", rd_path, str(tmp_path), strict=True, dtype_str="float32",
                         device="cpu", sizes=SIZES["rd"])
    assert torch.load(str(tmp_path / "rd_teacher.pt"))["vae"] == {}
    rd = build_teacher("rd", torch.Generator().manual_seed(41), SIZES["rd"], "float32", "cpu",
                       ckpt_path=str(tmp_path / "rd_teacher.pt"))
    _assert_leaves_equal([n for n, _ in rd.unet.named_parameters()], rd.unet, rd_src.unet)


def test_build_system_reads_weights_pth_and_teacher_ckpt_paths(files, tmp_path):
    cfg_path = os.path.join(REPO, "configs", "smoke_tiny.yaml")
    src = build_system(load_config(cfg_path), seed=0, device="cpu")
    _nonzero_adapters(src.geometry, 2)
    pth = ref.write_adapter(str(tmp_path / "adapter.pth"), src.geometry)
    paths = {}
    for kind in ("mv", "rd", "sd"):
        t = getattr(src.guidance, kind)
        paths[kind] = str(tmp_path / f"{kind}.pt")
        torch.save(ref.ldm_teacher_state(t.unet, t.vae), paths[kind])
    cfg = load_config(cfg_path, cli_args=[f"system.weights={pth}"] + [
        f"system.guidance.{k}_ckpt_path={p}" for k, p in paths.items()])
    trainer = build_system(cfg, seed=3, device="cpu")
    adapters = [n for n, _ in trainer.geometry.named_parameters()
                if any(t in n for t in ("lora", "locon", "retrofit")) or n.startswith("field.")]
    # route B: the JAX loaders on the same files, bridged
    geo = JC.load_torch_adapter(pth, files["jpipe"].geometry_params, strict=True)
    b = build_system(load_config(cfg_path), seed=4, device="cpu")
    load_flax_params(b.geometry, _np_tree(geo)["params"])
    _assert_leaves_equal(adapters, trainer.geometry, b.geometry, src.geometry)
    sizes = load_config(cfg_path).system.teacher_sizes
    for kind in ("mv", "rd", "sd"):
        assert {k: tuple(v) if isinstance(v, list) else v for k, v in sizes[kind].items()} == \
            SIZES[kind]  # the JAX templates fit the config's teachers
        mine, theirs = getattr(trainer.guidance, kind), getattr(src.guidance, kind)
        other = _jax_route(kind, paths[kind], getattr(b.guidance, kind))
        for m in ("unet", "vae"):
            if getattr(mine, m) is not None:
                _assert_leaves_equal([n for n, _ in getattr(mine, m).named_parameters()],
                                     getattr(mine, m), getattr(other, m), getattr(theirs, m))


def test_msgpack_files_raise_naming_a20b(tmp_path):
    """Since A20b the msgpack files load (``tests/test_torch_msgpack.py``): a missing
    one raises ``FileNotFoundError``, a truncated one ``ValueError``, and a pipeline
    path must be a directory or an adapter ``.pth``. (The name is that of the A20b
    refusal this test held before these files loaded.)"""
    for call in (lambda: C.check_weights_format("geometry.msgpack"),
                 lambda: C.load_teacher_params("mv_teacher.msgpack", None),
                 lambda: C.maybe_load_pipeline_params("params.msgpack", None, None)):
        with pytest.raises(FileNotFoundError):
            call()
    (tmp_path / "geometry.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="truncated"):
        C.maybe_load_pipeline_params(str(tmp_path), None, None)
    with pytest.raises(FileNotFoundError):
        C.check_weights_format(str(tmp_path / "missing.pth"))
    with pytest.raises(FileNotFoundError):
        C.maybe_load_pipeline_params(str(tmp_path / "missing"), None, None)
    with pytest.raises(ValueError):
        C.check_weights_format("weights.bin")


def test_converter_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--out", str(tmp_path), "--adapter", "triplane_turbo_sd_v1.pth"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("case", ["adapter-only", "vae-key-missing", "vae-key-misshapen"])
def test_strict_conversion_refuses_a_partial_student(case, files, tmp_path):
    """``--strict`` fails where a student parameter would keep its random
    initialisation or a key under a tower the student has does not land; without it
    the counts say so."""
    sd = None
    if case != "adapter-only":
        import shutil

        sd = str(tmp_path / "sd21")
        shutil.copytree(files["sd"], sd)
        vae_bin = os.path.join(sd, "vae", "diffusion_pytorch_model.bin")
        vae = torch.load(vae_bin)
        key = "decoder.mid_block.resnets.0.conv1.weight"
        if case == "vae-key-missing":
            del vae[key]
        else:
            vae[key] = vae[key][:, :-1]
        torch.save(vae, vae_bin)
    out = str(tmp_path / "out")
    os.makedirs(out)
    match = "mismatch" if case == "vae-key-misshapen" else "not loaded"
    with pytest.raises(ValueError, match=match):
        tool.convert_student(files["pth"], sd, out, strict=True, pipe=_port_pipe(12))
    stats = tool.convert_student(files["pth"], sd, out, strict=False, pipe=_port_pipe(12))
    assert stats["not_loaded"] > 0 and stats["loaded"] + stats["not_loaded"] == stats["params"]
    assert stats["mismatched"] == (case == "vae-key-misshapen")


@pytest.mark.parametrize("case", ["empty-dir", "unknown-keys", "dir-without-vae"])
def test_teacher_loader_refuses_random_teachers(case, tmp_path):
    """A path that gives the UNet no tensor raises; a VAE left random raises with
    ``strict`` and is warned of without it."""
    a = _teacher("sd", 50)
    if case == "empty-dir":
        path = str(tmp_path)
    elif case == "unknown-keys":
        path = str(tmp_path / "other.pt")
        torch.save({"cond_stage_model.proj.weight": torch.zeros(2, 2)}, path)
    else:
        path = ref.write_diffusers_dir(str(tmp_path / "sd"), unet=_teacher("sd", 51).unet)
    if case != "dir-without-vae":
        with pytest.raises(ValueError, match="no tensor"):
            C.load_teacher_params(path, a.unet, a.vae, 2, 1)
        return
    with pytest.raises(ValueError, match="teacher vae: .* not loaded"):
        C.load_teacher_params(path, a.unet, a.vae, 2, 1, strict=True)
    got = C.load_teacher_params(path, a.unet, a.vae, 2, 1)
    assert set(got["unet"][0]) == {n for n, _ in a.unet.named_parameters()} and "vae" not in got


def test_pipeline_directory_without_one_of_its_files_raises(tmp_path):
    src = _port_pipe(60)
    C.save_params(str(tmp_path / "geometry.pt"), src.geometry)
    with pytest.raises(FileNotFoundError, match="text_encoder.pt"):
        _port_pipe(61, str(tmp_path))
    os.remove(tmp_path / "geometry.pt")
    C.save_params(str(tmp_path / "text_encoder.pt"), src.text_encoder)
    with pytest.raises(FileNotFoundError, match="geometry.pt"):
        _port_pipe(61, str(tmp_path))


def test_from_pretrained_rejects_unknown_arguments(tmp_path):
    """Keys of ``config.json`` that are not fields are left out (the JAX package's
    files may carry more); an unknown keyword argument raises."""
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboPipelineConfig,
    )

    with pytest.raises(TypeError, match="bogus"):
        TriplaneTurboTextTo3DPipeline.from_pretrained(None, device="cpu", bogus=1)
    (tmp_path / "config.json").write_text('{"dtype_str": "bfloat16", "field_chunk": 4096}')
    cfg = TriplaneTurboPipelineConfig.from_pretrained(str(tmp_path))
    assert cfg.dtype_str == "bfloat16"
    assert TriplaneTurboPipelineConfig.from_pretrained(str(tmp_path),
                                                       dtype_str="float32").dtype_str == "float32"
    with pytest.raises(TypeError, match="dtype"):
        TriplaneTurboPipelineConfig.from_pretrained(str(tmp_path), dtype="bfloat16")
