"""Port ops against the JAX package on the CPU: tokenizer, schedules, the
plain versions of both CUDA kernels against the Pallas kernels in interpret
mode, triplane sampling, the field on the grid, and marching cubes.

Inputs come from numpy with a seed and go through both packages.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

import triplaneturbo_tpu.ops.attention_pallas as jap
import triplaneturbo_tpu.ops.field_grid_pallas as jfg
import triplaneturbo_tpu.ops.isosurface as jiso
import triplaneturbo_tpu.ops.triplane as jtri
from triplaneturbo_tpu.models import schedulers as jsched
from triplaneturbo_tpu.models.geometry.triplane_field import (
    TriplaneField as JaxTriplaneField,
    TriplaneFieldConfig as JaxTriplaneFieldConfig,
)
from triplaneturbo_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from triplaneturbo_tpu.ops.grid_sample import grid_sample_2d_packed as j_gs_packed
from triplaneturbo_tpu.ops.grid_sample import pack_2x2 as j_pack
from triplaneturbo_torch.models import schedulers as tsched
from triplaneturbo_torch.models.geometry.triplane_field import (
    TriplaneField,
    TriplaneFieldConfig,
)
from triplaneturbo_torch.models.tokenizer import CLIPTokenizer
from triplaneturbo_torch.models.unet_blocks import Upsample2D
from triplaneturbo_torch.ops import field_grid as tfg
from triplaneturbo_torch.ops import flash_attention as tfa
from triplaneturbo_torch.ops import isosurface as tiso
from triplaneturbo_torch.ops import triplane as ttri
from triplaneturbo_torch.ops.grid_sample import grid_sample_2d_packed, pack_2x2
from triplaneturbo_torch.utils.weights import load_flax_params

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# -- tokenizer and schedules --------------------------------------------------


def test_tokenizer_ids_match():
    texts = ["a photo of a hamburger", "A  Corgi's HAT, 3 colors!", "", "x " * 100,
             "café ünïcode ✓"]
    np.testing.assert_array_equal(CLIPTokenizer().batch_encode(texts),
                                  JaxTokenizer().batch_encode(texts))


def test_tokenizer_bpe_ids_match(tmp_path):
    vocab = {t: i for i, t in enumerate(
        ["a</w>", "ph", "ot", "o</w>", "phot", "photo</w>", "h", "a", "m", "b", "u", "r",
         "g", "e", "ham", "burg", "er</w>", "of</w>"])}
    (tmp_path / "vocab.json").write_text(__import__("json").dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\np h\no t\nph ot\nphot o</w>\nh a\nha m\nb u\nbu r\nbur g\ne r</w>\n")
    texts = ["a photo of a hamburger", "photo photo"]
    np.testing.assert_array_equal(CLIPTokenizer.from_pretrained(str(tmp_path)).batch_encode(texts),
                                  JaxTokenizer.from_pretrained(str(tmp_path)).batch_encode(texts))


@pytest.mark.parametrize("schedule", ["scaled_linear", "linear"])
def test_schedule_timesteps_and_ddim_step_match(schedule):
    tcfg = tsched.SchedulerConfig(beta_schedule=schedule)
    jcfg = jsched.SchedulerConfig(beta_schedule=schedule)
    ts_, js_ = tsched.make_schedule(tcfg), jsched.make_schedule(jcfg)
    for name in ("betas", "alphas_cumprod", "final_alpha_cumprod"):
        np.testing.assert_allclose(getattr(ts_, name).numpy(), np.asarray(getattr(js_, name)),
                                   atol=1e-6)
    for n in (1, 4, 50):
        np.testing.assert_array_equal(tsched.ddim_timesteps(ts_, n), jsched.ddim_timesteps(js_, n))
    rng = _rng(0)
    sample, eps = _normal(rng, 1, 6, 8, 8, 4), _normal(rng, 1, 6, 8, 8, 4)
    for t in tsched.ddim_timesteps(ts_, 4):
        a = tsched.ddim_step(ts_, torch.from_numpy(eps), int(t), torch.from_numpy(sample), 4)
        b = jsched.ddim_step(js_, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(sample), 4)
        np.testing.assert_allclose(a.prev_sample.numpy(), np.asarray(b.prev_sample), atol=1e-6)
        np.testing.assert_allclose(a.pred_original_sample.numpy(),
                                   np.asarray(b.pred_original_sample), atol=1e-6)


# -- K1: flash attention --------------------------------------------------------


@pytest.mark.parametrize("BH,L,Lk,D", [(3, 256, 256, 64), (2, 700, 700, 64),
                                       (2, 300, 77, 64), (2, 128, 96, 512)])
def test_flash_attention_plain_matches_pallas_interpret(BH, L, Lk, D):
    rng = _rng(L + D)
    q, k, v = _normal(rng, BH, L, D), _normal(rng, BH, Lk, D), _normal(rng, BH, Lk, D)
    with pltpu.force_tpu_interpret_mode():
        ref = jap.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("L,Lk,D", [(40, 40, 64), (128, 77, 64), (96, 96, 64), (256, 256, 32)])
def test_attention_dispatcher_matches_einsum_path(L, Lk, D):
    rng = _rng(L)
    q, k, v = _normal(rng, 2, L, 4, D), _normal(rng, 2, Lk, 4, D), _normal(rng, 2, Lk, 4, D)
    ref = jap.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=False)
    out = tfa.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert out.shape == (2, L, 4, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("D", [32, 64, 128, 192, 256, 512])
def test_attention_gate_admits_only_head_sizes_the_kernels_take(D, monkeypatch):
    """Every call the gate sends to ``flash_attention`` passes the kernels' ``_check``
    (D = 128 or 256 used to reach it and raise on the card); the rest takes the
    einsum path, which matches the JAX package's."""
    sent = []

    def checked(q, k, v):
        tfa._check(q, k, v)
        sent.append(q.shape[-1])
        return tfa.flash_attention_reference(q, k, v)

    monkeypatch.setattr(tfa, "flash_attention", checked)
    rng = _rng(D)
    q, k, v = (_normal(rng, 1, 128, 2, D) for _ in range(3))
    out = tfa.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    ref = jap.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert sent == ([D] if D in tfa._HEAD_DIMS else [])


def test_attention_dispatcher_counts_no_launch_on_cpu():
    q = torch.randn(1, 256, 2, 64)
    before = tfa.LAUNCHES
    tfa.attention(q, q, q)
    assert tfa.LAUNCHES == before


# -- K2: field grid -------------------------------------------------------------


def _field_grid_inputs(seed, R=16, C=32, concat=False):
    rng = _rng(seed)
    cin = 3 * C if concat else C
    m = [_normal(rng, R, R, C, scale=0.3) for _ in range(3)]
    ws = [_normal(rng, cin, 64, scale=0.1), _normal(rng, 64, 64, scale=0.1),
          _normal(rng, 64, 1, scale=0.1), _normal(rng, cin, 64, scale=0.1),
          _normal(rng, 64, 64, scale=0.1), _normal(rng, 64, 3, scale=0.1)]
    return m + ws


@pytest.mark.parametrize("concat", [False, True])
def test_field_grid_plain_matches_pallas_interpret(concat):
    args = _field_grid_inputs(0, concat=concat)
    sdf_j, def_j = jfg.fused_field_grid(*map(jnp.asarray, args), 1.0, 0.5, concat, True)
    sdf_t, def_t = tfg.fused_field_grid(*map(torch.from_numpy, args), 1.0, 0.5, concat)
    assert sdf_t.shape == (16, 16, 16) and def_t.shape == (3, 16, 16, 16)
    np.testing.assert_allclose(sdf_t.numpy(), np.asarray(sdf_j), atol=2e-5)
    np.testing.assert_allclose(def_t.numpy(), np.asarray(def_j), atol=2e-5)


@pytest.mark.parametrize("concat", [False, True])
def test_field_grid_prep_folds_layer_one(concat):
    """The kernel's inputs (layer 1 folded into the planes) rebuild the plain field."""
    args = [torch.from_numpy(a) for a in _field_grid_inputs(1, R=8, concat=concat)]
    m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d = args
    a_xy, a_xz, a_zy, w2blk, w3t = tfg._prep(m_xy, m_xz, m_zy, w1s, w1d, w2s, w2d, w3s, w3d,
                                             concat)
    assert a_xy.shape == (8, 8, 128) and w2blk.shape == (128, 128) and w3t.shape == (8, 128)
    h1 = torch.relu(a_xy[:, :, None] + a_xz[:, None, :] + a_zy[None])  # [x, y, z, H]
    heads = torch.relu(h1 @ w2blk) @ w3t.T
    sdf, deform = tfg.field_grid_reference(*args, 1.0, 0.5, concat)
    world = torch.linspace(-1.0, 1.0, 8)
    g = torch.stack(torch.meshgrid(world, world, world, indexing="ij"), -1)
    np.testing.assert_allclose((heads[..., 0] + g.norm(dim=-1) - 0.5).numpy(), sdf.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(heads[..., 1:4].permute(3, 0, 1, 2).numpy(), deform.numpy(),
                               atol=1e-5)
    assert torch.count_nonzero(heads[..., 4:]) == 0


# -- triplane sampling and the field --------------------------------------------


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_rotate_and_sample_from_planes_match(mode):
    rng = _rng(2)
    cache = _normal(rng, 2, 6, 10, 10, 5)
    pts = rng.uniform(-1.1, 1.1, size=(2, 50, 3)).astype(np.float32)
    rt = ttri.rotate_planes(torch.from_numpy(cache), mode)
    rj = jtri.rotate_planes(jnp.asarray(cache), mode)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    for interp in ("v1", "v2"):
        st = ttri.sample_from_planes(rt[:, 0:3], torch.from_numpy(pts), interp)
        sj = jtri.sample_from_planes(rj[:, 0:3], jnp.asarray(pts), interp)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)


def test_packed_grid_sample_matches_jax_and_torch():
    rng = _rng(3)
    feats = _normal(rng, 3, 7, 9, 4)
    grid = rng.uniform(-1.2, 1.2, size=(3, 40, 2)).astype(np.float32)
    ft = torch.from_numpy(feats)
    out = grid_sample_2d_packed(pack_2x2(ft), torch.from_numpy(grid))
    ref_j = j_gs_packed(j_pack(jnp.asarray(feats)), jnp.asarray(grid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_j), atol=1e-5)
    ref_t = F.grid_sample(ft.permute(0, 3, 1, 2), torch.from_numpy(grid)[:, None], mode="bilinear",
                          padding_mode="zeros", align_corners=False)[:, :, 0].permute(0, 2, 1)
    np.testing.assert_allclose(out.numpy(), ref_t.numpy(), atol=1e-5)


@pytest.mark.parametrize("interp", ["v1", "v2"])
def test_triplane_on_grid_matches(interp):
    rng = _rng(4)
    planes = _normal(rng, 3, 12, 12, 6)
    coords = np.linspace(-1.0, 1.0, 9).astype(np.float32)
    np.testing.assert_allclose(
        ttri.bilinear_interp_matrix(torch.from_numpy(coords), 12).numpy(),
        np.asarray(jtri.bilinear_interp_matrix(jnp.asarray(coords), 12)), atol=1e-6)
    gt = ttri.sample_triplane_on_grid(torch.from_numpy(planes), torch.from_numpy(coords), interp)
    gj = jtri.sample_triplane_on_grid(jnp.asarray(planes), jnp.asarray(coords), interp)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)
    pts = rng.uniform(-1.5, 1.5, size=(30, 3)).astype(np.float32)
    bbox = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    for unbounded in (False, True):
        np.testing.assert_allclose(
            ttri.contract_to_unisphere(torch.from_numpy(pts), torch.from_numpy(bbox),
                                       unbounded).numpy(),
            np.asarray(jtri.contract_to_unisphere(jnp.asarray(pts), jnp.asarray(bbox), unbounded)),
            atol=1e-6)


@pytest.fixture(scope="module")
def fields():
    """A JAX TriplaneField with random weights and the port's copy of it."""
    cfg = JaxTriplaneFieldConfig()
    jfield = JaxTriplaneField(cfg)
    rng = _rng(5)
    cache = _normal(rng, 1, 6, 24, 24, 32, scale=0.3)
    params = jfield.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 3)), jnp.asarray(cache),
                         method=jfield.init_all)
    tfield = TriplaneField(TriplaneFieldConfig())
    load_flax_params(tfield, jax.tree_util.tree_map(np.asarray, params["params"]))
    return jfield, params, tfield, cache


def test_forward_field_grid_matches(fields):
    jfield, params, tfield, cache = fields
    sdf_j, def_j = jfield.apply(params, jnp.asarray(cache), 16, method=jfield.forward_field_grid)
    sdf_t, def_t = tfield.forward_field_grid(torch.from_numpy(cache), 16)
    assert sdf_t.shape == (16 ** 3, 1) and def_t.shape == (16 ** 3, 3)
    np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j), atol=1e-5)
    np.testing.assert_allclose(def_t.detach().numpy(), np.asarray(def_j), atol=1e-5)


def test_forward_field_and_export_match(fields):
    jfield, params, tfield, cache = fields
    pts = _rng(6).uniform(-1, 1, size=(1, 64, 3)).astype(np.float32)
    sdf_j, def_j = jfield.apply(params, jnp.asarray(pts), jnp.asarray(cache),
                                method=jfield.forward_field)
    sdf_t, def_t = tfield.forward_field(torch.from_numpy(pts), torch.from_numpy(cache))
    np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j), atol=1e-5)
    np.testing.assert_allclose(def_t.detach().numpy(), np.asarray(def_j), atol=1e-5)
    fj = jfield.apply(params, jnp.asarray(pts), jnp.asarray(cache), method=jfield.export)
    ft = tfield.export(torch.from_numpy(pts), torch.from_numpy(cache))
    np.testing.assert_allclose(ft["features"].detach().numpy(), np.asarray(fj["features"]),
                               atol=1e-5)


# -- marching cubes ---------------------------------------------------------------


def test_isosurface_tables_equal_jax_tables():
    for name in ("EDGE_CLASS_DIRS", "TET_EDGE_CLASS", "TET_EDGE_BASE", "TET_TRI_EDGES",
                 "TET_TRI_COUNT", "CELL_TRI_VALID", "CELL_TRI_CLASS", "CELL_TRI_BASE",
                 "CELL_TRI_COUNT", "CUBE_CORNER_OFFSETS", "CELL_TRI_CODE", "MC_TRI_CODE",
                 "MC_TRI_COUNT"):
        np.testing.assert_array_equal(getattr(tiso, name), getattr(jiso, name), err_msg=name)
    assert tiso.EDGE_CLASS_DIR_BITS == jiso.EDGE_CLASS_DIR_BITS
    assert tiso.MC_MAX_TRIS == jiso.MC_MAX_TRIS


@pytest.mark.parametrize("method", ["marching_cubes", "marching_tets"])
@pytest.mark.parametrize("max_verts,max_faces", [(8192, 8192), (8192, 300), (300, 8192)])
def test_isosurface_matches_index_for_index(method, max_verts, max_faces):
    """Also past either capacity, where both packages drop the same overflow."""
    R = 20
    rng = _rng(7)
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    sdf = (np.linalg.norm(g, axis=-1) - 0.6 + 0.1 * rng.normal(size=(R, R, R))).astype(np.float32)
    deform = _normal(rng, R, R, R, 3)
    kw = dict(max_verts=max_verts, max_faces=max_faces)
    mt = getattr(tiso, method)(torch.from_numpy(sdf), torch.from_numpy(deform), **kw)
    mj = getattr(jiso, method)(jnp.asarray(sdf), jnp.asarray(deform), **kw)
    np.testing.assert_array_equal(mt.face_mask.numpy(), np.asarray(mj.face_mask))
    np.testing.assert_array_equal(mt.vert_mask.numpy(), np.asarray(mj.vert_mask))
    np.testing.assert_array_equal(mt.faces.numpy(), np.asarray(mj.faces))
    assert int(mt.n_faces) == int(mj.n_faces) and int(mt.n_verts) == int(mj.n_verts)
    assert mt.vert_mask.any() and (mt.face_mask.any() or max_verts < 8192)
    np.testing.assert_allclose(mt.verts.numpy(), np.asarray(mj.verts), atol=1e-6)


# -- layouts the port had to get right ------------------------------------------------


def test_upsample_is_nearest_resize():
    rng = _rng(8)
    x = _normal(rng, 2, 5, 6, 3)  # NHWC
    resized = jax.image.resize(jnp.asarray(x), (2, 10, 12, 3), "nearest")
    ours = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), np.asarray(resized))
    up = Upsample2D(3)
    assert up(torch.from_numpy(x).permute(0, 3, 1, 2)).shape == (2, 3, 10, 12)


# -- import and device rules ---------------------------------------------------------


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import triplaneturbo_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'triplaneturbo_tpu', 'imageio', 'msgpack'))\n"
        "assert not bad, bad\n"
        "for name in ('systems.trainer', 'systems.optimizers', 'utils.schedule', 'utils.weights',\n"
        "             'ops.flash_attention', 'ops.field_grid', 'pipelines.triplaneturbo_text_to_3d',\n"
        "             'utils.camera', 'utils.ops', 'data.multiview_multiprompt', 'ops.rasterize',\n"
        "             'ops.hashgrid', 'models.background.hashgrid_env_map',\n"
        "             'models.materials.no_material', 'models.renderers.rasterize_renderer',\n"
        "             'ops.ray', 'models.renderers.volume_renderer',\n"
        "             'models.renderers.patch_renderer', 'models.guidance.asd_guidance',\n"
        "             'models.prompt_processors.callable_processor', 'systems.builder',\n"
        "             'systems.prompt_setup', 'models.vae', 'models.unet', 'models.clip_text',\n"
        "             'launch', 'utils.config', 'utils.misc', 'utils.checkpoint',\n"
        "             'utils.callbacks', 'utils.profiling', 'utils.saving',\n"
        "             'models.exporters.mesh_exporter', 'utils.convert_torch', 'utils.native',\n"
        "             'utils.uv_export', 'tools.convert_checkpoints', 'tools.reference_layout',\n"
        "             'utils.msgpack_io', 'utils.flops'):\n"
        "    assert 'triplaneturbo_torch.' + name in sys.modules, name\n"
        "print(len([n for n in sys.modules if n.startswith('triplaneturbo_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert int(out.stdout.strip()) >= 70


def test_pipeline_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TriplaneTurboTextTo3DPipeline.from_pretrained(None)


def test_wrappers_refuse_other_devices():
    q = torch.empty(1, 128, 64, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    m = torch.empty(8, 8, 32, device="meta")
    with pytest.raises(ValueError):
        tfg.fused_field_grid(m, m, m, *([None] * 6), 1.0, 0.5, False)
