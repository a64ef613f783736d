"""The teachers and the ASD guidance of the PyTorch port against the JAX package on
the CPU.

Both packages get the same weights (random flax trees of the JAX package's own
``build_teacher``, bridged into the port's modules), the same images, cameras and
text states (numpy, seeded), and the same random draws: the JAX branches split
their key inside (MV ``split(key, 4)``, RD ``split(key, 3)``, SD ``split(key, 5)``),
and the test draws the port's :class:`GuidanceDraws` from the same splits. Tiny
teachers (two levels of 16 and 32 channels, one layer a block, head dim 8) and
images (32² and 16² renders; MV and SD at 16², RD at 8²).

Tolerances, f32 on both sides: losses and norms 1e-5 relative; a gradient or an
output within 1e-4 of its own largest value (sums run in other orders in XLA and
PyTorch, and the "dmd" weighting divides by sqrt(alpha_bar), 0.07 at t = 999).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.data.multiview_multiprompt import (
    DataModuleConfig as JaxDataModuleConfig,
    MultiviewMultipromptDataModule as JaxDataModule,
)
from triplaneturbo_tpu.models.guidance.asd_guidance import (
    ASDConfig as JaxASDConfig,
    ASDGuidance as JaxASDGuidance,
    _avg_pool_to as jax_avg_pool_to,
)
from triplaneturbo_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from triplaneturbo_tpu.models.vae import VAEConfig as JaxVAEConfig
from triplaneturbo_tpu.systems.builder import build_teacher as jax_build_teacher
from triplaneturbo_torch.models.guidance.asd_guidance import (
    ASDConfig,
    ASDGuidance,
    GuidanceDraws,
    TeacherBundle,
    _avg_pool_to,
    _resize,
)
from triplaneturbo_torch.models.vae import AutoencoderKLEncoder, VAEConfig
from triplaneturbo_torch.systems.builder import build_teacher
from triplaneturbo_torch.utils.weights import load_flax_params

torch.set_num_threads(2)

REL = 1e-5  # losses and norms
GRAD_REL = 1e-4  # of a gradient's (or an output's) largest value
TINY = dict(block_out_channels=(16, 32), layers_per_block=1, attention_head_dim=8,
            cross_attention_dim=32)
TINY_VAE = dict(vae_block_out_channels=(8, 16), vae_layers_per_block=1)
SIZES = {"mv": {**TINY, **TINY_VAE}, "rd": dict(TINY), "sd": {**TINY, **TINY_VAE}}
IMAGE_SIZES = dict(mv_image_size=16, rd_image_size=8, sd_image_size=16)
VIEWS, HW1, HW2, MIN_STEP, MAX_STEP = 8, 32, 16, 20, 980
WEIGHTINGS = ("dmd", "sds", "uniform", "fantasia3d", "sds_sqrt")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what, rel=GRAD_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, atol=rel * max(float(np.abs(want).max()), 1e-12),
                               rtol=0, err_msg=what)


def _scalar_close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=REL, atol=0, err_msg=what)


def _port_teacher(kind, jbundle):
    """The port's teacher of ``kind`` with the JAX bundle's weights."""
    bundle = build_teacher(kind, torch.Generator().manual_seed(0), SIZES[kind], "float32", "cpu")
    load_flax_params(bundle.unet, jax.tree_util.tree_map(np.asarray, jbundle.unet_params)["params"])
    if bundle.vae is not None:
        load_flax_params(bundle.vae, jax.tree_util.tree_map(np.asarray, jbundle.vae_params)["params"])
    return bundle


@pytest.fixture(scope="module")
def teachers():
    """(JAX guidance, port guidance) over the same tiny teachers."""
    jb = {kind: jax_build_teacher(kind, jax.random.PRNGKey(i), SIZES[kind], "float32")
          for i, kind in enumerate(("mv", "rd", "sd"))}
    tb = {kind: _port_teacher(kind, b) for kind, b in jb.items()}
    return (JaxASDGuidance(JaxASDConfig(**IMAGE_SIZES), **jb),
            ASDGuidance(ASDConfig(**IMAGE_SIZES), **tb))


def _draws_from_key(kind, key, views, dual, latent_hw, n_view=4):
    """The port's draws of one branch call, from the JAX branch's own key splits."""
    prompts = views // n_view
    images = views * (2 if dual else 1)
    view = None
    if kind == "mv":
        k_t, k_p, k_n, k_e = jax.random.split(key, 4)
    elif kind == "rd":
        (k_t, k_p, k_n), k_e = jax.random.split(key, 3), None
    else:
        k_v, k_t, k_p, k_n, k_e = jax.random.split(key, 5)
        view = jax.random.randint(k_v, (prompts,), 0, n_view)
        images = prompts * (2 if dual else 1)
    n_t = images if kind == "sd" else images // n_view
    t = jax.random.randint(k_t, (n_t,), MIN_STEP, MAX_STEP)
    u = jax.random.uniform(k_p, (n_t,))
    shape = (images, latent_hw, latent_hw, 4)
    noise = jax.random.normal(k_n, shape)
    eps = None if k_e is None else jax.random.normal(k_e, shape)

    def tt(x, long=False):
        return None if x is None else torch.tensor(np.asarray(x)).to(
            torch.long if long else torch.float32)

    return GuidanceDraws(tt(t, True), tt(u), tt(noise), tt(eps), tt(view, True))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    cfg = JaxDataModuleConfig(batch_size=VIEWS, n_view=4, height=HW1, width=HW1,
                              ray_height=HW2, ray_width=HW2, n_steps=1)
    batch = JaxDataModule(cfg, seed=seed).sample_train_batch()[0]
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return dict(c2w=batch["c2w"], dist=batch["camera_distances_relative"],
                rgb=u(VIEWS, HW1, HW1, 3), rgb2=u(VIEWS, HW2, HW2, 3),
                normal=u(VIEWS, HW1, HW1, 3), disp=u(VIEWS, HW1, HW1, 1),
                normal2=u(VIEWS, HW2, HW2, 3), disp2=u(VIEWS, HW2, HW2, 1),
                cond=rng.normal(size=(2, 77, 32)).astype(np.float32),
                uncond=rng.normal(size=(2, 77, 32)).astype(np.float32) * 0.1)


# -- the teacher UNets and the VAE encoder ------------------------------------


@pytest.mark.parametrize("kind", ["mv", "rd", "sd"])
def test_teacher_unet_matches(teachers, kind):
    jg, tg = teachers
    jb, tb = getattr(jg, kind), getattr(tg, kind)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 8, 8, 4)).astype(np.float32)
    t = np.array([1, 999, 500, 37, 250, 750, 3, 998], np.int32)
    ctx = rng.normal(size=(8, 77, 32)).astype(np.float32)
    cam = rng.normal(size=(8, 16)).astype(np.float32) if kind != "sd" else None
    want = jb.unet.apply(jb.unet_params, x, t, ctx, cam)
    with torch.no_grad():
        got = tb.unet(torch.tensor(x), torch.tensor(t).long(), torch.tensor(ctx),
                      None if cam is None else torch.tensor(cam))
    _close(got, want, f"{kind} unet")
    if kind == "rd":
        # the fixed head count: 8 heads at every level, dim_head = channels // 8
        attn = tb.unet.down_0_attn_0.transformer_blocks_0.attn1
        assert (attn.heads, attn.dim_head) == (8, 2)
    if cam is not None:
        # with a camera_dim but no camera, the camera embedding adds nothing (as in JAX)
        want = jb.unet.apply(jb.unet_params, x, t, ctx, None)
        with torch.no_grad():
            got = tb.unet(torch.tensor(x), torch.tensor(t).long(), torch.tensor(ctx))
        _close(got, want, f"{kind} unet without a camera")


@pytest.mark.parametrize("hw", [16, 20, 21])
def test_vae_encoder_moments_and_encode_match(hw):
    cfg = dict(block_out_channels=(8, 16, 16), layers_per_block=1)
    jvae = JaxAutoencoderKL(JaxVAEConfig(**cfg))
    img = np.random.default_rng(hw).uniform(-1, 1, (2, hw, hw, 3)).astype(np.float32)
    params = jvae.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), method=jvae.encode)
    vae = AutoencoderKLEncoder(VAEConfig(**cfg))
    load_flax_params(vae, jax.tree_util.tree_map(np.asarray, params)["params"])
    x = torch.tensor(img)
    moments = jvae.apply(params, img, method=jvae.encode_moments)
    with torch.no_grad():
        _close(vae.encode_moments(x), moments, "moments")
        key = jax.random.PRNGKey(9)
        eps = jax.random.normal(key, moments.shape[:-1] + (4,))
        _close(vae.encode(x, torch.tensor(np.asarray(eps))),
               jvae.apply(params, img, key, method=jvae.encode), "encode with noise")
        _close(vae.encode(x, scale=False), jvae.apply(params, img, None, False, method=jvae.encode),
               "encode, mean, unscaled")


def test_vae_encoder_in_bf16_keeps_quant_conv_in_f32():
    """A bf16 teacher VAE: encoder in bf16, quant_conv's bf16-stored weights applied in
    f32, as the flax conv without a dtype promotes them. Held to 2e-2 of the largest
    moment (bf16 products summed in other orders)."""
    cfg = dict(block_out_channels=(8, 16), layers_per_block=1)
    jvae = JaxAutoencoderKL(JaxVAEConfig(dtype_str="bfloat16", **cfg))
    params = jvae.init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3)), method=jvae.encode)
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    img = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    vae = AutoencoderKLEncoder(VAEConfig(dtype_str="bfloat16", **cfg))
    load_flax_params(vae, jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32), params)["params"])
    assert vae.quant_conv.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = vae.encode_moments(torch.tensor(img))
    assert got.dtype == torch.float32
    _close(got, jvae.apply(params, img, method=jvae.encode_moments), "bf16 moments", rel=2e-2)


# -- the ASD pieces -------------------------------------------------------------


def test_get_t_plus_truncates_as_the_jax_package():
    jg, tg = JaxASDGuidance(JaxASDConfig()), ASDGuidance(ASDConfig())
    t = np.concatenate([np.arange(0, 1000, 7), [998, 999, 1, 19, 20, 21]]).astype(np.int32)
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, t.shape)
    for ratio, rand, min_step in ((0.1, True, 20), (0.5, True, 0), (0.3, False, 20),
                                  (2.0, True, 100)):
        want = jg.get_t_plus(key, jnp.asarray(t), ratio, rand, jnp.int32(min_step))
        got = tg.get_t_plus(torch.tensor(t).long(), torch.tensor(np.asarray(u)), ratio, rand,
                            min_step)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_dual_ctx_avg_pool_and_cameras_match():
    rng = np.random.default_rng(2)
    text = rng.normal(size=(2, 77, 8)).astype(np.float32)
    for batch, dual in ((8, False), (16, True)):
        np.testing.assert_array_equal(
            _np(ASDGuidance._dual_ctx(torch.tensor(text), batch, dual)),
            np.asarray(JaxASDGuidance._dual_ctx(None, jnp.asarray(text), batch, dual)))
    x = rng.normal(size=(3, 32, 32, 4)).astype(np.float32)
    for size in (8, 16, 32):
        _close(_avg_pool_to(torch.tensor(x), size), jax_avg_pool_to(jnp.asarray(x), size),
               f"pool {size}", rel=1e-6)
    batch = _inputs(0)
    c2w = batch["c2w"]
    _close(ASDGuidance._mv_camera(torch.tensor(c2w)), JaxASDGuidance._mv_camera(jnp.asarray(c2w)),
           "mv camera", rel=1e-6)
    d = batch["dist"] * 2.0
    _close(ASDGuidance._rd_camera(torch.tensor(c2w), torch.tensor(d)),
           JaxASDGuidance._rd_camera(jnp.asarray(c2w), jnp.asarray(d)), "rd camera", rel=1e-6)


@pytest.mark.parametrize("src,dst", [(32, 16), (16, 32), (8, 32), (128, 256), (512, 256),
                                     (16, 16), (12, 8)])
def test_resize_matches_jax_image_resize(src, dst):
    """Bilinear without antialiasing, shrinking and enlarging: the edges are where
    ``F.interpolate`` (clamped source index) and ``jax.image.resize`` (renormalised
    weights) could part."""
    x = np.random.default_rng(src + dst).uniform(size=(2, src, src, 3)).astype(np.float32)
    want = jax.image.resize(x, (2, dst, dst, 3), "bilinear", antialias=False)
    got = _resize(torch.tensor(x), dst)
    _close(got, want, f"resize {src} -> {dst}", rel=1e-6)
    # the edge rows and columns on their own
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(_np(got)[sl], np.asarray(want)[sl], atol=1e-6, rtol=0)


@pytest.mark.parametrize("weighting", WEIGHTINGS)
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_asd_loss_matches(weighting, dual):
    rng = np.random.default_rng(3)
    B = 8 if dual else 4
    lat, p_text, p_uncond, p_second = (rng.normal(size=(B, 8, 8, 4)).astype(np.float32)
                                       for _ in range(4))
    t = np.array([999, 998, 500, 20, 21, 700, 5, 250][:B], np.int32)
    jg, tg = JaxASDGuidance(JaxASDConfig()), ASDGuidance(ASDConfig())

    def jloss(lat_):
        loss, gn = jg._asd_loss(lat_, p_text, p_uncond, p_second, jnp.asarray(t), 7.5,
                                weighting, dual)
        return loss.sum(), (loss, gn)

    (_, (loss_j, gn_j)), grad_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(lat))
    lat_t = torch.tensor(lat, requires_grad=True)
    loss_t, gn_t = tg._asd_loss(lat_t, *(torch.tensor(a) for a in (p_text, p_uncond, p_second)),
                                torch.tensor(t).long(), 7.5, weighting, dual)
    (grad_t,) = torch.autograd.grad(loss_t.sum(), lat_t)
    _scalar_close(loss_t, loss_j, "loss")
    _scalar_close(gn_t, gn_j, "grad norm")
    _close(grad_t, grad_j, "d loss / d latents")


# -- the branches -----------------------------------------------------------------


def _run_branch(kind, jg, tg, x, dual, seed):
    """The JAX branch and the port's with the same draws: (loss, grad norm, d loss /
    d each image) of each package."""
    key = jax.random.PRNGKey(seed)
    scale = {"mv": 10.0, "rd": 5.0, "sd": 7.5}[kind]
    if kind == "rd":
        names = ["normal", "disp"] + (["normal2", "disp2"] if dual else [])
    else:
        names = ["rgb"] + (["rgb2"] if dual else [])
    imgs = {n: x[n] for n in names}
    jx = {k: jnp.asarray(x[k]) for k in ("cond", "uncond", "c2w", "dist")}

    def jfn(im):
        if kind == "mv":
            o = jg.mv_branch(key, im["rgb"], jx["cond"], jx["uncond"], jx["c2w"], MIN_STEP, MAX_STEP,
                             scale, rgb_2nd=im.get("rgb2"))
        elif kind == "rd":
            o = jg.rd_branch(key, im["normal"], im["disp"], jx["cond"], jx["uncond"], jx["c2w"],
                             jx["dist"], MIN_STEP, MAX_STEP, scale, normal_2nd=im.get("normal2"),
                             disparity_2nd=im.get("disp2"))
        else:
            o = jg.sd_branch(key, im["rgb"], jx["cond"], jx["uncond"], MIN_STEP, MAX_STEP, scale,
                             rgb_2nd=im.get("rgb2"))
        return o["loss_asd"].sum(), (o["loss_asd"], o["grad_norm"])

    (_, (loss_j, gn_j)), grads_j = jax.jit(jax.value_and_grad(jfn, has_aux=True))(imgs)
    hw = {"mv": 8, "rd": 8, "sd": 8}[kind]
    draws = _draws_from_key(kind, key, VIEWS, dual, hw)
    t_imgs = {n: torch.tensor(v, requires_grad=True) for n, v in imgs.items()}
    cond, uncond, c2w = (torch.tensor(x[k]) for k in ("cond", "uncond", "c2w"))
    if kind == "mv":
        o = tg.mv_branch(draws, t_imgs["rgb"], cond, uncond, c2w, MIN_STEP, scale,
                         rgb_2nd=t_imgs.get("rgb2"))
    elif kind == "rd":
        o = tg.rd_branch(draws, t_imgs["normal"], t_imgs["disp"], cond, uncond, c2w,
                         torch.tensor(x["dist"]), MIN_STEP, scale,
                         normal_2nd=t_imgs.get("normal2"), disparity_2nd=t_imgs.get("disp2"))
    else:
        o = tg.sd_branch(draws, t_imgs["rgb"], cond, uncond, MIN_STEP, scale,
                         rgb_2nd=t_imgs.get("rgb2"))
    grads_t = dict(zip(t_imgs, torch.autograd.grad(o["loss_asd"].sum(), list(t_imgs.values()))))
    return (o["loss_asd"], o["grad_norm"], grads_t), (loss_j, gn_j, grads_j)


@pytest.mark.parametrize("kind", ["mv", "rd", "sd"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_branch_matches(teachers, kind, dual):
    jg, tg = teachers
    x = _inputs(4)
    (loss_t, gn_t, grads_t), (loss_j, gn_j, grads_j) = _run_branch(kind, jg, tg, x, dual, 11)
    assert tuple(loss_t.shape) == ((2,) if dual else ())
    _scalar_close(loss_t, loss_j, f"{kind} loss")
    _scalar_close(gn_t, gn_j, f"{kind} grad norm")
    for n, g in grads_t.items():
        assert float(g.abs().max()) > 0, n
        _close(g, grads_j[n], f"{kind} d loss / d {n}")


def test_teacher_math_is_stop_gradiented(teachers):
    """No teacher parameter takes a gradient, and no UNet keeps a graph: each runs
    under no_grad, and only the VAE encode (and RD's pooling) reach the images."""
    _, tg = teachers
    seen = []
    hooks = [b.unet.register_forward_hook(
        lambda m, a, out: seen.append((torch.is_grad_enabled(), out.grad_fn)))
        for b in (tg.mv, tg.rd, tg.sd)]
    try:
        for kind in ("mv", "rd", "sd"):
            _run_branch(kind, teachers[0], tg, _inputs(5), True, 12)
    finally:
        for h in hooks:
            h.remove()
    assert seen and all(not enabled and fn is None for enabled, fn in seen), seen
    for b in (tg.mv, tg.rd, tg.sd):
        for m in (b.unet, b.vae):
            if m is None:
                continue
            for n, p in m.named_parameters():
                assert not p.requires_grad and p.grad is None, n


def test_build_teacher_is_frozen_bf16_and_refuses_a_checkpoint():
    gen = torch.Generator().manual_seed(0)
    mv = build_teacher("mv", gen, SIZES["mv"], "bfloat16", "cpu")
    rd = build_teacher("rd", gen, SIZES["rd"], "bfloat16", "cpu")
    assert isinstance(mv, TeacherBundle) and mv.vae is not None and rd.vae is None
    for m in (mv.unet, mv.vae, rd.unet):
        for n, p in m.named_parameters():
            assert p.dtype == torch.bfloat16 and not p.requires_grad, n
    assert mv.unet.cfg.camera_dim == 16 and rd.unet.cfg.cross_attention_dim == 32
    # a teacher's own msgpack file (the JAX package's format, A20b) loads back bit-equal
    import tempfile

    from triplaneturbo_torch.utils.checkpoint import save_teacher

    with tempfile.TemporaryDirectory() as d:
        path = save_teacher(os.path.join(d, "mv_teacher.msgpack"), mv.unet, mv.vae)
        back = build_teacher("mv", torch.Generator().manual_seed(1), SIZES["mv"], "bfloat16",
                             "cpu", ckpt_path=path)
    for a, b in ((back.unet, mv.unet), (back.vae, mv.vae)):
        for (n, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), n
    # a missing file
    with pytest.raises(FileNotFoundError):
        build_teacher("sd", gen, SIZES["sd"], "bfloat16", "cpu", ckpt_path="sd_teacher.msgpack")
    with pytest.raises(FileNotFoundError):
        build_teacher("sd", gen, SIZES["sd"], "bfloat16", "cpu", ckpt_path="sd.ckpt")
    with pytest.raises(ValueError):
        build_teacher("xx", gen)
