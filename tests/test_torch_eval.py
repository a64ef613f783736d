"""The port's evaluation harness against the JAX package's, on the CPU.

Covers ``preprocess_for_clip`` (the antialiased bilinear resize at 512 -> 224 and
64 -> 32), a tiny ``CLIPVisionEncoder`` (the sizes of ``tests/test_eval_harness.py``),
``CLIPScorer.score`` (scores and R@1), ``convert_clip_vision`` on a synthetic
HF-layout state dict, ``render_mesh_views`` (images, and the overflow counts that the
JAX renderer drops, held against the JAX ``rasterize`` called directly), the kire
rig, ``run_eval.main`` on a tiny pipeline, and the schedulers' ``velocity`` and
``ddpm_step``. The JAX modules' parameters are bridged into the port with
``load_flax_params``; inputs come from numpy.

Tolerances, f32 on both sides: atol 1e-5 / rtol 1e-4 (the towers' features, the
images, the scheduler steps); the resize 1e-5 absolute on images in [0, 1]; the
scores 1e-5 absolute; R@1, the overflow counts and the converted arrays exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.evaluation import mesh_render as jmr
from triplaneturbo_tpu.evaluation.clipscore import CLIPScorer as JaxScorer
from triplaneturbo_tpu.models import schedulers as jsched
from triplaneturbo_tpu.models.clip_text import CLIPTextConfig as JaxTextConfig
from triplaneturbo_tpu.models.clip_text import CLIPTextEncoder as JaxTextEncoder
from triplaneturbo_tpu.models.clip_vision import CLIPVisionConfig as JaxVisionConfig
from triplaneturbo_tpu.models.clip_vision import CLIPVisionEncoder as JaxVisionEncoder
from triplaneturbo_tpu.models.clip_vision import preprocess_for_clip as jax_preprocess
from triplaneturbo_tpu.ops.rasterize import rasterize as jax_rasterize
from triplaneturbo_tpu.utils.convert_torch import convert_clip_vision as jax_convert_clip_vision
from triplaneturbo_tpu.utils.mesh import Mesh as JaxMesh
from triplaneturbo_torch.evaluation import mesh_render as tmr
from triplaneturbo_torch.evaluation import run_eval
from triplaneturbo_torch.evaluation.clipscore import (
    CLIPScorer,
    W,
    clip_b32_text_config,
    load_hf_clip,
)
from triplaneturbo_torch.models import schedulers as tsched
from triplaneturbo_torch.ops.isosurface import marching_tets
from triplaneturbo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from triplaneturbo_torch.models.clip_vision import (
    CLIPVisionConfig,
    CLIPVisionEncoder,
    preprocess_for_clip,
)
from triplaneturbo_torch.utils.convert_torch import convert_clip_vision
from triplaneturbo_torch.utils.mesh import Mesh
from triplaneturbo_torch.utils.misc import fold_seed
from triplaneturbo_torch.utils.weights import init_random_, load_flax_params, named_to_flax_tree

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
TINY_VISION = dict(image_size=64, patch_size=16, width=64, layers=2, heads=4, intermediate=128,
                   projection_dim=32)
TINY_TEXT = dict(width=32, layers=2, heads=4, intermediate=64)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("src, dst", [(512, 224), (64, 32), (20, 48)])
def test_preprocess_for_clip_matches(src, dst):
    img = np.random.default_rng(src).uniform(size=(2, src, src, 3)).astype(np.float32)
    want = np.asarray(jax_preprocess(jnp.asarray(img), dst))
    got = preprocess_for_clip(torch.from_numpy(img), dst).numpy()
    assert got.shape == want.shape == (2, dst, dst, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _zeros_like_shapes(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)


def _scorers(seed):
    """A tiny JAX scorer and the port's on the same weights: the port's towers drawn from
    ``seed`` by ``init_random_`` (the flax initializers) and the text projection
    N(0, 1/width), laid out as flax trees with ``named_to_flax_tree`` (their shapes from
    ``jax.eval_shape`` of the flax inits, so nothing compiles), then loaded into fresh port
    towers with ``load_flax_params``."""
    gen = torch.Generator().manual_seed(seed)
    vision = CLIPVisionEncoder(CLIPVisionConfig(**TINY_VISION))
    text = CLIPTextEncoder(CLIPTextConfig(**TINY_TEXT))
    init_random_(vision, gen)
    init_random_(text, gen)
    width = TINY_TEXT["width"]
    proj = (torch.randn((width, TINY_VISION["projection_dim"]), generator=gen)
            / np.sqrt(width)).numpy()
    jv = JaxVisionEncoder(JaxVisionConfig(**TINY_VISION))
    jt = JaxTextEncoder(JaxTextConfig(**TINY_TEXT))
    key, size = jax.random.PRNGKey(0), TINY_VISION["image_size"]
    vlike = _zeros_like_shapes(jax.eval_shape(jv.init, key, jnp.zeros((1, size, size, 3))))
    tlike = _zeros_like_shapes(jax.eval_shape(jt.init, key, jnp.zeros((1, 77), jnp.int32)))
    js = JaxScorer(
        vision=jv, text=jt, text_projection=jnp.asarray(proj),
        vision_params={"params": named_to_flax_tree(dict(vision.named_parameters()),
                                                    vlike["params"])},
        text_params={"params": named_to_flax_tree(dict(text.named_parameters()),
                                                  tlike["params"])})
    vision = CLIPVisionEncoder(CLIPVisionConfig(**TINY_VISION))
    text = CLIPTextEncoder(CLIPTextConfig(**TINY_TEXT))
    load_flax_params(vision, _np_tree(js.vision_params)["params"])
    load_flax_params(text, _np_tree(js.text_params)["params"])
    return js, CLIPScorer(vision=vision, text=text, text_projection=torch.from_numpy(proj),
                          device="cpu")


def test_clip_vision_encoder_matches():
    js, scorer = _scorers(0)
    px = np.random.default_rng(1).normal(size=(3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(js.vision.apply(js.vision_params, jnp.asarray(px)))
    got = scorer.vision(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_clip_scorer_scores_and_recall_match():
    """Seed 2 gives cosines of both signs, so the score holds W * max(cos, 0) with the
    clamp active on some views and not on others; the cosines before the clamp are
    held as well."""
    js, scorer = _scorers(2)
    rng = np.random.default_rng(2)
    prompts = ["a red sphere", "a blue cube", "a green cone"]
    imgs = {p: rng.uniform(size=(2, 96, 96, 3)).astype(np.float32) for p in prompts}
    want = js.score({p: jnp.asarray(v) for p, v in imgs.items()})
    got = scorer.score({p: torch.from_numpy(v) for p, v in imgs.items()})
    want_text = np.asarray(js.text_features(prompts))
    np.testing.assert_allclose(scorer.text_features(prompts).numpy(), want_text,
                               atol=ATOL, rtol=RTOL)
    want_cos = np.stack([np.asarray(js.image_features(jnp.asarray(imgs[p]))) @ want_text[i]
                         for i, p in enumerate(prompts)])  # [prompt, view]
    got_cos = np.stack([(scorer.image_features(torch.from_numpy(imgs[p]))
                         @ scorer.text_features(prompts)[i]).numpy()
                        for i, p in enumerate(prompts)])
    np.testing.assert_allclose(got_cos, want_cos, atol=ATOL, rtol=RTOL)
    assert (want_cos > 0).any() and (want_cos < 0).any() and want["clip_score"] > 0
    np.testing.assert_allclose(want["clip_score"], W * np.maximum(want_cos, 0).mean(), atol=1e-6)
    assert got["recall_at_1"] == want["recall_at_1"]
    np.testing.assert_allclose(got["clip_score"], want["clip_score"], atol=1e-5)


def _hf_clip_state(rng, vcfg, tcfg, typo=True):
    """A synthetic HF ``CLIPModel`` state dict at the given sizes, numpy float32."""
    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {"vision_model.embeddings.patch_embedding.weight":
          a(vcfg.width, 3, vcfg.patch_size, vcfg.patch_size),
          "vision_model.embeddings.class_embedding": a(vcfg.width),
          "vision_model.embeddings.position_embedding.weight":
          a((vcfg.image_size // vcfg.patch_size) ** 2 + 1, vcfg.width),
          "visual_projection.weight": a(vcfg.projection_dim, vcfg.width),
          "text_projection.weight": a(vcfg.projection_dim, tcfg.width),
          "text_model.embeddings.token_embedding.weight": a(tcfg.vocab_size, tcfg.width),
          "text_model.embeddings.position_embedding.weight": a(tcfg.max_length, tcfg.width)}
    pre = "pre_layrnorm" if typo else "pre_layernorm"
    for name, w in ((f"vision_model.{pre}", vcfg.width),
                    ("vision_model.post_layernorm", vcfg.width),
                    ("text_model.final_layer_norm", tcfg.width)):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = a(w), a(w)
    for tower, w, inter, n in (("vision_model", vcfg.width, vcfg.intermediate, vcfg.layers),
                               ("text_model", tcfg.width, tcfg.intermediate, tcfg.layers)):
        for i in range(n):
            b = f"{tower}.encoder.layers.{i}"
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{b}.self_attn.{proj}.weight"], sd[f"{b}.self_attn.{proj}.bias"] = (
                    a(w, w), a(w))
            for ln in ("layer_norm1", "layer_norm2"):
                sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = a(w), a(w)
            sd[f"{b}.mlp.fc1.weight"], sd[f"{b}.mlp.fc1.bias"] = a(inter, w), a(inter)
            sd[f"{b}.mlp.fc2.weight"], sd[f"{b}.mlp.fc2.bias"] = a(w, inter), a(w)
    return sd


@pytest.mark.parametrize("typo", [True, False])
def test_convert_clip_vision_matches_and_loads(typo, tmp_path, monkeypatch):
    vcfg, tcfg = CLIPVisionConfig(**TINY_VISION), CLIPTextConfig(**TINY_TEXT)
    sd = _hf_clip_state(np.random.default_rng(4), vcfg, tcfg, typo)
    mine, ref = convert_clip_vision(sd, n_layers=2), jax_convert_clip_vision(sd, n_layers=2)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k])

    scorer = _small_scorer_class(vcfg, tcfg)()
    loaded, bad = load_hf_clip(sd, scorer, strict=True)
    assert not bad and len(loaded) == len(list(scorer.vision.parameters())) + len(
        list(scorer.text.parameters()))
    np.testing.assert_array_equal(scorer.text_projection.numpy(), sd["text_projection.weight"].T)
    np.testing.assert_array_equal(scorer.vision.class_embedding.numpy(),
                                  sd["vision_model.embeddings.class_embedding"])

    # the HF state dict through from_checkpoint lands the same weights
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "clip.bin")
    got = _small_scorer_class(vcfg, tcfg).from_checkpoint(str(tmp_path / "clip.bin"),
                                                          device="cpu")
    for (n, p), (_, q) in zip(got.vision.named_parameters(), scorer.vision.named_parameters()):
        np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=n)
    np.testing.assert_array_equal(got.text_projection.numpy(), scorer.text_projection.numpy())

    # tools/convert_checkpoints.py --clip writes clip_scorer.pt, which from_checkpoint reads
    from triplaneturbo_torch.evaluation import clipscore
    from triplaneturbo_torch.tools import convert_checkpoints

    small = _small_scorer_class(vcfg, tcfg)
    monkeypatch.setattr(clipscore, "CLIPScorer", small)
    stats = convert_checkpoints.main(["--clip", str(tmp_path / "clip.bin"), "--out",
                                      str(tmp_path / "out"), "--device", "cpu", "--strict"])
    assert stats["clip_scorer"]["not_loaded"] == stats["clip_scorer"]["mismatched"] == 0
    back = small.from_checkpoint(str(tmp_path / "out" / "clip_scorer.pt"), device="cpu")
    img = torch.rand(2, 40, 40, 3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(back.image_features(img).numpy(),
                                  scorer.image_features(img).numpy())
    np.testing.assert_array_equal(back.text_features(["a cat"]).numpy(),
                                  scorer.text_features(["a cat"]).numpy())


def _small_scorer_class(vcfg, tcfg):
    """A CLIPScorer whose default towers are the tiny ones (what ``from_checkpoint``
    builds before it loads)."""
    class Small(CLIPScorer):
        def __init__(self, seed=0, device="cpu"):
            gen = torch.Generator().manual_seed(seed)
            vision, text = CLIPVisionEncoder(vcfg), CLIPTextEncoder(tcfg)
            init_random_(vision, gen)
            init_random_(text, gen)
            super().__init__(vision=vision, text=text, seed=seed, device=device)

    return Small


def test_clip_scorer_checkpoint_round_trip_and_msgpack(tmp_path):
    vcfg, tcfg = CLIPVisionConfig(**TINY_VISION), CLIPTextConfig(**TINY_TEXT)
    src = _small_scorer_class(vcfg, tcfg)(seed=7)
    path = tmp_path / "clip_scorer.pt"
    torch.save({"vision": src.vision.state_dict(), "text": src.text.state_dict(),
                "text_projection": src.text_projection}, path)
    img = torch.linspace(0, 1, 2 * 32 * 32 * 3).reshape(2, 32, 32, 3)

    dst = _small_scorer_class(vcfg, tcfg).from_checkpoint(str(path), seed=0, device="cpu")
    np.testing.assert_array_equal(dst.image_features(img).numpy(),
                                  src.image_features(img).numpy())
    np.testing.assert_array_equal(dst.text_features(["a cat"]).numpy(),
                                  src.text_features(["a cat"]).numpy())
    # the JAX package's format through the same entry point (A20b), and a missing file
    from triplaneturbo_torch.evaluation.clipscore import save_scorer

    msg = save_scorer(str(tmp_path / "clip_scorer.msgpack"), src)
    dst = _small_scorer_class(vcfg, tcfg).from_checkpoint(msg, seed=0, device="cpu")
    np.testing.assert_array_equal(dst.image_features(img).numpy(),
                                  src.image_features(img).numpy())
    with pytest.raises(FileNotFoundError):
        CLIPScorer.from_checkpoint(str(tmp_path / "missing.msgpack"), device="cpu")
    assert clip_b32_text_config().width == 512


def sphere_mesh(R=20):
    """The red sphere of ``tests/test_eval_harness.py``'s ``sphere_mesh``, extracted by the
    port's ``marching_tets`` (``tests/test_torch_ops.py`` holds it index for index against
    the JAX one, which takes seconds op by op), as a JAX mesh."""
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, R)] * 3, indexing="ij"), -1)
    sdf = torch.from_numpy((np.linalg.norm(g - 0.5, axis=-1) - 0.3).astype(np.float32))
    m = marching_tets(sdf, max_verts=4096, max_faces=8192)
    return JaxMesh(v_pos=jnp.asarray(m.verts.numpy() * 2 - 1),
                   t_pos_idx=jnp.asarray(m.faces.numpy().astype(np.int32)),
                   v_mask=jnp.asarray(m.vert_mask.numpy()), t_mask=jnp.asarray(m.face_mask.numpy()),
                   v_rgb=jnp.ones((4096, 3)) * jnp.asarray([0.9, 0.2, 0.2]))


def _to_port(jm: JaxMesh) -> Mesh:
    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    return Mesh(v_pos=t(jm.v_pos), t_pos_idx=t(jm.t_pos_idx).long(), v_mask=t(jm.v_mask),
                t_mask=t(jm.t_mask), v_rgb=t(jm.v_rgb))


def _jax_counts(jm, n_views, H, W, faces_per_tile=2048):
    """The overflow counts of the JAX ``rasterize`` on each view of the eval rig."""
    mvp = np.asarray(jmr.kire_camera_rig(n_views))
    v = jmr.kire_normalize_mesh(jm.v_pos, jm.v_mask)
    vh = jnp.concatenate([v, jnp.ones_like(v[:, :1])], axis=-1)
    counts = jax.jit(jax.vmap(lambda m: jax_rasterize(
        vh @ m.T, jm.t_pos_idx, jm.t_mask, H, W, faces_per_tile=faces_per_tile, max_span=4,
        big_face_cap=256)[-2:]))(jnp.asarray(mvp))
    return list(zip(np.asarray(counts[0]).tolist(), np.asarray(counts[1]).tolist()))


def test_render_mesh_views_matches_on_the_sphere():
    jm = sphere_mesh()
    want = np.asarray(jmr.render_mesh_views(jm, n_views=4, height=64, width=64))
    got = tmr.render_mesh_views(_to_port(jm), n_views=4, height=64, width=64)
    assert got.images.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got.images.numpy(), want, atol=ATOL, rtol=RTOL)
    counts = list(zip(got.n_span_overflow.tolist(), got.n_list_overflow.tolist()))
    assert counts == _jax_counts(jm, 4, 64, 64)
    np.testing.assert_allclose(tmr.kire_camera_rig(4), np.asarray(jmr.kire_camera_rig(4)),
                               atol=1e-6)


def test_render_mesh_views_reports_the_faces_the_jax_harness_drops():
    """300 parallel triangles, each covering the whole 128² image of both views (which
    look at them face on, from +y and -y): past the 256-slot big-face list, 44 faces a
    view are dropped, the front ones among them. The JAX renderer says nothing; the
    port's counts equal those of the JAX rasterizer called directly, and the images
    agree."""
    n = 300
    ys = np.linspace(-0.3, 0.3, n)
    corners = np.array([[-2.0, -2.0], [2.0, -2.0], [0.0, 2.0]])
    v_pos = np.stack([np.stack([corners[:, 0], np.full(3, y), corners[:, 1]], -1) for y in ys])
    v_pos = v_pos.reshape(-1, 3).astype(np.float32)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    rgb = np.random.default_rng(5).uniform(size=(n, 1, 3)).repeat(3, 1).reshape(-1, 3)
    jm = JaxMesh(v_pos=jnp.asarray(v_pos), t_pos_idx=jnp.asarray(faces),
                 v_mask=jnp.ones(3 * n, bool), t_mask=jnp.ones(n, bool),
                 v_rgb=jnp.asarray(rgb.astype(np.float32)))
    want = np.asarray(jmr.render_mesh_views(jm, n_views=2, height=128, width=128))
    got = tmr.render_mesh_views(_to_port(jm), n_views=2, height=128, width=128)
    np.testing.assert_allclose(got.images.numpy(), want, atol=ATOL, rtol=RTOL)
    counts = list(zip(got.n_span_overflow.tolist(), got.n_list_overflow.tolist()))
    assert counts == _jax_counts(jm, 2, 128, 128)
    assert [s for s, _ in counts] == [n - 256] * 2


def test_run_eval_main_on_a_tiny_pipeline(tmp_path):
    from test_torch_pipeline import PIPE_KW, TINY_SG
    from test_torch_pipeline import TINY_TEXT as PIPE_TEXT
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )

    pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cpu", space_generator_overrides=TINY_SG,
        text_config=CLIPTextConfig(**PIPE_TEXT), **PIPE_KW)
    scorer = _small_scorer_class(CLIPVisionConfig(**TINY_VISION), CLIPTextConfig(**TINY_TEXT))()
    prompts = ["a red chair", "a blue teapot / with a lid", "a green frog"]
    lib = tmp_path / "lib.json"
    lib.write_text(json.dumps({"train": prompts, "test": prompts}))
    out = tmp_path / "eval"
    metrics = run_eval.main(["--prompts", str(lib), "--out", str(out), "--limit", "2",
                             "--views", "2", "--render-size", "32", "--save-obj",
                             "--save-grid", "--device", "cpu"], pipe=pipe, scorer=scorer)
    on_disk = json.loads((out / "metrics_rank0.json").read_text())
    assert on_disk == json.loads(json.dumps(metrics))
    assert metrics["prompts"] == 2 and 0.0 <= metrics["clip_score"] <= 2.5
    assert metrics["recall_at_1"] in (0.0, 0.5, 1.0)
    assert set(metrics["overflow"]) == set(prompts[:2])
    for i, p in enumerate(prompts[:2]):
        slug = run_eval.prompt_slug(i, p)
        assert "/" not in slug and (out / slug / "model.obj").exists()
        assert (out / f"{slug}.png").exists()
    assert run_eval.prompt_slug(1, prompts[1]) == "001_a_blue_teapot_with_a_lid"

    # prompt i's mesh is the pipeline's from the generator seeded by (42, i)
    views = tmr.render_mesh_views(
        pipe(prompts[1], generator=torch.Generator().manual_seed(fold_seed(42, 1)))
        ["mesh"][0], n_views=2, height=32, width=32)
    again = scorer.score({prompts[0]: tmr.render_mesh_views(
        pipe(prompts[0], generator=torch.Generator().manual_seed(fold_seed(42, 0)))
        ["mesh"][0], n_views=2, height=32, width=32).images, prompts[1]: views.images})
    assert again == {k: metrics[k] for k in ("clip_score", "recall_at_1")}


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_velocity_and_ddpm_step_match(prediction_type):
    ts_ = tsched.make_schedule(tsched.SchedulerConfig(prediction_type=prediction_type))
    js_ = jsched.make_schedule(jsched.SchedulerConfig(prediction_type=prediction_type))
    rng = np.random.default_rng(6)
    sample, out, noise = (rng.normal(size=(2, 4, 8, 8)).astype(np.float32) for _ in range(3))
    t_b = np.array([10, 700])
    np.testing.assert_allclose(
        tsched.velocity(ts_, torch.from_numpy(sample), torch.from_numpy(noise),
                        torch.from_numpy(t_b)).numpy(),
        np.asarray(jsched.velocity(js_, jnp.asarray(sample), jnp.asarray(noise),
                                   jnp.asarray(t_b))), atol=ATOL, rtol=RTOL)
    key = jax.random.PRNGKey(3)
    for t in (999, 500, 1, 0):
        want = jsched.ddpm_step(js_, jnp.asarray(out), jnp.asarray(t), jnp.asarray(sample), key)
        z = np.asarray(jax.random.normal(key, sample.shape, jnp.float32))
        got = tsched.ddpm_step(ts_, torch.from_numpy(out), t, torch.from_numpy(sample),
                               noise=torch.from_numpy(z))
        np.testing.assert_allclose(got.prev_sample.numpy(), np.asarray(want.prev_sample),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got.pred_original_sample.numpy(),
                                   np.asarray(want.pred_original_sample), atol=ATOL, rtol=RTOL)
        mean = jsched.ddpm_step(js_, jnp.asarray(out), jnp.asarray(t), jnp.asarray(sample))
        got_mean = tsched.ddpm_step(ts_, torch.from_numpy(out), t, torch.from_numpy(sample))
        np.testing.assert_allclose(got_mean.prev_sample.numpy(), np.asarray(mean.prev_sample),
                                   atol=ATOL, rtol=RTOL)
    drawn = tsched.ddpm_step(ts_, torch.from_numpy(out), 500, torch.from_numpy(sample),
                             generator=torch.Generator().manual_seed(0))
    again = tsched.ddpm_step(ts_, torch.from_numpy(out), 500, torch.from_numpy(sample),
                             noise=torch.randn(sample.shape, generator=torch.Generator()
                                               .manual_seed(0)))
    np.testing.assert_array_equal(drawn.prev_sample.numpy(), again.prev_sample.numpy())
