"""The prompt processors of the PyTorch port against the JAX package on the CPU.

The SD-1.5 (quick GELU) tower, the ``.npz`` cache (its width-aware md5 key, the
round trip, the rank's share of the prompts, a stale entry) and
``build_prompt_setup``'s ``embeds_for``, key for key, from the same weights (the
JAX towers' flax trees bridged into the port's). Each package writes its own cache
directory. Tolerance: the states within 1e-5 of their largest value (f32; the
towers' sums run in other orders in XLA and PyTorch).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.models.clip_text import CLIPTextConfig as JaxCLIPTextConfig
from triplaneturbo_tpu.models.clip_text import CLIPTextEncoder as JaxCLIPTextEncoder
from triplaneturbo_tpu.models.clip_text import sd15_text_config as jax_sd15_text_config
from triplaneturbo_tpu.models.prompt_processors.callable_processor import (
    _cache_key as jax_cache_key,
)
from triplaneturbo_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from triplaneturbo_tpu.systems.prompt_setup import build_prompt_setup as jax_build_prompt_setup
from triplaneturbo_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextEncoder,
    hidden_act,
    sd15_text_config,
)
from triplaneturbo_torch.models.prompt_processors import callable_processor as cp
from triplaneturbo_torch.models.prompt_processors.callable_processor import (
    PromptProcessorConfig,
    StableDiffusionMultipromptPromptProcessor,
)
from triplaneturbo_torch.models.tokenizer import CLIPTokenizer
from triplaneturbo_torch.systems.prompt_setup import build_prompt_setup
from triplaneturbo_torch.utils.weights import init_random_, load_flax_params

torch.set_num_threads(2)

REL = 1e-5
PROMPTS = ["a delicious hamburger", "a wooden chair", "a delicious hamburger", "a red car"]


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=REL * float(np.abs(want).max()), rtol=0,
                               err_msg=what)


def _tiny_encoder(width=32, seed=0, act="quick_gelu"):
    enc = CLIPTextEncoder(CLIPTextConfig(width=width, layers=2, heads=2, intermediate=64,
                                         hidden_act=act))
    init_random_(enc, torch.Generator().manual_seed(seed))
    return enc.eval()


def test_sd15_config_and_quick_gelu_tower_match():
    assert sd15_text_config().__dict__ == jax_sd15_text_config().__dict__
    x = torch.linspace(-6, 6, 101)
    np.testing.assert_allclose(hidden_act("quick_gelu", x).numpy(),
                               (x * torch.sigmoid(1.702 * x)).numpy(), rtol=0, atol=0)
    kw = dict(width=48, layers=2, heads=3, intermediate=96, hidden_act="quick_gelu")
    jenc = JaxCLIPTextEncoder(JaxCLIPTextConfig(**kw))
    ids = JaxTokenizer().batch_encode(PROMPTS)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    local_j, pooled_j = jenc.apply(params, jnp.asarray(ids))
    enc = CLIPTextEncoder(CLIPTextConfig(**kw))
    load_flax_params(enc, jax.tree_util.tree_map(np.asarray, params)["params"])
    with torch.no_grad():
        local_t, pooled_t = enc(torch.tensor(ids).long())
    _close(local_t, local_j, "local states")
    _close(pooled_t, pooled_j, "pooled states")
    # the exact GELU stays the default, and the two activations differ
    with torch.no_grad():
        assert not torch.allclose(_tiny_encoder(act="gelu")(torch.tensor(ids).long())[0],
                                  _tiny_encoder(act="quick_gelu")(torch.tensor(ids).long())[0])


def test_cache_round_trip_key_and_shards(tmp_path, monkeypatch):
    cfg = PromptProcessorConfig(model_tag="sd21", cache_dir=str(tmp_path), negative_prompt="ugly")
    enc = _tiny_encoder()
    proc = StableDiffusionMultipromptPromptProcessor(cfg, enc)
    proc.prepare_text_embeddings(PROMPTS)
    # one entry a distinct prompt (and the negative and empty prompts), under the JAX key
    names = {jax_cache_key("sd21", p, width=32) + ".npz" for p in PROMPTS + ["ugly", ""]}
    assert set(os.listdir(tmp_path)) == names
    assert cp._cache_key("sd21", "a red car", width=32) == jax_cache_key("sd21", "a red car",
                                                                         width=32)
    out = proc(PROMPTS)
    with torch.no_grad():
        local, pooled = enc(torch.as_tensor(CLIPTokenizer().batch_encode(PROMPTS)).long())
    assert torch.equal(out.local_text_embeddings, local)
    assert torch.equal(out.global_text_embeddings, pooled)
    u = out.get_uncond_text_embeddings()
    assert u.shape == (4, 77, 32) and torch.equal(u[3], out.uncond_local[0])
    assert out.get_text_embeddings().shape == (8, 77, 32)

    # a second processor reads the cache and never runs its encoder
    cached = StableDiffusionMultipromptPromptProcessor(cfg, _tiny_encoder(seed=1))
    monkeypatch.setattr(cached.enc.text_encoder, "forward", lambda ids: 1 / 0)
    again = cached(PROMPTS)
    assert torch.equal(again.local_text_embeddings, local)

    # another width under the same tag gets its own entries
    wide = StableDiffusionMultipromptPromptProcessor(cfg, _tiny_encoder(width=64, seed=2))
    assert wide(PROMPTS[:1]).local_text_embeddings.shape == (1, 77, 64)
    assert len(os.listdir(tmp_path)) == len(names) + 2  # the prompt and the negative

    # an entry of another width under this key is encoded again
    path = cached.enc._path("a red car")
    np.savez(path, local=np.zeros((77, 16), np.float32), pooled=np.zeros(16, np.float32))
    fresh = StableDiffusionMultipromptPromptProcessor(cfg, enc)
    assert torch.equal(fresh(["a red car"]).local_text_embeddings, local[3:])

    # with a world of two, rank 1 encodes every second uncached prompt
    shard_dir = tmp_path / "shard"
    monkeypatch.setattr(cp, "_rank_world", lambda: (1, 2))
    sharded = StableDiffusionMultipromptPromptProcessor(
        PromptProcessorConfig(cache_dir=str(shard_dir)), enc)
    sharded.enc.prepare(["p0", "p1", "p2", "p3", "p1"])
    assert sorted(os.listdir(shard_dir)) == sorted(
        cp._cache_key("sd21", p, width=32) + ".npz" for p in ("p1", "p3"))


def test_embeds_for_matches_build_prompt_setup(tmp_path, monkeypatch):
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    monkeypatch.chdir(jax_dir)  # the JAX processors cache under ./.cache
    jproc, jembeds = jax_build_prompt_setup(32, seed=0, negative_prompt="blurry")
    proc, embeds = build_prompt_setup(32, seed=0, negative_prompt="blurry", device="cpu",
                                      cache_dir=str(tmp_path / "port"))
    for side in ("p1", "p2"):
        load_flax_params(getattr(proc, side).enc.text_encoder, jax.tree_util.tree_map(
            np.asarray, getattr(jproc, side).enc.params)["params"])
    assert proc.p1.enc.text_encoder.cfg.width == proc.p2.enc.text_encoder.cfg.width == 32
    want = jembeds(PROMPTS)
    got = embeds(PROMPTS)
    assert set(got) == set(want) == {"cond_local", "cond_21", "uncond_21", "cond_15",
                                     "uncond_15", "global_21"}
    for k, v in want.items():
        _close(got[k], v, k)
    assert not torch.equal(got["cond_15"], got["cond_21"])
    assert os.listdir(tmp_path / "port") and os.listdir(jax_dir / ".cache" / "text_embeddings")


def test_prompt_setup_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_prompt_setup(32)
