"""The traffic generators are deterministic in --seed, and every seed sends the same sizes."""

import os

import numpy as np
import pytest
import torch

from port_bench.lib import cells, serve, train
from port_bench.tests.conftest import tiny_train

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BIG = 2 ** 31 + 12345


def test_serving_inputs():
    cell = cells.load(ROOT, "serve-b8")
    a, b, c = (serve.Traffic(cell, s, torch.device("cpu")) for s in (BIG, BIG, BIG + 1))
    for i in (0, 3):
        (pa, la), (pb, lb), (pc, lc) = a.call(i), b.call(i), c.call(i)
        assert pa == pb and torch.equal(la, lb)
        assert len(pa) == len(pc) == 8 and la.shape == lc.shape == (8, 6, 32, 32, 4)
        assert pa != pc and not torch.equal(la, lc)


def test_training_inputs():
    cell = tiny_train(cells.load(ROOT, "train-v1"))
    runs = []
    for s in (BIG, BIG, BIG + 1):
        inp = train.Inputs(cell, s, torch.device("cpu"))
        batch_list, gen = inp.next()
        runs.append((batch_list, torch.randn(4, generator=gen), inp.timestep_rng().rand(3)))
    (b0, g0, t0), (b1, g1, t1), (b2, g2, t2) = runs
    assert b0[0]["prompt"] == b1[0]["prompt"]
    for k in b0[0]:
        if isinstance(b0[0][k], np.ndarray):
            assert np.array_equal(b0[0][k], b1[0][k]) and b0[0][k].shape == b2[0][k].shape
    assert torch.equal(g0, g1) and np.array_equal(t0, t1)
    assert not torch.equal(g0, g2) and not np.array_equal(b0[0]["noise"], b2[0]["noise"])


def test_weights_are_the_seeds_and_fit_program_and_reference():
    from port_bench.lib import weights
    from port_bench.tests.conftest import tiny_serve
    from triplaneturbo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder

    cell = tiny_serve(cells.load(ROOT, "serve-b1"))
    meta = serve.reference_pipeline(cell.config, "meta", "float32").text_encoder
    cpu = torch.device("cpu")
    a, b, c = (weights.make_weights(meta, s, "text_encoder", cpu) for s in (BIG, BIG, BIG + 1))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    program = CLIPTextEncoder(CLIPTextConfig(**cell.config["text"]))
    weights.load(program, a)
    for name, p in program.named_parameters():
        assert torch.equal(p.detach(), a[name].float())
    with pytest.raises(ValueError):
        weights.load(program, {k: v for k, v in a.items() if k != "position_embedding"})
