"""The harness's own tests. The `gpu` marker is for tests that need a CUDA device;
they decide inside a fixture, never at import, and skip here with a reason."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (run on the card)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


TINY_SG = dict(block_out_channels=[64, 128], layers_per_block=1, cross_attention_dim=64,
               attention_head_dim=64, vae_block_out_channels=[32, 64], vae_layers_per_block=1)


def tiny_serve(cell):
    """The serving cell's code path at a size the CPU holds: the same widths' kinds
    (LoRA, LoCon, kernel sites at D = 64), a two-level UNet and VAE, R = 64."""
    cfg = copy.deepcopy(cell.config)
    cfg["space_generator"].update(TINY_SG)
    cfg["text"].update(width=64, layers=2, heads=1, intermediate=128)
    cfg["pipeline"].update(latent_resolution=16, isosurface_resolution=64, max_verts=20000,
                           max_faces=40000)
    cell.config = cfg
    return cell


def tiny_train(cell, checked=1, reference=1):
    """The training cell's code path at a size the CPU holds (as chip_smoke.py's small
    model): small student and teachers, 64² renders, 32² rays, R = 16."""
    cfg = copy.deepcopy(cell.config)
    s = cfg["system"]
    s["geometry"]["space_generator_config"].update(TINY_SG)
    t = dict(block_out_channels=[64, 128], layers_per_block=1, attention_head_dim=64,
             cross_attention_dim=64)
    tv = dict(vae_block_out_channels=[32, 64], vae_layers_per_block=1)
    s["teacher_sizes"] = {"mv": {**t, **tv}, "rd": dict(t), "sd": {**t, **tv}}
    s["guidance"].update(mv_image_size=32, rd_image_size=16, sd_image_size=32)
    s["background"] = {"c_dim": 64, "encoding": {"n_levels": 4, "log2_hashmap_size": 12}}
    s["renderer"]["isosurface_resolution"] = 16
    s["renderer_2nd"].update(num_samples_per_ray=8, num_samples_per_ray_importance=16,
                             field_chunk=300)
    s["patch"]["patch_size"] = 8
    s["rasterize_hw"] = 64
    cfg["data"].update(height=64, width=64, ray_height=32, ray_width=32, dim_gaussian=[6, 4, 8, 8])
    cell.config = cfg
    cell.traffic = dict(cell.traffic, checked_steps=checked, reference_steps=reference)
    return cell
