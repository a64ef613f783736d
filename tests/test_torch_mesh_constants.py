"""The field-and-mesh layer's constants, built once a device.

The marching-cubes and marching-tets tables, the field's bounding box and the empty-field
sphere come from per-device caches, so that a prompt uploads none of them. On the CPU they
are the values the layer uploaded before: the tables equal the numpy ones, extraction stays
index for index with the JAX package, and the rescaled points are bit-equal to those
rescaled by the field's CPU ``bbox``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triplaneturbo_tpu.ops.isosurface as jiso
from triplaneturbo_torch.models.geometry import triplane_field as tf
from triplaneturbo_torch.ops import isosurface as tiso
from triplaneturbo_torch.ops.triplane import contract_to_unisphere
from triplaneturbo_torch.pipelines import triplaneturbo_text_to_3d as pl

CPU = torch.device("cpu")
TABLES = {"mc": ("MC_TRI_CODE", "MC_TRI_COUNT"), "mt": ("CELL_TRI_CODE", "CELL_TRI_COUNT")}


@pytest.mark.parametrize("method", ["mc", "mt"])
def test_tri_tables_are_the_numpy_tables_built_once_a_device(method):
    code, count = tiso.tri_tables(method, CPU)
    for got, name in zip((code, count), TABLES[method]):
        assert got.dtype == torch.long and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), getattr(tiso, name), err_msg=name)
    again = tiso.tri_tables(method, CPU)
    assert again[0] is code and again[1] is count


def _field(R, seed):
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    sdf = (np.linalg.norm(g, axis=-1) - 0.6 + 0.1 * rng.normal(size=(R, R, R))).astype(np.float32)
    return sdf, rng.normal(size=(R, R, R, 3)).astype(np.float32)


@pytest.mark.parametrize("method", ["marching_cubes", "marching_tets"])
@pytest.mark.parametrize("R,max_verts,max_faces", [(18, 8192, 8192), (18, 8192, 400),
                                                   (13, 300, 8192)])
def test_isosurface_is_bit_equal_from_call_to_call_and_to_jax(method, R, max_verts, max_faces):
    sdf, deform = _field(R, R * 3 + max_faces)
    kw = dict(max_verts=max_verts, max_faces=max_faces)
    extract = getattr(tiso, method)
    first = extract(torch.from_numpy(sdf), torch.from_numpy(deform), **kw)
    second = extract(torch.from_numpy(sdf), torch.from_numpy(deform), **kw)
    for name, a, b in zip(first._fields, first, second):
        assert torch.equal(a, b), name
    mj = getattr(jiso, method)(jnp.asarray(sdf), jnp.asarray(deform), **kw)
    for name in ("faces", "vert_mask", "face_mask", "n_verts", "n_faces"):
        np.testing.assert_array_equal(getattr(first, name).numpy(), np.asarray(getattr(mj, name)),
                                      err_msg=name)
    assert first.vert_mask.any() and first.face_mask.any()
    np.testing.assert_allclose(first.verts.numpy(), np.asarray(mj.verts), atol=1e-6)


def test_field_state_dict_keeps_its_keys():
    field = tf.TriplaneField(tf.TriplaneFieldConfig())
    field.rescale_points(torch.zeros(1, 2, 3))
    assert list(field.state_dict()) == [
        f"{net}.Dense_{i}.weight"
        for net in ("sdf_network", "feature_network", "deformation_network") for i in range(3)]
    assert list(field.buffers()) == []


@pytest.mark.parametrize("radius", [1.0, 0.75, 2.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rescale_points_is_bit_equal_to_the_cpu_bbox(radius, dtype):
    field = tf.TriplaneField(tf.TriplaneFieldConfig(radius=radius))
    gen = torch.Generator().manual_seed(int(radius * 8))
    pts = (torch.rand((2, 300, 3), generator=gen) * 3.0 - 1.5).to(dtype)
    bbox = field.bbox
    assert bbox.device == CPU and bbox.dtype == torch.float32
    assert bbox.tolist() == [[-radius] * 3, [radius] * 3]
    got = field.rescale_points(pts)
    want = contract_to_unisphere(pts, bbox, unbounded=False)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert tf._bbox_on(radius, CPU) is tf._bbox_on(radius, CPU)
    assert field.bbox is not bbox  # the property still builds its own CPU tensor


def _mesh_self(R):
    cfg = pl.TriplaneTurboPipelineConfig(isosurface_resolution=R, max_verts=8192,
                                         max_faces=16384)
    return SimpleNamespace(cfg=cfg)


@pytest.mark.parametrize("R", [12, 17])
def test_extract_mesh_falls_back_to_the_same_sphere(R):
    lin = torch.linspace(-1.0, 1.0, R)
    grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)
    sphere = torch.linalg.norm(grid, dim=-1) - 1.0
    cached = pl._sphere_sdf(R, CPU)
    assert torch.equal(cached, sphere) and pl._sphere_sdf(R, CPU) is cached
    deform = torch.zeros((R ** 3, 3))
    got = pl.TriplaneTurboTextTo3DPipeline.extract_mesh(_mesh_self(R), torch.ones(R ** 3), deform)
    want = tiso.marching_cubes(sphere.reshape(R, R, R), deform.reshape(R, R, R, 3),
                               max_verts=8192, max_faces=16384)
    assert bool(got.face_mask.any())
    for name, a, b in zip(got._fields, got, want._replace(verts=want.verts * 2.0 - 1.0)):
        assert torch.equal(a, b), name
    assert torch.equal(cached, sphere)  # the fallback wrote nothing into the cache
