"""The port's export formats against the JAX package's, on the CPU.

The native OBJ writer (``native/objwriter.cpp``, built by the port into its own
build directory) against the JAX binding and the port's Python writer;
``export_obj(save_normal=True)``; the UV atlas, the baked texture on a mesh whose
charts overlap (the texels that faces share go to the largest face index, as the
JAX loop's later face wins), ``export_obj_mtl``'s OBJ, MTL and PNG, the mesh
exporter's ``obj-mtl`` with the same explicit closure in both packages; and the
launcher's ``--export`` with ``system.exporter.fmt=obj-mtl``.
"""

import json
import os

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_native_objwriter import _mesh
from triplaneturbo_tpu.models.exporters.mesh_exporter import (
    MeshExporterConfig as JaxExporterConfig,
    MultipromptMeshExporter as JaxExporter,
)
from triplaneturbo_tpu.pipelines.triplaneturbo_text_to_3d import export_obj as jax_export_obj
from triplaneturbo_tpu.utils import uv_export as J
from triplaneturbo_tpu.utils.mesh import Mesh as JaxMesh
from triplaneturbo_tpu.utils.native import write_obj_native as jax_write_obj_native
from triplaneturbo_torch import launch
from triplaneturbo_torch.models.exporters.mesh_exporter import (
    MeshExporterConfig,
    MultipromptMeshExporter,
)
from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import export_obj
from triplaneturbo_torch.utils import native
from triplaneturbo_torch.utils import uv_export as T
from triplaneturbo_torch.utils.mesh import Mesh
from triplaneturbo_torch.utils.saving import save_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJ_ATOL = 2e-4  # tests/test_native_objwriter.py: colors %.4f against %.6f


def _parse(path):
    vs, fs = [], []
    for line in open(path):
        t = line.split()
        if t and t[0] == "v":
            vs.append([float(x) for x in t[1:]])
        elif t and t[0] == "f":
            fs.append([int(x) for x in t[1:]])
    return np.asarray(vs), np.asarray(fs)


def _text(path):
    with open(path) as f:
        return f.read()


def test_native_writer_matches_the_jax_binding_and_the_python_writer(tmp_path):
    verts, colors, faces, vm, fm = _mesh()
    mine = native.write_obj_native(str(tmp_path / "port.obj"), verts, faces, colors, vm, fm)
    assert jax_write_obj_native(str(tmp_path / "jax.obj"), verts, faces, colors, vm, fm)
    assert _text(mine) == _text(str(tmp_path / "jax.obj"))  # one C++ source
    assert native.library()._name.startswith(os.path.join(REPO, "triplaneturbo_torch", "_build"))
    # the Python writer (which save_obj takes for normals) parses equal
    py = save_obj(str(tmp_path / "python.obj"), verts, faces, v_rgb=colors,
                  v_nrm=np.zeros_like(verts), v_mask=vm, t_mask=fm)
    v1, f1 = _parse(mine)
    v2, f2 = _parse(py)
    assert v1.shape == v2.shape == (int(vm.sum()), 6)
    np.testing.assert_allclose(v1, v2, atol=OBJ_ATOL)
    np.testing.assert_array_equal(f1, f2)
    # save_obj without normals is the native writer
    assert _text(save_obj(str(tmp_path / "save.obj"), torch.from_numpy(verts),
                          torch.from_numpy(faces), v_rgb=torch.from_numpy(colors),
                          v_mask=torch.from_numpy(vm), t_mask=torch.from_numpy(fm))) == _text(mine)


def _meshes(seed=0, n=400, f=700):
    """The same masked, vertex-colored mesh for both packages."""
    verts, colors, faces, vm, fm = _mesh(n, f, seed)
    jm = JaxMesh(v_pos=jnp.asarray(verts), t_pos_idx=jnp.asarray(faces), v_mask=jnp.asarray(vm),
                 t_mask=jnp.asarray(fm), v_rgb=jnp.asarray(colors))
    tm = Mesh(v_pos=torch.from_numpy(verts), t_pos_idx=torch.from_numpy(faces).long(),
              v_mask=torch.from_numpy(vm), t_mask=torch.from_numpy(fm),
              v_rgb=torch.from_numpy(colors))
    return jm, tm


@pytest.mark.parametrize("save_normal", [False, True])
def test_export_obj_matches_the_jax_text(tmp_path, save_normal):
    jm, tm = _meshes()
    want = jax_export_obj(jm, str(tmp_path / "jax.obj"), save_normal=save_normal)[0]
    got = export_obj(tm, str(tmp_path / "port.obj"), save_normal=save_normal)[0]
    text = _text(got)
    assert text == _text(want)
    assert (text.count("\nvn ") > 0) == save_normal


@pytest.mark.parametrize("n_faces,tex_size", [(1, 16), (37, 64), (700, 128), (196608, 1024)])
def test_per_face_uv_atlas_is_bit_equal(n_faces, tex_size):
    want, wcell = J.per_face_uv_atlas(n_faces, tex_size)
    got, cell = T.per_face_uv_atlas(n_faces, tex_size)
    assert cell == wcell and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


W_COLOR = np.random.default_rng(7).normal(size=(3, 3))


def _color_np(p):
    return 1.0 / (1.0 + np.exp(-(p @ W_COLOR)))


def _color_torch(p):
    return torch.sigmoid(p @ torch.from_numpy(W_COLOR).to(p))


@pytest.mark.parametrize("uv_kind", ["atlas", "overlapping"])
def test_bake_texture_matches_the_jax_loop(uv_kind):
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (600, 3))
    if uv_kind == "atlas":
        uvs, _ = J.per_face_uv_atlas(600, 128)
    else:  # every chart over the same patch of the texture: most texels are shared
        uvs = (rng.uniform(0, 1, (600, 3, 2)) * 0.3 + 0.1).astype(np.float32)
    want = J.bake_texture(verts, faces, uvs, _color_np, 128)
    got = T.bake_texture(torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(uvs),
                         _color_torch, 128)
    assert got.dtype == torch.float32 and got.shape == (128, 128, 3)
    covered = want.any(-1)
    assert covered.sum() > 1000
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_obj_mtl_equal(got, want):
    for ext in ("obj", "mtl"):
        assert _text(f"{got}.{ext}") == _text(f"{want}.{ext}")
    dg, dw = os.path.dirname(got), os.path.dirname(want)
    pg = imageio.imread(os.path.join(dg, "texture_kd.png"))
    pw = imageio.imread(os.path.join(dw, "texture_kd.png"))
    assert pg.shape == pw.shape == (1024, 1024, 3) and pg.dtype == np.uint8
    np.testing.assert_array_equal(pg, pw)
    assert pg.any()


def test_export_obj_mtl_files_equal(tmp_path):
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(200, 3)).astype(np.float32)
    faces = rng.integers(0, 200, (350, 3))
    J.export_obj_mtl(str(tmp_path / "jax"), "model", verts, faces, _color_np)
    T.export_obj_mtl(str(tmp_path / "port"), "model", torch.from_numpy(verts),
                     torch.from_numpy(faces), _color_torch)
    _assert_obj_mtl_equal(str(tmp_path / "port" / "model"), str(tmp_path / "jax" / "model"))


def test_mesh_exporter_obj_mtl_matches_and_needs_a_closure(tmp_path):
    jm, tm = _meshes(seed=3)
    JaxExporter(JaxExporterConfig(fmt="obj-mtl"))([jm], str(tmp_path / "jax"), ["a"],
                                                   color_fns=[_color_np])
    exporter = MultipromptMeshExporter(MeshExporterConfig(fmt="obj-mtl"))
    paths = exporter([tm], str(tmp_path / "port"), ["a"], color_fns=[_color_torch])
    assert paths == [str(tmp_path / "port" / "a" / "model.obj")]
    _assert_obj_mtl_equal(str(tmp_path / "port" / "a" / "model"),
                          str(tmp_path / "jax" / "a" / "model"))
    # no closure: the JAX exporter's nearest-of-500-vertices fallback is not carried over
    with pytest.raises(ValueError, match="color_fns"):
        exporter([tm], str(tmp_path / "none"), ["a"])
    with pytest.raises(ValueError, match="obj-mtl"):
        MultipromptMeshExporter(MeshExporterConfig(fmt="glb"))


def test_launcher_exports_obj_mtl_on_the_tiny_config(tmp_path):
    lib = tmp_path / "lib"
    lib.mkdir()
    (lib / "tiny.json").write_text(json.dumps({"train": ["a red chair"], "val": ["a frog"],
                                               "test": ["a ceramic lion"]}))
    trial = str(tmp_path / "trial")
    extras = {"trial_dir": trial, "exp_root_dir": str(tmp_path / "exp"),
              "data.prompt_library_dir": str(lib), "data.prompt_library": "tiny",
              "system.exporter.isosurface_resolution": 24, "system.exporter.fmt": "obj-mtl"}
    trainer = launch.main(["--config", os.path.join(REPO, "configs", "smoke_tiny.yaml"),
                           "--export", "--device", "cpu",
                           *[f"{k}={v}" for k, v in extras.items()]])
    out = os.path.join(trial, "it0-export", "a_ceramic_lion")
    assert sorted(os.listdir(out)) == ["model.mtl", "model.obj", "texture_kd.png"]
    text = _text(os.path.join(out, "model.obj"))
    n_v, n_vt, n_f = (sum(ln.startswith(p) for ln in text.splitlines()) for p in ("v ", "vt ", "f "))
    assert n_v > 0 and n_f > 0 and n_vt == 3 * n_f
    tex = imageio.imread(os.path.join(out, "texture_kd.png"))
    assert tex.shape == (1024, 1024, 3) and tex.any()
    assert trainer.global_step == 0
