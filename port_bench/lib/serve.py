"""The serving runner: prompts through ``TriplaneTurboTextTo3DPipeline.__call__`` in a
closed loop.

The traffic file gives ``batch`` (prompts a call, one client waiting on each call), the
prompt library, ``sample_calls`` (how many of the window's calls the reference checks,
drawn from the seed), ``trace_calls`` (the calls a traced run profiles, after
``trace_warmup_calls`` under the profiler) and ``warmup_calls``. Call i's prompts are the i-th slice of the library in an order drawn
from the seed, and its latents are drawn from a generator seeded by (seed, i), so every
seed sends the same sizes.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..reference.ttref.models.clip_text import CLIPTextConfig as RefTextConfig
from ..reference.ttref.models.clip_text import CLIPTextEncoder as RefTextEncoder
from ..reference.ttref.models.geometry.space_generator import (
    SpaceGeneratorConfig as RefSGConfig,
)
from ..reference.ttref.models.geometry.triplane_geometry import (
    TriplaneGeometry as RefGeometry,
)
from ..reference.ttref.models.geometry.triplane_geometry import (
    TriplaneGeometryConfig as RefGeometryConfig,
)
from ..reference.ttref.models.networks import MLPConfig as RefMLPConfig
from ..reference.ttref.models.schedulers import SchedulerConfig as RefSchedulerConfig
from ..reference.ttref.models.schedulers import make_schedule as ref_make_schedule
from ..reference.ttref.models.tokenizer import CLIPTokenizer as RefTokenizer
from ..reference.ttref.pipelines.triplaneturbo_text_to_3d import (
    TriplaneTurboPipelineConfig as RefPipelineConfig,
)
from ..reference.ttref.pipelines.triplaneturbo_text_to_3d import (
    TriplaneTurboTextTo3DPipeline as RefPipeline,
)
from . import common, weights
from .cells import BENCH_DIR, Cell
from .compare import Checks, load_limits, rel_gap
from .control import Fp8Products
from .seeds import derive, derive32
from .trace import TracedWindow
from .work import WorkCounter

# -- the reference -----------------------------------------------------------------------

def reference_pipeline(config: Dict[str, Any], device, dtype_str: str) -> RefPipeline:
    """The plain reference's pipeline at the configuration's sizes, in ``dtype_str``,
    with its parameters uninitialised (``device`` may be meta)."""
    pcfg = RefPipelineConfig(**{**config["pipeline"], "dtype_str": dtype_str})
    sg = RefSGConfig(dtype_str=dtype_str, **_tuples(config["space_generator"]))
    geo_cfg = RefGeometryConfig(
        n_feature_dims=pcfg.n_feature_dims, sdf_bias=pcfg.sdf_bias,
        sdf_bias_params=pcfg.sdf_bias_params, rotate_planes=pcfg.rotate_planes,
        split_channels=pcfg.split_channels, geo_interpolate=pcfg.geo_interpolate,
        tex_interpolate=pcfg.tex_interpolate,
        isosurface_deformable_grid=pcfg.isosurface_deformable_grid, radius=pcfg.radius,
        space_generator=sg, mlp=RefMLPConfig())
    device = torch.device(device)
    with torch.device("meta"):
        geometry = RefGeometry(geo_cfg)
        text_encoder = RefTextEncoder(RefTextConfig(**config["text"]))
    if device.type != "meta":
        geometry = geometry.to_empty(device=device)
        text_encoder = text_encoder.to_empty(device=device)
    return RefPipeline(pcfg, geometry.eval(), text_encoder.eval(), RefTokenizer(),
                       ref_make_schedule(RefSchedulerConfig(), device=device), device)


def _tuples(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def load_weights(seed: int, device, pairs) -> None:
    """The benchmark's weights from ``seed`` into each (tag, reference meta module,
    target module)."""
    for tag, meta_module, target in pairs:
        w = weights.make_weights(meta_module, seed, tag, device)
        weights.load(target, w)
        del w


# -- the traffic -------------------------------------------------------------------------

class Traffic:
    def __init__(self, cell: Cell, seed: int, device):
        t = cell.traffic
        with open(os.path.join(BENCH_DIR, "traffic", t["prompt_library"])) as f:
            lib = json.load(f)
        prompts = lib[t.get("split", "train")] if isinstance(lib, dict) else list(lib)
        order = np.random.RandomState(derive32(seed, "prompts")).permutation(len(prompts))
        self.prompts = [prompts[i] for i in order]
        self.batch = int(t["batch"])
        self.seed = seed
        self.device = device
        pc = cell.config["pipeline"]
        self.latent_shape = (self.batch, 6, int(pc.get("latent_resolution", 32)),
                             int(pc.get("latent_resolution", 32)), int(pc.get("latent_channels", 4)))

    def call(self, i: int, tag: str = "window"):
        n = len(self.prompts)
        prompts = [self.prompts[(i * self.batch + j) % n] for j in range(self.batch)]
        gen = torch.Generator(device=self.device).manual_seed(derive(self.seed, tag, i))
        latents = torch.randn(self.latent_shape, generator=gen, device=self.device)
        return prompts, latents


# -- the work count ----------------------------------------------------------------------

def count_work(config: Dict[str, Any], batch: int) -> WorkCounter:
    """The FLOPs and kernel sites of one call of ``batch`` prompts, counted on the meta
    device through the reference's stages (marching cubes, whose sizes depend on the
    data, has no products; colour is taken at the vertex capacity)."""
    ref = reference_pipeline(config, "meta", config["pipeline"].get("dtype_str", "bfloat16"))
    pc = ref.cfg
    r = pc.latent_resolution
    with torch.no_grad(), WorkCounter() as w:
        text = ref.encode_prompt(["a"] * batch)
        x0 = ref.denoise_latents(text, torch.zeros((batch, pc.n_planes, r, r, pc.latent_channels),
                                                   device="meta"))
        planes = ref.geometry.decode(x0)
        for i in range(batch):
            ref.field_on_grid(planes[i])
            ref.colorize(torch.zeros((pc.max_verts, 3), device="meta"), planes[i])
    return w


# -- one run -----------------------------------------------------------------------------

def _mc_gap(mesh, ref_mesh) -> float:
    """The program's mesh against the reference's marching cubes on the program's own
    grid: inf unless the valid vertex and face counts agree; else the larger of the
    sorted vertex positions' largest gap (world units) and the sorted face areas' gap
    relative to the largest area. Order-free, so a kernel that numbers them otherwise
    reads the same."""
    pv = mesh.v_pos[mesh.v_mask.bool()].double()
    rv = ref_mesh.verts[ref_mesh.vert_mask.bool()].double().to(pv.device)
    pf = mesh.t_pos_idx[mesh.t_mask.bool()].long()
    rf = ref_mesh.faces[ref_mesh.face_mask.bool()].long().to(pv.device)
    if pv.shape != rv.shape or pf.shape != rf.shape:
        return float("inf")
    if len(pv) == 0:
        return 0.0
    pv_s = pv[np.lexsort(pv.cpu().numpy().T[::-1]).copy()]
    rv_s = rv[np.lexsort(rv.cpu().numpy().T[::-1]).copy()]

    def areas(v, f):
        tri = v[f]
        return 0.5 * torch.linalg.norm(torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                                                   dim=-1), dim=-1)

    pa = torch.sort(areas(mesh.v_pos.double(), pf)).values
    ra = torch.sort(areas(ref_mesh.verts.double().to(pv.device), rf)).values
    area_gap = rel_gap(pa, ra) if len(ra) else 0.0
    return max((pv_s - rv_s).abs().max().item(), area_gap)


def _record_calls(pipe) -> Dict[str, Any]:
    """Wrap the pipeline's text and grid stages so that a call's intermediate outputs
    are kept (references only, nothing computed) in the returned dict."""
    rec: Dict[str, Any] = {}
    encode, grid = pipe.encode_prompt, pipe.field_on_grid

    def encode_prompt(prompts):
        out = encode(prompts)
        rec["text"] = out
        return out

    def field_on_grid(space_cache_i):
        sdf, deform = grid(space_cache_i)
        rec["grids"].append((sdf, deform))
        return sdf, deform

    pipe.encode_prompt = encode_prompt
    pipe.field_on_grid = field_on_grid
    return rec


def compare_call(ref: RefPipeline, prompts: List[str], latents: torch.Tensor,
                 out: Dict[str, Any], checks: Checks) -> None:
    """The reference over one call's inputs, each stage from its own previous output,
    against what the program (or the control) produced: text states, x̂₀ after the
    denoise steps, the decoded planes, SDF and deformation on the grid; then the stages
    that follow on the program's own data: its marching cubes against the reference's on
    its grid, and its colour against the reference's at its vertices."""
    with torch.no_grad():
        text = ref.encode_prompt(prompts)
        checks.add("text_gap", rel_gap(out["text"], text))
        x0 = ref.denoise_latents(text, latents)
        checks.add("latent_gap", rel_gap(out["latents"], x0))
        planes = ref.geometry.decode(x0)
        checks.add("plane_gap", rel_gap(out["space_cache"], planes))
        for i, mesh in enumerate(out["mesh"]):
            sdf, deform = ref.field_on_grid(planes[i])
            psdf, pdef = out["grids"][i]
            checks.add("sdf_gap", rel_gap(psdf, sdf))
            checks.add("deform_gap", rel_gap(pdef, deform))
            checks.add("mc_gap", _mc_gap(mesh, ref.extract_mesh(psdf.float(), pdef.float())))
            valid = mesh.v_mask.bool()
            color = ref.colorize(mesh.v_pos.float(), planes[i])
            gap = (mesh.v_rgb[valid].double() - color[valid].double()).abs().max().item() \
                if bool(valid.any()) else 0.0
            checks.add("color_gap", gap)


def run_control(config, traffic: Traffic, calls, device, seed: int, checks: Checks) -> None:
    """The control: the reference one precision below the configuration's in the
    program's place, every stage from its own previous output, compared as the program
    is: fp8 products, and marching cubes on the grid rounded to bf16 (it has no
    products; its inputs are f32 in the configuration)."""
    from ..reference.ttref.utils.mesh import Mesh as RefMesh

    ref = reference_pipeline(config, device, "float32")
    meta = reference_pipeline(config, "meta", "float32")
    load_weights(seed, device, [("geometry", meta.geometry, ref.geometry),
                                ("text_encoder", meta.text_encoder, ref.text_encoder)])
    for i in calls:
        prompts, latents = traffic.call(i)
        with torch.no_grad(), common.reference_precision():
            with Fp8Products():
                text = ref.encode_prompt(prompts)
                x0 = ref.denoise_latents(text, latents)
                planes = ref.geometry.decode(x0)
                grids, meshes = [], []
                for j in range(len(prompts)):
                    sdf, deform = ref.field_on_grid(planes[j])
                    m = ref.extract_mesh(sdf.bfloat16().float(), deform.bfloat16().float())
                    grids.append((sdf, deform))
                    meshes.append(RefMesh(v_pos=m.verts, t_pos_idx=m.faces, v_mask=m.vert_mask,
                                          t_mask=m.face_mask,
                                          v_rgb=ref.colorize(m.verts, planes[j])))
            out = {"text": text, "latents": x0, "space_cache": planes, "grids": grids,
                   "mesh": meshes}
            compare_call(ref, prompts, latents, out, checks)


def build_program(config: Dict[str, Any], device):
    from triplaneturbo_torch.models.clip_text import CLIPTextConfig
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )

    return TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, seed=0, space_generator_overrides=_tuples(config["space_generator"]),
        text_config=CLIPTextConfig(**config["text"]), device=device, **config["pipeline"])


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, limits: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    config, t = cell.config, cell.traffic
    traffic = Traffic(cell, seed, device)
    pipe = build_program(config, device)
    common.log("program built", t_start)
    meta = reference_pipeline(config, "meta", "float32")
    load_weights(seed, device, [("geometry", meta.geometry, pipe.geometry),
                                ("text_encoder", meta.text_encoder, pipe.text_encoder)])
    common.log("weights loaded", t_start)
    for i in range(int(t.get("warmup_calls", 2))):
        prompts, latents = traffic.call(i, "warmup")
        pipe(prompts, latents=latents)
        common.sync(device)
        common.log(f"warm-up call {i} done", t_start)
    rec = _record_calls(pipe)
    keep = random.Random(derive32(seed, "sample"))
    k = int(t["sample_calls"])
    kept: Dict[int, Dict[str, Any]] = {}
    latencies: List[float] = []
    attempted = failed = 0
    n_trace = int(t["trace_calls"]) if trace else 0
    traced = None
    if n_trace:  # the profiler on, and a few calls under it before the window
        traced = TracedWindow(device).start()
        for j in range(int(t.get("trace_warmup_calls", 3))):
            prompts, latents = traffic.call(j, "trace-warmup")
            rec["grids"] = []
            pipe(prompts, latents=latents)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    i = 0
    while True:
        prompts, latents = traffic.call(i)
        if i == 0 and traced is not None:
            traced.begin()
        t0 = time.perf_counter()
        rec.clear()
        rec["grids"] = []
        attempted += len(prompts)
        try:
            out = pipe(prompts, latents=latents)
            common.sync(device)
        except RuntimeError as e:  # a failed call: counted, and the run is not correct
            print(f"port_bench: call {i} failed: {e!r}", file=sys.stderr)
            failed += len(prompts)
            out = None
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if traced is not None and i + 1 == n_trace:
            traced.end()
            traced.stop()
        if out is not None:
            record = {**out, "text": rec["text"], "grids": list(rec["grids"])}
            if len(kept) < k:
                kept[i] = record
            else:
                j = keep.randrange(i + 1)
                if j < k:
                    kept.pop(sorted(kept)[j])
                    kept[i] = record
        i += 1
        if t1 - t_window >= seconds and i >= n_trace:
            break
    window_s = t1 - t_window
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result: Dict[str, Any] = {"attempted": attempted, "failed": failed}
    if trace:
        summary = traced.summary()
        work = count_work(config, traffic.batch)
        ctx = {"trace": summary, "calls": n_trace, "units_per_call": traffic.batch,
               "work_flops": work.flops, "work_sites": work.sites}
        result["metrics"] = common.per_layer(cell, ctx)
        result["device_extra"] = {"busy_s": summary.busy_s, "window_s": summary.window_s}
        result["breakdown"] = summary.breakdown()
        del traced
    else:
        values = {"setup_s": setup_s, "prompt_ms": window_s * 1e3 / max(attempted - failed, 1)}
        if traffic.batch == 1 and len(latencies) >= 10:  # a call's latency is a prompt's
            values["prompt_ms_p90"] = statistics.quantiles(latencies, n=10)[8] * 1e3
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in values}
    result["device"] = common.device_record(device, peak)
    # the window is closed and the peak read: free the program, then check its answers
    common.log(f"window closed after {i} calls", t_start)
    samples = {i: (traffic.call(i), r) for i, r in kept.items()}
    del pipe, rec, kept, out
    common.free(device)
    checks = Checks(limits if limits is not None else load_limits(BENCH_DIR, cell.name))
    ref = reference_pipeline(config, device, "float32")
    load_weights(seed, device, [("geometry", meta.geometry, ref.geometry),
                                ("text_encoder", meta.text_encoder, ref.text_encoder)])
    with common.reference_precision():
        for i, ((prompts, latents), r) in sorted(samples.items()):
            compare_call(ref, prompts, latents, r, checks)
    common.log("reference done", t_start)
    result["correct"] = failed == 0 and bool(samples) and checks.correct()
    result["checks"] = checks
    return result

