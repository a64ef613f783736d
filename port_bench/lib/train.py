"""The training runner: whole v1 distillation steps through
``TriplaneTurboTrainer.train_step`` on the system ``systems/builder.py`` builds.

The configuration file holds the recipe (``data``, ``system``); the traffic file gives
``checked_steps`` (the steps set-up drives from the seed and the check compares),
``reference_steps`` (how many of them the reference follows), ``trace_steps`` (the
steps a traced run profiles) and the prompt library. Step k's prompts and cameras come
from the benchmark's data module (the reference's copy) seeded from ``--seed``, its
timesteps from a generator the benchmark seeds, and its draws (noise, volume, teacher
draws) from a ``torch.Generator`` seeded by (seed, k) that each side draws from in its
own code.

The check (:func:`compare_steps`) compares, after the reference has followed the first
steps from the same weights and inputs: program G's image gradients of the first step;
each leaf's change over the first step and over the steps the reference followed; and,
stage by stage in the first step, program R's images against the reference's and
program G's image gradients against the reference's teachers run on the program's own
images (:class:`FirstStepTap`).
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..reference.ttref.data.multiview_multiprompt import (
    DataModuleConfig as RefDataModuleConfig,
)
from ..reference.ttref.data.multiview_multiprompt import (
    MultiviewMultipromptDataModule as RefDataModule,
)
from ..reference.ttref.models.background.hashgrid_env_map import (
    HashgridBackgroundConfig as RefBgConfig,
)
from ..reference.ttref.models.background.hashgrid_env_map import (
    HashgridEnvironmentMapBackground as RefBackground,
)
from ..reference.ttref.models.background.hashgrid_env_map import HyperNetConfig as RefHyperNet
from ..reference.ttref.models.clip_text import CLIPTextConfig as RefTextConfig
from ..reference.ttref.models.clip_text import CLIPTextEncoder as RefTextEncoder
from ..reference.ttref.models.clip_text import sd15_text_config as ref_sd15_text_config
from ..reference.ttref.models.geometry.space_generator import (
    SpaceGeneratorConfig as RefSGConfig,
)
from ..reference.ttref.models.geometry.triplane_geometry import TriplaneGeometry as RefGeometry
from ..reference.ttref.models.geometry.triplane_geometry import (
    TriplaneGeometryConfig as RefGeometryConfig,
)
from ..reference.ttref.models.renderers.volume_renderer import (
    GenerativeSpaceSDFVolumeRenderer as RefVolume,
)
from ..reference.ttref.models.renderers.volume_renderer import (
    VolumeRendererConfig as RefVolumeConfig,
)
from ..reference.ttref.models.unet import UNet2DConditionModel as RefUNet
from ..reference.ttref.models.vae import AutoencoderKLEncoder as RefVAEEncoder
from ..reference.ttref.models.vae import VAEConfig as RefVAEConfig
from ..reference.ttref.ops.hashgrid import HashGridConfig as RefHashGridConfig
from ..reference.ttref.systems import builder as ref_builder
from ..reference.ttref.systems.prompt_setup import build_prompt_setup as ref_prompt_setup
from ..reference.ttref.utils.config import parse_structured as ref_parse
from . import common, weights
from .cells import BENCH_DIR, Cell
from .compare import Checks, load_limits
from .control import Fp8Products
from .seeds import derive, derive32
from .trace import TracedWindow
from .work import WorkCounter

_GEOMETRY_KEYS = ("n_feature_dims", "sdf_bias", "sdf_bias_params", "rotate_planes",
                  "split_channels", "geo_interpolate", "tex_interpolate", "radius")
_TEACHERS = {"mv": "mvdream_config", "rd": "richdreamer_config", "sd": "sd21_teacher_config"}


def _system(config: Dict[str, Any], f32: bool) -> Dict[str, Any]:
    cfg = {"system": copy.deepcopy(config["system"])}
    if f32:
        cfg["system"]["geometry"]["space_generator_config"]["dtype_str"] = "float32"
        cfg["system"]["teacher_dtype"] = "float32"
    return cfg


def reference_modules_meta(config: Dict[str, Any]) -> Dict[str, torch.nn.Module]:
    """Every module that takes weights, as the reference builds it, on the meta device:
    the names, shapes and kinds of the benchmark's weights."""
    from ..reference.ttref.models import unet as ref_unet

    sys_cfg = config["system"]
    geo_d = sys_cfg["geometry"]
    sg = ref_parse(RefSGConfig, dict(geo_d.get("space_generator_config", {})))
    bg_d = dict(sys_cfg.get("background", {}))
    sizes = dict(sys_cfg.get("teacher_sizes", {}) or {})
    c_dim = sg.cross_attention_dim
    with torch.device("meta"):
        mods = {
            "geometry": RefGeometry(RefGeometryConfig(
                space_generator=sg, **{k: geo_d[k] for k in _GEOMETRY_KEYS if k in geo_d})),
            "background": RefBackground(RefBgConfig(
                hypernet=RefHyperNet(c_dim=bg_d.get("c_dim", c_dim)),
                encoding=ref_parse(RefHashGridConfig, dict(bg_d.get("encoding", {}))))),
            "renderer": RefVolume(ref_parse(RefVolumeConfig, dict(sys_cfg.get("renderer_2nd", {})))),
            "text_15": RefTextEncoder(ref_sd15_text_config() if c_dim == 1024
                                      else RefTextConfig(width=c_dim)),
            "text_21": RefTextEncoder(RefTextConfig(width=c_dim)),
        }
        for kind, fn in _TEACHERS.items():
            ksizes = {k: tuple(v) if isinstance(v, list) else v
                      for k, v in dict(sizes.get(kind, {}) or {}).items()}
            vae_sizes = {k[4:]: ksizes.pop(k) for k in list(ksizes) if k.startswith("vae_")}
            from dataclasses import replace

            mods[f"{kind}_unet"] = RefUNet(replace(getattr(ref_unet, fn)("float32"), **ksizes))
            if kind in ("mv", "sd"):
                mods[f"{kind}_vae"] = RefVAEEncoder(RefVAEConfig(dtype_str="float32", **vae_sizes))
    return mods


def _targets(trainer, processor) -> Dict[str, torch.nn.Module]:
    g = trainer.guidance
    return {"geometry": trainer.geometry, "background": trainer.background,
            "renderer": trainer.volume_renderer, "text_15": processor.p1.enc.text_encoder,
            "text_21": processor.p2.enc.text_encoder, "mv_unet": g.mv.unet, "mv_vae": g.mv.vae,
            "rd_unet": g.rd.unet, "sd_unet": g.sd.unet, "sd_vae": g.sd.vae}


def _load_all(seed: int, device, meta: Dict[str, torch.nn.Module], targets) -> None:
    for tag, m in meta.items():
        w = weights.make_weights(m, seed, tag, device)
        weights.load(targets[tag], w)
        del w


class Inputs:
    """The benchmark's inputs of every step: batches, timesteps and draw seeds."""

    def __init__(self, cell: Cell, seed: int, device):
        data = dict(cell.config["data"])
        data["prompt_library"] = os.path.splitext(cell.traffic["prompt_library"])[0]
        data["prompt_library_dir"] = os.path.join(BENCH_DIR, "traffic")
        fields = RefDataModuleConfig.__dataclass_fields__
        self.negative_prompt = data.get("negative_prompt", "")
        self.dm = RefDataModule(RefDataModuleConfig(**{k: tuple(v) if isinstance(v, list) else v
                                                       for k, v in data.items() if k in fields}),
                                seed=derive32(seed, "data"))
        self.seed, self.device, self.k = seed, device, 0

    def timestep_rng(self) -> np.random.RandomState:
        return np.random.RandomState(derive32(self.seed, "timesteps"))

    def next(self):
        self.dm.update_step(self.k)
        batch_list = self.dm.sample_train_batch()
        gen = torch.Generator(device=self.device).manual_seed(derive(self.seed, "step", self.k))
        self.k += 1
        return batch_list, gen


def build_program(config: Dict[str, Any], device, cache_dir: str):
    from triplaneturbo_torch.systems.builder import build_system
    from triplaneturbo_torch.systems.prompt_setup import build_prompt_setup

    trainer = build_system(_system(config, f32=False), seed=0, device=device)
    neg = config["data"].get("negative_prompt", "")
    processor, embeds_for = build_prompt_setup(
        trainer.geometry.cfg.space_generator.cross_attention_dim, seed=0, negative_prompt=neg,
        device=device, cache_dir=cache_dir)
    return trainer, processor, embeds_for


def build_reference(config: Dict[str, Any], device, cache_dir: str,
                    teacher_dtype: str = "float32"):
    """The reference in f32; ``teacher_dtype`` sets its teachers' type (a witness of
    where a gap arises, ``calibrate.py``)."""
    cfg = _system(config, f32=True)
    cfg["system"]["teacher_dtype"] = teacher_dtype
    trainer = ref_builder.build_system(cfg, seed=0, device=device)
    neg = config["data"].get("negative_prompt", "")
    processor, embeds_for = ref_prompt_setup(
        trainer.geometry.cfg.space_generator.cross_attention_dim, seed=0, negative_prompt=neg,
        device=device, cache_dir=cache_dir)
    return trainer, processor, embeds_for


def _trainable(trainer) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in trainer.params_train.items()}


def _first_grad(trainer) -> Dict[str, torch.Tensor]:
    state = trainer.optimizer.adan.state
    return {n: state[p]["prev_grad"].detach().clone() if p in state and "prev_grad" in state[p]
            else torch.full_like(p, float("nan")) for n, p in trainer.params_train.items()}


def _per_prompt_gap(prog: torch.Tensor, ref: torch.Tensor, n_view: int) -> List[float]:
    """Per prompt (``n_view`` images each), ||prog - ref|| / ||ref||, in f64 on ``ref``'s
    device."""
    r = ref.detach().double()
    d = prog.detach().to(r.device).double() - r
    rn = r.reshape(r.shape[0] // n_view, -1).norm(dim=1)
    dn = d.reshape(d.shape[0] // n_view, -1).norm(dim=1)
    return [0.0 if float(b) == 0.0 and float(a) == 0.0 else float(a) / max(float(b), 1e-30)
            for a, b in zip(dn, rn)]


class FirstStepTap:
    """Program G (``_stage_teacher``) of the first step, tapped part by part: per image
    and prompt the norm of each image gradient; with ``keep``, the images and image
    gradients themselves, on the host, for the reference's teachers to judge; with
    ``judging``, each call's images and arguments, so that :meth:`judge` can run the
    teachers on another side's images of the same part once the step is done."""

    def __init__(self, trainer, keep: bool = False, judging: bool = False):
        self.trainer, self.keep, self.judging = trainer, keep, judging
        self.n_view = trainer.guidance.cfg.n_view
        self.names: List[str] = []
        self.norms: List[List[float]] = []
        self.parts: List[Dict[str, Dict[str, torch.Tensor]]] = []
        self.calls: List[Any] = []
        self.orig = trainer._stage_teacher
        self.had = "_stage_teacher" in trainer.__dict__
        trainer._stage_teacher = self

    def __call__(self, images, *args):
        res = self.orig(images, *args)
        grads = res[1]
        for name in sorted(grads):
            g = grads[name].detach()
            per_prompt = g.reshape(g.shape[0] // self.n_view, -1).double().norm(dim=1)
            self.names.append(name)
            self.norms.append([float(x) for x in per_prompt])
        if self.keep:
            self.parts.append({
                "images": {k: v.detach().float().cpu() for k, v in images.items()},
                "grads": {k: g.detach().float().cpu() for k, g in grads.items()}})
        if self.judging:
            self.calls.append(({k: v.detach() for k, v in images.items()}, args))
        return res

    def undo(self) -> None:
        if self.had:
            self.trainer._stage_teacher = self.orig
        else:
            self.trainer.__dict__.pop("_stage_teacher", None)

    def judge(self, candidate: List[Dict[str, Dict[str, torch.Tensor]]]) -> Dict[str, Any]:
        """Another side's first step against this one, part by part, per image and
        prompt: its images against these (``render``), and its image gradients against
        these teachers' on its own images, with this side's draws, text states and
        scalars (``teacher``)."""
        out: Dict[str, Dict[str, List[float]]] = {"render": {}, "teacher": {}}
        if len(candidate) != len(self.calls):
            return {"render": None, "teacher": None}
        for (images, args), rec in zip(self.calls, candidate):
            imgs = {k: rec["images"][k].to(device=v.device, dtype=v.dtype)
                    for k, v in images.items()}
            _, grads = self.orig(imgs, *args)
            for name in sorted(images):
                out["render"].setdefault(name, []).extend(
                    _per_prompt_gap(imgs[name], images[name], self.n_view))
                out["teacher"].setdefault(name, []).extend(
                    _per_prompt_gap(rec["grads"][name], grads[name], self.n_view))
            del imgs, grads
        return out


def drive_checked(trainer, embeds_for, inputs: Inputs, n: int, keep_at: int,
                  counter: Optional[WorkCounter] = None, keep_stage: bool = False,
                  judge: Optional[List[Any]] = None) -> Dict[str, Any]:
    """``n`` steps from the seed: each step's loss, the first step's image gradients
    (per prompt, their norms), the first gradient as the optimizer took it, the
    trainable leaves before, after the first step and after ``keep_at`` steps. With
    ``keep_stage``, the first step's program G images and gradients (``stage``); with
    ``judge`` (other sides' ``stage``), each judged against this side's first step
    (``judged``, :meth:`FirstStepTap.judge`)."""
    trainer.rng = inputs.timestep_rng()
    theta0 = _trainable(trainer)
    losses: List[float] = []
    g1 = theta1 = theta = None
    judged = None
    tap = FirstStepTap(trainer, keep=keep_stage, judging=bool(judge))
    for k in range(n):
        batch_list, gen = inputs.next()
        if counter is not None and k == 0:
            with counter:
                m = trainer.train_step(batch_list, embeds_for(batch_list[0]["prompt"]), gen)
        else:
            m = trainer.train_step(batch_list, embeds_for(batch_list[0]["prompt"]), gen)
        losses.append(float(m["loss"]))
        if k == 0:
            g1 = _first_grad(trainer)
            theta1 = _trainable(trainer)
            tap.undo()
            if judge:
                judged = [tap.judge(c) for c in judge]
            tap.calls = []
        if k + 1 == keep_at:
            theta = _trainable(trainer)
    out = {"losses": losses, "image_grads": tap.norms, "image_grad_names": tap.names,
           "g1": g1, "theta0": theta0, "theta1": theta1, "theta": theta}
    if keep_stage:
        out["stage"] = tap.parts
    if judge:
        out["judged"] = judged
    return out


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


def leaf_norms(res: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """The per-leaf norms the comparison reads: the first gradient, the change over the
    first step and over the steps the reference followed."""
    return {"g1": _norms(res["g1"]),
            "first_change": _norms({k: res["theta1"][k] - res["theta0"][k]
                                    for k in res["theta1"]}),
            "change": _norms({k: res["theta"][k] - res["theta0"][k] for k in res["theta"]})}


_RGB = ("comp_rgb",)  # the images MVDream and SD-2.1 score; RichDreamer scores the rest


def _median_of(readings: Dict[str, List[float]], rgb: bool) -> float:
    vals = [v for name, vs in readings.items() if name.startswith(_RGB) == rgb for v in vs]
    return float(np.median(vals)) if vals else float("inf")


def _leaf_gaps(p: Dict[str, float], r: Dict[str, float], keys: List[str]) -> List[float]:
    """| p - r | / max(r, the median leaf's r), leaf by leaf over ``keys``."""
    med = float(np.median([r[k] for k in keys])) if keys else 0.0
    return [abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keys] or [float("inf")]


def compare_steps(prog: Dict[str, Any], ref: Dict[str, Any], checks: Checks,
                  judged: Optional[Dict[str, Any]] = None) -> None:
    """The numbers of the training check (PERF.md section 2 says which are held).

    From the seed, both sides alike: ``loss_gap``, the first step's loss;
    ``image_grad_median_gap`` and ``image_grad_gap``, program G's image gradients of the
    first step per part, image and prompt, | ||p|| - ||r|| | / ||r||, their median and
    worst, and ``rgb_image_grad_gap`` / ``rd_image_grad_gap``, the median of the RGB
    images' (MVDream's and SD's) and of the normal and disparity images' (RichDreamer's);
    ``grad_gap``, ``grad_median_gap`` and ``grad_cos_gap``, the first gradient as the
    optimizer took it, leaf by leaf (the worst, the median leaf) and all leaves' cosine;
    ``first_change_median_gap`` and ``change_median_gap`` (``change_gap`` the worst), each
    leaf's change over the first step and over the steps the reference followed, leaf by
    leaf | ||dp|| - ||dr|| | / max(||dr||, the median leaf's), leaves whose first
    reference gradient is under a thousandth of the median leaf's left out.

    Stage by stage (``judged``, the reference's :meth:`FirstStepTap.judge` of this side's
    first step; by default ``ref["judged"][0]``), per part, image and prompt,
    ||p - r|| / ||r||, the median over the RGB images and over the rest:
    ``rgb_render_gap`` / ``geo_render_gap``, program R's images against the reference's;
    ``rgb_teacher_gap`` / ``rd_teacher_gap``, program G's image gradients against the
    reference's teachers on the program's own images."""
    lp, lr = prog["losses"][0], ref["losses"][0]
    checks.add("loss_gap", abs(lp - lr) / max(abs(lr), 1e-12))
    gaps = [abs(a - b) / max(b, 1e-30) for pa, ra in zip(prog["image_grads"], ref["image_grads"])
            for a, b in zip(pa, ra)]
    if len(prog["image_grads"]) != len(ref["image_grads"]) or not gaps:
        gaps = [float("inf")]
    checks.add("image_grad_gap", max(gaps))
    checks.add("image_grad_median_gap", float(np.median(gaps)))
    by_name: Dict[str, List[float]] = {}
    for name, pa, ra in zip(prog["image_grad_names"], prog["image_grads"], ref["image_grads"]):
        by_name.setdefault(name, []).extend(abs(a - b) / max(b, 1e-30) for a, b in zip(pa, ra))
    checks.add("rgb_image_grad_gap", _median_of(by_name, True))
    checks.add("rd_image_grad_gap", _median_of(by_name, False))
    P, R = leaf_norms(prog), leaf_norms(ref)
    gp, gr = P["g1"], R["g1"]
    g_gaps = _leaf_gaps(gp, gr, list(gr))
    checks.add("grad_gap", max(g_gaps))
    checks.add("grad_median_gap", float(np.median(g_gaps)))
    vp = torch.cat([prog["g1"][k].double().flatten() for k in gr])
    vr = torch.cat([ref["g1"][k].double().flatten() for k in gr])
    cos = float((vp @ vr) / max(float(vp.norm() * vr.norm()), 1e-300))
    checks.add("grad_cos_gap", 1.0 - cos)
    g_med = float(np.median(list(gr.values())))
    kept = [k for k in gr if gr[k] >= 1e-3 * g_med]
    checks.add("first_change_median_gap",
               float(np.median(_leaf_gaps(P["first_change"], R["first_change"], kept))))
    c_gaps = _leaf_gaps(P["change"], R["change"], kept)
    checks.add("change_gap", max(c_gaps))
    checks.add("change_median_gap", float(np.median(c_gaps)))
    if judged is None:
        judged = (ref.get("judged") or [None])[0]
    if judged is not None:
        for kind, (rgb_name, rest_name) in (("render", ("rgb_render_gap", "geo_render_gap")),
                                            ("teacher", ("rgb_teacher_gap", "rd_teacher_gap"))):
            readings = judged[kind]
            checks.add(rgb_name, _median_of(readings, True) if readings else float("inf"))
            checks.add(rest_name, _median_of(readings, False) if readings else float("inf"))


def _to_host(d: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(d)
    for key in ("g1", "theta0", "theta1", "theta"):
        out[key] = {n: t.cpu() for n, t in d[key].items()}
    return out


def run_reference(cell: Cell, seed: int, device, n_ref: int, counter=None,
                  control: bool = False, judge: Optional[List[Any]] = None) -> Dict[str, Any]:
    """The reference over the first ``n_ref`` steps of the seed, judging each of
    ``judge`` (other sides' first-step ``stage``) on the way; or, with ``control``, the
    reference in fp8 products, keeping its own ``stage`` for the reference to judge."""
    cache = tempfile.mkdtemp(prefix="port_bench_text_")
    try:
        with common.reference_precision():
            t0 = time.perf_counter()
            trainer, processor, embeds_for = build_reference(cell.config, device, cache)
            _load_all(seed, device, reference_modules_meta(cell.config),
                      _targets(trainer, processor))
            common.log("reference built", t0)
            inputs = Inputs(cell, seed, device)
            if control:
                with Fp8Products():
                    out = drive_checked(trainer, embeds_for, inputs, n_ref, n_ref,
                                        keep_stage=True)
            else:
                out = drive_checked(trainer, embeds_for, inputs, n_ref, n_ref, counter,
                                    judge=judge)
        out = _to_host(out)
        del trainer, processor, embeds_for
        common.free(device)
        return out
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, limits: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    t = cell.traffic
    n_checked, n_ref = int(t["checked_steps"]), int(t["reference_steps"])
    cache = tempfile.mkdtemp(prefix="port_bench_text_")
    try:
        trainer, processor, embeds_for = build_program(cell.config, device, cache)
        common.log("program built", t_start)
        _load_all(seed, device, reference_modules_meta(cell.config), _targets(trainer, processor))
        common.log("weights loaded", t_start)
        inputs = Inputs(cell, seed, device)
        checked = _to_host(drive_checked(trainer, embeds_for, inputs, n_checked, n_ref,
                                         keep_stage=True))
        common.sync(device)
        common.log(f"{n_checked} checked steps done", t_start)
        setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        n_trace = int(t["trace_steps"]) if trace else 0
        traced = TracedWindow(device).start() if n_trace else None
        attempted = failed = 0
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        while True:
            batch_list, gen = inputs.next()
            if attempted == 0 and traced is not None:
                traced.begin()
            attempted += 1
            skipped_before = trainer.optimizer.total_notfinite
            trainer.train_step(batch_list, embeds_for(batch_list[0]["prompt"]), gen)
            common.sync(device)
            failed += int(trainer.optimizer.total_notfinite > skipped_before)
            t1 = time.perf_counter()
            if traced is not None and attempted == n_trace:
                traced.end()
                traced.stop()
            if t1 - t_window >= seconds and attempted >= n_trace:
                break
        window_s = t1 - t_window
        window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        result: Dict[str, Any] = {"attempted": attempted, "failed": failed}
        summary = traced.summary() if traced is not None else None
        del traced
        del trainer, processor, embeds_for
        common.free(device)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    common.log(f"window closed after {attempted} steps", t_start)
    counter = WorkCounter() if trace else None
    ref = run_reference(cell, seed, device, n_ref, counter, judge=[checked.pop("stage")])
    common.log("reference done", t_start)
    if trace:
        ctx = {"trace": summary, "calls": n_trace, "units_per_call": 1,
               "work_flops": counter.flops, "work_sites": _as_configured(cell, counter.sites),
               "peak_window_bytes": window_peak}
        result["metrics"] = common.per_layer(cell, ctx)
        result["device_extra"] = {"busy_s": summary.busy_s, "window_s": summary.window_s}
        result["breakdown"] = summary.breakdown()
    else:
        values = {"setup_s": setup_s, "step_s": window_s / attempted}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in values}
    result["device"] = common.device_record(device, max(setup_peak, window_peak))
    checks = Checks(limits if limits is not None else load_limits(BENCH_DIR, cell.name))
    compare_steps(checked, ref, checks)
    result["correct"] = failed == 0 and checks.correct()
    result["checks"] = checks
    return result


def _as_configured(cell: Cell, sites: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The reference's sites in the type the configuration computes them in: it runs in
    f32, the configuration's student and teachers in ``dtype_str`` / ``teacher_dtype``."""
    sys_cfg = cell.config["system"]
    student = sys_cfg["geometry"]["space_generator_config"].get("dtype_str", "float32")
    if sys_cfg.get("teacher_dtype", "bfloat16") != student:
        raise ValueError("the attention sites' type is the student's and the teachers' alike")
    return [dict(s, dtype=student) if s["kind"] == "attention" else s for s in sites]

