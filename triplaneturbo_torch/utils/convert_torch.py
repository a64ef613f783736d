"""Reference checkpoint -> the port's parameters: the key mapping, in numpy.

The port's own copy of ``triplaneturbo_tpu/utils/convert_torch.py`` (it imports
nothing of the JAX package): the same functions under the same names map the
state dicts the reference ships onto flax-style parameter paths, and
:func:`apply_flat_to_module` writes those paths onto a port module's parameters
by the naming and layout rule of ``utils/weights.py`` (Dense kernel transposed,
HWIO -> OIHW, ``scale`` -> ``weight``).

* :func:`convert_unet`: diffusers ``UNet2DConditionModel`` state dict;
* :func:`convert_vae`: diffusers ``AutoencoderKL``;
* :func:`convert_clip_text`: HF ``CLIPTextModel``;
* :func:`convert_clip_vision`: HF ``CLIPModel`` / ``CLIPVisionModelWithProjection``
  (the evaluation harness's image tower, with the text projection apart);
* :func:`convert_adapters`: the TriplaneTurbo adapter checkpoint
  (``triplane_turbo_sd_v1.pth``: hexa-LoRA stacked on the plane axis in the
  routing order [xy_geo, xz_geo, yz_geo, xy_tex, xz_tex, yz_tex], vanilla
  LoRA, LoCon, the VAE ``conv_out`` retrofit, the field MLPs);
* :func:`extract_ema`, :func:`ldm_unet_to_diffusers`,
  :func:`ldm_vae_to_diffusers`, :func:`convert_ldm_teacher`: LDM-layout
  teacher checkpoints (MVDream, RichDreamer) with ``model_ema`` shadows.

Every converter takes and returns plain dicts of numpy arrays. ``_linear`` and
``_conv`` return views, not copies (the JAX package's make them contiguous): an
array is copied once, into its parameter, and a zero-stride input (a shape-only
check at full width) is never materialised.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .weights import _torch_leaf

PLANE_ORDER = ["xy_lora_geo", "xz_lora_geo", "yz_lora_geo", "xy_lora_tex", "xz_lora_tex", "yz_lora_tex"]


def _linear(w: np.ndarray) -> np.ndarray:
    return w.T


def _conv(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)


def _norm_pair(src: Dict, prefix: str, dst: Dict, out_prefix: str) -> None:
    if f"{prefix}.weight" in src:
        dst[f"{out_prefix}/scale"] = np.asarray(src[f"{prefix}.weight"])
        dst[f"{out_prefix}/bias"] = np.asarray(src[f"{prefix}.bias"])


def _linear_pair(src: Dict, prefix: str, dst: Dict, out_prefix: str) -> None:
    if f"{prefix}.weight" in src:
        dst[f"{out_prefix}/kernel"] = _linear(np.asarray(src[f"{prefix}.weight"]))
        if f"{prefix}.bias" in src:
            dst[f"{out_prefix}/bias"] = np.asarray(src[f"{prefix}.bias"])


def _conv_pair(src: Dict, prefix: str, dst: Dict, out_prefix: str) -> None:
    if f"{prefix}.weight" in src:
        dst[f"{out_prefix}/kernel"] = _conv(np.asarray(src[f"{prefix}.weight"]))
        if f"{prefix}.bias" in src:
            dst[f"{out_prefix}/bias"] = np.asarray(src[f"{prefix}.bias"])


def _resnet(src: Dict, p: str, dst: Dict, o: str) -> None:
    _norm_pair(src, f"{p}.norm1", dst, f"{o}/norm1")
    _conv_pair(src, f"{p}.conv1", dst, f"{o}/conv1/conv")
    _linear_pair(src, f"{p}.time_emb_proj", dst, f"{o}/time_emb_proj")
    _norm_pair(src, f"{p}.norm2", dst, f"{o}/norm2")
    _conv_pair(src, f"{p}.conv2", dst, f"{o}/conv2/conv")
    _conv_pair(src, f"{p}.conv_shortcut", dst, f"{o}/conv_shortcut/conv")


def _attn_block(src: Dict, p: str, dst: Dict, o: str) -> None:
    """diffusers Transformer2DModel -> our Transformer2D."""
    _norm_pair(src, f"{p}.norm", dst, f"{o}/norm")
    _linear_pair(src, f"{p}.proj_in", dst, f"{o}/proj_in")
    _linear_pair(src, f"{p}.proj_out", dst, f"{o}/proj_out")
    i = 0
    while f"{p}.transformer_blocks.{i}.norm1.weight" in src:
        b = f"{p}.transformer_blocks.{i}"
        ob = f"{o}/transformer_blocks_{i}"
        for n in ("norm1", "norm2", "norm3"):
            _norm_pair(src, f"{b}.{n}", dst, f"{ob}/{n}")
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _linear_pair(src, f"{b}.{attn}.{proj}", dst, f"{ob}/{attn}/{proj}")
            _linear_pair(src, f"{b}.{attn}.to_out.0", dst, f"{ob}/{attn}/to_out")
        _linear_pair(src, f"{b}.ff.net.0.proj", dst, f"{ob}/ff/net_0/proj")
        _linear_pair(src, f"{b}.ff.net.2", dst, f"{ob}/ff/net_2")
        i += 1


def convert_unet(src: Dict[str, Any], n_blocks: int = 4, layers_per_block: int = 2) -> Dict[str, np.ndarray]:
    """diffusers UNet2DConditionModel -> flat {path: array} for our UNet."""
    dst: Dict[str, np.ndarray] = {}
    _conv_pair(src, "conv_in", dst, "conv_in/conv")
    _linear_pair(src, "time_embedding.linear_1", dst, "time_embedding_linear_1")
    _linear_pair(src, "time_embedding.linear_2", dst, "time_embedding_linear_2")
    # MVDream/RichDreamer camera embedding MLP (openaimodel.py:937-940)
    _linear_pair(src, "camera_embed.0", dst, "camera_embedding_linear_1")
    _linear_pair(src, "camera_embed.2", dst, "camera_embedding_linear_2")

    for i in range(n_blocks):
        for j in range(layers_per_block):
            _resnet(src, f"down_blocks.{i}.resnets.{j}", dst, f"down_{i}_res_{j}")
            _attn_block(src, f"down_blocks.{i}.attentions.{j}", dst, f"down_{i}_attn_{j}")
        _conv_pair(src, f"down_blocks.{i}.downsamplers.0.conv", dst, f"down_{i}_downsample/conv/conv")
    _resnet(src, "mid_block.resnets.0", dst, "mid_res_0")
    _attn_block(src, "mid_block.attentions.0", dst, "mid_attn")
    _resnet(src, "mid_block.resnets.1", dst, "mid_res_1")
    for i in range(n_blocks):
        for j in range(layers_per_block + 1):
            _resnet(src, f"up_blocks.{i}.resnets.{j}", dst, f"up_{i}_res_{j}")
            _attn_block(src, f"up_blocks.{i}.attentions.{j}", dst, f"up_{i}_attn_{j}")
        _conv_pair(src, f"up_blocks.{i}.upsamplers.0.conv", dst, f"up_{i}_upsample/conv/conv")
    _norm_pair(src, "conv_norm_out", dst, "conv_norm_out")
    _conv_pair(src, "conv_out", dst, "conv_out/conv")
    return dst


def _vae_attn(src: Dict, p: str, dst: Dict, o: str) -> None:
    _norm_pair(src, f"{p}.group_norm", dst, f"{o}/group_norm")
    names = (
        [("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out.0", "to_out")]
        if f"{p}.to_q.weight" in src
        else [("query", "to_q"), ("key", "to_k"), ("value", "to_v"), ("proj_attn", "to_out")]
    )
    for s_name, o_name in names:
        _linear_pair(src, f"{p}.{s_name}", dst, f"{o}/attention/{o_name}")


def convert_vae(src: Dict[str, Any], n_blocks: int = 4, layers_per_block: int = 2) -> Dict[str, np.ndarray]:
    """diffusers AutoencoderKL -> flat params for our AutoencoderKL
    (decoder + encoder + quant convs; decoder.conv_out only maps when shapes
    agree — the student replaces it with the retrofit conv)."""
    dst: Dict[str, np.ndarray] = {}
    _conv_pair(src, "quant_conv", dst, "quant_conv")
    _conv_pair(src, "post_quant_conv", dst, "post_quant_conv")

    # decoder
    _conv_pair(src, "decoder.conv_in", dst, "decoder/conv_in/conv")
    _resnet(src, "decoder.mid_block.resnets.0", dst, "decoder/mid_res_0")
    _vae_attn(src, "decoder.mid_block.attentions.0", dst, "decoder/mid_attn")
    _resnet(src, "decoder.mid_block.resnets.1", dst, "decoder/mid_res_1")
    for i in range(n_blocks):
        for j in range(layers_per_block + 1):
            _resnet(src, f"decoder.up_blocks.{i}.resnets.{j}", dst, f"decoder/up_{i}_res_{j}")
        _conv_pair(src, f"decoder.up_blocks.{i}.upsamplers.0.conv", dst, f"decoder/up_{i}_upsample/conv/conv")
    _norm_pair(src, "decoder.conv_norm_out", dst, "decoder/conv_norm_out")
    _conv_pair(src, "decoder.conv_out", dst, "decoder/conv_out")

    # encoder
    _conv_pair(src, "encoder.conv_in", dst, "encoder/conv_in/conv")
    for i in range(n_blocks):
        for j in range(layers_per_block):
            _resnet(src, f"encoder.down_blocks.{i}.resnets.{j}", dst, f"encoder/down_{i}_res_{j}")
        _conv_pair(src, f"encoder.down_blocks.{i}.downsamplers.0.conv", dst, f"encoder/down_{i}_downsample/conv")
    _resnet(src, "encoder.mid_block.resnets.0", dst, "encoder/mid_res_0")
    _vae_attn(src, "encoder.mid_block.attentions.0", dst, "encoder/mid_attn")
    _resnet(src, "encoder.mid_block.resnets.1", dst, "encoder/mid_res_1")
    _norm_pair(src, "encoder.conv_norm_out", dst, "encoder/conv_norm_out")
    _conv_pair(src, "encoder.conv_out", dst, "encoder/conv_out")
    return dst


def convert_clip_text(src: Dict[str, Any], n_layers: int = 23) -> Dict[str, np.ndarray]:
    """HF CLIPTextModel -> flat params for CLIPTextEncoder."""
    dst: Dict[str, np.ndarray] = {}
    p = "text_model." if any(k.startswith("text_model.") for k in src) else ""
    dst["token_embedding/embedding"] = np.asarray(src[f"{p}embeddings.token_embedding.weight"])
    dst["position_embedding"] = np.asarray(src[f"{p}embeddings.position_embedding.weight"])
    for i in range(n_layers):
        b = f"{p}encoder.layers.{i}"
        o = f"layers_{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear_pair(src, f"{b}.self_attn.{proj}", dst, f"{o}/self_attn/{proj}")
        _norm_pair(src, f"{b}.layer_norm1", dst, f"{o}/layer_norm1")
        _norm_pair(src, f"{b}.layer_norm2", dst, f"{o}/layer_norm2")
        _linear_pair(src, f"{b}.mlp.fc1", dst, f"{o}/mlp_fc1")
        _linear_pair(src, f"{b}.mlp.fc2", dst, f"{o}/mlp_fc2")
    _norm_pair(src, f"{p}final_layer_norm", dst, "final_layer_norm")
    return dst


def convert_clip_vision(src: Dict[str, Any], n_layers: int = 12) -> Dict[str, np.ndarray]:
    """HF CLIPModel / CLIPVisionModelWithProjection -> flat params for CLIPVisionEncoder.

    The patch, class and position embeddings, the ViT stack, both layer norms (HF's
    ``pre_layrnorm`` spelling too) and ``visual_projection``, under an optional
    ``vision_model.`` prefix; ``text_projection`` comes back under
    ``__text_projection__`` ([width, projection_dim]), for the scorer's text side."""
    dst: Dict[str, np.ndarray] = {}
    p = "vision_model." if any(k.startswith("vision_model.") for k in src) else ""
    if f"{p}embeddings.patch_embedding.weight" in src:
        dst["patch_embedding/kernel"] = _conv(
            np.asarray(src[f"{p}embeddings.patch_embedding.weight"]))
        dst["class_embedding"] = np.asarray(src[f"{p}embeddings.class_embedding"]).reshape(-1)
        dst["position_embedding"] = np.asarray(src[f"{p}embeddings.position_embedding.weight"])
    for hf_name, our_name in ((f"{p}pre_layrnorm", "pre_layernorm"),
                              (f"{p}pre_layernorm", "pre_layernorm"),
                              (f"{p}post_layernorm", "post_layernorm")):
        _norm_pair(src, hf_name, dst, our_name)
    for i in range(n_layers):
        b = f"{p}encoder.layers.{i}"
        o = f"layers_{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear_pair(src, f"{b}.self_attn.{proj}", dst, f"{o}/self_attn/{proj}")
        _norm_pair(src, f"{b}.layer_norm1", dst, f"{o}/layer_norm1")
        _norm_pair(src, f"{b}.layer_norm2", dst, f"{o}/layer_norm2")
        _linear_pair(src, f"{b}.mlp.fc1", dst, f"{o}/mlp_fc1")
        _linear_pair(src, f"{b}.mlp.fc2", dst, f"{o}/mlp_fc2")
    if "visual_projection.weight" in src:
        dst["visual_projection/kernel"] = _linear(np.asarray(src["visual_projection.weight"]))
    if "text_projection.weight" in src:
        dst["__text_projection__"] = _linear(np.asarray(src["text_projection.weight"]))
    return dst


def convert_adapters(src: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """TriplaneTurbo adapter checkpoint (``triplane_turbo_sd_v1.pth``) -> flat params.

    The reference loads this with ``geometry.load_state_dict(sd, strict=False)``
    (triplaneturbo_text_to_3d.py:166-177), so the key space is the executable
    geometry module's state dict (``geometry.`` stripped):

    * hexa self-attn LoRA: six torch modules per projection,
      ``...attn1.processor.to_{q,k,v,out}_{xy,xz,yz}_lora_{geo,tex}.{down,up}.weight``
      (sd_dual_triplane_modules.py:236-276) -> ONE stacked tensor
      ``.../attn1/lora_{q,k,v,out}/{down,up}`` with a leading plane axis in
      routing order [xy_geo, xz_geo, yz_geo, xy_tex, xz_tex, yz_tex]
      (= batch strides 0::6 .. 5::6, :305-320);
    * vanilla LoRA (cross-attn "vanilla", VAE "basic"):
      ``...processor.to_q_lora.{down,up}.weight`` (:273-276);
    * LoCon conv adapters: ``<conv>.lora_layer.{down,up}.weight``
      (vanilla_v1, :154-157 / _set_conv_processor :869-888);
    * VAE conv_out retrofit ``space_generator.vae.decoder.conv_out.{weight,bias}``
      (:833-846); field MLPs ``{sdf,feature,deformation}_network.layers.{2i}.weight``.
    """
    dst: Dict[str, np.ndarray] = {}

    # field MLPs: Sequential Linear at even indices
    for tname, fname in (
        ("sdf_network", "field/sdf_network"),
        ("feature_network", "field/feature_network"),
        ("deformation_network", "field/deformation_network"),
    ):
        for i in range(8):
            k = f"{tname}.layers.{2*i}.weight"
            if k in src:
                dst[f"{fname}/Dense_{i}/kernel"] = _linear(np.asarray(src[k]))

    # collect hexa groups: strip the per-plane tag, stack over PLANE_ORDER
    hexa: Dict[str, List[Optional[np.ndarray]]] = {}
    for k, v in src.items():
        m = re.match(
            r"(.*)\.to_(q|k|v|out)_(xy|xz|yz)_lora_(geo|tex)\.(down|up|bias)(\.weight)?$", k
        )
        if not m:
            continue
        base, proj, plane, kind, which = m.group(1), m.group(2), m.group(3), m.group(4), m.group(5)
        slot = PLANE_ORDER.index(f"{plane}_lora_{kind}")
        hexa.setdefault(f"{base}|{proj}|{which}", [None] * 6)[slot] = np.asarray(v)
    for key, vals in hexa.items():
        base, proj, which = key.split("|")
        if any(x is None for x in vals):
            continue
        out_base = _map_attn_path(base) + f"/lora_{proj}"
        if which in ("down", "up"):
            dst[f"{out_base}/{which}"] = np.stack([_linear(x) for x in vals])
        else:
            # torch bias is a [1, 1, out] Parameter; ours is [P, out]
            dst[f"{out_base}/bias"] = np.stack([x.reshape(-1) for x in vals])

    # vanilla LoRA (cross attention / vae 'basic')
    for k, v in src.items():
        m = re.match(r"(.*)\.to_(q|k|v|out)_lora\.(down|up|bias)(\.weight)?$", k)
        if m:
            out_base = _map_attn_path(m.group(1))
            which = m.group(3)
            arr = np.asarray(v)
            dst[f"{out_base}/lora_{m.group(2)}/{which}"] = (
                _linear(arr) if which in ("down", "up") else arr.reshape(-1)
            )

    # LoCon conv adapters
    for k, v in src.items():
        m = re.match(r"(.*)\.lora_layer\.(down|up)\.(weight|bias)$", k)
        if m:
            out_base = _map_conv_path(m.group(1))
            which = "kernel" if m.group(3) == "weight" else "bias"
            arr = np.asarray(v)
            dst[f"{out_base}/locon/{m.group(2)}/{which}"] = (
                _conv(arr) if which == "kernel" else arr
            )

    # conv_out retrofit (the replaced 128 -> output_dim decoder conv)
    for k, v in src.items():
        if re.search(r"vae\.decoder\.conv_out\.(weight|bias)$", k):
            which = "kernel" if k.endswith("weight") else "bias"
            arr = np.asarray(v)
            dst[f"space_generator/vae/decoder/conv_out_retrofit/{which}"] = (
                _conv(arr) if which == "kernel" else arr
            )
    return dst


def _map_attn_path(torch_path: str) -> str:
    """Attention-processor torch path -> flax module path.

    ``space_generator.unet.down_blocks.0.attentions.1.transformer_blocks.0.attn1.processor``
    -> ``space_generator/unet/down_0_attn_1/transformer_blocks_0/attn1``;
    ``space_generator.vae.decoder.mid_block.attentions.0.processor``
    -> ``space_generator/vae/decoder/mid_attn/attention``.
    """
    p = re.sub(r"\.processor$", "", torch_path)
    p = re.sub(r"^(space_generator\.)?", "", p)
    root = "space_generator/vae" if p.startswith("vae.") else "space_generator/unet"
    p = re.sub(r"^(unet|vae)\.", "", p)
    p = re.sub(r"down_blocks\.(\d+)\.attentions\.(\d+)", r"down_\1_attn_\2", p)
    p = re.sub(r"up_blocks\.(\d+)\.attentions\.(\d+)", r"up_\1_attn_\2", p)
    p = re.sub(r"mid_block\.attentions\.0", "mid_attn", p)
    if root.endswith("vae"):
        # our VAE attention block wraps the shared Attention module under
        # an extra "attention" scope (vae.py VAEAttnBlock)
        p = re.sub(r"mid_attn$", "mid_attn.attention", p)
    p = re.sub(r"transformer_blocks\.(\d+)", r"transformer_blocks_\1", p)
    p = p.replace(".", "/")
    return f"{root}/{p}"


def _map_conv_path(torch_path: str) -> str:
    """Resnet/sampler conv paths -> AdaptedConv module paths."""
    p = re.sub(r"^(space_generator\.)?", "", torch_path)
    root = "space_generator/vae" if p.startswith("vae.") else "space_generator/unet"
    p = re.sub(r"^(unet|vae)\.", "", p)
    p = re.sub(r"down_blocks\.(\d+)\.resnets\.(\d+)\.", r"down_\1_res_\2.", p)
    p = re.sub(r"up_blocks\.(\d+)\.resnets\.(\d+)\.", r"up_\1_res_\2.", p)
    p = re.sub(r"mid_block\.resnets\.(\d+)\.", r"mid_res_\1.", p)
    p = re.sub(r"down_blocks\.(\d+)\.downsamplers\.0\.conv", r"down_\1_downsample.conv", p)
    p = re.sub(r"up_blocks\.(\d+)\.upsamplers\.0\.conv", r"up_\1_upsample.conv", p)
    p = p.replace(".", "/")
    return f"{root}/{p}"


@torch.no_grad()
def apply_flat_to_module(flat_src: Dict[str, np.ndarray], module: torch.nn.Module,
                         prefix: str = "") -> Tuple[List[str], List[str]]:
    """Write flat ``{flax path: array}`` entries onto ``module``'s parameters.

    Each ``prefix + path`` names one parameter by the rule of
    ``utils/weights.py``; its array is laid out for torch, checked against the
    parameter's shape and cast to the parameter's dtype. A parameter on the meta
    device is checked and not written. Returns (the names of the parameters
    loaded, the paths not loaded with the reason)."""
    params = dict(module.named_parameters())
    loaded, mismatched = [], []
    for k, v in flat_src.items():
        path = prefix + k
        name, arr = _torch_leaf(path, np.asarray(v), contiguous=False)
        p = params.get(name)
        if p is None:
            mismatched.append(f"{path}: not in module")
        elif tuple(p.shape) != arr.shape:
            mismatched.append(f"{path}: ckpt{arr.shape} != module{tuple(p.shape)}")
        else:
            if not p.is_meta:
                p.copy_(torch.tensor(arr, dtype=p.dtype, device=p.device))
            loaded.append(name)
    return loaded, mismatched


# ---------------------------------------------------------------------------
# LDM-format checkpoints (MVDream sd-v2.1-base-4view.pt / RichDreamer
# nd_mv_ema.ckpt): model.diffusion_model.{input,middle,output}_blocks naming
# + model_ema shadow weights (extern/mvdream/model_zoo.py:35-58,
# extern/nd_sd/model_zoo.py:21-61). Strategy: extract EMA, rename LDM keys to
# the diffusers naming convert_unet/convert_vae already consume, reuse them.
# ---------------------------------------------------------------------------


def extract_ema(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """Replace ``model.*`` params with their ``model_ema.*`` shadows.

    Mirrors extern/nd_sd/model_zoo.py:21-61: the EMA buffer name is the
    parameter name with dots stripped (``model_ema.diffusion_modelout2weight``
    for ``model.diffusion_model.out.2.weight``). Keys without a shadow are
    kept as-is; ``model_ema.decay``/``num_updates`` bookkeeping is dropped.
    """
    ema = {k[len("model_ema."):]: v for k, v in ckpt.items() if k.startswith("model_ema.")}
    if not ema:
        return ckpt
    out = {}
    for k, v in ckpt.items():
        if k.startswith("model_ema."):
            continue
        if k.startswith("model."):
            s_name = k[len("model."):].replace(".", "")
            v = ema.get(s_name, v)
        out[k] = v
    return out


def _ldm_resblock_rename(sub: str) -> Optional[str]:
    """openaimodel ResBlock key -> diffusers ResnetBlock2D key."""
    table = {
        "in_layers.0": "norm1",
        "in_layers.2": "conv1",
        "emb_layers.1": "time_emb_proj",
        "out_layers.0": "norm2",
        "out_layers.3": "conv2",
        "skip_connection": "conv_shortcut",
    }
    for src_name, dst_name in table.items():
        if sub.startswith(src_name + "."):
            return dst_name + sub[len(src_name):]
    return None


def ldm_unet_to_diffusers(
    src: Dict[str, Any],
    n_blocks: int = 4,
    layers_per_block: int = 2,
    prefix: str = "model.diffusion_model.",
) -> Dict[str, np.ndarray]:
    """Rename MultiViewUNetModel (openaimodel.py:811-1209 /
    openaimodel_v2_1.py:851-1212) state-dict keys to diffusers naming.

    Handles the index arithmetic: input_blocks.{1 + i*(L+1) + j}.0 is
    down-res (i, j), .1 the spatial transformer, the (L+1)-th entry of a level
    the downsample ``op``; output_blocks.{i*(L+1)+j} analogously with the
    upsample conv appended as the last module of a level. 1x1-conv transformer
    projections (RichDreamer: use_linear_in_transformer unset) squeeze to
    linear layout.
    """
    L = layers_per_block
    dst: Dict[str, np.ndarray] = {}
    direct = {
        "time_embed.0": "time_embedding.linear_1",
        "time_embed.2": "time_embedding.linear_2",
        "camera_embed.0": "camera_embed.0",
        "camera_embed.2": "camera_embed.2",
        "input_blocks.0.0": "conv_in",
        "out.0": "conv_norm_out",
        "out.2": "conv_out",
        "middle_block.0": "mid_block.resnets.0",
        "middle_block.1": "mid_block.attentions.0",
        "middle_block.2": "mid_block.resnets.1",
    }

    def put(new_key: str, v: Any) -> None:
        arr = np.asarray(v)
        # transformer proj_in/proj_out as 1x1 convs -> linear
        if (
            arr.ndim == 4
            and arr.shape[-1] == 1
            and arr.shape[-2] == 1
            and ("proj_in" in new_key or "proj_out" in new_key)
        ):
            arr = arr[:, :, 0, 0]
        dst[new_key] = arr

    for k, v in src.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        matched = False
        for ldm_name, diff_name in direct.items():
            if k.startswith(ldm_name + "."):
                sub = k[len(ldm_name) + 1:]
                if "resnets" in diff_name or ldm_name.startswith("middle_block.0") or ldm_name.startswith("middle_block.2"):
                    renamed = _ldm_resblock_rename(sub)
                    if renamed is not None:
                        sub = renamed
                put(f"{diff_name}.{sub}", v)
                matched = True
                break
        if matched:
            continue

        m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)$", k)
        if m:
            idx, mod, sub = int(m.group(1)), int(m.group(2)), m.group(3)
            level = (idx - 1) // (L + 1)
            pos = (idx - 1) % (L + 1)
            if pos == L:  # downsample entry
                if sub.startswith("op."):
                    put(f"down_blocks.{level}.downsamplers.0.conv.{sub[3:]}", v)
                continue
            if mod == 0:
                renamed = _ldm_resblock_rename(sub)
                if renamed is not None:
                    put(f"down_blocks.{level}.resnets.{pos}.{renamed}", v)
            else:
                put(f"down_blocks.{level}.attentions.{pos}.{sub}", v)
            continue

        m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)$", k)
        if m:
            idx, mod, sub = int(m.group(1)), int(m.group(2)), m.group(3)
            level = idx // (L + 1)
            pos = idx % (L + 1)
            if mod == 0:
                renamed = _ldm_resblock_rename(sub)
                if renamed is not None:
                    put(f"up_blocks.{level}.resnets.{pos}.{renamed}", v)
            elif sub.startswith("conv."):
                # the upsample module appended at the end of a level
                put(f"up_blocks.{level}.upsamplers.0.{sub}", v)
            else:
                put(f"up_blocks.{level}.attentions.{pos}.{sub}", v)
            continue
    return dst


def _ldm_vae_resblock(sub: str) -> Optional[str]:
    table = {
        "norm1": "norm1",
        "conv1": "conv1",
        "temb_proj": "time_emb_proj",
        "norm2": "norm2",
        "conv2": "conv2",
        "nin_shortcut": "conv_shortcut",
        "conv_shortcut": "conv_shortcut",
    }
    head = sub.split(".", 1)[0]
    if head in table:
        return table[head] + sub[len(head):]
    return None


def ldm_vae_to_diffusers(
    src: Dict[str, Any],
    n_blocks: int = 4,
    prefix: str = "first_stage_model.",
) -> Dict[str, np.ndarray]:
    """CompVis AutoencoderKL naming -> diffusers naming.

    encoder.down.{i}.block.{j} -> encoder.down_blocks.{i}.resnets.{j};
    decoder.up.{i} is REVERSED: decoder.up.{n-1-i} -> decoder.up_blocks.{i};
    mid.block_1/attn_1/block_2 -> mid_block.resnets.0/attentions.0/resnets.1;
    attn q/k/v/proj_out 1x1 convs -> to_q/to_k/to_v/to_out linears.
    """
    dst: Dict[str, np.ndarray] = {}
    # "to_out.0": diffusers wraps the out projection in a ModuleList — the
    # name convert_vae's _vae_attn looks up (a bare "to_out" is skipped
    # silently, leaving the projection random: caught by the VAE parity test)
    attn_names = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0", "norm": "group_norm"}

    def put(new_key: str, v: Any, squeeze_attn: bool = False) -> None:
        arr = np.asarray(v)
        if squeeze_attn and arr.ndim == 4 and arr.shape[-1] == 1 and arr.shape[-2] == 1:
            arr = arr[:, :, 0, 0]
        dst[new_key] = arr

    for k, v in src.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k in ("quant_conv.weight", "quant_conv.bias", "post_quant_conv.weight", "post_quant_conv.bias"):
            put(k, v)
            continue
        m = re.match(r"(encoder|decoder)\.(.*)$", k)
        if not m:
            continue
        tower, rest = m.group(1), m.group(2)

        if rest.startswith("conv_in.") or rest.startswith("conv_out."):
            put(f"{tower}.{rest}", v)
            continue
        if rest.startswith("norm_out."):
            put(f"{tower}.conv_norm_out.{rest[len('norm_out.'):]}", v)
            continue
        mm = re.match(r"mid\.block_(\d)\.(.*)$", rest)
        if mm:
            renamed = _ldm_vae_resblock(mm.group(2))
            if renamed is not None:
                put(f"{tower}.mid_block.resnets.{int(mm.group(1)) - 1}.{renamed}", v)
            continue
        mm = re.match(r"mid\.attn_1\.(\w+)\.(.*)$", rest)
        if mm and mm.group(1) in attn_names:
            put(
                f"{tower}.mid_block.attentions.0.{attn_names[mm.group(1)]}.{mm.group(2)}",
                v,
                squeeze_attn=mm.group(1) != "norm",
            )
            continue
        mm = re.match(r"down\.(\d+)\.block\.(\d+)\.(.*)$", rest)
        if mm:
            renamed = _ldm_vae_resblock(mm.group(3))
            if renamed is not None:
                put(f"encoder.down_blocks.{mm.group(1)}.resnets.{mm.group(2)}.{renamed}", v)
            continue
        mm = re.match(r"down\.(\d+)\.downsample\.conv\.(.*)$", rest)
        if mm:
            put(f"encoder.down_blocks.{mm.group(1)}.downsamplers.0.conv.{mm.group(2)}", v)
            continue
        mm = re.match(r"up\.(\d+)\.block\.(\d+)\.(.*)$", rest)
        if mm:
            i = n_blocks - 1 - int(mm.group(1))
            renamed = _ldm_vae_resblock(mm.group(3))
            if renamed is not None:
                put(f"decoder.up_blocks.{i}.resnets.{mm.group(2)}.{renamed}", v)
            continue
        mm = re.match(r"up\.(\d+)\.upsample\.conv\.(.*)$", rest)
        if mm:
            i = n_blocks - 1 - int(mm.group(1))
            put(f"decoder.up_blocks.{i}.upsamplers.0.conv.{mm.group(2)}", v)
            continue
    return dst


def convert_ldm_teacher(
    ckpt: Dict[str, Any],
    n_blocks: int = 4,
    layers_per_block: int = 2,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Full LDM teacher checkpoint -> {"unet": flat, "vae": flat} for our trees.

    Applies EMA extraction (RichDreamer's nd_mv_ema.ckpt ships shadow
    weights), then the two renamers + the diffusers converters. The VAE dict
    is empty when the checkpoint carries no first_stage weights (wovae).
    """
    ckpt = extract_ema(ckpt)
    unet_diff = ldm_unet_to_diffusers(ckpt, n_blocks, layers_per_block)
    unet = convert_unet(unet_diff, n_blocks=n_blocks, layers_per_block=layers_per_block)
    # LDM camera_embed.{0,2} keys pass through ldm_unet_to_diffusers verbatim
    # and convert_unet maps them to camera_embedding_linear_{1,2}.
    vae_diff = ldm_vae_to_diffusers(ckpt, n_blocks=n_blocks)
    vae = convert_vae(vae_diff, n_blocks=n_blocks, layers_per_block=layers_per_block) if vae_diff else {}
    return {"unet": unet, "vae": vae}
