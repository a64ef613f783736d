"""Write a port module's weights under the reference's key names (verification only).

The inverse of ``utils/convert_torch.py``: each function takes a module of the
port and returns its parameters as the reference's checkpoints name and lay them
out, so a round trip through the converters and the loaders can be held bit for
bit without any reference weights:

* :func:`unet_state`, :func:`vae_state`, :func:`clip_text_state`: the diffusers
  UNet, the diffusers VAE and the HF CLIP text model dicts;
* :func:`adapter_state`: the keys of ``triplane_turbo_sd_v1.pth`` (hexa-LoRA
  split into six per-plane modules, vanilla LoRA, LoCon, the ``conv_out``
  retrofit, the field MLPs), and :func:`write_adapter` the file;
* :func:`ldm_teacher_state`: an LDM teacher checkpoint (``model.diffusion_model.*``,
  ``first_stage_model.*``), with ``model_ema`` shadows that hold the weights and
  ``model.*`` entries that do not;
* :func:`write_diffusers_dir`: ``unet/``, ``vae/`` and ``text_encoder/`` of a
  diffusers pipeline directory.

Tensors keep their module's dtype and are copied to the host, contiguous; on the
meta device they stay meta (a shape-only check). No entry point of the package
calls this module; ``chip_smoke.py`` and the tests do.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch
from torch import nn

from ..utils.convert_torch import PLANE_ORDER

_ADAPTER = re.compile(r"lora|locon|retrofit")


def _out(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t if t.is_meta else t.to("cpu", copy=True).contiguous()


def flax_paths(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``{flax path: parameter}``: the inverse of ``utils/weights.py``'s naming (a
    Linear or conv ``weight`` is a ``kernel``, a norm's a ``scale``, an embedding's an
    ``embedding``). The tensors stay in the port's layout, which for every kernel is
    torch's."""
    out = {}
    for name, p in module.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        if leaf == "weight":
            mod = module.get_submodule(mod_name)
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                leaf = "kernel"
            elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                leaf = "scale"
            elif isinstance(mod, nn.Embedding):
                leaf = "embedding"
        out["/".join(mod_name.split(".") + [leaf]) if mod_name else leaf] = p
    return out


# -- names ------------------------------------------------------------------


def unet_key(path: str) -> str:
    """flax UNet path -> diffusers key."""
    p = path
    p = re.sub(r"^down_(\d+)_res_(\d+)/", r"down_blocks.\1.resnets.\2.", p)
    p = re.sub(r"^down_(\d+)_attn_(\d+)/", r"down_blocks.\1.attentions.\2.", p)
    p = re.sub(r"^down_(\d+)_downsample/conv/conv/", r"down_blocks.\1.downsamplers.0.conv.", p)
    p = re.sub(r"^up_(\d+)_res_(\d+)/", r"up_blocks.\1.resnets.\2.", p)
    p = re.sub(r"^up_(\d+)_attn_(\d+)/", r"up_blocks.\1.attentions.\2.", p)
    p = re.sub(r"^up_(\d+)_upsample/conv/conv/", r"up_blocks.\1.upsamplers.0.conv.", p)
    p = re.sub(r"^mid_res_(\d+)/", r"mid_block.resnets.\1.", p)
    p = re.sub(r"^mid_attn/", "mid_block.attentions.0.", p)
    p = re.sub(r"transformer_blocks_(\d+)/", r"transformer_blocks.\1.", p)
    p = re.sub(r"(attn\d)/to_out/", r"\1.to_out.0.", p)
    p = p.replace("ff/net_0/proj/", "ff.net.0.proj.")
    p = p.replace("ff/net_2/", "ff.net.2.")
    p = p.replace("time_embedding_linear_1/", "time_embedding.linear_1.")
    p = p.replace("time_embedding_linear_2/", "time_embedding.linear_2.")
    p = p.replace("camera_embedding_linear_1/", "camera_embed.0.")
    p = p.replace("camera_embedding_linear_2/", "camera_embed.2.")
    for conv in ("conv_in", "conv_out", "conv1", "conv2", "conv_shortcut"):
        p = p.replace(f"{conv}/conv/", f"{conv}.")
    p = p.replace("/", ".")
    return p.replace(".scale", ".weight").replace(".kernel", ".weight")


def vae_key(path: str) -> str:
    """flax VAE path -> diffusers key."""
    p = path
    p = re.sub(r"^(decoder|encoder)/up_(\d+)_res_(\d+)/", r"\1.up_blocks.\2.resnets.\3.", p)
    p = re.sub(r"^(decoder|encoder)/down_(\d+)_res_(\d+)/", r"\1.down_blocks.\2.resnets.\3.", p)
    p = re.sub(r"^decoder/up_(\d+)_upsample/conv/conv/", r"decoder.up_blocks.\1.upsamplers.0.conv.", p)
    p = re.sub(r"^encoder/down_(\d+)_downsample/conv/", r"encoder.down_blocks.\1.downsamplers.0.conv.", p)
    p = re.sub(r"^(decoder|encoder)/mid_res_(\d+)/", r"\1.mid_block.resnets.\2.", p)
    p = re.sub(r"^(decoder|encoder)/mid_attn/attention/to_out/", r"\1.mid_block.attentions.0.to_out.0.", p)
    p = re.sub(r"^(decoder|encoder)/mid_attn/attention/", r"\1.mid_block.attentions.0.", p)
    p = re.sub(r"^(decoder|encoder)/mid_attn/group_norm/", r"\1.mid_block.attentions.0.group_norm.", p)
    for conv in ("conv_in", "conv1", "conv2", "conv_shortcut"):
        p = p.replace(f"{conv}/conv/", f"{conv}.")
    p = p.replace("/", ".")
    return p.replace(".scale", ".weight").replace(".kernel", ".weight")


def clip_text_key(path: str) -> str:
    """flax CLIP text path -> HF ``CLIPTextModel`` key."""
    p = path.replace("token_embedding/embedding", "embeddings.token_embedding.weight")
    if p == "position_embedding":
        p = "embeddings.position_embedding.weight"
    p = re.sub(r"^layers_(\d+)/", r"encoder.layers.\1.", p)
    p = p.replace("mlp_fc1/", "mlp.fc1.").replace("mlp_fc2/", "mlp.fc2.")
    p = p.replace("/", ".").replace(".scale", ".weight").replace(".kernel", ".weight")
    return "text_model." + p


def adapter_module(path: str) -> str:
    """flax adapter module path (ending in ``/``) -> the reference's module path."""
    p = path
    p = re.sub(r"^space_generator/(unet|vae)/", r"space_generator.\1.", p)
    p = re.sub(r"down_(\d+)_attn_(\d+)/", r"down_blocks.\1.attentions.\2.", p)
    p = re.sub(r"up_(\d+)_attn_(\d+)/", r"up_blocks.\1.attentions.\2.", p)
    p = re.sub(r"down_(\d+)_res_(\d+)/", r"down_blocks.\1.resnets.\2.", p)
    p = re.sub(r"up_(\d+)_res_(\d+)/", r"up_blocks.\1.resnets.\2.", p)
    p = re.sub(r"mid_res_(\d+)/", r"mid_block.resnets.\1.", p)
    p = re.sub(r"mid_attn/attention/", "mid_block.attentions.0.", p)
    p = re.sub(r"mid_attn/", "mid_block.attentions.0.", p)
    p = re.sub(r"down_(\d+)_downsample/conv/", r"down_blocks.\1.downsamplers.0.conv.", p)
    p = re.sub(r"up_(\d+)_upsample/conv/", r"up_blocks.\1.upsamplers.0.conv.", p)
    p = re.sub(r"transformer_blocks_(\d+)/", r"transformer_blocks.\1.", p)
    return p.replace("/", ".")


_LDM_RES = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
            "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_LDM_DIRECT = {"time_embedding.linear_1": "time_embed.0", "time_embedding.linear_2": "time_embed.2",
               "camera_embed.0": "camera_embed.0", "camera_embed.2": "camera_embed.2",
               "conv_in": "input_blocks.0.0", "conv_norm_out": "out.0", "conv_out": "out.2"}


def _res_sub(table: Dict[str, str], sub: str) -> str:
    head = sub.split(".", 1)[0]
    return table[head] + sub[len(head):]


def ldm_unet_key(key: str, L: int, attn_up) -> str:
    """diffusers UNet key -> LDM ``openaimodel`` key (without ``model.diffusion_model.``):
    ``input_blocks`` / ``middle_block`` / ``output_blocks`` index arithmetic, ``L``
    layers a level; ``attn_up(i)`` says whether up level ``i`` has attention, which
    puts its upsampler at module 2 rather than 1."""
    for dname, lname in _LDM_DIRECT.items():
        if key.startswith(dname + "."):
            return lname + key[len(dname):]
    m = re.match(r"mid_block\.resnets\.(\d)\.(.*)$", key)
    if m:
        return f"middle_block.{int(m.group(1)) * 2}.{_res_sub(_LDM_RES, m.group(2))}"
    m = re.match(r"mid_block\.attentions\.0\.(.*)$", key)
    if m:
        return f"middle_block.1.{m.group(1)}"
    m = re.match(r"(down|up)_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.*)$", key)
    if m:
        side, i, kind, j, sub = m.group(1), int(m.group(2)), m.group(3), int(m.group(4)), m.group(5)
        idx = 1 + i * (L + 1) + j if side == "down" else i * (L + 1) + j
        blocks = "input_blocks" if side == "down" else "output_blocks"
        if kind == "resnets":
            return f"{blocks}.{idx}.0.{_res_sub(_LDM_RES, sub)}"
        return f"{blocks}.{idx}.1.{sub}"
    m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)$", key)
    if m:
        return f"input_blocks.{1 + int(m.group(1)) * (L + 1) + L}.0.op.{m.group(2)}"
    m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)$", key)
    if m:
        i = int(m.group(1))
        return f"output_blocks.{i * (L + 1) + L}.{2 if attn_up(i) else 1}.conv.{m.group(2)}"
    raise ValueError(f"no LDM name for {key}")


_LDM_VAE_RES = {"norm1": "norm1", "conv1": "conv1", "time_emb_proj": "temb_proj",
                "norm2": "norm2", "conv2": "conv2", "conv_shortcut": "nin_shortcut"}
_LDM_VAE_ATTN = {"to_q": "q", "to_k": "k", "to_v": "v", "group_norm": "norm"}


def ldm_vae_key(dkey: str, n_blocks: int) -> str:
    """diffusers VAE key -> CompVis ``AutoencoderKL`` key (without
    ``first_stage_model.``); the decoder's up levels run in reverse."""
    if dkey.startswith(("quant_conv.", "post_quant_conv.")):
        return dkey
    tower, rest = dkey.split(".", 1)
    if rest.startswith(("conv_in.", "conv_out.")):
        return dkey
    if rest.startswith("conv_norm_out."):
        return f"{tower}.norm_out.{rest[len('conv_norm_out.'):]}"
    m = re.match(r"mid_block\.resnets\.(\d)\.(.*)$", rest)
    if m:
        return f"{tower}.mid.block_{int(m.group(1)) + 1}.{_res_sub(_LDM_VAE_RES, m.group(2))}"
    m = re.match(r"mid_block\.attentions\.0\.to_out\.0\.(.*)$", rest)
    if m:
        return f"{tower}.mid.attn_1.proj_out.{m.group(1)}"
    m = re.match(r"mid_block\.attentions\.0\.(\w+)\.(.*)$", rest)
    if m:
        return f"{tower}.mid.attn_1.{_LDM_VAE_ATTN[m.group(1)]}.{m.group(2)}"
    m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)$", rest)
    if m:
        return f"encoder.down.{m.group(1)}.block.{m.group(2)}.{_res_sub(_LDM_VAE_RES, m.group(3))}"
    m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)$", rest)
    if m:
        return f"encoder.down.{m.group(1)}.downsample.conv.{m.group(2)}"
    m = re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)$", rest)
    if m:
        i = n_blocks - 1 - int(m.group(1))
        return f"decoder.up.{i}.block.{m.group(2)}.{_res_sub(_LDM_VAE_RES, m.group(3))}"
    m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)$", rest)
    if m:
        return f"decoder.up.{n_blocks - 1 - int(m.group(1))}.upsample.conv.{m.group(2)}"
    raise ValueError(f"no LDM name for {dkey}")


# -- state dicts --------------------------------------------------------------


def _backbone(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's flax paths without the adapters (LoRA, LoCon, the retrofit)."""
    return {p: t for p, t in flax_paths(module).items() if not _ADAPTER.search(p)}


def unet_state(unet: nn.Module) -> Dict[str, torch.Tensor]:
    """A diffusers ``UNet2DConditionModel`` state dict of ``unet`` (adapters left out)."""
    return {unet_key(p): _out(t) for p, t in _backbone(unet).items()}


def vae_state(vae: nn.Module) -> Dict[str, torch.Tensor]:
    """A diffusers ``AutoencoderKL`` state dict of the towers ``vae`` has (the
    student's decoder without its adapters and retrofit, or a teacher's encoder)."""
    return {vae_key(p): _out(t) for p, t in _backbone(vae).items()}


def clip_text_state(text_encoder: nn.Module) -> Dict[str, torch.Tensor]:
    """An HF ``CLIPTextModel`` state dict (``text_model.*``)."""
    return {clip_text_key(p): _out(t) for p, t in flax_paths(text_encoder).items()}


def adapter_state(geometry: nn.Module) -> Dict[str, torch.Tensor]:
    """The adapter checkpoint's keys (``geometry.`` not prefixed) for every adapter and
    field-MLP parameter of a ``TriplaneGeometry``."""
    src: Dict[str, torch.Tensor] = {}
    for path, t in flax_paths(geometry).items():
        m = re.match(r"(.*)/lora_(q|k|v|out)/(down|up|bias)$", path)
        if m:
            base = adapter_module(m.group(1) + "/")[:-1] + ".processor"
            proj, which = m.group(2), m.group(3)
            hexa = t.ndim == (2 if which == "bias" else 3)
            tags = [tag.split("_lora_") for tag in PLANE_ORDER] if hexa else [None]
            for slot, tag in enumerate(tags):
                x = t[slot] if hexa else t
                stem = f"{base}.to_{proj}_{tag[0]}_lora_{tag[1]}" if hexa else f"{base}.to_{proj}_lora"
                if which == "bias":  # a [1, 1, out] Parameter in the reference
                    src[f"{stem}.bias"] = _out(x[None, None])
                else:  # [in, rank] or [rank, out] -> torch Linear [out, in]
                    src[f"{stem}.{which}.weight"] = _out(x.T)
            continue
        m = re.match(r"(.*)/locon/(down|up)/(kernel|bias)$", path)
        if m:
            base = adapter_module(m.group(1) + "/")[:-1]
            src[f"{base}.lora_layer.{m.group(2)}.{'weight' if m.group(3) == 'kernel' else 'bias'}"] = _out(t)
            continue
        m = re.match(r"space_generator/vae/decoder/conv_out_retrofit/(kernel|bias)$", path)
        if m:
            which = "weight" if m.group(1) == "kernel" else "bias"
            src[f"space_generator.vae.decoder.conv_out.{which}"] = _out(t)
            continue
        m = re.match(r"field/(sdf|feature|deformation)_network/Dense_(\d+)/kernel$", path)
        if m:
            src[f"{m.group(1)}_network.layers.{2 * int(m.group(2))}.weight"] = _out(t)
    return src


def ldm_teacher_state(unet: nn.Module, vae: Optional[nn.Module] = None,
                      ema: bool = True) -> Dict[str, torch.Tensor]:
    """An LDM teacher checkpoint of ``unet`` (and ``vae``'s towers under
    ``first_stage_model.``, attention projections as 1x1 convs). With ``ema`` the
    weights go into the ``model_ema`` shadows (the parameter name without its dots)
    and every ``model.diffusion_model.*`` entry holds zeros (a one-element tensor
    expanded, so it costs no space), which the loader must not read."""
    L = unet.cfg.layers_per_block
    n_blocks = len(unet.cfg.block_out_channels)
    out: Dict[str, torch.Tensor] = {}
    for dkey, t in unet_state(unet).items():
        key = "model.diffusion_model." + ldm_unet_key(
            dkey, L, lambda i: hasattr(unet, f"up_{i}_attn_0"))
        if ema:
            out["model_ema." + key[len("model."):].replace(".", "")] = t
            t = torch.zeros((), dtype=t.dtype, device=t.device).expand(t.shape)
        out[key] = t
    if ema:
        out["model_ema.decay"] = torch.tensor(0.9999)
        out["model_ema.num_updates"] = torch.tensor(0, dtype=torch.int32)
    if vae is not None:
        nv = len(vae.cfg.block_out_channels)
        for dkey, t in vae_state(vae).items():
            if re.search(r"attentions\.0\.(to_q|to_k|to_v|to_out\.0)\.weight$", dkey):
                t = t[:, :, None, None]
            out["first_stage_model." + ldm_vae_key(dkey, nv)] = t
    return out


# -- files --------------------------------------------------------------------


def write_adapter(path: str, geometry: nn.Module) -> str:
    """``triplane_turbo_sd_v1.pth``: ``{state_dict: {geometry.*}, epoch, global_step}``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {f"geometry.{k}": v for k, v in adapter_state(geometry).items()}
    torch.save({"state_dict": state, "epoch": 0, "global_step": 0}, path)
    return path


def write_diffusers_dir(path: str, unet: Optional[nn.Module] = None,
                        vae: Optional[nn.Module] = None,
                        text_encoder: Optional[nn.Module] = None) -> str:
    """``unet/diffusion_pytorch_model.bin``, ``vae/diffusion_pytorch_model.bin`` and
    ``text_encoder/pytorch_model.bin`` under ``path``, for the modules given."""
    for sub, fname, module, state in (
            ("unet", "diffusion_pytorch_model.bin", unet, unet_state),
            ("vae", "diffusion_pytorch_model.bin", vae, vae_state),
            ("text_encoder", "pytorch_model.bin", text_encoder, clip_text_state)):
        if module is not None:
            os.makedirs(os.path.join(path, sub), exist_ok=True)
            torch.save(state(module), os.path.join(path, sub, fname))
    return path
