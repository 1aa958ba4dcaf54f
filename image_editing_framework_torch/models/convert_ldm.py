"""Single-file (LDM/CompVis layout) checkpoint conversion.

Counterpart of ``image_editing_framework_tpu/models/convert_ldm.py``, key
for key: the renames are the same, on tensors (views of the file's map)
instead of numpy arrays, and the results are the port's ``state_dict()``
keys, which are the diffusers keys.

The reference loads community checkpoints via diffusers ``from_single_file``
(p2p/edit_real.py:92-98: animagineXL, ghostv2, cf, anythingv4-5). Those
.safetensors files use the original LDM key layout
(``model.diffusion_model.*`` / ``first_stage_model.*`` /
``cond_stage_model.*`` / SDXL's ``conditioner.embedders.*``); this module
renames them to the diffusers-style keys of the port's modules.

The UNet/VAE rename tables are built *from the UNetConfig / VAEConfig*, so
the same code serves SD1.x, SD2.1 and SDXL block structures.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from image_editing_framework_torch.models.loader import load_safetensors
from image_editing_framework_torch.models.unet import UNetConfig
from image_editing_framework_torch.models.vae import VAEConfig

Tensors = Dict[str, torch.Tensor]

_RES_SUB = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}


def unet_rename_table(cfg: UNetConfig) -> Dict[str, str]:
    """diffusers-prefix -> LDM-prefix for every module in the UNet."""
    table: Dict[str, str] = {
        "time_embedding.linear_1": "time_embed.0",
        "time_embedding.linear_2": "time_embed.2",
        "add_embedding.linear_1": "label_emb.0.0",
        "add_embedding.linear_2": "label_emb.0.2",
        "conv_in": "input_blocks.0.0",
        "conv_norm_out": "out.0",
        "conv_out": "out.2",
    }
    n_levels = len(cfg.block_out_channels)
    lpb = cfg.layers_per_block

    # --- input blocks
    idx = 1
    for level, btype in enumerate(cfg.down_block_types):
        for j in range(lpb):
            table[f"down_blocks.{level}.resnets.{j}"] = f"input_blocks.{idx}.0"
            if btype == "CrossAttnDownBlock2D":
                table[f"down_blocks.{level}.attentions.{j}"] = f"input_blocks.{idx}.1"
            idx += 1
        if level != n_levels - 1:
            table[f"down_blocks.{level}.downsamplers.0"] = f"input_blocks.{idx}.0.op"
            idx += 1

    # --- middle
    table["mid_block.resnets.0"] = "middle_block.0"
    table["mid_block.attentions.0"] = "middle_block.1"
    table["mid_block.resnets.1"] = "middle_block.2"

    # --- output blocks
    idx = 0
    for i, btype in enumerate(cfg.up_block_types):
        has_attn = btype == "CrossAttnUpBlock2D"
        for j in range(lpb + 1):
            table[f"up_blocks.{i}.resnets.{j}"] = f"output_blocks.{idx}.0"
            if has_attn:
                table[f"up_blocks.{i}.attentions.{j}"] = f"output_blocks.{idx}.1"
            if i != len(cfg.up_block_types) - 1 and j == lpb:
                sub = 2 if has_attn else 1
                table[f"up_blocks.{i}.upsamplers.0"] = f"output_blocks.{idx}.{sub}"
            idx += 1
    return table


def _translate_unet_key(key: str, table: Mapping[str, str]) -> str:
    # resnet sub-key rename first (longest-prefix match on module).
    for dk, lk in table.items():
        if key.startswith(dk + "."):
            rest = key[len(dk) + 1 :]
            if "resnets" in dk or dk.startswith("mid_block.resnets"):
                for a, b in _RES_SUB.items():
                    if rest.startswith(b):
                        rest = a + rest[len(b) :]
                        break
            if dk.endswith("upsamplers.0") or dk.endswith("downsamplers.0"):
                # diffusers: upsamplers.0.conv.weight; LDM output: <prefix>.conv.weight
                # for upsample, <prefix>.op.weight is complete for downsample.
                if dk.endswith("downsamplers.0"):
                    rest = rest[len("conv.") :] if rest.startswith("conv.") else rest
            return f"{lk}.{rest}"
    raise KeyError(key)


def convert_ldm_unet(
    state: Mapping[str, torch.Tensor], cfg: UNetConfig
) -> Tensors:
    """model.diffusion_model.* -> diffusers-style UNet dict."""
    table = unet_rename_table(cfg)
    inverse: Dict[str, str] = {}
    # Build full-key inverse by attempting translation of every diffusers key
    # pattern present in the LDM file.
    prefix = "model.diffusion_model."
    ldm = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    out: Tensors = {}
    # invert module table: ldm-prefix -> diffusers-prefix
    inv_table = sorted(
        ((lk, dk) for dk, lk in table.items()), key=lambda x: -len(x[0])
    )
    for key, val in ldm.items():
        for lk, dk in inv_table:
            if key == lk + ".weight" or key == lk + ".bias" or key.startswith(lk + "."):
                rest = key[len(lk) + 1 :]
                if "resnets" in dk:
                    for a, b in _RES_SUB.items():
                        if rest.startswith(a):
                            rest = b + rest[len(a) :]
                            break
                if dk.endswith(("upsamplers.0",)) and rest in ("conv.weight", "conv.bias"):
                    pass  # both layouts name it conv.*
                if dk.endswith("downsamplers.0") and rest in ("weight", "bias"):
                    rest = "conv." + rest
                out[f"{dk}.{rest}"] = val
                break
        else:
            raise KeyError(f"unmapped LDM UNet key: {key}")
    return out


_VAE_RES_SUB = {
    "nin_shortcut": "conv_shortcut",
}


def convert_ldm_vae(
    state: Mapping[str, torch.Tensor], cfg: VAEConfig
) -> Tensors:
    """first_stage_model.* -> diffusers-style VAE dict."""
    n = len(cfg.block_out_channels)
    prefix = "first_stage_model."
    ldm = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    out: Tensors = {}
    for key, val in ldm.items():
        parts = key.split(".")
        tower = parts[0]
        if tower in ("quant_conv", "post_quant_conv"):
            out[key] = val
            continue
        rest = parts[1:]
        if rest[0] == "conv_in" or rest[0] == "conv_out":
            out[f"{tower}.{'.'.join(rest)}"] = val
        elif rest[0] == "norm_out":
            out[f"{tower}.conv_norm_out.{rest[1]}"] = val
        elif rest[0] == "down":
            level, kind = int(rest[1]), rest[2]
            if kind == "block":
                j = int(rest[3])
                sub = ".".join(rest[4:])
                sub = sub.replace("nin_shortcut", "conv_shortcut")
                out[f"encoder.down_blocks.{level}.resnets.{j}.{sub}"] = val
            elif kind == "downsample":
                out[f"encoder.down_blocks.{level}.downsamplers.0.{'.'.join(rest[3:])}"] = val
        elif rest[0] == "up":
            # LDM decoder indexes up blocks in REVERSE (up.3 runs first).
            level = n - 1 - int(rest[1])
            kind = rest[2]
            if kind == "block":
                j = int(rest[3])
                sub = ".".join(rest[4:]).replace("nin_shortcut", "conv_shortcut")
                out[f"decoder.up_blocks.{level}.resnets.{j}.{sub}"] = val
            elif kind == "upsample":
                out[f"decoder.up_blocks.{level}.upsamplers.0.{'.'.join(rest[3:])}"] = val
        elif rest[0] == "mid":
            kind = rest[1]
            if kind in ("block_1", "block_2"):
                j = 0 if kind == "block_1" else 1
                out[f"{tower}.mid_block.resnets.{j}.{'.'.join(rest[2:])}"] = val
            elif kind == "attn_1":
                sub = rest[2]
                name = {
                    "norm": "group_norm",
                    "q": "to_q",
                    "k": "to_k",
                    "v": "to_v",
                    "proj_out": "to_out.0",
                }[sub]
                # LDM attention uses 1x1 conv weights (C, C, 1, 1) -> linear.
                if val.ndim == 4:
                    val = val[:, :, 0, 0]
                out[f"{tower}.mid_block.attentions.0.{name}.{rest[3]}"] = val
        else:
            raise KeyError(f"unmapped LDM VAE key: {key}")
    return out


def convert_open_clip_text(
    state: Mapping[str, torch.Tensor], prefix: str
) -> Tensors:
    """open_clip text-tower naming -> transformers CLIPTextModel naming.

    Used by SD2.x single files (``cond_stage_model.model.*``) and the SDXL
    second tower (``conditioner.embedders.1.model.*``). The fused
    ``attn.in_proj_weight/bias`` splits into q/k/v thirds;
    ``text_projection`` is stored as x@W (D, P) and transposes to the
    transformers Linear convention.
    """
    sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if not sub:
        return {}
    out: Tensors = {}
    out["text_model.embeddings.token_embedding.weight"] = sub["token_embedding.weight"]
    out["text_model.embeddings.position_embedding.weight"] = sub["positional_embedding"]
    out["text_model.final_layer_norm.weight"] = sub["ln_final.weight"]
    out["text_model.final_layer_norm.bias"] = sub["ln_final.bias"]
    if "text_projection" in sub:
        out["text_projection.weight"] = sub["text_projection"].T
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sub:
        src = f"transformer.resblocks.{i}"
        dst = f"text_model.encoder.layers.{i}"
        for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2")):
            out[f"{dst}.{b}.weight"] = sub[f"{src}.{a}.weight"]
            out[f"{dst}.{b}.bias"] = sub[f"{src}.{a}.bias"]
        w = sub[f"{src}.attn.in_proj_weight"]
        bia = sub[f"{src}.attn.in_proj_bias"]
        d = w.shape[0] // 3
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{dst}.self_attn.{name}.weight"] = w[j * d : (j + 1) * d]
            out[f"{dst}.self_attn.{name}.bias"] = bia[j * d : (j + 1) * d]
        out[f"{dst}.self_attn.out_proj.weight"] = sub[f"{src}.attn.out_proj.weight"]
        out[f"{dst}.self_attn.out_proj.bias"] = sub[f"{src}.attn.out_proj.bias"]
        out[f"{dst}.mlp.fc1.weight"] = sub[f"{src}.mlp.c_fc.weight"]
        out[f"{dst}.mlp.fc1.bias"] = sub[f"{src}.mlp.c_fc.bias"]
        out[f"{dst}.mlp.fc2.weight"] = sub[f"{src}.mlp.c_proj.weight"]
        out[f"{dst}.mlp.fc2.bias"] = sub[f"{src}.mlp.c_proj.bias"]
        i += 1
    return out


def convert_ldm_text(state: Mapping[str, torch.Tensor]) -> Tensors:
    """LDM text encoder -> transformers naming.

    SD1.x: ``cond_stage_model.transformer.*`` is already transformers naming.
    SD2.x: ``cond_stage_model.model.*`` uses open_clip naming.
    """
    prefix = "cond_stage_model.transformer."
    out = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if out:
        return out
    out = convert_open_clip_text(state, "cond_stage_model.model.")
    if out:
        return out
    raise KeyError("no recognizable text-encoder keys found")


def convert_single_file_xl(
    path: str, unet_cfg: UNetConfig, vae_cfg: VAEConfig
) -> Tuple[
    Tensors, Tensors,
    Tensors, Tensors,
]:
    """SDXL single-file layout: returns (unet, vae, text1, text2) dicts.

    text1 = ``conditioner.embedders.0.transformer.*`` (CLIP-L, transformers
    naming already); text2 = ``conditioner.embedders.1.model.*`` (open_clip
    bigG with text_projection).
    """
    state = load_safetensors(path)
    state = {k: state[k] for k in state.keys()}
    p1 = "conditioner.embedders.0.transformer."
    text1 = {k[len(p1):]: v for k, v in state.items() if k.startswith(p1)}
    text2 = convert_open_clip_text(state, "conditioner.embedders.1.model.")
    return (
        convert_ldm_unet(state, unet_cfg),
        convert_ldm_vae(state, vae_cfg),
        text1,
        text2,
    )


def convert_single_file(
    path: str, unet_cfg: UNetConfig, vae_cfg: VAEConfig
) -> Tuple[Tensors, Tensors, Tensors]:
    """Load an LDM-layout .safetensors and return (unet, vae, text) dicts in
    diffusers-style key naming."""
    state = load_safetensors(path)
    state = {k: state[k] for k in state.keys()}
    return (
        convert_ldm_unet(state, unet_cfg),
        convert_ldm_vae(state, vae_cfg),
        convert_ldm_text(state),
    )
