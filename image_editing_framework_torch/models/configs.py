"""Model-family presets (SD 1.4/1.5, SD 2.1, SDXL base + refiner).

Counterpart of ``image_editing_framework_tpu/models/configs.py``, with the
PnP injection-site tables.
"""

from __future__ import annotations

from typing import Tuple

from image_editing_framework_torch.models.unet import UNetConfig

SD15_UNET = UNetConfig()  # defaults are SD1.x

SD21_UNET = UNetConfig(
    num_heads=(5, 10, 20, 20),
    cross_attention_dim=1024,
    use_linear_projection=True,
)

SDXL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    num_heads=(5, 10, 20),
    transformer_layers=(1, 2, 10),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,  # 1280 pooled + 6*256 time ids
)

SDXL_REFINER_UNET = UNetConfig(
    block_out_channels=(384, 768, 1536, 1536),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    num_heads=(6, 12, 24, 24),
    transformer_layers=(1, 4, 4, 4),
    cross_attention_dim=1280,
    use_linear_projection=True,
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2560,  # 1280 pooled + 5*256 time ids
)

# Tiny config for unit tests: 2 levels, full structure.
TINY_UNET = UNetConfig(
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    num_heads=(2, 2),
    transformer_layers=(1, 1),
    cross_attention_dim=32,
)

# Tiny refiner flavour: SDXL_REFINER_UNET's distinguishing structure, with
# attention-free outermost and innermost blocks and 5 addition time ids
# (orig_size, crop, aesthetic_score).
TINY_REFINER_UNET = UNetConfig(
    block_out_channels=(32, 64, 64),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    num_heads=(2, 2, 2),
    transformer_layers=(1, 2, 2),
    cross_attention_dim=32,
    use_linear_projection=True,
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=16 + 8 * 5,
)

TINY_XL_UNET = UNetConfig(
    block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    num_heads=(2, 2),
    transformer_layers=(1, 2),
    cross_attention_dim=32,
    use_linear_projection=True,
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=16 + 8 * 6,
)


# --- PnP injection sites (reference: pnp/model/register.py) -----------------


def pnp_sites_sd(cfg: UNetConfig = SD15_UNET) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """SD: self-attn of up_blocks[1].attentions[1:3] + up_blocks[2:4].attentions[:]
    (register.py:82-88), conv of up_blocks[1].resnets[1] (register.py:179).

    The up-block numbering folds diffusers' up_blocks[0] (the attention-free
    UpBlock2D) into index 0, so diffusers up_blocks[k] == our up index k.
    """
    _, _, up = cfg.forward_layout()
    layers = []
    skipped_first = False
    for blk in up:
        for j, tb in enumerate(blk):
            # skip the first Transformer2D of the first attention-bearing up
            # block ("not in the first block of the lowest resolution",
            # pnp/model/register.py:82) — up_blocks[1].attentions[0] for SD.
            if not skipped_first and j == 0:
                skipped_first = True
                continue
            layers.extend(tb)
    return tuple(layers), ("up1_res1",)


def pnp_sites_xl(cfg: UNetConfig = SDXL_UNET) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """SDXL: all transformer blocks of up_blocks[1] (register.py:243-250),
    conv of up_blocks[1].resnets[0] (register.py:339)."""
    _, _, up = cfg.forward_layout()
    layers = []
    for tb in up[1]:
        layers.extend(tb)
    return tuple(layers), ("up1_res0",)


SD_VAE_SCALING = 0.18215  # vae.config.scaling_factor for SD1.x/2.1
SDXL_VAE_SCALING = 0.13025
