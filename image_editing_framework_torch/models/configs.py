"""Model presets for the SD1.5 slice.

Counterpart of ``image_editing_framework_tpu/models/configs.py``: the SD1.x
UNet and the tiny test UNet. SD2.1 and SDXL presets arrive with their slices.
"""

from __future__ import annotations

from image_editing_framework_torch.models.unet import UNetConfig

SD15_UNET = UNetConfig()  # defaults are SD1.x

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

SD_VAE_SCALING = 0.18215  # vae.config.scaling_factor for SD1.x/2.1
