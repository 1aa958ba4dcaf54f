"""Checkpoint location registry of the port (user-editable, reference parity).

Counterpart of ``image_editing_framework_tpu/sd_mapping.py``, with the same
keys and placeholders: the reference instructs users to edit this mapping
to point at their weights (README.md:30, p2p/sd_mapping.py:1-6). Values are
local directories in the HuggingFace snapshot layout (``unet/``, ``vae/``,
``text_encoder/``, ``tokenizer/`` with safetensors weights, plus
``text_encoder_2/`` and ``tokenizer_2/`` for SDXL), or, for the entries
marked single-file, one LDM-layout ``.safetensors`` file. Nothing is
downloaded.
"""

sd_maps = {
    "1.4": "/checkpoints/stable-diffusion-v1-4",
    "1.5": "/checkpoints/stable-diffusion-v1-5",
    "2.1": "/checkpoints/stable-diffusion-2-1",
    "xl-base": "/checkpoints/stable-diffusion-xl-base-1.0",
    # 'xl-refiner' selects an XL-*base* editing pipeline plus an attached
    # refiner img2img pipeline (reference: p2p/edit_real.py:77-89), so this
    # entry points at base-layout weights; the refiner's own are refiner_key.
    "xl-refiner": "/checkpoints/stable-diffusion-xl-base-1.0",
    # single-file community checkpoints (reference: p2p/edit_real.py:92-98)
    "animagineXL": "/checkpoints/animagine-xl.safetensors",
    "ghostv2": "/checkpoints/ghostmix-v2.safetensors",
    "cf": "/checkpoints/counterfeit.safetensors",
    "anythingv4-5": "/checkpoints/anything-v4.5.safetensors",
}

# The refiner checkpoint (the reference hardcodes refiner_key =
# "stabilityai/stable-diffusion-xl-refiner-1.0", p2p/edit_real.py:32),
# loaded beside the base pipe for sd_version 'xl-refiner'.
refiner_key = "/checkpoints/stable-diffusion-xl-refiner-1.0"
