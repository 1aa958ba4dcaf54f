"""Convert a single-file (LDM layout) .safetensors checkpoint into the
diffusers directory layout the registry loads fastest.

Counterpart of the JAX package's ``tools/convert_checkpoint.py``, with its
arguments:

    python -m image_editing_framework_torch.tools.convert_checkpoint INPUT.safetensors OUTPUT_DIR \\
        [--family sd|sd21|xl]

Writes OUTPUT_DIR/{unet,vae}/diffusion_pytorch_model.safetensors and
OUTPUT_DIR/text_encoder[_2]/model.safetensors through the port's own writer
(``models/loader.py save_safetensors``), every tensor in the dtype the file
stores it in. The renames are ``models/convert_ldm.py``'s, so the directory
holds exactly what a single-file load would copy into the modules: an SD2.x
file's OpenCLIP text tower keeps every resblock it carries (a real SD2.1 file
has 24, ``OPEN_CLIP_VIT_H`` runs 23: the loader ignores the 24th, as the JAX
package's does). Tokenizer files are not derivable from weights: copy a
``tokenizer/`` directory (and ``tokenizer_2/`` for XL) from the matching base
checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

FAMILIES = ("sd", "sd21", "xl")


def convert(input_path: str, output_dir: str, family: str = "sd") -> Dict[str, Tuple[str, int]]:
    """Convert ``input_path`` into ``output_dir``. Returns {subdirectory:
    (file written, tensors)}."""
    from image_editing_framework_torch.models import configs, convert_ldm
    from image_editing_framework_torch.models.loader import save_safetensors
    from image_editing_framework_torch.models.vae import VAEConfig

    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    unet_cfg = {"sd": configs.SD15_UNET, "sd21": configs.SD21_UNET, "xl": configs.SDXL_UNET}[family]
    vae_cfg = VAEConfig(scaling_factor=configs.SDXL_VAE_SCALING if family == "xl" else configs.SD_VAE_SCALING)
    if family == "xl":
        unet, vae, text1, text2 = convert_ldm.convert_single_file_xl(input_path, unet_cfg, vae_cfg)
        towers = [("text_encoder", text1), ("text_encoder_2", text2)]
    else:
        unet, vae, text1 = convert_ldm.convert_single_file(input_path, unet_cfg, vae_cfg)
        towers = [("text_encoder", text1)]
    written = {}
    for sub, base, tensors in [("unet", "diffusion_pytorch_model", unet), ("vae", "diffusion_pytorch_model", vae)] + [
            (name, "model", tensors) for name, tensors in towers]:
        directory = os.path.join(output_dir, sub)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, base + ".safetensors")
        save_safetensors(tensors, path)
        written[sub] = (path, len(tensors))
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("convert an LDM single-file checkpoint to the snapshot layout")
    ap.add_argument("input")
    ap.add_argument("output_dir")
    ap.add_argument("--family", choices=FAMILIES, default="sd")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    for sub, (path, count) in convert(args.input, args.output_dir, args.family).items():
        print(f"wrote {sub}/{os.path.basename(path)} ({count} tensors)")
    print(f"done in {time.perf_counter() - t0:.2f} s — add a tokenizer/ (and tokenizer_2/ for XL) directory")
    return 0


if __name__ == "__main__":
    sys.exit(main())
