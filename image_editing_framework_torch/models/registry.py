"""Pipeline assembly from checkpoints: the ``from_pretrained`` equivalent.

Counterpart of ``image_editing_framework_tpu/models/registry.py``. It
replicates the reference's loader keyed by ``--sd_version``
(p2p/edit_real.py:71-98) through ``sd_mapping.sd_maps``, offline: weights
are read from local HF-snapshot directories or single LDM-layout
``.safetensors`` files by the port's own reader (``models/loader.py``).

Every module is built on the ``meta`` device and materialised by
``load_params`` straight from the file's map in the asked dtype on the
asked device, so no module is ever initialised at random and no weight
passes through numpy (the JAX package's ``_skeleton`` /
``_added_cond_skeleton`` have no counterpart: the meta modules take their
place).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
from torch import nn

from image_editing_framework_torch import sd_mapping
from image_editing_framework_torch.core.device import DeviceLike, resolve_device
from image_editing_framework_torch.core.scheduler import make_ddim_schedule
from image_editing_framework_torch.models import configs
from image_editing_framework_torch.models.clip import (
    CLIP_VIT_L,
    OPEN_CLIP_BIG_G,
    OPEN_CLIP_VIT_H,
    CLIPTextConfig,
    CLIPTextModel,
)
from image_editing_framework_torch.models.loader import (
    load_params,
    load_safetensors,
    load_sharded_safetensors,
    save_safetensors,
)
from image_editing_framework_torch.models.tokenizer import CLIPTokenizer
from image_editing_framework_torch.models.unet import UNet2DCondition, UNetConfig
from image_editing_framework_torch.models.vae import AutoencoderKL, VAEConfig
from image_editing_framework_torch.pipelines import SDPipeline


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    model_type: str  # 'sd' | 'xl'
    unet: UNetConfig
    text: CLIPTextConfig
    text_2: Optional[CLIPTextConfig] = None
    vae_scaling: float = configs.SD_VAE_SCALING
    sample_size: int = 512
    # Full VAE architecture override (tests inject tiny configs); None means
    # the standard SD VAE at this version's scaling factor.
    vae: Optional[VAEConfig] = None

    @property
    def vae_config(self) -> VAEConfig:
        return self.vae or VAEConfig(scaling_factor=self.vae_scaling)


_XL = dict(vae_scaling=configs.SDXL_VAE_SCALING, sample_size=1024)

VERSION_SPECS = {
    "1.4": VersionSpec("sd", configs.SD15_UNET, CLIP_VIT_L),
    "1.5": VersionSpec("sd", configs.SD15_UNET, CLIP_VIT_L),
    "2.1": VersionSpec("sd", configs.SD21_UNET, OPEN_CLIP_VIT_H, sample_size=768),
    "xl-base": VersionSpec("xl", configs.SDXL_UNET, CLIP_VIT_L, OPEN_CLIP_BIG_G, **_XL),
    # an XL-*base* editing pipeline with the refiner img2img pipeline
    # attached (reference: p2p/edit_real.py:77-89); the refiner itself uses
    # REFINER_SPEC
    "xl-refiner": VersionSpec("xl", configs.SDXL_UNET, CLIP_VIT_L, OPEN_CLIP_BIG_G, **_XL),
    # single-file community checkpoints reuse the base architectures
    "animagineXL": VersionSpec("xl", configs.SDXL_UNET, CLIP_VIT_L, OPEN_CLIP_BIG_G, **_XL),
    "ghostv2": VersionSpec("sd", configs.SD15_UNET, CLIP_VIT_L),
    "cf": VersionSpec("sd", configs.SD15_UNET, CLIP_VIT_L),
    "anythingv4-5": VersionSpec("sd", configs.SD15_UNET, CLIP_VIT_L),
}

# The refiner's own architecture: bigG tower only (``text`` holds the single
# tower's config), 1280-wide cross-attention, 5 addition time ids.
REFINER_SPEC = VersionSpec("xl", configs.SDXL_REFINER_UNET, OPEN_CLIP_BIG_G, **_XL)


def _weights(directory: str, sub: str, base: str = "diffusion_pytorch_model"):
    """``sub/base.safetensors``, else ``sub/base.fp16.safetensors``, else
    the shards of ``sub/base.safetensors.index.json``."""
    d = os.path.join(directory, sub)
    for candidate in (base, base + ".fp16"):
        p = os.path.join(d, candidate + ".safetensors")
        if os.path.exists(p):
            return load_safetensors(p)
    return load_sharded_safetensors(d, base)


def _tokenizer2_dir(tok_dir: str, root: str, single_file: bool) -> str:
    """XL second-tower tokenizer directory for a resolved first-tower
    ``tok_dir``. For single-file checkpoints, swap only the TRAILING
    directory name (str.replace would also rewrite a "tokenizer" substring
    elsewhere in the path, e.g. /ckpts/tokenizer-lab/tokenizer) and fall
    back to the first tower's files when no tokenizer_2/ exists (the two
    towers share the BPE vocab in most community single-file layouts)."""
    if single_file:
        tok2 = os.path.join(os.path.dirname(tok_dir), "tokenizer_2")
        return tok2 if os.path.isdir(tok2) else tok_dir
    return os.path.join(root, "tokenizer_2")


def _load(cls, config, ckpt, dtype: torch.dtype, device: torch.device) -> nn.Module:
    """``cls(config)`` built on the meta device, filled from ``ckpt`` in
    ``dtype`` on ``device``, frozen."""
    with torch.device("meta"):
        module = cls(config)
    return load_params(module, ckpt, dtype, device).eval().requires_grad_(False)


def _single_file_tokenizer_dir(root: str, spec: VersionSpec) -> str:
    """The tokenizer of a single-file checkpoint: ``tokenizer/`` next to the
    file, else the base registry entry's. Fails before the (expensive)
    conversion, naming both paths tried, rather than later with a confusing
    tokenizer-file error (a user with only a community .safetensors commonly
    has neither)."""
    base = "xl-base" if spec.model_type == "xl" else "1.5"
    local_tok = os.path.join(os.path.dirname(root), "tokenizer")
    base_tok = os.path.join(sd_mapping.sd_maps[base], "tokenizer")
    tok_dir = local_tok if os.path.isdir(local_tok) else base_tok
    if not os.path.isdir(tok_dir):
        raise FileNotFoundError(
            f"no tokenizer files for single-file checkpoint {root}: looked for {local_tok} (next to the "
            f"checkpoint) and {base_tok} (the {base!r} base entry). Either place a tokenizer/ directory "
            f"(vocab.json + merges.txt) next to the .safetensors file, or point sd_maps[{base!r}] in "
            f"sd_mapping.py at a full {base} checkpoint directory."
        )
    return tok_dir


def load_pipeline(
    sd_version: str,
    num_inference_steps: int = 50,
    dtype: torch.dtype = torch.float32,
    path: Optional[str] = None,
    spec: Optional[VersionSpec] = None,
    refiner_path: Optional[str] = None,
    refiner_spec: Optional[VersionSpec] = None,
    device: DeviceLike = None,
) -> SDPipeline:
    """Build a fully loaded SDPipeline for a registry version on ``device``
    (the card unless the caller passes ``device="cpu"``).

    ``path`` overrides ``sd_mapping.sd_maps[sd_version]``. Both HF-snapshot
    directories and single-file ``.safetensors`` checkpoints (SD1.x, SD2.x
    and XL LDM key layouts, via ``models/convert_ldm.py``) are supported.

    ``sd_version='xl-refiner'`` loads the XL-base editing pipeline and
    attaches the refiner img2img pipeline as ``pipe.refiner``, sharing
    text_encoder_2 / vae / tokenizer_2 / scheduler with the base (reference:
    p2p/edit_real.py:77-89). ``spec`` / ``refiner_spec`` override the
    architecture presets (tests inject tiny configs through the full path).
    """
    if sd_version not in VERSION_SPECS:
        raise ValueError(f"please use the right sd_version (got {sd_version!r})")
    spec = spec or VERSION_SPECS[sd_version]
    device = resolve_device(device)
    root = path or sd_mapping.sd_maps[sd_version]
    single_file = root.endswith(".safetensors")
    is_xl = spec.model_type == "xl"
    if single_file:
        tok_dir = _single_file_tokenizer_dir(root, spec)
        from image_editing_framework_torch.models import convert_ldm

        if is_xl:
            unet_ckpt, vae_ckpt, text_ckpt, text2_ckpt = convert_ldm.convert_single_file_xl(
                root, spec.unet, spec.vae_config)
        else:
            unet_ckpt, vae_ckpt, text_ckpt = convert_ldm.convert_single_file(root, spec.unet, spec.vae_config)
    else:
        tok_dir = os.path.join(root, "tokenizer")
        unet_ckpt, vae_ckpt = _weights(root, "unet"), _weights(root, "vae")
        text_ckpt = _weights(root, "text_encoder", "model")
        text2_ckpt = _weights(root, "text_encoder_2", "model") if is_xl else None

    pipe = SDPipeline(
        model_type=spec.model_type,
        unet=_load(UNet2DCondition, spec.unet, unet_ckpt, dtype, device),
        vae=_load(AutoencoderKL, spec.vae_config, vae_ckpt, dtype, device),
        text_encoder=_load(CLIPTextModel, spec.text, text_ckpt, dtype, device),
        tokenizer=CLIPTokenizer.from_dir(tok_dir),
        scheduler=make_ddim_schedule(num_inference_steps),
        device=device,
        dtype=dtype,
    )
    if is_xl:
        pipe.text_encoder_2 = _load(CLIPTextModel, spec.text_2, text2_ckpt, dtype, device)
        pipe.tokenizer_2 = CLIPTokenizer.from_dir(_tokenizer2_dir(tok_dir, root, single_file))
    if sd_version == "xl-refiner":
        pipe.refiner = load_refiner_pipeline(path=refiner_path, base=pipe, num_inference_steps=num_inference_steps,
                                             dtype=dtype, spec=refiner_spec, device=device)
    return pipe


def load_refiner_pipeline(
    path: Optional[str] = None,
    base: Optional[SDPipeline] = None,
    num_inference_steps: int = 50,
    dtype: torch.dtype = torch.float32,
    spec: Optional[VersionSpec] = None,
    device: DeviceLike = None,
) -> SDPipeline:
    """Load the SDXL refiner img2img pipeline (SDXL_REFINER_UNET: bigG tower
    only, 1280-wide context, 5 addition time ids with aesthetic_score).

    When ``base`` is given, text_encoder_2 / vae / tokenizer_2 / scheduler
    are *shared* with it and the refiner goes on ``base``'s device: the
    reference's ``StableDiffusionXLImg2ImgPipeline.from_pretrained(
    refiner_key, text_encoder_2=pipe.text_encoder_2, vae=pipe.vae)``
    (p2p/edit_real.py:80-88). A standalone load reads them from the refiner
    checkpoint directory (which ships text_encoder_2/ and vae/ but no
    text_encoder/).
    """
    spec = spec or REFINER_SPEC
    root = path or sd_mapping.refiner_key
    device = base.device if base is not None else resolve_device(device)
    unet = _load(UNet2DCondition, spec.unet, _weights(root, "unet"), dtype, device)
    if base is not None:
        vae, text2, tok2, scheduler = base.vae, base.text_encoder_2, base.tokenizer_2, base.scheduler
    else:
        vae = _load(AutoencoderKL, spec.vae_config, _weights(root, "vae"), dtype, device)
        text2 = _load(CLIPTextModel, spec.text, _weights(root, "text_encoder_2", "model"), dtype, device)
        tok2 = CLIPTokenizer.from_dir(os.path.join(root, "tokenizer_2"))
        scheduler = make_ddim_schedule(num_inference_steps)
    return SDPipeline(
        model_type="xl",
        unet=unet,
        vae=vae,
        text_encoder=text2,
        tokenizer=tok2,
        scheduler=scheduler,
        device=device,
        dtype=dtype,
        text_encoder_2=text2,
        tokenizer_2=tok2,
        is_refiner=True,
    )


# ---------------------------------------------------------------------------
# the pipeline cache: a loaded pipeline's weights, restored without key mapping


def _cache_modules(pipe):
    modules = {"unet": pipe.unet, "vae": pipe.vae, "text": pipe.text_encoder}
    if pipe.text_encoder_2 is not None:
        modules["text2"] = pipe.text_encoder_2
    return modules


def save_pipeline_cache(pipe: SDPipeline, cache_dir: str) -> None:
    """Persist a loaded pipeline's weights (JAX ``save_pipeline_cache``): one
    ``.safetensors`` file of each module's state in its own dtype under
    ``cache_dir`` (``unet``, ``vae``, ``text``, and ``text2`` when the pipe
    has ``text_encoder_2``), so later loads skip the checkpoint's key
    mapping and conversion."""
    os.makedirs(cache_dir, exist_ok=True)
    for name, module in _cache_modules(pipe).items():
        save_safetensors(module.state_dict(), os.path.join(cache_dir, f"{name}.safetensors"))


def restore_pipeline_cache(pipe: SDPipeline, cache_dir: str) -> SDPipeline:
    """Restore the weights ``save_pipeline_cache`` wrote into ``pipe``'s
    modules (each keeps its device and dtype); ``text2`` only where the
    pipe has a second tower and the file exists."""
    for name, module in _cache_modules(pipe).items():
        path = os.path.join(cache_dir, f"{name}.safetensors")
        if name == "text2" and not os.path.exists(path):
            continue
        load_params(module, load_safetensors(path), strict=True)
    return pipe
