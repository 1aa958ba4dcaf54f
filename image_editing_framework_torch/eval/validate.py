"""Real-weight validation runway.

Counterpart of ``image_editing_framework_tpu/eval/validate.py``. Once
trained checkpoints exist, one command produces every quality number and
golden hash: per method, a synthesized-source edit and a real-image edit
(inversion + edit), the sha256 of every PNG, MSE / PSNR / SSIM between the
source and its reconstruction, and the CLIP score and LPIPS when their
weights are given:

    python -m image_editing_framework_torch.eval.validate --sd_version 1.5 \\
        --source_image ./test.jpg --clip_checkpoint CLIP_DIR --lpips_weights LPIPS.safetensors

It runs on the card (``--random_weights`` takes the production-shape
pipeline with seeded random weights). Differences from the JAX runway:

* the synthesized start latent (and the refiner's noise) come from
  ``seeded_latent``: ``torch.randn`` from ``torch.Generator(device)`` seeded
  with ``seed``, as ``cli.edit_syn_main`` draws them; JAX's
  ``PRNGKey(seed)`` stream cannot be reproduced, so a seed gives other
  images, and other hashes, than the JAX package's;
* ``report.json`` has no ``flash_layout`` / ``flash_bwd_layout`` (the TPU
  kernels' operand layouts; the port has one layout) and its ``backend`` is
  the pipeline's device type, ``"cuda"`` or ``"cpu"``; there is no
  ``use_flash``: the tensors' device picks the kernels or their plain
  versions;
* ``--lpips_weights`` is the path of one ``.safetensors`` file with the
  torchvision VGG16 and LPIPS head weights (``eval/lpips.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from image_editing_framework_torch.core.config import SamplerConfig
from image_editing_framework_torch.eval import metrics
from image_editing_framework_torch.utils.images import load_image, resize, save_img

METHODS = ("p2p", "masactrl", "pnp", "p2z")


def _sha256_png(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def synth_source_image(seed: int, res: int) -> np.ndarray:
    """Deterministic synthetic photo-ish input (smooth random field) so the
    real-image flow (invert + edit + recon metrics) runs and hashes
    reproducibly with no dataset in the environment: a (res/16)² grid of
    ``RandomState(seed)`` uniforms upsampled with JAX's cubic filter,
    uint8 (res, res, 3), the JAX package's bytes."""
    small = np.random.RandomState(seed).rand(res // 16, res // 16, 3).astype(np.float32)
    img = resize(torch.from_numpy(small), (res, res, 3), "cubic")
    return torch.round(torch.clamp(img, 0, 1) * 255).to(torch.uint8).numpy()


def seeded_latent(pipe, shape: Tuple[int, ...], seed: int) -> torch.Tensor:
    """N(0, 1) of ``shape`` from ``torch.Generator(pipe.device)`` seeded
    with ``seed``, in the pipeline's dtype: the runway's one source of
    random numbers (the synthesized start latent, the refiner's noise)."""
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=pipe.device).to(pipe.dtype)


def validate_pipeline(
    pipe,
    out_dir: str,
    methods: Sequence[str] = METHODS,
    source_image: Optional[np.ndarray] = None,  # uint8 HWC; None => synth only
    source_prompt: str = "a gray horse in the field",
    target_prompt: str = "a whie horse in the field",
    seed: int = 42,
    resolution: Optional[int] = None,
    inversion_type: str = "ddim",
    clip_checkpoint: Optional[str] = None,
    lpips_weights=None,
    provenance: Optional[str] = None,  # e.g. 'random_weights seed=42'
    sd_version: Optional[str] = None,
) -> dict:
    """Run every method e2e on ``pipe``; write PNGs + report.json.

    Per method: a synthesized-source edit (edit_syn flow, seeded latent) and,
    when ``source_image`` is given, a real-image edit (invert + edit, the
    inversion shared across methods unless XL null-text schedules differ).
    Records sha256 of every PNG (golden hashes), structure metrics between
    source and reconstruction, and CLIP/LPIPS when their weights are given
    (the towers on the pipeline's device). ``report.json`` and
    ``report.md`` are rewritten after each method, so a run that dies keeps
    the finished methods. Deterministic for fixed (weights, seed, steps) on
    one device.
    """
    from image_editing_framework_torch.cli import invert, run_method

    res = resolution or (1024 if pipe.model_type == "xl" else 512)
    sampler = SamplerConfig(height=res, width=res, seed=seed)
    os.makedirs(out_dir, exist_ok=True)

    clip_score = metrics.CLIPScore(clip_checkpoint, device=pipe.device) if clip_checkpoint else None
    lpips = None
    if lpips_weights:
        from image_editing_framework_torch.eval.lpips import LPIPS

        lpips = LPIPS(lpips_weights, device=pipe.device)

    report = {
        "seed": seed,
        "resolution": res,
        "num_steps": pipe.scheduler.num_steps,
        "model_type": pipe.model_type,
        "sd_version": sd_version,
        "inversion_type": inversion_type,
        "backend": pipe.device.type,
        "decode_tile_latent": pipe.decode_tile_latent,
        # XL p2z recomputes its reference maps (cli.run_method default)
        "p2z_recompute_refs": pipe.model_type == "xl" and "p2z" in methods,
        # gradient passes (p2z guided step, NTI) take the checkpointed UNet at
        # XL >= 1024² (methods/common.grad_unet): the same outputs and grads
        "grad_remat": pipe.model_type == "xl" and res >= 1024
        and ("p2z" in methods or inversion_type == "null-text"),
        "provenance": provenance or "loaded checkpoint",
        "methods": {},
    }

    def write_report():
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2)

    syn_latent = seeded_latent(pipe, (1, res // 8, res // 8, 4), seed)
    inv_cache = None  # (latent, traj, uncond_seq) shared across methods
    for method in methods:
        entry = {}
        mdir = os.path.join(out_dir, method)
        os.makedirs(mdir, exist_ok=True)

        # --- edit_syn flow (seeded latent)
        t0 = time.perf_counter()
        src_img, edit_img = run_method(method, pipe, [source_prompt, target_prompt], syn_latent, sampler,
                                       method_kwargs=_default_kwargs(method, pipe))
        entry["syn_elapsed_s"] = round(time.perf_counter() - t0, 3)
        p_src = os.path.join(mdir, "syn_source.png")
        p_edit = os.path.join(mdir, "syn_edit.png")
        save_img(src_img, p_src)
        save_img(edit_img, p_edit)
        entry["syn_source_sha256"] = _sha256_png(p_src)
        entry["syn_edit_sha256"] = _sha256_png(p_edit)
        if clip_score is not None:
            entry["syn_clip_score"] = clip_score(edit_img[None], [target_prompt])
        # the syn hashes are written before the (often much longer) real flow
        report["methods"][method] = entry
        write_report()

        # --- edit_real flow (invert + edit), when an input image is given
        if source_image is not None:
            # XL NTI lr schedules are method-dependent (cli.nti_config_for):
            # share the inversion only where the schedule is the same
            share = inversion_type != "null-text" or pipe.model_type != "xl"
            if inv_cache is None or not share:
                inv_cache = invert(pipe, source_image, source_prompt, inversion_type, method)
            latent, traj, uncond_seq = inv_cache
            t0 = time.perf_counter()
            inv_img, edit_img = run_method(
                method, pipe, [source_prompt, target_prompt], latent, sampler, uncond_seq,
                _default_kwargs(method, pipe), source_replay=traj if inversion_type == "direct" else None,
            )
            entry["real_elapsed_s"] = round(time.perf_counter() - t0, 3)
            p_inv = os.path.join(mdir, "real_inversion.png")
            p_re = os.path.join(mdir, "real_edit.png")
            save_img(inv_img, p_inv)
            save_img(edit_img, p_re)
            entry["real_inversion_sha256"] = _sha256_png(p_inv)
            entry["real_edit_sha256"] = _sha256_png(p_re)
            # reconstruction fidelity vs the input (the reference's visual
            # inversion.png check, quantified)
            entry["recon_mse"] = metrics.mse(source_image, inv_img)
            entry["recon_psnr"] = metrics.psnr(source_image, inv_img)
            entry["recon_ssim"] = metrics.ssim(source_image, inv_img)
            if clip_score is not None:
                entry["real_clip_score"] = clip_score(edit_img[None], [target_prompt])
            if lpips is not None:
                entry["recon_lpips"] = lpips(source_image[None], inv_img[None])
        report["methods"][method] = entry
        write_report()
        _write_markdown(report, os.path.join(out_dir, "report.md"))
    return report


def validate_refiner(
    pipe,
    out_dir: str,
    source_image: np.ndarray,
    prompt: str = "a gray horse in the field",
    strength: float = 0.3,
    seed: int = 42,
    resolution: Optional[int] = None,
    provenance: Optional[str] = None,
) -> dict:
    """Golden anchor for the refiner img2img flow (methods/img2img.py).

    The refiner is not an editing pipe: its capability is partial-denoise
    refinement (the role the reference loads it for but never invokes,
    p2p/edit_real.py:77-89), so its golden flow refines a deterministic
    source image at ``strength`` with ``seeded_latent`` noise and hashes the
    output, recording structural similarity to the input (a 0.3-strength
    refinement must stay close)."""
    from image_editing_framework_torch.methods.img2img import img2img

    res = resolution or source_image.shape[-3]
    os.makedirs(out_dir, exist_ok=True)
    p_src = os.path.join(out_dir, "source.png")
    save_img(source_image, p_src)

    # the noise has the latent's shape: the VAE halves each side per level
    vae = pipe.vae.config
    down = 2 ** (len(vae.block_out_channels) - 1)
    h, w = source_image.shape[-3:-1]
    t0 = time.perf_counter()
    out = img2img(pipe, source_image, prompt, strength=strength,
                  noise=seeded_latent(pipe, (1, h // down, w // down, vae.latent_channels), seed))
    elapsed = round(time.perf_counter() - t0, 3)
    p_out = os.path.join(out_dir, "refined.png")
    save_img(out, p_out)

    report = {
        "flow": "img2img-refine",
        "seed": seed,
        "strength": strength,
        "resolution": res,
        "num_steps": pipe.scheduler.num_steps,
        "model_type": "xl-refiner",
        "backend": pipe.device.type,
        "decode_tile_latent": pipe.decode_tile_latent,
        "provenance": provenance or "loaded checkpoint",
        "elapsed_s": elapsed,
        "source_sha256": _sha256_png(p_src),
        "refined_sha256": _sha256_png(p_out),
        "refine_mse": metrics.mse(source_image, out),
        "refine_psnr": metrics.psnr(source_image, out),
        "refine_ssim": metrics.ssim(source_image, out),
    }
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def _default_kwargs(method: str, pipe) -> dict:
    if method == "masactrl":
        from image_editing_framework_torch.methods.masactrl import default_masactrl_config

        return {"config": default_masactrl_config(pipe)}
    return {}


def _write_markdown(report: dict, path: str) -> None:
    """The table that fills BASELINE.md's quality cells."""
    lines = [
        f"## Validation report (seed {report['seed']}, "
        f"{report['num_steps']} steps, {report['resolution']}^2, "
        f"{report['model_type']})",
        "",
        "| method | syn edit sha256 | recon PSNR | recon SSIM | CLIP | LPIPS |",
        "|---|---|---|---|---|---|",
    ]
    for m, e in report["methods"].items():
        lines.append(
            f"| {m} | `{e.get('syn_edit_sha256', '')[:16]}` | "
            f"{_fmt(e.get('recon_psnr'))} | {_fmt(e.get('recon_ssim'))} | "
            f"{_fmt(e.get('real_clip_score') or e.get('syn_clip_score'))} | "
            f"{_fmt(e.get('recon_lpips'))} |"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _fmt(v) -> str:
    return "—" if v is None else f"{v:.4g}"


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser("real-weight validation runway")
    p.add_argument("--sd_version", type=str, default="1.5")
    p.add_argument("--path", type=str, default=None,
                   help="checkpoint dir (overrides sd_mapping)")
    p.add_argument("--out", type=str, default="./validation")
    p.add_argument("--source_image", type=str, default=None)
    p.add_argument("--source_prompt", type=str,
                   default="a gray horse in the field")
    p.add_argument("--target_prompt", type=str,
                   default="a whie horse in the field")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--inversion_type", type=str, default="ddim")
    p.add_argument("--methods", type=str, default=",".join(METHODS))
    p.add_argument("--clip_checkpoint", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="one .safetensors file: torchvision vgg16 features.N.* and LPIPS linN.model.1.weight")
    p.add_argument("--random_weights", action="store_true",
                   help="production-shape pipeline with deterministic random "
                        "weights (pipelines.random_pipeline) — the on-card "
                        "golden-hash anchor until checkpoints exist")
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--report_name", type=str, default=None,
                   help="subdirectory under --out (default: --sd_version); "
                        "lets one model version carry several golden configs")
    p.add_argument("--decode_tile", type=int, default=None,
                   help="tiled-decode tile size in latent pixels (default: "
                        "64 for XL at >=1024², full-frame otherwise); the "
                        "tile size changes the seam blending and therefore "
                        "the golden hashes — reports record it")
    args = p.parse_args(argv)

    if args.random_weights:
        from image_editing_framework_torch.pipelines import random_pipeline

        pipe = random_pipeline(args.sd_version, args.num_steps, dtype=torch.bfloat16, seed=args.seed)
    else:
        from image_editing_framework_torch.models.registry import load_pipeline

        pipe = load_pipeline(args.sd_version, args.num_steps, dtype=torch.bfloat16, path=args.path)
    res = args.resolution or (1024 if pipe.model_type == "xl" else 512)
    if args.decode_tile is not None:
        pipe.decode_tile_latent = args.decode_tile
    elif pipe.model_type == "xl" and res >= 1024 and pipe.decode_tile_latent is None:
        # the sweep's memory-safety default: a full-frame 1024² decode beside
        # the resident XL UNet and towers
        pipe.decode_tile_latent = 64
    image = None
    if args.source_image == "synth":
        image = synth_source_image(args.seed, res)
    elif args.source_image:
        image = load_image(args.source_image, res, res)
    provenance = f"random_weights seed={args.seed} (pipelines.random_pipeline)" if args.random_weights else None
    if args.sd_version == "xl-refiner":
        # refiner flow: img2img golden anchor (random_pipeline returns the
        # refiner pipe itself; the registry attaches it as pipe.refiner on an
        # XL-base editing pipe)
        rpipe = pipe if args.random_weights else (pipe.refiner or pipe)
        if args.decode_tile is None and res >= 1024 and rpipe.decode_tile_latent is None:
            rpipe.decode_tile_latent = 64
        report = validate_refiner(
            rpipe, os.path.join(args.out, args.report_name or args.sd_version),
            source_image=image if image is not None else synth_source_image(args.seed, res),
            prompt=args.source_prompt, seed=args.seed, resolution=args.resolution, provenance=provenance,
        )
        print(json.dumps({"refined_sha256": report["refined_sha256"], "refine_ssim": report["refine_ssim"]},
                         indent=2))
        return
    report = validate_pipeline(
        pipe, os.path.join(args.out, args.report_name or args.sd_version), methods=tuple(args.methods.split(",")),
        source_image=image, source_prompt=args.source_prompt, target_prompt=args.target_prompt, seed=args.seed,
        resolution=args.resolution, inversion_type=args.inversion_type, clip_checkpoint=args.clip_checkpoint,
        lpips_weights=args.lpips_weights, provenance=provenance, sd_version=args.sd_version,
    )
    print(json.dumps({m: e.get("syn_edit_sha256") for m, e in report["methods"].items()}, indent=2))


if __name__ == "__main__":
    main()
