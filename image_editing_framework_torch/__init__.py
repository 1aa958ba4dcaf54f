"""PyTorch / CUDA port of the image-editing framework, for NVIDIA Hopper.

The counterpart of ``image_editing_framework_tpu``: training-free,
text-driven image editing on Stable Diffusion (SD1.x, SDXL) with the
framework's attention controls, written in PyTorch, with every TPU kernel
of the JAX package rewritten by hand for the H100 (``csrc/*.cu``, built
with ``nvcc`` at first use). Ported so far: Prompt-to-Prompt, MasaCtrl,
Plug-and-Play and pix2pix-zero, DDIM and null-text inversion, the SD1.5,
SD2.1 and SDXL pipelines (with seeded random weights, or loaded from
HF-snapshot directories and single-file LDM checkpoints by
``load_pipeline``, with the CLIP BPE tokenizer), the reference's
``edit_real`` / ``edit_syn`` entry points (``cli.py``, ``shims.py``), and
its PIE-Bench sweep one image at a time (``test`` / ``cli.test_main``:
``data/pie.py``, the inversion cache, ``eval/metrics.py`` MSE / PSNR / SSIM,
``eval/sweep.py``).

Importing the package imports nothing heavy: the top-level API below is
resolved on first access, as the JAX package's is.
"""

__version__ = "0.1.0"

_API = {
    "SDPipeline": ("image_editing_framework_torch.pipelines", "SDPipeline"),
    "random_pipeline": ("image_editing_framework_torch.pipelines", "random_pipeline"),
    "tiny_pipeline": ("image_editing_framework_torch.pipelines", "tiny_pipeline"),
    "load_pipeline": ("image_editing_framework_torch.models.registry", "load_pipeline"),
    "CLIPTokenizer": ("image_editing_framework_torch.models.tokenizer", "CLIPTokenizer"),
    "ddim_invert": ("image_editing_framework_torch.inversion.ddim", "ddim_invert"),
    "null_text_inversion": ("image_editing_framework_torch.inversion.nti", "null_text_inversion"),
    "p2p_edit": ("image_editing_framework_torch.methods.p2p", "p2p_edit"),
    "masactrl_edit": ("image_editing_framework_torch.methods.masactrl", "masactrl_edit"),
    "pnp_edit": ("image_editing_framework_torch.methods.pnp", "pnp_edit"),
    "p2z_edit": ("image_editing_framework_torch.methods.p2z", "p2z_edit"),
    "run_sweep": ("image_editing_framework_torch.eval.sweep", "run_sweep"),
}


def __getattr__(name):
    """Lazy top-level API: the module that defines ``name`` is imported on
    first access."""
    if name in _API:
        import importlib

        module, attr = _API[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)


def __dir__():
    return sorted(list(globals()) + list(_API))
