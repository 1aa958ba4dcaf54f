"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*.py).

One set of random weights lives in the JAX tiny pipeline; ``export_params``
turns it into diffusers-keyed arrays, which the port's strict loader copies
into the port's tiny pipeline. Inputs are made with numpy and handed to both
frameworks; NHWC <-> NCHW happens only inside the port, never here.
"""

from __future__ import annotations

import functools
import importlib.util
import os

import numpy as np
import torch

from image_editing_framework_torch.methods.base import LocalBlend
from image_editing_framework_torch.models.weights import load_weights
from image_editing_framework_torch.pipelines import tiny_pipeline as torch_tiny_pipeline
from image_editing_framework_tpu.models import loader
from image_editing_framework_tpu.pipelines import tiny_pipeline as jax_tiny_pipeline

# f32 convolutions through cuDNN would run in TF32 by default on a card;
# parity is stated in true f32.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# The suite runs under pytest-xdist with several workers on one machine; with
# torch's default of one intra-op thread per core in every worker, the
# workers' threads contend for the cores and the tiny models' many small ops
# run 20-100x slower than alone. One thread per worker keeps each test at its
# single-process speed. (Every worker imports this module while collecting.)
torch.set_num_threads(1)


def shared_pipelines(num_steps: int = 4, seed: int = 0, model_type: str = "sd"):
    """(jax_pipe, torch_pipe) with the same tiny-pipeline weights; the port's
    runs on the CPU in f32. ``model_type``: 'sd', 'xl' (both text towers,
    the second with its ``text_projection``; the UNet's ``add_embedding``)
    or 'xl-refiner' (its one tower serves as both)."""
    jpipe = jax_tiny_pipeline(num_steps=num_steps, model_type=model_type, seed=seed)
    tpipe = torch_tiny_pipeline(num_steps=num_steps, model_type=model_type, device="cpu")
    load_weights(tpipe.unet, loader.export_params(jpipe.unet_params, loader.unet_key))
    load_weights(tpipe.vae, loader.export_params(jpipe.vae_params, loader.vae_key))
    load_weights(tpipe.text_encoder, loader.export_params(jpipe.text_params, loader.clip_key))
    if model_type == "xl":
        load_weights(tpipe.text_encoder_2, loader.export_params(jpipe.text_params_2, loader.clip_key))
    return jpipe, tpipe


def fix_vocab(pipes, prompts):
    """Give the words of ``prompts`` their ids in the tiny pipelines'
    tokenizers, in one order in every pipeline. The tiny tokenizer hands
    out ids in the order it first sees words, so tests that encode the
    source and the target prompt in different orders in the two frameworks
    would otherwise give them different ids."""
    words = " ".join(prompts)
    for pipe in pipes:
        for tok in {id(x): x for x in (pipe.tokenizer, pipe.tokenizer_2) if x is not None}.values():
            tok.encode(words)


def t(x) -> torch.Tensor:
    """numpy (or JAX) array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RecordingBlend(LocalBlend):
    """LocalBlend that keeps each step's distance of the mask from its
    threshold: a mask value near the threshold could flip between
    frameworks, so a parity test checks this margin."""

    gaps = None

    def __call__(self, x_t, store):
        if store:
            gap = (self.mask(x_t, store) - self.threshold).abs().min().item()
            self.gaps = (self.gaps or []) + [gap]
        return super().__call__(x_t, store)


# Smallest |g| / max|g| an NTI gradient may have: Adam's first step moves an
# element by lr · g / (|g| + 1e-8), about lr · sign(g).
GRAD_MARGIN = 1e-7


def recorded_latents(monkeypatch, module):
    """The final latents that ``module.denoise`` returns from now on (the
    JAX package's returns (latents, records)), recorded on their way out."""
    seen = []
    real = module.denoise

    def recording(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[0] if isinstance(out, tuple) else out)
        return out

    monkeypatch.setattr(module, "denoise", recording)
    return seen


def recorded_grads(monkeypatch):
    """Every gradient ``torch.autograd.grad`` returns from now on (the port's
    NTI takes one per inner iteration), recorded on its way out."""
    grads = []
    grad = torch.autograd.grad

    def recording(*args, **kw):
        out = grad(*args, **kw)
        grads.append(out[0].detach().clone())
        return out

    monkeypatch.setattr(torch.autograd, "grad", recording)
    return grads


def check_grad_margin(grads, count):
    """``count`` gradients, none with an element within GRAD_MARGIN · max|g|
    of 0, where f32 noise could give it the other sign in the other
    framework."""
    assert len(grads) == count
    for g in grads:
        a = g.abs()
        assert a.min().item() >= GRAD_MARGIN * a.max().item(), a.min().item() / a.max().item()


@functools.lru_cache()
def chip_smoke():
    """chip_smoke.py as a module (importing it runs nothing): its checkpoint
    writer, inverse LDM rename and synthetic CLIP vocab serve the loader,
    registry and CLI tests."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def export_random(module, seed, key_fn, *args):
    """Diffusers-keyed f32 arrays of a JAX module's params: the tree's
    shapes from ``eval_shape`` (no init is run or compiled), values
    N(0, 0.02²) from a seeded numpy generator, norm scales centred at 1;
    contiguous (``export_params`` returns transposed views, which
    ``safetensors.numpy.save_file`` would write in storage order)."""
    import jax

    skeleton = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)
    params = {path: (rng.randn(*leaf.shape) * 0.02 + (path[-1] == "scale")).astype(np.float32)
              for path, leaf in loader._flatten(skeleton["params"]).items()}
    exported = loader.export_params({"params": loader._unflatten(params)}, key_fn)
    return {k: np.ascontiguousarray(v) for k, v in exported.items()}
