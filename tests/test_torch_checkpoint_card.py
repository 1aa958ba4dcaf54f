"""Checkpoint loading and the edit entry points on the card: ``load_params``
straight onto the card in bf16 against a CPU load cast to bf16 (bitwise),
and ``cli.edit_syn_main`` through ``load_pipe`` on a tiny checkpoint
directory, written by ``chip_smoke.py``'s own writer (the GPU machine has
no ``safetensors``).

Imports only torch, numpy, the port and chip_smoke.py (which imports no
JAX), so it runs on the GPU machine, which has no JAX:

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_checkpoint_card.py

Without a card every test skips (the CPU suite holds the loader, the
registry and the entry points against JAX in test_torch_loader.py,
test_torch_registry.py and test_torch_cli.py).
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from image_editing_framework_torch import cli, sd_mapping
from image_editing_framework_torch.models import configs, registry
from image_editing_framework_torch.models.clip import TINY_CLIP, CLIPTextModel
from image_editing_framework_torch.models.loader import load_params, load_safetensors, save_safetensors
from image_editing_framework_torch.models.unet import UNet2DCondition
from image_editing_framework_torch.models.vae import TINY_VAE
from image_editing_framework_torch.pipelines import _build, tiny_pipeline
from image_editing_framework_torch.utils.images import decode_png

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
TEXT = dataclasses.replace(TINY_CLIP, vocab_size=49408, projection_dim=None)  # the synthetic CLIP vocab's size


@pytest.fixture
def smoke():
    """chip_smoke.py as a module (importing it runs nothing), on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tiny_sd_pipe():
    pipe = tiny_pipeline(num_steps=4, device="cpu")
    pipe.text_encoder = _build(CLIPTextModel, TEXT, torch.device("cpu"), torch.float32, 5)
    return pipe


@pytest.mark.cuda
def test_load_params_on_the_card_equals_a_cpu_load_cast(smoke, tmp_path):
    pipe = _tiny_sd_pipe()
    path = str(tmp_path / "unet.safetensors")
    save_safetensors(pipe.unet.state_dict(), path, torch.float16)
    ckpt = load_safetensors(path)

    def meta_unet():
        with torch.device("meta"):
            return UNet2DCondition(configs.TINY_UNET)

    gpu = load_params(meta_unet(), ckpt, torch.bfloat16, "cuda")
    cpu = load_params(meta_unet(), ckpt, None, "cpu")
    assert all(p.device.type == "cuda" and p.dtype == torch.bfloat16 for p in gpu.parameters())
    want, got = cpu.state_dict(), gpu.state_dict()
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(got[key].cpu(), want[key].to(torch.bfloat16)), key


@pytest.mark.cuda
def test_edit_syn_main_on_a_tiny_checkpoint_writes_its_pngs(smoke, tmp_path, monkeypatch):
    snapshot, _, _, _ = smoke.write_sd_checkpoints(_tiny_sd_pipe(), str(tmp_path / "ckpt"),
                                                   " ".join(smoke.CKPT_PROMPTS).split())
    spec = registry.VersionSpec("sd", configs.TINY_UNET, TEXT, sample_size=32, vae=TINY_VAE)
    monkeypatch.setitem(registry.VERSION_SPECS, "1.5", spec)
    monkeypatch.setitem(sd_mapping.sd_maps, "1.5", snapshot)
    monkeypatch.setattr(cli, "resolution_for", lambda pipe: 64)
    monkeypatch.setattr(cli, "NUM_INFERENCE_STEPS", 4)
    monkeypatch.chdir(tmp_path)
    cli.edit_syn_main("p2p", argv=["--source_prompt", smoke.CKPT_PROMPTS[0], "--target_prompt",
                                   smoke.CKPT_PROMPTS[1]])
    for name in ("source", "edit"):
        with open(os.path.join("exp", name + ".png"), "rb") as f:
            img = decode_png(f.read())
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8, (name, img.shape)
