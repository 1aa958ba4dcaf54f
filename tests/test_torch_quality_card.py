"""The quality metrics and the validation runway on the card: ``CLIPScore``
and LPIPS on the card against the same towers on the CPU (files written by
``chip_smoke.py``'s own writers, CLIPScore at a tiny width put into
``models/clip.py``), and ``validate_pipeline`` on the tiny pipeline on the
card against the same run on the CPU.

Imports only torch, numpy, the port and chip_smoke.py (which imports no
JAX), so it runs on the GPU machine, which has no JAX:

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_quality_card.py

Without a card every test skips (the CPU suite holds the towers and the
runway against JAX in test_torch_clip_vision.py, test_torch_clip_score.py,
test_torch_lpips.py and test_torch_validate.py).
"""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from image_editing_framework_torch.eval import validate
from image_editing_framework_torch.eval.lpips import LPIPS
from image_editing_framework_torch.eval.metrics import CLIPScore
from image_editing_framework_torch.models import clip
from image_editing_framework_torch.pipelines import tiny_pipeline
from image_editing_framework_torch.utils.images import decode_png

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
RTOL = 1e-4  # chip_smoke.py's TOWER_RTOL: the card's towers against the CPU's, f32
LEVELS = 2
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]


@pytest.fixture
def smoke():
    """chip_smoke.py as a module (importing it runs nothing), on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the towers and the runway's kernels run there")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_towers_on_the_card_match_the_cpu(smoke, tmp_path, monkeypatch):
    monkeypatch.setattr(clip, "CLIP_VIT_B32_VISION", dataclasses.replace(clip.TINY_CLIP_VISION, image_size=224,
                                                                         patch_size=32))
    monkeypatch.setattr(clip, "CLIPTextConfig", functools.partial(clip.CLIPTextConfig, vocab_size=1024,
                                                                  hidden_size=32, num_layers=2, num_heads=2,
                                                                  intermediate_size=64))
    clip_dir, lpips_path = str(tmp_path / "clip"), str(tmp_path / "lpips.safetensors")
    smoke.write_clip_checkpoint(clip_dir, " ".join(PROMPTS).split(), "cuda")
    smoke.write_lpips_weights(lpips_path)
    rng = np.random.RandomState(0)
    a, b = (rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8) for _ in range(2))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True  # the towers turn it off
        card, cpu = CLIPScore(clip_dir, device="cuda"), CLIPScore(clip_dir, device="cpu")
        for got, want in zip(card.embeddings(a, PROMPTS), cpu.embeddings(a, PROMPTS)):
            assert got.device.type == "cuda" and float(torch.linalg.vector_norm(got.cpu() - want)) <= RTOL
        scores, want_scores = card.scores(a, PROMPTS), cpu.scores(a, PROMPTS)
        assert torch.all(torch.abs(scores - want_scores) <= RTOL * torch.clamp_min(want_scores.abs(), 1.0))
        card_lpips, cpu_lpips = LPIPS(lpips_path, device="cuda"), LPIPS(lpips_path, device="cpu")
        got, want = card_lpips.distances(a, b), cpu_lpips.distances(a, b)
        assert torch.all(torch.abs(got - want) <= RTOL * want) and torch.all(want > 0)
        assert card_lpips(a, a) == 0.0
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


@pytest.mark.cuda
def test_validate_pipeline_on_the_card(smoke, tmp_path, monkeypatch):
    """The runway on the tiny pipeline on the card (P2P and p2z, so the
    forward and both backward kernels run) against the same run on the CPU,
    from one start latent drawn on the CPU: every PNG within 2 levels, the
    kernels launched on the card."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    image = np.random.RandomState(1).randint(0, 255, (32, 32, 3), np.uint8)
    cpu_pipe, card_pipe = tiny_pipeline(num_steps=4, device="cpu"), tiny_pipeline(num_steps=4, device="cuda")
    for name in ("unet", "vae", "text_encoder"):
        getattr(card_pipe, name).load_state_dict(getattr(cpu_pipe, name).state_dict())
    for pipe in (cpu_pipe, card_pipe):
        pipe.tokenizer.encode(" ".join(PROMPTS))  # the same word ids in both
    latent = validate.seeded_latent(cpu_pipe, (1, 4, 4, 4), 3)
    monkeypatch.setattr(validate, "seeded_latent", lambda pipe, shape, seed: latent.to(pipe.device, pipe.dtype))
    kw = dict(methods=("p2p", "p2z"), source_image=image, resolution=32, seed=3, source_prompt=PROMPTS[0],
              target_prompt=PROMPTS[1])
    want = validate.validate_pipeline(cpu_pipe, str(tmp_path / "cpu"), **kw)
    smoke.reset_launch_counts()
    got = validate.validate_pipeline(card_pipe, str(tmp_path / "card"), **kw)
    counts = smoke.launch_counts()
    assert got["backend"] == "cuda" and want["backend"] == "cpu" and set(got) == set(want)
    assert counts[0] > 0 and counts[1] == counts[2] > 0
    for method in kw["methods"]:
        for name in ("syn_source", "syn_edit", "real_inversion", "real_edit"):
            a, b = (_png(os.path.join(tmp_path, side, method, name + ".png")).astype(int) for side in ("card", "cpu"))
            assert a.shape == b.shape and np.abs(a - b).max() <= LEVELS, (method, name, np.abs(a - b).max())
