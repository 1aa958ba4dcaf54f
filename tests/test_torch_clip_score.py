"""The port's ``eval/metrics.py CLIPScore`` against the JAX package's, on the
CPU in float32, from one tmp checkpoint directory (``model.safetensors``
with both towers, fp16, and a synthetic BPE vocab under ``tokenizer/``,
written by ``chip_smoke.write_clip_checkpoint``). Both packages build
their towers from ``models/clip.py``'s ``CLIPTextConfig`` and
``CLIP_VIT_B32_VISION`` at call time, so the tests put tiny configurations
into both modules (``tiny_clip``; its vision tower takes 224² images, as
JAX's ``CLIPScore`` resizes to 224² whatever the configuration). Scores
(0-100) within ``SCORE_ATOL`` = 1e-4 of JAX's, each image's and the mean;
the unit embeddings within ``EMBED_ATOL`` = 1e-5 of JAX's towers' (a
random CLIP's cosines may be negative, which the score clamps to 0)."""

import dataclasses
import functools
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.device import true_f32
from image_editing_framework_torch.eval import metrics as tmetrics
from image_editing_framework_torch.models import clip as tclip
from image_editing_framework_tpu.eval import metrics as jmetrics
from image_editing_framework_tpu.models import clip as jclip
from image_editing_framework_tpu.models.tokenizer import pad_token_ids
from torch_port_helpers import chip_smoke

SCORE_ATOL = 1e-4
EMBED_ATOL = 1e-5
TINY_TEXT = dict(vocab_size=1024, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
PROMPTS = ["a cat sitting on the grass", "a dog standing in the field"]


@pytest.fixture
def tiny_clip(monkeypatch, tmp_path):
    """Tiny CLIPScore configurations in both packages and a checkpoint
    directory in their shapes; returns the directory."""
    for clip in (jclip, tclip):
        # 224² like ViT-B/32: JAX's CLIPScore resizes to 224² whatever the config
        monkeypatch.setattr(clip, "CLIP_VIT_B32_VISION", dataclasses.replace(clip.TINY_CLIP_VISION, image_size=224,
                                                                             patch_size=32))
        monkeypatch.setattr(clip, "CLIPTextConfig", functools.partial(clip.CLIPTextConfig, **TINY_TEXT))
    path = str(tmp_path / "clip")
    chip_smoke().write_clip_checkpoint(path, " ".join(PROMPTS).split(), "cpu")
    return path


def _images(n=2, side=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, side, side, 3)).astype(np.uint8)


def _jax_embeddings(scorer, images, prompts):
    img = scorer.vision.apply(scorer.vision_params, scorer._preprocess(jnp.asarray(images)))["image_embeds"]
    txt = scorer.text.apply(scorer.text_params, jnp.asarray(pad_token_ids(scorer.tokenizer, prompts)))["pooled"]
    return [np.asarray(x / jnp.linalg.norm(x, axis=-1, keepdims=True)) for x in (img, txt)]


def test_clip_score_matches_jax(tiny_clip):
    port, ref = tmetrics.CLIPScore(tiny_clip, device="cpu"), jmetrics.CLIPScore(tiny_clip)
    assert port.text.config.hidden_size == 32 and port.vision.config == tclip.CLIP_VIT_B32_VISION
    images = _images()
    scores = port.scores(images, PROMPTS)
    assert scores.shape == (2,) and scores.dtype == torch.float32
    for i, prompt in enumerate(PROMPTS):
        assert abs(float(scores[i]) - ref(images[i:i + 1], [prompt])) <= SCORE_ATOL
    assert abs(port(images, PROMPTS) - ref(images, PROMPTS)) <= SCORE_ATOL
    assert all(0.0 <= float(s) <= 100.0 for s in scores)
    for got, want in zip(port.embeddings(images, PROMPTS), _jax_embeddings(ref, images, PROMPTS)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EMBED_ATOL)
    # a uint8 tensor scores as its array does
    assert torch.equal(port.scores(torch.from_numpy(images), PROMPTS), scores)


def test_clip_score_reads_a_top_level_tokenizer(tiny_clip, tmp_path):
    top = str(tmp_path / "top")
    shutil.copytree(tiny_clip, top)
    for name in os.listdir(os.path.join(top, "tokenizer")):
        shutil.move(os.path.join(top, "tokenizer", name), top)
    os.rmdir(os.path.join(top, "tokenizer"))
    images = _images(seed=1)
    want = tmetrics.CLIPScore(tiny_clip, device="cpu").scores(images, PROMPTS)
    assert torch.equal(tmetrics.CLIPScore(top, device="cpu").scores(images, PROMPTS), want)
    assert abs(float(want.mean()) - jmetrics.CLIPScore(top)(images, PROMPTS)) <= SCORE_ATOL


def test_clip_score_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tmetrics.CLIPScore(str(tmp_path), device="cpu")


def test_true_f32_turns_tf32_off_and_restores_it():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with true_f32():
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        with pytest.raises(RuntimeError), true_f32():
            raise RuntimeError("a tower failed")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_checkpoint_holds_both_towers_in_transformers_keys(tiny_clip):
    from image_editing_framework_torch.models.loader import load_safetensors

    keys = set(load_safetensors(os.path.join(tiny_clip, "model.safetensors")).keys())
    assert {k.split(".")[0] for k in keys} == {"text_model", "vision_model", "text_projection", "visual_projection"}
    assert "vision_model.pre_layrnorm.weight" in keys and "text_model.embeddings.position_ids" in keys
