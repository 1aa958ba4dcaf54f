"""CLIP text encoders (OpenAI CLIP ViT-L/14, OpenCLIP ViT-H / bigG) and the
CLIP ViT vision tower of the CLIP-score metric.

Counterpart of ``image_editing_framework_tpu/models/clip.py``.
Module and parameter names follow transformers' ``CLIPTextModel``, so
``state_dict()`` keys are its keys. The attention (77 tokens, causal) is
plain tensor code, as in JAX. Output conventions: SD1.x and SD2.1 take the
last hidden state (CLIP-L with quick_gelu; a 23-layer OpenCLIP-H with exact
gelu); SDXL takes CLIP-L's and bigG's penultimate hidden states side by side
and bigG's projected pooled embedding.

The vision tower (``CLIPVisionModel``) follows transformers'
``CLIPVisionModelWithProjection``: its ``state_dict()`` keys are that
model's (with the upstream ``pre_layrnorm`` spelling), and its layers are
the text tower's ``CLIPLayer`` with every key visible to every query.
``clip_preprocess`` resizes with JAX's antialiased bicubic filter
(``utils/images.py resize``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from image_editing_framework_torch.parallel.sharding import (
    copy_to_tensor_parallel,
    row_parallel_linear,
    tensor_parallel_size,
)
from image_editing_framework_torch.utils.images import resize


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_length: int = 77
    hidden_act: str = "quick_gelu"  # "quick_gelu" (OpenAI) | "gelu" (OpenCLIP)
    # projection to the pooled text embedding (SDXL's text_encoder_2)
    projection_dim: Optional[int] = None


CLIP_VIT_L = CLIPTextConfig()  # SD1.x / SDXL text_encoder
OPEN_CLIP_VIT_H = CLIPTextConfig(
    hidden_size=1024, num_layers=23, num_heads=16, intermediate_size=4096,
    hidden_act="gelu",
)  # SD2.1
OPEN_CLIP_BIG_G = CLIPTextConfig(
    hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
    hidden_act="gelu", projection_dim=1280,
)  # SDXL text_encoder_2

TINY_CLIP = CLIPTextConfig(
    vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, projection_dim=32,
)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


class CLIPAttention(nn.Module):
    """Under tensor parallelism (``tp_group``, set by ``parallel/sharding.py
    shard_params``) q/k/v_proj are column-parallel and out_proj
    row-parallel: this rank runs its num_heads/n heads."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))
        self.tp_group = None

    @property
    def heads(self) -> int:
        return self.cfg.num_heads

    def forward(self, x, causal_mask):
        cfg, tp = self.cfg, self.tp_group
        b, n, _ = x.shape
        d = cfg.hidden_size // cfg.num_heads
        heads = cfg.num_heads // tensor_parallel_size(tp)
        x = copy_to_tensor_parallel(x, tp)
        q, k, v = (f(x).view(b, n, heads, d).transpose(1, 2) for f in (self.q_proj, self.k_proj, self.v_proj))
        s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(d)
        s = torch.where(causal_mask, s, torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.matmul(p, v).transpose(1, 2).reshape(b, n, heads * d)
        return row_parallel_linear(self.out_proj, out, tp)


class CLIPMLP(nn.Module):
    """Under tensor parallelism fc1 is column-parallel and fc2 row-parallel."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.tp_group = None

    def forward(self, x):
        tp = self.tp_group
        return row_parallel_linear(self.fc2, _act(self.act, self.fc1(copy_to_tensor_parallel(x, tp))), tp)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """input_ids: (B, 77) int.

        Returns dict with:
          last_hidden_state: (B, 77, D) after the final LayerNorm,
          penultimate:       (B, 77, D) hidden_states[-2] (pre final LN),
          pooled:            (B, D_proj) EOS-position embedding (projected if
                             projection_dim is set).
        """
        cfg, tm = self.config, self.text_model
        b, n = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[None, :n]
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=input_ids.device))[None, None]
        penultimate = None
        for i, layer in enumerate(tm.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, causal)
        last = tm.final_layer_norm(x)
        # Pooled: embedding at the EOS token — CLIP takes argmax(ids) since
        # EOS has the highest token id.
        pooled = last[torch.arange(b, device=last.device), input_ids.argmax(dim=-1)]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return {"last_hidden_state": last, "penultimate": penultimate, "pooled": pooled}


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    projection_dim: int = 512


CLIP_VIT_B32_VISION = CLIPVisionConfig()  # the standard CLIP-score backbone

TINY_CLIP_VISION = CLIPVisionConfig(
    hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
    image_size=32, patch_size=16, projection_dim=32,
)

# CLIP image preprocessing constants (OpenAI).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        # patch embedding: a convolution at stride = patch, no bias (transformers parity)
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.encoder = _Encoder(CLIPTextConfig(
            hidden_size=cfg.hidden_size, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            intermediate_size=cfg.intermediate_size, hidden_act=cfg.hidden_act,
        ))
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPVisionModel(nn.Module):
    """CLIP ViT vision tower with its projection (for the CLIP-score metric;
    the reference computes no metrics)."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pixel_values: (B, H, W, 3) NHWC, CLIP-normalized.

        Returns dict with 'pooled' (B, hidden) post-LN class embedding and
        'image_embeds' (B, projection_dim).
        """
        vm = self.vision_model
        emb = vm.embeddings
        b = pixel_values.shape[0]
        x = emb.patch_embedding(pixel_values.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([emb.class_embedding.expand(b, 1, -1), x], dim=1)
        n = x.shape[1]
        x = vm.pre_layrnorm(x + emb.position_embedding.weight[None, :n])
        everyone = torch.ones((n, n), dtype=torch.bool, device=x.device)[None, None]
        for layer in vm.encoder.layers:
            x = layer(x, everyone)
        pooled = vm.post_layernorm(x[:, 0])
        return {"pooled": pooled, "image_embeds": self.visual_projection(pooled)}


def clip_preprocess(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> CLIP-normalized float32 (B, image_size,
    image_size, 3), NHWC, on ``images``' device: JAX's antialiased bicubic
    resize of the [0, 1] image (``utils/images.py resize``), then the
    per-channel mean and standard deviation."""
    x = images.to(torch.float32) / 255.0
    x = resize(x, (x.shape[0], image_size, image_size, 3), "bicubic")
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
