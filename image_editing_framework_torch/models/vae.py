"""AutoencoderKL (the SD VAE): mean encode and decode.

Counterpart of ``image_editing_framework_tpu/models/vae.py``. The reference
calls the VAE at two sites: encode to the latent distribution *mean*
(p2p/inversion/ddim.py:39) and decode (p2p/model/sd_utils.py:84). GroupNorm
eps 1e-6 throughout. Module and parameter names follow diffusers. Inside,
activations are NCHW; ``encode``/``decode`` take and return NHWC as JAX does.
The mid-block attention is single-head (d = 512) and plain tensor code, as
in JAX. Tiled decoding arrives with a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _gn(ch: int) -> int:
    """GroupNorm group count: 32 in all real configs; clamp for tiny tests."""
    return min(32, ch)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215


TINY_VAE = VAEConfig(block_out_channels=(16, 32), layers_per_block=1)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(_gn(in_channels), in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(_gn(out_channels), out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention at the VAE mid block."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(_gn(channels), channels, eps=1e-6)
        self.to_q, self.to_k, self.to_v = (nn.Linear(channels, channels) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(c)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        h = self.to_out[0](torch.matmul(p, v))
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class _Sampler(nn.Module):
    """diffusers' ``downsamplers.0`` / ``upsamplers.0``: one conv named ``conv``."""

    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=stride, padding=0 if stride == 2 else 1)


class _Level(nn.Module):
    def __init__(self, resnets, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler_name is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch), VAEResnet(ch, ch)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, h):
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = chs[0]
        for i, out_ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VAEResnet(ch, out_ch))
                ch = out_ch
            last = i == len(chs) - 1
            self.down_blocks.append(
                _Level(resnets, None if last else "downsamplers", None if last else _Sampler(out_ch, 2))
            )
        self.mid_block = _Mid(chs[-1])
        self.conv_norm_out = nn.GroupNorm(_gn(chs[-1]), chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down_blocks:
            for resnet in level.resnets:
                h = resnet(h)
            if hasattr(level, "downsamplers"):
                # diffusers VAE downsampler uses asymmetric (0,1) padding.
                h = level.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0])
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out_ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnet(ch, out_ch))
                ch = out_ch
            last = i == len(rev) - 1
            self.up_blocks.append(
                _Level(resnets, None if last else "upsamplers", None if last else _Sampler(out_ch, 1))
            )
        self.conv_norm_out = nn.GroupNorm(_gn(rev[-1]), rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for level in self.up_blocks:
            for resnet in level.resnets:
                h = resnet(h)
            if hasattr(level, "upsamplers"):
                h = level.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) image in [-1, 1] -> scaled latent mean (B, H/8, W/8, 4)
        — the reference's image2latent (p2p/inversion/ddim.py:35-41)."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2).contiguous()))
        mean = moments[:, : self.config.latent_channels]
        return (mean * self.config.scaling_factor).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled NHWC latents -> (B, H, W, 3) in [-1, 1]
        (reference latent2image, p2p/model/sd_utils.py:82-88)."""
        z = z.permute(0, 3, 1, 2).contiguous() / self.config.scaling_factor
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


@torch.no_grad()
def decode_tiled(vae: AutoencoderKL, z: torch.Tensor, tile: int = 64, overlap: int = 16) -> torch.Tensor:
    """Memory-bounded decode (JAX ``models/vae.py:163 decode_tiled``): split
    the (B, h, w, 4) scaled latents into overlapping spatial tiles, decode
    each, and blend the overlaps with linear ramps (rows, then columns: the
    diffusers enable_vae_tiling recipe). Peak activation memory follows the
    tile, not the image.

    ``tile``/``overlap`` are in latent pixels; the decoded tiles overlap by
    scale*overlap image pixels (scale = the decoder's upsampling factor, 8
    for SD VAEs). Tiles are decoded and accumulated one at a time.
    """
    b, h, w, _ = z.shape
    if h <= tile and w <= tile:
        return vae.decode(z)
    # Small tiles with the default overlap would give a non-positive stride;
    # cap the overlap at half the tile.
    overlap = min(overlap, tile // 2)
    stride = tile - overlap
    rows = max(1, -(-(h - overlap) // stride))
    cols = max(1, -(-(w - overlap) // stride))
    scale = 2 ** (len(vae.config.block_out_channels) - 1)
    out_tile, out_ov = tile * scale, overlap * scale
    img_h, img_w = h * scale, w * scale
    ramp = torch.arange(1, out_ov + 1, dtype=torch.float32, device=z.device) / (out_ov + 1)

    def edge_weights(t0, full):
        wgt = torch.ones(out_tile, dtype=torch.float32, device=z.device)
        if t0 > 0:
            wgt[:out_ov] = ramp
        if t0 + out_tile < full:
            wgt[-out_ov:] = ramp.flip(0)
        return wgt

    canvas = torch.zeros((b, img_h, img_w, 3), dtype=z.dtype, device=z.device)
    weight = torch.zeros((1, img_h, img_w, 1), dtype=torch.float32, device=z.device)
    for r in range(rows):
        y = min(r * stride, h - tile)
        for c in range(cols):
            x = min(c * stride, w - tile)
            timg = vae.decode(z[:, y:y + tile, x:x + tile])
            ty, tx = y * scale, x * scale
            wt = (edge_weights(ty, img_h)[:, None] * edge_weights(tx, img_w)[None, :])[None, :, :, None]
            # in place: the canvas and the weight sum belong to this call
            canvas[:, ty:ty + out_tile, tx:tx + out_tile] += (timg.float() * wt).to(canvas.dtype)
            weight[:, ty:ty + out_tile, tx:tx + out_tile] += wt
    return (canvas.float() / torch.clamp(weight, min=1e-6)).to(canvas.dtype)
