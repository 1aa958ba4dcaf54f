"""Plain PyTorch Stable Diffusion networks over diffusers-keyed weights.

The benchmark's reference: the CLIP text towers, the UNet2DCondition of
SD1.x and SDXL, and the AutoencoderKL, written as functions of a flat
``{diffusers key: tensor}`` dict, with no kernel, cache or batching trick.
Attention is ``softmax(q k^T / sqrt(d)) v`` materialised. It imports nothing
of the program under test.

Departures from diffusers, each the framework's own definition (the JAX
package's, which the port follows): the GEGLU gate uses the tanh
approximation of GELU (flax's default); LayerNorm eps 1e-5 in the
transformer blocks.

``Precision`` quantises the operands of every product (linear, convolution,
attention matmul): identity for the float32 reference, per-tensor scaled
float8 for the lower-precision control (e4m3 values, e5m2 gradients).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """Per-tensor scaled float8 (amax mapped to ``top``), carried back in
    the input's dtype."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFP8(torch.autograd.Function):
    """e4m3 on the way forward; the gradient passes through the rounding
    (straight through) and is itself rounded to e5m2, as a float8 program
    rounds both operands of its backward products."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


class Precision:
    """Rounds the operands of products. ``fp8``: per-tensor scaled e4m3
    forward, e5m2 gradients, values carried in float32 after the round
    trip."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {kind}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        return _RoundFP8.apply(x)


F32 = Precision("f32")


def linear(p: Params, key: str, x: torch.Tensor, q: Precision, bias: bool = True) -> torch.Tensor:
    b = p.get(key + ".bias") if bias else None
    return F.linear(q(x), q(p[key + ".weight"]), b)


def conv(p: Params, key: str, x: torch.Tensor, q: Precision, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(q(x), q(p[key + ".weight"]), p[key + ".bias"], stride=stride, padding=padding)


def group_norm(p: Params, key: str, x: torch.Tensor, eps: float, groups: int = 32) -> torch.Tensor:
    return F.group_norm(x, min(groups, x.shape[1]), p[key + ".weight"], p[key + ".bias"], eps)


def layer_norm(p: Params, key: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[key + ".weight"], p[key + ".bias"], eps)


def attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, q: Precision, mask=None):
    """(B, H, N, D) heads -> (B, H, N, D) and the probabilities."""
    s = torch.matmul(q(qh), q(kh).transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    probs = torch.softmax(s, dim=-1)
    return torch.matmul(q(probs), q(vh)), probs


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, n, c // n).transpose(1, 2)


def unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


# ---------------------------------------------------------------- CLIP text


def clip_shapes(cfg: dict) -> Dict[str, tuple]:
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    s = {"text_model.embeddings.token_embedding.weight": (cfg["vocab_size"], d),
         "text_model.embeddings.position_embedding.weight": (cfg["max_position_embeddings"], d),
         "text_model.final_layer_norm.weight": (d,), "text_model.final_layer_norm.bias": (d,)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"text_model.encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            s[pre + ln + ".weight"], s[pre + ln + ".bias"] = (d,), (d,)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[pre + f"self_attn.{proj}.weight"], s[pre + f"self_attn.{proj}.bias"] = (d, d), (d,)
        s[pre + "mlp.fc1.weight"], s[pre + "mlp.fc1.bias"] = (m, d), (m,)
        s[pre + "mlp.fc2.weight"], s[pre + "mlp.fc2.bias"] = (d, m), (d,)
    if cfg.get("projection_dim") and cfg.get("with_projection"):
        s["text_projection.weight"] = (cfg["projection_dim"], d)
    return s


def clip_text(p: Params, cfg: dict, ids: torch.Tensor, q: Precision = F32) -> Dict[str, torch.Tensor]:
    """ids (B, 77) -> last hidden state, penultimate hidden state (the input
    of the last layer), and the pooled EOS embedding (projected when the
    tower has a projection)."""
    n = ids.shape[1]
    x = p["text_model.embeddings.token_embedding.weight"][ids] + p["text_model.embeddings.position_embedding.weight"][:n]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=ids.device))
    act = cfg["hidden_act"]
    layers = cfg["num_hidden_layers"]
    penultimate = None
    for i in range(layers):
        pre = f"text_model.encoder.layers.{i}."
        if i == layers - 1:
            penultimate = x
        h = layer_norm(p, pre + "layer_norm1", x)
        qh, kh, vh = (heads(linear(p, pre + f"self_attn.{k}_proj", h, q), cfg["num_attention_heads"])
                      for k in "qkv")
        o, _ = attention(qh, kh, vh, q, mask)
        x = x + linear(p, pre + "self_attn.out_proj", unheads(o), q)
        h = linear(p, pre + "mlp.fc1", layer_norm(p, pre + "layer_norm2", x), q)
        h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h)
        x = x + linear(p, pre + "mlp.fc2", h, q)
    last = layer_norm(p, "text_model.final_layer_norm", x)
    pooled = last[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]
    if "text_projection.weight" in p:
        pooled = linear(p, "text_projection", pooled, q, bias=False)
    return {"last": last, "penultimate": penultimate, "pooled": pooled}


# --------------------------------------------------------------------- UNet


def _unet_layout(cfg: dict):
    """Per level: channels, heads, transformer depth; the block lists."""
    chs = cfg["block_out_channels"]
    heads_ = cfg["attention_head_dim"]
    heads_ = [heads_] * len(chs) if isinstance(heads_, int) else list(heads_)
    depth = cfg.get("transformer_layers_per_block", 1)
    depth = [depth] * len(chs) if isinstance(depth, int) else list(depth)
    return chs, heads_, depth


def unet_shapes(cfg: dict) -> Dict[str, tuple]:
    chs, _, depth = _unet_layout(cfg)
    c0, temb, cross = chs[0], chs[0] * 4, cfg["cross_attention_dim"]
    linear_proj = cfg.get("use_linear_projection", False)
    s: Dict[str, tuple] = {}

    def lin(k, o, i, bias=True):
        s[k + ".weight"] = (o, i)
        if bias:
            s[k + ".bias"] = (o,)

    def cv(k, o, i, ks):
        s[k + ".weight"], s[k + ".bias"] = (o, i, ks, ks), (o,)

    def norm(k, c):
        s[k + ".weight"], s[k + ".bias"] = (c,), (c,)

    def resnet(k, ci, co):
        norm(k + ".norm1", ci)
        cv(k + ".conv1", co, ci, 3)
        lin(k + ".time_emb_proj", co, temb)
        norm(k + ".norm2", co)
        cv(k + ".conv2", co, co, 3)
        if ci != co:
            cv(k + ".conv_shortcut", co, ci, 1)

    def transformer(k, c, n):
        norm(k + ".norm", c)
        (lin if linear_proj else lambda kk, o, i: cv(kk, o, i, 1))(k + ".proj_in", c, c)
        (lin if linear_proj else lambda kk, o, i: cv(kk, o, i, 1))(k + ".proj_out", c, c)
        for b in range(n):
            t = f"{k}.transformer_blocks.{b}"
            for j in (1, 2, 3):
                norm(f"{t}.norm{j}", c)
            for a, src in (("attn1", c), ("attn2", cross)):
                lin(f"{t}.{a}.to_q", c, c, False)
                lin(f"{t}.{a}.to_k", c, src, False)
                lin(f"{t}.{a}.to_v", c, src, False)
                lin(f"{t}.{a}.to_out.0", c, c)
            lin(f"{t}.ff.net.0.proj", 8 * c, c)
            lin(f"{t}.ff.net.2", c, 4 * c)

    cv("conv_in", c0, cfg["in_channels"], 3)
    lin("time_embedding.linear_1", temb, c0)
    lin("time_embedding.linear_2", temb, temb)
    if cfg.get("addition_embed_type") == "text_time":
        lin("add_embedding.linear_1", temb, cfg["projection_class_embeddings_input_dim"])
        lin("add_embedding.linear_2", temb, temb)
    skips, ch = [c0], c0
    n_levels = len(chs)
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(cfg["layers_per_block"]):
            resnet(f"down_blocks.{i}.resnets.{j}", ch, chs[i])
            ch = chs[i]
            if kind.startswith("CrossAttn"):
                transformer(f"down_blocks.{i}.attentions.{j}", ch, depth[i])
            skips.append(ch)
        if i < n_levels - 1:
            cv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
            skips.append(ch)
    resnet("mid_block.resnets.0", ch, ch)
    transformer("mid_block.attentions.0", ch, depth[-1])
    resnet("mid_block.resnets.1", ch, ch)
    for i, kind in enumerate(cfg["up_block_types"]):
        lvl = n_levels - 1 - i
        for j in range(cfg["layers_per_block"] + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", ch + skips.pop(), chs[lvl])
            ch = chs[lvl]
            if kind.startswith("CrossAttn"):
                transformer(f"up_blocks.{i}.attentions.{j}", ch, depth[lvl])
        if i < n_levels - 1:
            cv(f"up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    norm("conv_norm_out", c0)
    cv("conv_out", cfg["out_channels"], c0, 3)
    return s


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cos first (flip_sin_to_cos), no frequency shift."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class AttnHooks:
    """What an editing method does inside the UNet's attention: ``cross``
    edits each cross-attention site's probabilities (and may record them),
    ``self_probs`` may replace a self-attention site's probabilities.
    ``site`` counts the transformer blocks in forward order."""

    def cross(self, site: int, tokens: int, probs: torch.Tensor) -> torch.Tensor:
        return probs

    def self_probs(self, site: int, tokens: int, probs: torch.Tensor) -> torch.Tensor:
        return probs


def unet(p: Params, cfg: dict, x: torch.Tensor, t, ctx: torch.Tensor, hooks: Optional[AttnHooks] = None,
         added: Optional[dict] = None, q: Precision = F32) -> torch.Tensor:
    """x (B, 4, h, w) NCHW, t a timestep, ctx (B, 77, D) -> eps (B, 4, h, w)."""
    hooks = hooks or AttnHooks()
    chs, heads_, depth = _unet_layout(cfg)
    b = x.shape[0]
    tt = torch.full((b,), float(t), device=x.device)
    temb = linear(p, "time_embedding.linear_2", F.silu(linear(p, "time_embedding.linear_1",
                                                                timestep_embedding(tt, chs[0]), q)), q)
    if cfg.get("addition_embed_type") == "text_time":
        ids = added["time_ids"].reshape(-1)
        te = timestep_embedding(ids, cfg["addition_time_embed_dim"]).reshape(b, -1)
        h = torch.cat([added["text_embeds"], te], dim=-1)
        temb = temb + linear(p, "add_embedding.linear_2", F.silu(linear(p, "add_embedding.linear_1", h, q)), q)
    site = [0]
    linear_proj = cfg.get("use_linear_projection", False)

    def resnet(k, h):
        r = conv(p, k + ".conv1", F.silu(group_norm(p, k + ".norm1", h, 1e-5)), q, padding=1)
        r = r + linear(p, k + ".time_emb_proj", F.silu(temb), q)[:, :, None, None]
        r = conv(p, k + ".conv2", F.silu(group_norm(p, k + ".norm2", r, 1e-5)), q, padding=1)
        if k + ".conv_shortcut.weight" in p:
            h = conv(p, k + ".conv_shortcut", h, q)
        return h + r

    def attn(k, h, src, n_heads, is_cross):
        qh = heads(linear(p, k + ".to_q", h, q, bias=False), n_heads)
        kh = heads(linear(p, k + ".to_k", src, q, bias=False), n_heads)
        vh = heads(linear(p, k + ".to_v", src, q, bias=False), n_heads)
        s = torch.matmul(q(qh), q(kh).transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        probs = torch.softmax(s, dim=-1)
        tokens = h.shape[1]
        probs = hooks.cross(site[0], tokens, probs) if is_cross else hooks.self_probs(site[0], tokens, probs)
        return linear(p, k + ".to_out.0", unheads(torch.matmul(q(probs), q(vh))), q)

    def transformer(k, h, n_heads, n_blocks):
        bb, c, hh, ww = h.shape
        res = h
        h = group_norm(p, k + ".norm", h, 1e-6)
        if not linear_proj:
            h = conv(p, k + ".proj_in", h, q)
        h = h.permute(0, 2, 3, 1).reshape(bb, hh * ww, c)
        if linear_proj:
            h = linear(p, k + ".proj_in", h, q)
        for j in range(n_blocks):
            tb = f"{k}.transformer_blocks.{j}"
            n1 = layer_norm(p, tb + ".norm1", h)
            h = h + attn(tb + ".attn1", n1, n1, n_heads, False)
            h = h + attn(tb + ".attn2", layer_norm(p, tb + ".norm2", h), ctx, n_heads, True)
            g, gate = linear(p, tb + ".ff.net.0.proj", layer_norm(p, tb + ".norm3", h), q).chunk(2, dim=-1)
            h = h + linear(p, tb + ".ff.net.2", g * F.gelu(gate, approximate="tanh"), q)
            site[0] += 1
        if linear_proj:
            h = linear(p, k + ".proj_out", h, q)
        h = h.reshape(bb, hh, ww, c).permute(0, 3, 1, 2)
        if not linear_proj:
            h = conv(p, k + ".proj_out", h, q)
        return h + res

    h = conv(p, "conv_in", x, q, padding=1)
    skips = [h]
    n_levels = len(chs)
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(cfg["layers_per_block"]):
            h = resnet(f"down_blocks.{i}.resnets.{j}", h)
            if kind.startswith("CrossAttn"):
                h = transformer(f"down_blocks.{i}.attentions.{j}", h, heads_[i], depth[i])
            skips.append(h)
        if i < n_levels - 1:
            h = conv(p, f"down_blocks.{i}.downsamplers.0.conv", h, q, stride=2, padding=1)
            skips.append(h)
    h = resnet("mid_block.resnets.0", h)
    h = transformer("mid_block.attentions.0", h, heads_[-1], depth[-1])
    h = resnet("mid_block.resnets.1", h)
    for i, kind in enumerate(cfg["up_block_types"]):
        lvl = n_levels - 1 - i
        for j in range(cfg["layers_per_block"] + 1):
            h = resnet(f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], dim=1))
            if kind.startswith("CrossAttn"):
                h = transformer(f"up_blocks.{i}.attentions.{j}", h, heads_[lvl], depth[lvl])
        if i < n_levels - 1:
            h = conv(p, f"up_blocks.{i}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0, mode="nearest"),
                     q, padding=1)
    return conv(p, "conv_out", F.silu(group_norm(p, "conv_norm_out", h, 1e-5)), q, padding=1)


def self_attention_sites(cfg: dict, latent_side: int):
    """(tokens, heads, head dim) of every self-attention site of one UNet
    forward, in forward order."""
    chs, heads_, depth = _unet_layout(cfg)
    out = []
    n_levels = len(chs)
    side = latent_side
    for i, kind in enumerate(cfg["down_block_types"]):
        if kind.startswith("CrossAttn"):
            out += [(side * side, heads_[i], chs[i] // heads_[i])] * (depth[i] * cfg["layers_per_block"])
        if i < n_levels - 1:
            side //= 2
    out += [(side * side, heads_[-1], chs[-1] // heads_[-1])] * depth[-1]
    for i, kind in enumerate(cfg["up_block_types"]):
        lvl = n_levels - 1 - i
        if kind.startswith("CrossAttn"):
            out += [(side * side, heads_[lvl], chs[lvl] // heads_[lvl])] * (depth[lvl] * (cfg["layers_per_block"] + 1))
        if i < n_levels - 1:
            side *= 2
    return out


# ---------------------------------------------------------------------- VAE


def vae_shapes(cfg: dict) -> Dict[str, tuple]:
    chs, n, lat = cfg["block_out_channels"], cfg["layers_per_block"], cfg["latent_channels"]
    s: Dict[str, tuple] = {}

    def cv(k, o, i, ks):
        s[k + ".weight"], s[k + ".bias"] = (o, i, ks, ks), (o,)

    def norm(k, c):
        s[k + ".weight"], s[k + ".bias"] = (c,), (c,)

    def resnet(k, ci, co):
        norm(k + ".norm1", ci)
        cv(k + ".conv1", co, ci, 3)
        norm(k + ".norm2", co)
        cv(k + ".conv2", co, co, 3)
        if ci != co:
            cv(k + ".conv_shortcut", co, ci, 1)

    def mid(k, c):
        resnet(k + ".resnets.0", c, c)
        resnet(k + ".resnets.1", c, c)
        norm(k + ".attentions.0.group_norm", c)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            s[f"{k}.attentions.0.{proj}.weight"], s[f"{k}.attentions.0.{proj}.bias"] = (c, c), (c,)

    cv("encoder.conv_in", chs[0], cfg["in_channels"], 3)
    ch = chs[0]
    for i, co in enumerate(chs):
        for j in range(n):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch, co)
            ch = co
        if i < len(chs) - 1:
            cv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
    mid("encoder.mid_block", ch)
    norm("encoder.conv_norm_out", ch)
    cv("encoder.conv_out", 2 * lat, ch, 3)
    rev = list(reversed(chs))
    cv("decoder.conv_in", rev[0], lat, 3)
    mid("decoder.mid_block", rev[0])
    ch = rev[0]
    for i, co in enumerate(rev):
        for j in range(n + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch, co)
            ch = co
        if i < len(rev) - 1:
            cv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    norm("decoder.conv_norm_out", ch)
    cv("decoder.conv_out", cfg["out_channels"], ch, 3)
    cv("quant_conv", 2 * lat, 2 * lat, 1)
    cv("post_quant_conv", lat, lat, 1)
    return s


def _vae_resnet(p, k, h, q):
    r = conv(p, k + ".conv1", F.silu(group_norm(p, k + ".norm1", h, 1e-6)), q, padding=1)
    r = conv(p, k + ".conv2", F.silu(group_norm(p, k + ".norm2", r, 1e-6)), q, padding=1)
    if k + ".conv_shortcut.weight" in p:
        h = conv(p, k + ".conv_shortcut", h, q)
    return h + r


def _vae_mid(p, k, h, q):
    h = _vae_resnet(p, k + ".resnets.0", h, q)
    b, c, hh, ww = h.shape
    a = k + ".attentions.0"
    x = group_norm(p, a + ".group_norm", h, 1e-6).permute(0, 2, 3, 1).reshape(b, 1, hh * ww, c)
    o, _ = attention(linear(p, a + ".to_q", x, q), linear(p, a + ".to_k", x, q), linear(p, a + ".to_v", x, q), q)
    h = h + linear(p, a + ".to_out.0", o[:, 0], q).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return _vae_resnet(p, k + ".resnets.1", h, q)


def vae_encode(p: Params, cfg: dict, img: torch.Tensor, q: Precision = F32) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> scaled latent mean (B, 4, H/8, W/8)."""
    chs, n = cfg["block_out_channels"], cfg["layers_per_block"]
    h = conv(p, "encoder.conv_in", img, q, padding=1)
    for i in range(len(chs)):
        for j in range(n):
            h = _vae_resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", h, q)
        if i < len(chs) - 1:
            h = conv(p, f"encoder.down_blocks.{i}.downsamplers.0.conv", F.pad(h, (0, 1, 0, 1)), q, stride=2)
    h = _vae_mid(p, "encoder.mid_block", h, q)
    h = conv(p, "encoder.conv_out", F.silu(group_norm(p, "encoder.conv_norm_out", h, 1e-6)), q, padding=1)
    moments = conv(p, "quant_conv", h, q)
    return moments[:, : cfg["latent_channels"]] * cfg["scaling_factor"]


def vae_decode(p: Params, cfg: dict, z: torch.Tensor, q: Precision = F32) -> torch.Tensor:
    """Scaled latents (B, 4, h, w) -> images (B, 3, 8h, 8w) in [-1, 1]."""
    chs, n = cfg["block_out_channels"], cfg["layers_per_block"]
    h = conv(p, "post_quant_conv", z / cfg["scaling_factor"], q)
    h = _vae_mid(p, "decoder.mid_block", conv(p, "decoder.conv_in", h, q, padding=1), q)
    for i in range(len(chs)):
        for j in range(n + 1):
            h = _vae_resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", h, q)
        if i < len(chs) - 1:
            h = conv(p, f"decoder.up_blocks.{i}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0, mode="nearest"),
                     q, padding=1)
    return conv(p, "decoder.conv_out", F.silu(group_norm(p, "decoder.conv_norm_out", h, 1e-6)), q, padding=1)


def vae_decode_tiled(decode: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor, tile: int,
                     overlap: int = 16, scale: int = 8) -> torch.Tensor:
    """Decode (B, 4, h, w) in overlapping latent tiles of side ``tile``,
    blending the overlaps with linear ramps; one call when the latent fits a
    tile. The tiling recipe of diffusers' ``enable_vae_tiling``, as the
    framework's sweep decodes SDXL at 1024²."""
    b, _, h, w = z.shape
    if h <= tile and w <= tile:
        return decode(z)
    overlap = min(overlap, tile // 2)
    stride = tile - overlap
    rows, cols = max(1, -(-(h - overlap) // stride)), max(1, -(-(w - overlap) // stride))
    out_tile, out_ov = tile * scale, overlap * scale
    ramp = torch.arange(1, out_ov + 1, dtype=torch.float32, device=z.device) / (out_ov + 1)

    def edge(t0, full):
        wgt = torch.ones(out_tile, dtype=torch.float32, device=z.device)
        if t0 > 0:
            wgt[:out_ov] = ramp
        if t0 + out_tile < full:
            wgt[-out_ov:] = ramp.flip(0)
        return wgt

    canvas = torch.zeros((b, 3, h * scale, w * scale), dtype=torch.float32, device=z.device)
    weight = torch.zeros((1, 1, h * scale, w * scale), dtype=torch.float32, device=z.device)
    for r in range(rows):
        y = min(r * stride, h - tile)
        for c in range(cols):
            x = min(c * stride, w - tile)
            img = decode(z[:, :, y:y + tile, x:x + tile])
            ty, tx = y * scale, x * scale
            wt = (edge(ty, h * scale)[:, None] * edge(tx, w * scale)[None, :])[None, None]
            canvas[:, :, ty:ty + out_tile, tx:tx + out_tile] += img * wt
            weight[:, :, ty:ty + out_tile, tx:tx + out_tile] += wt
    return canvas / weight.clamp(min=1e-6)
