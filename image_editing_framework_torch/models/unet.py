"""Config-driven UNet2DCondition for the SD family (SD1.x/2.1, SDXL, refiner).

Counterpart of ``image_editing_framework_tpu/models/unet.py``. Every
BasicTransformerBlock carries a static forward-order index (``layer``); the
editing control is an argument of ``forward``: self-attention runs through
the flash kernel with the control's batch-remap plan, cross-attention exposes
editable f32 probabilities, and ResNet blocks expose the PnP feature hook
keyed like ``up1_res1``.

Module and parameter names follow diffusers, so ``state_dict()`` keys are
diffusers keys. Inside, activations have the NCHW shape: channels-last
memory on a CUDA device, contiguous on the CPU (``models/layout.py``), and
every GroupNorm, with the SiLU that follows it, is ``ops/group_norm.py``'s;
the public ``forward`` takes and returns the JAX package's NHWC latents.

SDXL's ``added_cond`` (``text_embeds`` and ``time_ids``) feeds the
``add_embedding`` MLP, whose output joins the time embedding. ``remat=True``
checkpoints every BasicTransformerBlock (``torch.utils.checkpoint``), the
counterpart of the JAX ``nn.remat`` twin: the same values and gradients,
with the blocks' activations recomputed during the backward pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from image_editing_framework_torch.models.embeddings import TimestepEmbedding, sinusoidal_timestep_embedding
from image_editing_framework_torch.models.layout import ChannelsLastNet, to_nchw
from image_editing_framework_torch.ops.attention import (
    AttnSite,
    apply_probs,
    cross_attention_probs,
    merge_heads,
    self_attention,
    split_heads,
)
from image_editing_framework_torch.ops.controls import NoneStep
from image_editing_framework_torch.ops.group_norm import GroupNorm
from image_editing_framework_torch.parallel.sharding import (
    copy_to_tensor_parallel,
    gather_heads,
    refuse_ulysses_ring,
    row_parallel_linear,
    tensor_parallel_size,
)
from image_editing_framework_torch.utils.profiling import phase

Records = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    # Attention heads per level (diffusers' ``attention_head_dim``): 8 for SD1.x.
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    # BasicTransformerBlocks per Transformer2D, per level.
    transformer_layers: Tuple[int, ...] = (1, 1, 1, 1)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    # SDXL "text_time" addition embeddings.
    addition_time_embed_dim: Optional[int] = None  # 256 for XL
    projection_class_embeddings_input_dim: Optional[int] = None  # 2816 base / 2560 refiner

    @property
    def num_transformer_blocks(self) -> int:
        """Total BasicTransformerBlocks in forward order (16 for SD, 70 for
        SDXL): the self-attention sites of one forward."""
        down, mid, up = self.forward_layout()
        return sum(len(tb) for blk in down + up for tb in blk) + len(mid)

    def forward_layout(self):
        """Assign forward-order transformer-block indices.

        Returns (down, mid, up) where down/up are lists per block of lists per
        Transformer2D of block-index lists, and mid is one index list.
        """
        idx = 0
        down = []
        for lvl, t in enumerate(self.down_block_types):
            blk = []
            if t == "CrossAttnDownBlock2D":
                for _ in range(self.layers_per_block):
                    tb = list(range(idx, idx + self.transformer_layers[lvl]))
                    idx += len(tb)
                    blk.append(tb)
            down.append(blk)
        mid = list(range(idx, idx + self.transformer_layers[-1]))
        idx += len(mid)
        up = []
        for i, t in enumerate(self.up_block_types):
            lvl = len(self.block_out_channels) - 1 - i
            blk = []
            if t == "CrossAttnUpBlock2D":
                for _ in range(self.layers_per_block + 1):
                    tb = list(range(idx, idx + self.transformer_layers[lvl]))
                    idx += len(tb)
                    blk.append(tb)
            up.append(blk)
        return down, mid, up


class Attention(nn.Module):
    """One attention layer (attn1 self / attn2 cross) with editing hooks.

    Under tensor parallelism (``tp_group``, set by
    ``parallel/sharding.py shard_params``) it runs its H/n local heads: the
    projections to_q / to_k / to_v are column-parallel, to_out.0
    row-parallel, and a recorded cross-attention map is gathered over every
    head before the control sees it."""

    def __init__(self, query_dim: int, heads: int, cross_dim: Optional[int], layer: int, place: str):
        super().__init__()
        self.heads, self.cross_dim, self.layer, self.place = heads, cross_dim, layer, place
        # context parallelism, set by UNet2DCondition.set_context_parallel
        self.cp_mesh, self.cp_min_seq, self.cp_mode = None, 4096, "ring"
        self.tp_group = None
        src_dim = cross_dim if cross_dim is not None else query_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(src_dim, query_dim, bias=False)
        self.to_v = nn.Linear(src_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x, context, ctrl, running=None):
        is_cross = self.cross_dim is not None
        site = AttnSite(layer=self.layer, place=self.place, seq_len=x.shape[1], is_cross=is_cross)
        tp = self.tp_group
        x = copy_to_tensor_parallel(x, tp)
        src = copy_to_tensor_parallel(context, tp) if is_cross else x
        heads = self.heads // tensor_parallel_size(tp)
        q, k, v = (split_heads(f(t), heads) for f, t in ((self.to_q, x), (self.to_k, src), (self.to_v, src)))
        records: Records = {}
        if is_cross:
            # P2P's edits act head by head, on this rank's heads
            probs = ctrl.edit_cross(site, cross_attention_probs(q, k))
            rkey = ctrl.record_key(site)
            if rkey is not None:
                records[rkey] = ctrl.record(site, gather_heads(probs, tp))
            out = apply_probs(probs, v)
        else:
            # A self-attention site of at least cp_min_seq tokens runs
            # context-parallel, the masked overrides' calls too. Cross-
            # attention never does: its probabilities are P2P's.
            cp = dict(cp_mesh=self.cp_mesh if x.shape[1] >= self.cp_min_seq else None, cp_mode=self.cp_mode)
            out = ctrl.self_override(site, q, k, v, running, **cp)
            if out is None:
                out = self_attention(q, k, v, ctrl.self_plan(site, x.shape[0], x.device), **cp)
        out = merge_heads(out).to(x.dtype)
        return row_parallel_linear(self.to_out[0], out, tp), records


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # flax's nn.gelu defaults to the tanh approximation
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward (dim -> 4*dim gated -> dim); diffusers' ``net`` keys.
    Under tensor parallelism the GEGLU projection is column-parallel (each
    rank holds hidden and gate columns of the same indices) and net.2
    row-parallel."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])
        self.tp_group = None

    def forward(self, x):
        tp = self.tp_group
        return row_parallel_linear(self.net[2], self.net[0](copy_to_tensor_parallel(x, tp)), tp)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_dim: int, layer: int, place: str):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, None, layer, place)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, cross_dim, layer, place)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, ctrl, running=None):
        records: Records = {}
        h, rec = self.attn1(self.norm1(x), None, ctrl, running)
        records.update(rec)
        x = x + h
        h, rec = self.attn2(self.norm2(x), context, ctrl)
        records.update(rec)
        x = x + h
        x = x + self.ff(self.norm3(x))
        return x, records


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks -> proj_out + residual.
    A channels-last activation enters the blocks as (B, HW, C) and leaves
    them through views, so the residual add meets its own layout."""

    def __init__(self, channels: int, heads: int, cross_dim: int, layers: Tuple[int, ...], place: str,
                 use_linear_projection: bool = False):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(32, channels, eps=1e-6)
        proj = (lambda: nn.Linear(channels, channels)) if use_linear_projection else (
            lambda: nn.Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, cross_dim, layer, place) for layer in layers]
        )
        self.proj_out = proj()

    def forward(self, x, context, ctrl, running=None, remat=False):
        b, c, hh, ww = x.shape
        residual = x
        h = self.norm(x)
        if not self.use_linear_projection:
            h = self.proj_in(h)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        if self.use_linear_projection:
            h = self.proj_in(h)
        records: Records = {}
        # ``running`` is the UNet-wide records dict, threaded down so later
        # sites see earlier sites' recorded maps within the same forward;
        # it is updated here, outside the (possibly checkpointed) block.
        if running is None:
            running = {}
        for block in self.transformer_blocks:
            if remat:
                h, rec = checkpoint(block, h, context, ctrl, dict(running), use_reentrant=False)
            else:
                h, rec = block(h, context, ctrl, dict(running))
            records.update(rec)
            running.update(rec)
        if self.use_linear_projection:
            h = self.proj_out(h)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        if not self.use_linear_projection:
            h = self.proj_out(h)
        return h + residual, records


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, key: str):
        super().__init__()
        self.key = key  # PnP injection site key, e.g. "up1_res1"
        self.norm1 = GroupNorm(32, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm(32, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb, ctrl):
        h = self.conv1(self.norm1(x, silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        # PnP spatial feature injection after conv2 (pnp/model/register.py:163-168).
        h = ctrl.resnet_hook(self.key, h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A diffusers down/up/mid block: a container of resnets, attentions and
    resamplers, named as diffusers names them."""

    def __init__(self, resnets, attentions=(), resamplers=(), resampler_name=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if resampler_name is not None:
            setattr(self, resampler_name, nn.ModuleList(resamplers))


class UNet2DCondition(ChannelsLastNet):
    """``cp_mesh`` (a ``DeviceMesh``): context parallelism, as the JAX
    ``UNet2DCondition``'s: every self-attention site of at least
    ``cp_min_seq`` tokens splits its sequence over the mesh's 'data' axis,
    ``cp_mode`` 'ring' (K/V rotation), 'ulysses' (all-to-all head <->
    sequence) or 'ulysses_ring' (2D, over 'tensor' x 'data'). The
    activations stay replicated on every rank: at a CP site each rank takes
    its chunk of q, k, v and the bias, and the output is all-gathered
    (``parallel/ring_attention.py context_parallel_attention``). Every rank
    runs the same forward with the same weights, or, under tensor
    parallelism (``parallel/sharding.py shard_params``), its slice of the
    attention and feed-forward weights."""

    def __init__(self, config: UNetConfig, cp_mesh=None, cp_min_seq: int = 4096, cp_mode: str = "ring"):
        super().__init__()
        cfg = self.config = config
        block0 = cfg.block_out_channels[0]
        temb_dim = block0 * 4
        down_layout, mid_layout, up_layout = cfg.forward_layout()
        self.conv_in = nn.Conv2d(cfg.in_channels, block0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(block0, temb_dim)
        if cfg.addition_time_embed_dim is not None:
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb_dim)

        skip_channels = [block0]
        self.down_blocks = nn.ModuleList()
        ch = block0
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(ch, out_ch, temb_dim, key=f"down{i}_res{j}"))
                ch = out_ch
                if btype == "CrossAttnDownBlock2D":
                    attns.append(Transformer2D(out_ch, cfg.num_heads[i], cfg.cross_attention_dim,
                                               tuple(down_layout[i][j]), "down", cfg.use_linear_projection))
                skip_channels.append(out_ch)
            last = i == len(cfg.down_block_types) - 1
            self.down_blocks.append(
                _Block(resnets, attns, [] if last else [Downsample(out_ch)], None if last else "downsamplers")
            )
            if not last:
                skip_channels.append(out_ch)

        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = _Block(
            [ResnetBlock(mid_ch, mid_ch, temb_dim, "mid_res0"), ResnetBlock(mid_ch, mid_ch, temb_dim, "mid_res1")],
            [Transformer2D(mid_ch, cfg.num_heads[-1], cfg.cross_attention_dim, tuple(mid_layout), "mid",
                           cfg.use_linear_projection)],
        )

        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, btype in enumerate(cfg.up_block_types):
            out_ch = rev[i]
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(ch + skip_channels.pop(), out_ch, temb_dim, key=f"up{i}_res{j}"))
                ch = out_ch
                if btype == "CrossAttnUpBlock2D":
                    attns.append(Transformer2D(out_ch, cfg.num_heads[len(rev) - 1 - i], cfg.cross_attention_dim,
                                               tuple(up_layout[i][j]), "up", cfg.use_linear_projection))
            last = i == len(cfg.up_block_types) - 1
            self.up_blocks.append(
                _Block(resnets, attns, [] if last else [Upsample(out_ch)], None if last else "upsamplers")
            )

        self.conv_norm_out = GroupNorm(32, block0, eps=1e-5)
        self.conv_out = nn.Conv2d(block0, cfg.out_channels, 3, padding=1)
        self.tp_mesh = None  # tensor parallelism's mesh, set by parallel/sharding.py shard_params
        self.set_context_parallel(cp_mesh, cp_min_seq, cp_mode)

    @property
    def lockstep_mesh(self):
        """The mesh whose ranks must take the same host-side branches (NTI's
        early stop): context parallelism's, else tensor parallelism's."""
        return self.cp_mesh if self.cp_mesh is not None else self.tp_mesh

    def set_context_parallel(self, cp_mesh=None, cp_min_seq: int = 4096, cp_mode: str = "ring"):
        """Switch context parallelism on (a mesh) or off (None) for every
        attention layer; a loaded pipeline's UNet takes it this way. Under
        tensor parallelism 'ulysses_ring' raises: it takes the 'tensor' axis
        for heads."""
        if self.tp_mesh is not None:
            refuse_ulysses_ring(cp_mesh, cp_mode)
        self.cp_mesh, self.cp_min_seq, self.cp_mode = cp_mesh, cp_min_seq, cp_mode
        for module in self.modules():
            if isinstance(module, Attention):
                module.cp_mesh, module.cp_min_seq, module.cp_mode = cp_mesh, cp_min_seq, cp_mode
        return self

    def forward(self, sample: torch.Tensor, timestep, context: torch.Tensor, ctrl=None,
                added_cond: Optional[Dict[str, torch.Tensor]] = None, remat: bool = False):
        """sample: (B, h, w, C) NHWC latents; timestep: int or (B,);
        context: (B, 77, cross_dim); added_cond (SDXL): ``text_embeds``
        (B, pooled dim) and ``time_ids`` (B, 6 or 5). ``remat`` checkpoints
        the transformer blocks. Returns (eps NHWC, records)."""
        with phase("unet"):  # the host's issue of one forward
            cfg = self.config
            if ctrl is None:
                ctrl = NoneStep()
            dtype = self.conv_in.weight.dtype
            b = sample.shape[0]
            if isinstance(timestep, torch.Tensor):
                t = timestep.to(sample.device).expand(b)
            else:
                # a fill on the device: no host-to-device copy that the host waits for
                t = torch.full((b,), timestep, device=sample.device)
            temb = self.time_embedding(sinusoidal_timestep_embedding(t, cfg.block_out_channels[0], dtype=dtype))
            if cfg.addition_time_embed_dim is not None:
                if added_cond is None:
                    raise ValueError("an SDXL UNet needs added_cond (text_embeds, time_ids)")
                ids = added_cond["time_ids"].to(sample.device).reshape(-1)
                te = sinusoidal_timestep_embedding(ids, cfg.addition_time_embed_dim, dtype=dtype).reshape(b, -1)
                temb = temb + self.add_embedding(torch.cat([added_cond["text_embeds"].to(dtype), te], dim=-1))
            context = context.to(dtype)

            records: Records = {}
            x = self.conv_in(to_nchw(sample.to(dtype)))
            skips = [x]
            for blk in self.down_blocks:
                for j, resnet in enumerate(blk.resnets):
                    x = resnet(x, temb, ctrl)
                    if len(blk.attentions):
                        x, rec = blk.attentions[j](x, context, ctrl, records, remat)
                        records.update(rec)
                    skips.append(x)
                if hasattr(blk, "downsamplers"):
                    x = blk.downsamplers[0](x)
                    skips.append(x)

            x = self.mid_block.resnets[0](x, temb, ctrl)
            x, rec = self.mid_block.attentions[0](x, context, ctrl, records, remat)
            records.update(rec)
            x = self.mid_block.resnets[1](x, temb, ctrl)

            for blk in self.up_blocks:
                for j, resnet in enumerate(blk.resnets):
                    x = resnet(torch.cat([x, skips.pop()], dim=1), temb, ctrl)
                    if len(blk.attentions):
                        x, rec = blk.attentions[j](x, context, ctrl, records, remat)
                        records.update(rec)
                if hasattr(blk, "upsamplers"):
                    x = blk.upsamplers[0](x)

            x = self.conv_out(self.conv_norm_out(x, silu=True))
            return x.permute(0, 2, 3, 1), records
