"""The GroupNorm of the UNet and the VAE (``ops/group_norm.py``) and their
channels-last layout (``models/layout.py``) on the CPU.

The plain version against ``F.group_norm`` (+ ``F.silu``) and an f64
computation at every channels-per-group count the configurations use, on
channels-last input; the autograd Function with the kernels' plain backward
under ``gradcheck``; the tiny UNets and the tiny VAE giving the same output
with their activations kept channels-last as on the card (weights included),
every convolution and GroupNorm then reading a channels-last input. The
kernel itself runs only on a card: tests/test_torch_group_norm_card.py.
"""

import pytest
import torch
import torch.nn.functional as F

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from image_editing_framework_torch.core.config import PnPConfig
from image_editing_framework_torch.models import layout
from image_editing_framework_torch.models.loader import export_params, load_params
from image_editing_framework_torch.models.unet import UNet2DCondition
from image_editing_framework_torch.ops import group_norm as gn
from image_editing_framework_torch.ops.controls import build_pnp_control
from image_editing_framework_torch.pipelines import tiny_pipeline

CL = torch.channels_last


def operands(n, c, hw, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, *hw, generator=gen) * 2 + torch.randn(1, c, 1, 1, generator=gen) * 3
    weight = 1 + 0.3 * torch.randn(c, generator=gen)
    bias = 0.5 * torch.randn(c, generator=gen)
    return x.to(dtype), weight.to(dtype), bias.to(dtype)


def exact(x, weight, bias, groups, eps, silu):
    """GroupNorm (+ SiLU) in f64 from the definition."""
    n, c = x.shape[:2]
    xg = x.double().reshape(n, groups, -1)
    xh = ((xg - xg.mean(-1, keepdim=True)) / torch.sqrt(xg.var(-1, unbiased=False, keepdim=True) + eps))
    z = xh.reshape(x.shape) * weight.double()[:, None, None] + bias.double()[:, None, None]
    return z * torch.sigmoid(z) if silu else z


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_group", [4, 10, 16, 20, 40])  # the VAE's 4 and 16, the UNets' 10, 20, 40
def test_plain_version_matches_group_norm_on_channels_last_input(per_group, dtype, silu):
    """``group_norm_nhwc`` on a channels-last CPU tensor: F.group_norm (+
    F.silu), bit for bit; it and the contiguous tensor's within the dtype's
    rounding of the f64 definition; the kernels' plain forward
    (``_forward``) the same; the ``GroupNorm`` module nn.GroupNorm (+
    F.silu) bit for bit, with its keys."""
    groups, eps = 32, 1e-5
    x, weight, bias = operands(2, 32 * per_group, (3, 5), dtype)
    got = gn.group_norm_nhwc(x.contiguous(memory_format=CL), weight, bias, groups, eps, silu)
    want = F.group_norm(x.contiguous(memory_format=CL), groups, weight, bias, eps)
    want = F.silu(want) if silu else want
    assert got.dtype == dtype and torch.equal(got, want)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    ref = exact(x, weight, bias, groups, eps, silu)
    assert (got.double() - ref).abs().max().item() <= tol * ref.abs().max().item()
    on_nchw = gn.group_norm_nhwc(x, weight, bias, groups, eps, silu)
    assert (on_nchw.double() - ref).abs().max().item() <= tol * ref.abs().max().item()
    y, mean, rstd = gn._forward(x.contiguous(memory_format=CL), weight, bias, groups, eps, silu)
    assert (y.double() - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert mean.shape == rstd.shape == (2, groups)
    module = gn.GroupNorm(groups, x.shape[1], eps=eps).to(dtype)
    plain = torch.nn.GroupNorm(groups, x.shape[1], eps=eps).to(dtype)
    with torch.no_grad():
        for m in (module, plain):
            m.weight.copy_(weight)
            m.bias.copy_(bias)
    assert list(module.state_dict()) == list(plain.state_dict())
    assert torch.equal(module(x, silu=silu), F.silu(plain(x)) if silu else plain(x))


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("needs", ["all", "x", "params"])
def test_function_gradients_pass_gradcheck(silu, needs):
    """The autograd Function (on the CPU: the kernels' plain stats, apply and
    backward formulas) against finite differences in f64, for dx, dweight and
    dbias; an input that does not require grad gets None."""
    x, weight, bias = operands(2, 8, (3, 4), torch.float64, seed=1)
    x = x.contiguous(memory_format=CL)
    flags = {"all": (True, True, True), "x": (True, False, False), "params": (False, True, True)}[needs]
    args = tuple(t.requires_grad_(f) for t, f in zip((x, weight, bias), flags))

    def fn(*a):
        return gn.GroupNormNHWC.apply(*a, 4, 1e-5, silu)

    assert torch.autograd.gradcheck(fn, args)
    grads = torch.autograd.grad(fn(*args).sum(), [t for t in args if t.requires_grad])
    assert len(grads) == sum(flags)
    dy = torch.randn_like(x)
    mean, rstd = gn.group_norm_stats_reference(x, 4, 1e-5)
    dx, dw, db = gn.group_norm_bwd_reference(x, dy, weight, bias, mean, rstd, 4, silu, params=False)
    assert dw is None and db is None and dx.shape == x.shape


def channels_last_everywhere(monkeypatch):
    """Keep activations and conv weights channels-last on the CPU too, as
    ``models/layout.py`` keeps them on the card."""
    monkeypatch.setattr(layout, "channels_last", lambda t: True)


def strided_inputs(nets):
    """Forward pre-hooks on every convolution and GroupNorm of ``nets`` that
    note an input that is not channels-last; returns (notes, handles)."""
    notes = []

    def pre(m, args):
        if args[0].dim() == 4 and not args[0].is_contiguous(memory_format=CL):
            notes.append((type(m).__name__, tuple(args[0].shape), args[0].stride()))

    return notes, [m.register_forward_pre_hook(pre) for net in nets for m in net.modules()
                   if isinstance(m, (torch.nn.Conv2d, gn.GroupNorm))]


@pytest.mark.parametrize("model_type", ["sd", "xl", "xl-refiner"])
def test_tiny_unet_and_vae_give_the_same_output_channels_last(monkeypatch, model_type):
    """A tiny UNet (under a PnP control whose hook replaces ResNet features)
    and the tiny VAE on the CPU: with activations and conv weights
    channels-last, as on the card, every convolution and GroupNorm reads a
    channels-last input (the skips' cat, the upsampler's interpolate, the
    encoder's pad, the adds and the hook keep it) and the outputs equal the
    contiguous path's to f32 rounding, as contiguous NHWC tensors."""
    pipe = tiny_pipeline(num_steps=4, model_type=model_type, device="cpu")
    unet, vae, cfg = pipe.unet, pipe.vae, pipe.unet.config
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn(4, 16, 16, cfg.in_channels, generator=gen)
    ctx = torch.randn(4, 77, cfg.cross_attention_dim, generator=gen)
    added = None
    if cfg.addition_time_embed_dim is not None:
        ids = 5 if model_type == "xl-refiner" else 6
        added = {"text_embeds": torch.randn(4, cfg.projection_class_embeddings_input_dim
                                            - ids * cfg.addition_time_embed_dim, generator=gen),
                 "time_ids": torch.randn(4, ids, generator=gen)}
    img = torch.rand(2, 32, 32, 3, generator=gen) * 2 - 1
    z = torch.randn(2, 16, 16, 4, generator=gen)
    pnp = build_pnp_control(4, PnPConfig(), (), ("down0_res0", "up1_res0", "up1_res1"), device="cpu").at_step(0)

    def run():
        with torch.no_grad():
            eps = unet(lat, 10, ctx, pnp, added)[0]
            return eps, vae.encode(img), vae.decode(z)

    contiguous = run()
    assert all(m.weight.is_contiguous() for m in unet.modules() if isinstance(m, torch.nn.Conv2d))
    channels_last_everywhere(monkeypatch)
    layout.channels_last_convs_(unet)
    layout.channels_last_convs_(vae)
    assert all(m.weight.is_contiguous(memory_format=CL) for net in (unet, vae) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d))
    notes, handles = strided_inputs((unet, vae))
    try:
        kept = run()
    finally:
        for h in handles:
            h.remove()
    assert not notes, notes[:8]
    for a, b in zip(contiguous, kept):
        assert b.is_contiguous()  # NHWC memory throughout: the last permute is free
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4 * a.abs().max().item())


def test_layout_follows_the_device_and_the_network(monkeypatch):
    """On the CPU ``to_nchw`` gives contiguous NCHW and ``load_params`` leaves
    conv weights NCHW (the CPU path the JAX parity tests hold); where the
    layout is channels-last, ``to_nchw`` is a view of a contiguous NHWC
    tensor and ``load_params`` makes the UNet's conv weights channels-last,
    not those of a network outside ``ChannelsLastNet``."""
    x = torch.randn(2, 4, 6, 8)
    assert layout.to_nchw(x).is_contiguous() and layout.to_nchw(x).shape == (2, 8, 4, 6)
    pipe = tiny_pipeline(num_steps=4, device="cpu")
    state = export_params(pipe.unet)
    with torch.device("meta"):
        fresh = UNet2DCondition(pipe.unet.config)
    loaded = load_params(fresh, state)
    assert all(m.weight.is_contiguous() for m in loaded.modules() if isinstance(m, torch.nn.Conv2d))
    channels_last_everywhere(monkeypatch)
    y = layout.to_nchw(x)
    assert y.data_ptr() == x.data_ptr() and y.is_contiguous(memory_format=CL)
    with torch.device("meta"):
        fresh = UNet2DCondition(pipe.unet.config)
    loaded = load_params(fresh, state)
    convs = [m for m in loaded.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m.weight.is_contiguous(memory_format=CL) for m in convs)
    for key, value in loaded.state_dict().items():
        assert torch.equal(value, state[key])
    plain = torch.nn.Sequential(torch.nn.Conv2d(4, 8, 3))
    assert layout.channels_last_convs_(plain)[0].weight.is_contiguous()
