"""The NHWC GroupNorm kernel (``csrc/group_norm_nhwc.cu``) against its plain
version on the card, its refusals, and the UNet's and VAE's channels-last
forward: no layout conversion, every GroupNorm through the kernel.

Imports only torch and the port, so it runs on the GPU machine, which has
no JAX (``--noconftest`` skips the JAX-pinning conftest there):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_group_norm_card.py

Without a card every test skips (the CPU suite holds the plain versions in
test_torch_group_norm.py). Limits, against the plain version in f32 on the
same inputs: bf16 2^-7 · max|ref| (one or two bf16 ulps of the largest
value: the kernel rounds once, from f32), f32 2e-5 · max|ref|.
"""

import pytest
import torch

from image_editing_framework_torch.inversion import graphs
from image_editing_framework_torch.models import layout
from image_editing_framework_torch.ops import group_norm as gn
from image_editing_framework_torch.utils import profiling

# (N, C, H, W, groups): the cells' GroupNorm shapes (SD1.5 at CFG batch 16 and
# 64² latents, SD2.1's 96² and 48² levels, SDXL at CFG batch 8 and 128²
# latents, the VAE at 512²) and edges (one pixel, an odd side, the tiny
# configurations' 1 and 3 channels a group). A group of one value is left
# out: its output is beta and its dx 0 exactly, which a limit relative to
# max|ref| cannot judge (any rounding of the cancelling terms exceeds 0).
SHAPES = [(16, 320, 64, 64, 32), (16, 640, 32, 32, 32), (16, 1280, 16, 16, 32), (16, 2560, 8, 8, 32),
          (16, 1920, 16, 16, 32), (16, 960, 32, 32, 32), (4, 320, 96, 96, 32), (16, 640, 48, 48, 32),
          (8, 320, 128, 128, 32), (8, 1280, 32, 32, 32), (8, 2560, 32, 32, 32), (2, 128, 512, 512, 32),
          (2, 512, 64, 64, 32), (1, 96, 7, 9, 32), (3, 16, 5, 5, 16), (2, 32, 1, 1, 8)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GroupNorm kernel runs only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def limit(ref: torch.Tensor, dtype: torch.dtype) -> float:
    return (2.0 ** -7 if dtype == torch.bfloat16 else 2e-5) * ref.abs().max().item()


def operands(n, c, h, w, dtype, seed=0):
    """x (channels-last, off-centre groups so the statistics' shift
    matters), weight, bias and dy on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen, device="cuda") * 2 + torch.randn(1, c, 1, 1, generator=gen,
                                                                                    device="cuda") * 3
    weight = 1 + 0.3 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.5 * torch.randn(c, generator=gen, device="cuda")
    dy = torch.randn(n, c, h, w, generator=gen, device="cuda")
    cl = torch.channels_last
    return (x.to(dtype).contiguous(memory_format=cl), weight.to(dtype), bias.to(dtype),
            dy.to(dtype).contiguous(memory_format=cl))


def held(name, got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= limit(ref, dtype), f"{name}: error {err} over the limit {limit(ref, dtype)}"


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,h,w,groups", SHAPES)
def test_kernel_matches_plain_version_forward_and_backward(cuda_device, n, c, h, w, groups, dtype, silu):
    """y, the statistics, dx, dweight and dbias of the kernels against the
    plain versions in f32 on the same inputs; the output channels-last; the
    autograd Function's gradients those of the backward kernels."""
    x, weight, bias, dy = operands(n, c, h, w, dtype)
    f32 = [t.float() for t in (x, weight, bias, dy)]
    eps = 1e-5
    mean_ref, rstd_ref = gn.group_norm_stats_reference(f32[0], groups, eps)
    y_ref = gn.group_norm_reference(f32[0], f32[1], f32[2], groups, eps, silu)
    y, mean, rstd = gn._forward(x, weight, bias, groups, eps, silu)
    assert y.is_contiguous(memory_format=torch.channels_last) and y.dtype == dtype
    held("y", y, y_ref, dtype)
    torch.testing.assert_close(mean, mean_ref, rtol=1e-5, atol=1e-5 * mean_ref.abs().max().item())
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-4, atol=0)

    dx_ref, dw_ref, db_ref = gn.group_norm_bwd_reference(f32[0], f32[3], f32[1], f32[2], mean_ref, rstd_ref,
                                                         groups, silu)
    dx, dw, db = gn.group_norm_nhwc_bwd(x, dy, weight, bias, mean, rstd, groups, silu)
    for name, got, ref in (("dx", dx, dx_ref), ("dweight", dw, dw_ref), ("dbias", db, db_ref)):
        held(name, got, ref, dtype)
    dx_only = gn.group_norm_nhwc_bwd(x, dy, weight, bias, mean, rstd, groups, silu, params=False)
    assert dx_only[1] is None and torch.equal(dx_only[0], dx)

    xg, wg, bg = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
    grads = torch.autograd.grad(gn.group_norm_nhwc(xg, wg, bg, groups, eps, silu), (xg, wg, bg), dy)
    for got, want in zip(grads, (dx, dw, db)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_plain_backward_matches_autograd_on_the_card(cuda_device):
    """The plain backward on the card against autograd through the plain
    version (F.group_norm, F.silu) in f32."""
    x, weight, bias, dy = (t.float() for t in operands(4, 320, 32, 32, torch.float32))
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, weight, bias))
    want = torch.autograd.grad(gn.group_norm_reference(xg, wg, bg, 32, 1e-5, True), (xg, wg, bg), dy)
    mean, rstd = gn.group_norm_stats_reference(x, 32, 1e-5)
    for got, ref in zip(gn.group_norm_bwd_reference(x, dy, weight, bias, mean, rstd, 32, True), want):
        held("plain backward", got, ref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nchw", "float16", "weight_dtype", "c_not_vector", "c_over_smem", "c_not_groups"])
def test_refused_launches_raise(cuda_device, case):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    x, weight, bias, _ = operands(2, 64, 8, 8, torch.bfloat16)
    groups, err = 32, ValueError
    if case == "nchw":
        x = x.contiguous()
    elif case == "float16":
        x, weight, bias, err = x.half(), weight.half(), bias.half(), TypeError
    elif case == "weight_dtype":
        weight, err = weight.float(), TypeError
    elif case == "c_not_vector":  # 36 bf16 channels: not whole 16-byte vectors
        x, weight, bias, _ = operands(2, 36, 8, 8, torch.bfloat16)
        groups = 4
    elif case == "c_over_smem":
        x, weight, bias, _ = operands(1, 8192, 2, 2, torch.bfloat16)
    elif case == "c_not_groups":
        groups = 24
    with pytest.raises(err):
        gn.group_norm_nhwc(x, weight, bias, groups, 1e-5, True)
    if case == "nchw":
        with pytest.raises(ValueError):
            gn.GroupNorm(32, 64).to("cuda", torch.bfloat16)(x, silu=True)


def kernel_names(fn):
    """Names of the device kernels fn() launches, from torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


CONVERSIONS = ("nchwToNhwc", "nhwcToNchw", "RowwiseMoments")


def counted(fn):
    """fn()'s result and its GroupNorm counters (calls, kernel launches)
    from the program's tracer."""
    profiling.take()
    profiling.enable()
    try:
        with profiling.phase("probe"):
            out = fn()
    finally:
        profiling.disable()
    counts = [s.counts for s in profiling.take()]
    return out, sum(c.get("norm_calls", 0) for c in counts), sum(c.get("norm_nhwc", 0) for c in counts)


@pytest.fixture(scope="module")
def sd15():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from image_editing_framework_torch.pipelines import random_pipeline

    return random_pipeline("1.5", num_steps=4, dtype=torch.bfloat16, seed=0, device="cuda")


@pytest.mark.cuda
def test_sd15_unet_and_vae_stay_channels_last(cuda_device, sd15):
    """At full SD1.5 width, bf16, under a PnP control that replaces ResNet
    features (the hook's gather and select): every convolution's and
    GroupNorm's input, every conv weight and the outputs are channels-last
    (so the skips' ``cat``, the upsampler's ``interpolate``, the encoder's
    ``pad``, the adds and the hook keep it); an eager forward, the VAE's
    encode and decode launch no layout conversion and no PyTorch GroupNorm;
    every GroupNorm call launches the kernel."""
    from image_editing_framework_torch.core.config import PnPConfig
    from image_editing_framework_torch.ops.controls import build_pnp_control

    unet, vae = sd15.unet, sd15.vae
    strided = []

    def pre(m, args):
        if args[0].dim() == 4 and not args[0].is_contiguous(memory_format=torch.channels_last):
            strided.append((type(m).__name__, tuple(args[0].shape), args[0].stride()))

    convs = [m for net in (unet, vae) for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m.weight.is_contiguous(memory_format=torch.channels_last) for m in convs)
    hooks = [m.register_forward_pre_hook(pre) for net in (unet, vae) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, gn.GroupNorm))]
    gen = torch.Generator(device="cuda").manual_seed(0)
    lat = torch.randn(4, 64, 64, 4, generator=gen, device="cuda", dtype=torch.bfloat16)
    ctx = torch.randn(4, 77, 768, generator=gen, device="cuda", dtype=torch.bfloat16)
    img = torch.rand(2, 512, 512, 3, generator=gen, device="cuda", dtype=torch.bfloat16) * 2 - 1
    pnp = build_pnp_control(4, PnPConfig(), (), ("up1_res1", "up2_res0"), device="cuda").at_step(0)
    try:
        with torch.no_grad():
            (eps, _), calls, launched = counted(lambda: unet(lat, 981, ctx, pnp))
            names = kernel_names(lambda: unet(lat, 981, ctx))
            (enc, dec), vae_calls, vae_launched = counted(lambda: (vae.encode(img), vae.decode(lat)))
            vae_names = kernel_names(lambda: (vae.encode(img), vae.decode(lat)))
    finally:
        for h in hooks:
            h.remove()
    assert not strided, strided[:8]
    assert eps.is_contiguous() and enc.is_contiguous() and dec.is_contiguous()
    # 22 ResNets' two norms, 16 transformers' and the output's; the encoder's
    # 22 (8 ResNets, the mid block's 2 and attention, the output) and the
    # decoder's 30 (12 ResNets)
    assert calls == launched == 61 and vae_calls == vae_launched == 22 + 30
    for kernels in (names, vae_names):
        assert any("gn_apply" in k for k in kernels)
        bad = sorted({k for k in kernels if any(c in k for c in CONVERSIONS)})
        assert not bad, bad


@pytest.mark.cuda
def test_graphed_sd15_forward_launches_no_conversion(cuda_device, sd15):
    """Through ``inversion/graphs.py`` at batch 4: the capture counts as many
    kernel launches as GroupNorm calls, a replay counts neither and launches
    no layout conversion, and it gives the eager forward's eps."""
    unet = sd15.unet
    gen = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn(4, 64, 64, 4, generator=gen, device="cuda", dtype=torch.bfloat16)
    ctx = torch.randn(4, 77, 768, generator=gen, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        eager = unet(lat, 501, ctx)[0]
        step = graphs.forward_for(unet, lat, ctx)
        first, calls, launched = counted(lambda: step(lat, 501))
        assert calls == launched == 2 * 61  # the warm-up forward and the capture
        names = kernel_names(lambda: step(lat, 501))
        _, replay_calls, _ = counted(lambda: step(lat, 501))
        replayed = step(lat, 501)
    assert replay_calls == 0
    assert any("gn_apply" in k for k in names)
    bad = sorted({k for k in names if any(c in k for c in CONVERSIONS)})
    assert not bad, bad
    assert torch.equal(first, eager) and torch.equal(replayed, eager)


@pytest.mark.cuda
def test_channels_last_follows_the_device(cuda_device):
    """``to_nchw`` gives a channels-last view of a contiguous NHWC tensor on
    the card (no copy) and contiguous NCHW on the CPU."""
    x = torch.randn(2, 8, 6, 16, device="cuda")
    y = layout.to_nchw(x)
    assert y.data_ptr() == x.data_ptr() and y.is_contiguous(memory_format=torch.channels_last)
    assert layout.to_nchw(x.cpu()).is_contiguous()
