"""SD2.1's shapes on the card: the flash kernels at its 768² sites and an
SD2.1-shaped UNet on the card against the same UNet on the CPU.

Imports only torch and the port, so it runs on the GPU machine (no JAX):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_sd21_card.py

The sites are 9216, 2304, 576 and 144 tokens at head dim 64 (5, 10, 20 and
20 heads), passed as the head-split views of (B, N, H·D) projections the
UNet gives the kernels; 576 and 144 leave the forward's last 128-query block
and 128-key tile part filled, 144 also the backward's 64-row tiles. Limits:
``parity_atol`` / ``grad_parity_atol`` (bf16 2^-6 of max|ref|, f32 1e-4 and
2^-14); the UNet card vs CPU within 1e-4 · max|ref| in true f32. Without a
card every test skips (the CPU suite holds the plain versions and the
SD2.1-shaped model against JAX: ``tests/test_torch_sd21.py``).
"""

import pytest
import torch

from image_editing_framework_torch.models.unet import UNet2DCondition, UNetConfig
from image_editing_framework_torch.models.weights import random_init_
from image_editing_framework_torch.ops import flash_attention as tfa
from image_editing_framework_torch.ops.attention import split_heads

SITES = [(9216, 5), (2304, 10), (576, 20), (144, 20)]  # (tokens, heads) at d = 64
D = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _views(b, n, h, dtype, gen, count):
    return [split_heads(torch.randn(b, n, h * D, device="cuda", dtype=dtype, generator=gen), h) for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("n,h", SITES)
def test_forward_kernel_at_sd21_sites(cuda_device, dtype, b, n, h):
    gen = torch.Generator(device=cuda_device).manual_seed(n + b)
    q, k, v = _views(b, n, h, dtype, gen, 3)
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_reference(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tfa.parity_atol(ref), (err, tfa.parity_atol(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h", SITES)
def test_backward_kernels_at_sd21_sites(cuda_device, dtype, n, h):
    """NTI's batch 1 (the first site sees no embedding, but its shape is the
    next four's)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    q, k, v, do = _views(1, n, h, dtype, gen, 4)
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    ref_o, ref_lse = tfa.flash_attention_reference(q, k, v, return_lse=True)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    got = tfa.flash_attention_bwd(q, k, v, None, o, do, lse)
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    ref = tfa.flash_attention_bwd_reference(q, k, v, None, ref_o, do, ref_lse)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tfa.grad_parity_atol(r), (name, err, tfa.grad_parity_atol(r))


@pytest.mark.cuda
def test_sd21_shaped_unet_card_matches_cpu(cuda_device):
    """A tiny UNet of SD2.1's structure (head dim 16 at both levels, linear
    projections) at a 24² latent (576- and 144-token sites, no 256), f32:
    the card's forward against the CPU's, every self-attention site through
    the kernel."""
    cfg = UNetConfig(block_out_channels=(32, 64), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                     up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1, num_heads=(2, 4),
                     transformer_layers=(1, 1), cross_attention_dim=32, use_linear_projection=True)
    cpu = random_init_(UNet2DCondition(cfg), 0).eval().requires_grad_(False)
    card = random_init_(UNet2DCondition(cfg), 0).eval().requires_grad_(False).to(cuda_device)
    gen = torch.Generator().manual_seed(1)
    lat, ctx = torch.randn(4, 24, 24, 4, generator=gen), torch.randn(4, 77, 32, generator=gen)
    before = tfa.flash_attention.launches
    with torch.no_grad():
        out, _ = card(lat.to(cuda_device), 501, ctx.to(cuda_device))
        ref, _ = cpu(lat, 501, ctx)
    assert tfa.flash_attention.launches == before + cfg.num_transformer_blocks == before + 4
    err = (out.cpu() - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err
