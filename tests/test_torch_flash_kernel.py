"""The flash kernel against its plain version on the card.

Imports only torch and the port, so it runs on the GPU machine, which has
no JAX (``--noconftest`` skips the JAX-pinning conftest there):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_flash_kernel.py

Without a card every test skips (the CPU suite holds the plain version
against JAX in test_torch_flash_attention.py).
"""

import pytest
import torch

from image_editing_framework_torch.ops import flash_attention as tfa
from image_editing_framework_torch.ops.attention import split_heads


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,h,nq,nk,d,with_bias,split",
    [(2, 8, 1024, 1024, 40, False, True), (2, 8, 256, 256, 80, False, True), (1, 8, 64, 64, 160, False, False),
     (2, 3, 130, 1000, 64, True, False), (2, 2, 70, 77, 16, True, True), (1, 2, 33, 50, 32, False, False)],
)
def test_flash_kernel_matches_plain_version(cuda_device, dtype, b, h, nq, nk, d, with_bias, split):
    """The CUDA kernel against its plain version on the card, within
    ``parity_atol`` (bf16: 2^-6 of the largest output). ``split`` passes
    q/k/v as the head-split views of (B, N, H*D) projections that the UNet
    gives the kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def make(n):
        if split:
            x = torch.randn(b, n, h * d, device=cuda_device, dtype=dtype, generator=g)
            return split_heads(x, h)
        return torch.randn(b, h, n, d, device=cuda_device, dtype=dtype, generator=g)

    q, k, v = make(nq), make(nk), make(nk)
    bias = None
    if with_bias:
        bias = torch.zeros(b, nk, device=cuda_device)
        bias[:, nk // 2:] = tfa.NEG_INF
        bias[0] = tfa.NEG_INF
    before = tfa.flash_attention.launches
    out, lse = tfa.flash_attention(q, k, v, bias, return_lse=True)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, bias, return_lse=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tfa.parity_atol(ref), rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_refuses_inputs_that_require_grad(cuda_device):
    """Inference only until the backward kernels arrive: no answer with a
    silently missing gradient."""
    q = torch.randn(1, 2, 64, 40, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    before = tfa.flash_attention.launches
    with pytest.raises(RuntimeError, match="backward"):
        tfa.flash_attention(q, q.detach(), q.detach())
    assert tfa.flash_attention.launches == before
