"""The flash kernels (forward and backward) against their plain versions on
the card.

Imports only torch and the port, so it runs on the GPU machine, which has
no JAX (``--noconftest`` skips the JAX-pinning conftest there):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_flash_kernel.py

Without a card every test skips (the CPU suite holds the plain versions
against JAX in test_torch_flash_attention.py and test_torch_flash_grad.py).
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
     (2, 3, 130, 1000, 64, True, False), (2, 2, 70, 77, 16, True, True), (1, 2, 33, 50, 32, False, False),
     # Nq off the 128-query block; Nk below one key tile (128, or 64 at d = 160) and not a multiple of 8
     (2, 3, 200, 100, 64, False, True), (1, 2, 130, 45, 160, True, False), (2, 2, 257, 127, 80, True, True),
     # SDXL's two sites as head-split views; d = 40 at 4096 tokens, d = 160 at 256
     (4, 10, 4096, 4096, 64, False, True), (4, 20, 1024, 1024, 64, False, True),
     (2, 8, 4096, 4096, 40, False, True), (4, 8, 256, 256, 160, False, True)],
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
@pytest.mark.parametrize("d", [40, 64, 160])
def test_flash_kernel_is_deterministic(cuda_device, d):
    """Each block owns its rows and sums its key tiles in one order: a rerun
    gives the same bits, output and lse, with and without a bias."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (split_heads(torch.randn(2, 1000, 4 * d, device=cuda_device, dtype=torch.bfloat16, generator=g), 4)
               for _ in range(3))
    bias = torch.zeros(2, 1000, device=cuda_device)
    bias[:, 300:500] = tfa.NEG_INF
    for b in (None, bias):
        first = tfa.flash_attention(q, k, v, b, return_lse=True)
        second = tfa.flash_attention(q, k, v, b, return_lse=True)
        assert all(torch.equal(x, y) for x, y in zip(first, second))


# MasaCtrl's biased calls at their gated sites, CFG batch 4: (variant, heads,
# tokens, head dim); union doubles the keys, mask keeps them (SD1.5: 1024/80
# and 4096/40; SDXL: 1024/64 with 20 heads and 4096/64 with 10)
MASACTRL_SHAPES = [(variant, h, n, d) for variant in ("union", "mask")
                   for h, n, d in ((8, 1024, 80), (8, 4096, 40), (20, 1024, 64), (10, 4096, 64))]


def _masactrl_operands(device, variant, h, n, d, gate):
    """(q, k, v, bias) as MasaCtrl's sites pass them: head-split views, the
    union plan's gathered segments and segment bias (``gate``: a gated step),
    or the source K/V gathered for the mask variants with a random fg bias."""
    from image_editing_framework_torch.ops import controls as ctl
    from image_editing_framework_torch.ops.attention import AttnSite, plan_operands

    g = torch.Generator(device=device).manual_seed(2)
    q, k, v = (split_heads(torch.randn(4, n, h * d, device=device, dtype=torch.bfloat16, generator=g), h)
               for _ in range(3))
    if variant == "union":
        step = ctl.MasaCtrlStep(step_gate=torch.tensor(gate, device=device), layers=(0,), union=True)
        return plan_operands(q, k, v, step.self_plan(AttnSite(0, "up", n, False), 4))
    src = torch.tensor([0, 0, 2, 2], device=device)
    return q, k[src], v[src], ctl.key_bias(torch.rand(n, device=device, generator=g) > 0.5, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("variant,h,n,d", MASACTRL_SHAPES)
def test_flash_kernel_matches_plain_version_at_masactrl_shapes(cuda_device, variant, h, n, d, gate):
    """The biased kernel (whole key tiles at NEG_INF before the open ones,
    logits in natural units) against its plain version at the shapes
    MasaCtrl's union and mask variants give it, at a gated and an ungated
    step, within ``parity_atol``."""
    q, k, v, bias = _masactrl_operands(cuda_device, variant, h, n, d, gate)
    assert k.shape[2] == (2 * n if variant == "union" else n) and bias.is_contiguous()
    out = tfa.flash_attention(q, k, v, bias)
    ref = tfa.flash_attention_reference(q, k, v, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tfa.parity_atol(ref), rtol=0)


@pytest.mark.cuda
def test_flash_kernel_refuses_a_broadcast_bias(cuda_device):
    """A bias made with ``expand`` (batch stride 0) is refused on the card,
    where the plain version would take it: the controls materialise theirs."""
    q, k, v = (torch.randn(2, 2, 128, 64, device=cuda_device, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.zeros(128, device=cuda_device).expand(2, 128)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q, k, v, bias)
    out = tfa.flash_attention(q, k, v, bias.contiguous())
    ref = tfa.flash_attention_reference(q, k, v, bias)
    torch.testing.assert_close(out.float(), ref.float(), atol=tfa.parity_atol(ref), rtol=0)


GRID = [(2, 8, 1024, 1024, 40, False, True), (2, 8, 256, 256, 80, False, True), (1, 8, 64, 64, 160, False, False),
        (2, 3, 130, 1000, 64, True, False), (2, 2, 70, 77, 16, True, True), (1, 2, 33, 50, 32, False, False)]

# The bf16 backward's tiles: 64 output rows per block; dQ streams 128-key
# tiles (64 at d = 160), dK/dV 64-query tiles (32 at d = 160).
BWD_CASES = [
    # Nq and Nk off the 64-row blocks and off both kernels' streamed tiles
    (2, 3, 200, 300, 64, False, True), (1, 4, 130, 45, 160, True, False), (2, 2, 257, 129, 80, True, True),
    (1, 3, 100, 190, 40, True, True), (2, 2, 31, 97, 16, False, False), (1, 2, 65, 200, 32, True, True),
    # SDXL's NTI sites: head-split views, dO in autograd's layout
    (1, 10, 4096, 4096, 64, False, True), (1, 20, 1024, 1024, 64, False, True),
    # SD1.5's NTI sites: d = 40, 80 and 160
    (1, 8, 4096, 4096, 40, False, True), (1, 8, 1024, 1024, 80, False, True),
    (1, 8, 256, 256, 160, False, True), (1, 8, 64, 64, 160, False, True),
    # pix2pix-zero's sites: every site of SD1.5 and SDXL at CFG batch 2
    (2, 8, 4096, 4096, 40, False, True), (2, 8, 1024, 1024, 80, False, True),
    (2, 8, 256, 256, 160, False, True), (2, 8, 64, 64, 160, False, True),
    (2, 10, 4096, 4096, 64, False, True), (2, 20, 1024, 1024, 64, False, True),
]


def _bwd_inputs(device, dtype, b, h, nq, nk, d, with_bias, split, seed=0):
    """q, k, v, dO (head-split views of (B, N, H*D) projections when
    ``split``, as the UNet and autograd give them), the bias, and the
    forward kernel's output and lse."""
    g = torch.Generator(device=device).manual_seed(seed)

    def make(n):
        if split:
            return split_heads(torch.randn(b, n, h * d, device=device, dtype=dtype, generator=g), h)
        return torch.randn(b, h, n, d, device=device, dtype=dtype, generator=g)

    q, k, v, do = make(nq), make(nk), make(nk), make(nq)
    bias = None
    if with_bias:
        bias = torch.zeros(b, nk, device=device)
        bias[:, nk // 2:] = tfa.NEG_INF
        bias[0] = tfa.NEG_INF
    o, lse = tfa.flash_attention(q, k, v, bias, return_lse=True)
    return q, k, v, do, bias, o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,nq,nk,d,with_bias,split", GRID + BWD_CASES)
def test_flash_bwd_kernels_match_plain_version(cuda_device, dtype, b, h, nq, nk, d, with_bias, split):
    """Both backward kernels against ``flash_attention_bwd_reference`` on the
    same inputs, within ``grad_parity_atol`` per output (bf16: 2^-6 of the
    largest gradient; f32: 2^-14), with dO taken as it comes (no copy):
    the path shapes, and where the bf16 kernels' tiles end (BWD_CASES)."""
    q, k, v, do, bias, o, lse = _bwd_inputs(cuda_device, dtype, b, h, nq, nk, d, with_bias, split)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches, tfa.flash_attention_bwd.copies)
    got = tfa.flash_attention_bwd(q, k, v, bias, o, do, lse)
    ref = tfa.flash_attention_bwd_reference(q, k, v, bias, o, do, lse)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches, tfa.flash_attention_bwd.copies) == (
        before[0] + 1, before[1] + 1, before[2])
    for a, r in zip(got, ref):
        assert a.dtype == dtype and a.shape == r.shape
        torch.testing.assert_close(a.float(), r.float(), atol=tfa.grad_parity_atol(r), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_flash_bwd_kernels_are_deterministic(cuda_device, dtype, d):
    """No atomics: every block owns its outputs, so two runs give the same
    bits, at every tile shape."""
    q, k, v, do, bias, o, lse = _bwd_inputs(cuda_device, dtype, 1, 8, 1000, 1000, d, True, True)
    first = tfa.flash_attention_bwd(q, k, v, bias, o, do, lse)
    second = tfa.flash_attention_bwd(q, k, v, bias, o, do, lse)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_flash_all_neg_inf_row_gets_zero_gradients_on_the_card(cuda_device, d):
    """A batch row whose every logit is -inf gets zero dQ, dK and dV; the
    other row stays within the limit (Nq and Nk off the tiles)."""
    q, k, v, do, _, _, _ = _bwd_inputs(cuda_device, torch.bfloat16, 2, 2, 70, 150, d, False, False)
    bias = torch.zeros(2, 150, device=cuda_device)
    bias[1] = -float("inf")
    o, lse = tfa.flash_attention(q, k, v, bias, return_lse=True)
    got = tfa.flash_attention_bwd(q, k, v, bias, o, do, lse)
    ref = tfa.flash_attention_bwd_reference(q, k, v, bias, o, do, lse)
    for x, r in zip(got, ref):
        assert torch.isfinite(x).all() and torch.all(x[1] == 0)
        torch.testing.assert_close(x.float(), r.float(), atol=tfa.grad_parity_atol(r), rtol=0)


@pytest.mark.cuda
def test_flash_kernel_runs_the_backward_for_inputs_that_require_grad(cuda_device):
    """Inputs that require grad run the forward kernel with its lse and, on
    backward, both backward kernels: the gradient matches autograd through
    the plain forward."""
    x = torch.randn(1, 64, 2 * 40, device=cuda_device, dtype=torch.float32, requires_grad=True)
    q = split_heads(x, 2)
    before = (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    out = tfa.flash_attention(q, q, q)
    (g,) = torch.autograd.grad(out.square().sum(), x)
    assert (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    (want,) = torch.autograd.grad(tfa.flash_attention_reference(q, q, q).square().sum(), x)
    torch.testing.assert_close(g, want, atol=1e-4, rtol=1e-4)
