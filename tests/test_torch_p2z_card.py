"""pix2pix-zero on the card: the tiny SD and SDXL pipelines' edit against
the same weights on the CPU (the kernels' plain versions), and their guided
steps without a host sync, through the helpers of chip_smoke.py's tiny
phase (``tiny_p2z``, ``p2z_sync_free``).

Imports only torch, the port and chip_smoke.py (which imports no JAX), so
it runs on the GPU machine, which has no JAX (``--noconftest`` skips the
JAX-pinning conftest there):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_p2z_card.py

Without a card every test skips (the CPU suite holds p2z against JAX in
test_torch_p2z.py and test_torch_xl_p2z.py). Limit: final latents within
1e-3 of the CPU's, as the tiny phase holds every edit (f32 kernels; no
TF32).
"""

import importlib.util
import os

import pytest
import torch

from image_editing_framework_torch.models.weights import load_weights
from image_editing_framework_torch.pipelines import tiny_pipeline

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")


@pytest.fixture
def smoke():
    """chip_smoke.py as a module (importing it runs nothing), on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pipes(model_type):
    """(CPU pipeline, card pipeline) with the same weights."""
    cpu = tiny_pipeline(num_steps=4, model_type=model_type, device="cpu")
    gpu = tiny_pipeline(num_steps=4, model_type=model_type, device="cuda")
    for name in ("unet", "vae", "text_encoder") + (("text_encoder_2",) if model_type == "xl" else ()):
        load_weights(getattr(gpu, name), {k: v.numpy() for k, v in getattr(cpu, name).state_dict().items()})
    return cpu, gpu


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["sd", "xl"])
def test_p2z_on_the_card_matches_the_cpu(smoke, model_type):
    """SD with recorded references; XL with the XL defaults at 1024²
    (recomputed references, the checkpointed UNet); both with per-step NTI
    embeddings: the reconstruction's and the edit's final latents."""
    cpu, gpu = _pipes(model_type)
    got, want = smoke.tiny_p2z(gpu, model_type), smoke.tiny_p2z(cpu, model_type)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["sd", "xl"])
def test_p2z_guided_steps_do_not_sync(smoke, model_type):
    """Pass 2 under ``torch.cuda.set_sync_debug_mode("error")``: the
    gradient, the SGD step, the noise forward and the DDIM step never make
    the host wait for the card."""
    assert smoke.p2z_sync_free(_pipes(model_type)[1], model_type)
