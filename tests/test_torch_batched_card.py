"""The batched editors and the service on the card: the tiny SD and SDXL
pipelines' batched edits and batched null-text inversion against the same
weights on the CPU (the kernels' plain versions) and against each image
alone on the card, through chip_smoke.py's ``tiny_batched``; and a group
served by ``EditService`` launching the flash kernel as often as one
request.

Imports only torch, the port and chip_smoke.py (which imports no JAX), so
it runs on the GPU machine, which has no JAX (``--noconftest`` skips the
JAX-pinning conftest there):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_batched_card.py

Without a card every test skips (the CPU suite holds the batched editors
against JAX in test_torch_batched.py, test_torch_nti_batch.py,
test_torch_xl_batched.py and test_torch_serve.py). Limit: final latents and
embeddings within 1e-3, as chip_smoke.py's tiny phase holds every edit (f32
kernels; no TF32).
"""

import importlib.util
import json
import os

import pytest
import torch

from image_editing_framework_torch.models.weights import load_weights
from image_editing_framework_torch.ops import flash_attention as fa
from image_editing_framework_torch.pipelines import tiny_pipeline
from image_editing_framework_torch.serve import EditService

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
TOL = 1e-3


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
def test_batched_editors_on_the_card_match_the_cpu(smoke, model_type):
    cpu, gpu = _pipes(model_type)
    (want, want_seqs, want_stops), (got, got_seqs, got_stops) = (smoke.tiny_batched(p, model_type) for p in (cpu, gpu))
    assert set(got) == set(want) and len(got) == (8 if model_type == "sd" else 1)
    for name in got:
        assert (got[name][0] - want[name][0]).abs().max().item() < TOL, name  # card vs CPU
        assert (got[name][0] - got[name][1]).abs().max().item() < TOL, name  # the group vs each image alone
    for name in got_seqs:
        assert (got_seqs[name][0] - want_seqs[name][0]).abs().max().item() < TOL, name
        assert (got_seqs[name][0] - got_seqs[name][1]).abs().max().item() < TOL, name
    assert got_stops == want_stops
    if model_type == "sd":
        assert got_stops[0] == smoke.TINY_NTI_STOPS


@pytest.mark.cuda
def test_a_served_group_launches_what_one_request_launches(smoke, tmp_path):
    _, gpu = _pipes("sd")

    def serve(root, n, max_batch):
        svc = EditService(gpu, str(root), resolution=32, max_batch=max_batch)
        for i in range(n):
            with open(os.path.join(svc.requests_dir, f"r{i}.json"), "w") as f:
                json.dump(dict(method="p2p", source_prompt="a cat sat", target_prompt="a dog sat", seed=i,
                               image_path=None), f)
        fa.flash_attention.launches = 0
        assert svc.poll_once() == n
        return fa.flash_attention.launches, svc.stats

    group, stats = serve(tmp_path / "group", 3, 4)
    one, _ = serve(tmp_path / "one", 1, 4)
    assert stats["batched"] == 3 and group == one > 0
