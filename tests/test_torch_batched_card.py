"""The batched editors and the service on the card: the tiny SD and SDXL
pipelines' batched edits and batched null-text inversion against the same
weights on the CPU (the kernels' plain versions) and against each image
alone on the card, through chip_smoke.py's ``tiny_batched``; and a group
served by ``EditService`` launching the flash kernel as often as one
request; and the inversion's graphed UNet forward (``inversion/graphs.py``)
at full SD1.5 and SDXL width against the eager scan, bit for bit, with the
same kernel launches and attention calls.

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

from image_editing_framework_torch.eval import batched
from image_editing_framework_torch.inversion import ddim
from image_editing_framework_torch.models import unet as unet_module
from image_editing_framework_torch.models.weights import load_weights
from image_editing_framework_torch.ops import flash_attention as fa
from image_editing_framework_torch.pipelines import random_pipeline, tiny_pipeline
from image_editing_framework_torch.serve import EditService
from image_editing_framework_torch.utils import profiling

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


GRAPH_STEPS = 10


@pytest.mark.cuda
@pytest.mark.parametrize("model, g", [("sd", 1), ("sd", 4), ("xl", 2)])
def test_the_graphed_inversion_is_the_eager_one_bit_for_bit(smoke, monkeypatch, model, g):
    """Two groups of the same shape at full width in bf16, through
    ``ddim_invert_batch`` (at G = 1 through the serial ``ddim_invert``, as
    chip_smoke.py's main path inverts): the trajectories equal the eager
    scan's (a stand-in UNet keeps the eager loop) bit for bit, the flash
    forward launches equal the eager scan's and the exact count,
    ``models.unet.self_attention`` is called as often and with the same
    shapes, and the two groups make one capture."""
    version, _, side, _ = smoke.MODELS[model]
    pipe = random_pipeline(version, num_steps=GRAPH_STEPS, dtype=torch.bfloat16, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    groups = [(torch.randn(g, 1, side // 8, side // 8, 4, generator=gen, device="cuda", dtype=torch.bfloat16),
               [f"a photo of a {w} number {k}" for k in range(g)]) for w in ("cat", "dog")]
    unet = pipe.unet
    calls = []
    attention = unet_module.self_attention
    monkeypatch.setattr(unet_module, "self_attention",
                        lambda q, k, v, *a, **kw: calls.append((q.shape, k.shape)) or attention(q, k, v, *a, **kw))

    def run(lat, prompts):
        fa.flash_attention.launches = 0
        calls.clear()
        if g == 1:
            traj = ddim.ddim_invert(pipe, lat[:, 0], prompts[0])[1]
        else:
            traj = batched.ddim_invert_batch(pipe, lat, prompts, return_trajectory=True)[1]
        torch.cuda.synchronize()
        return traj, fa.flash_attention.launches, list(calls)

    with monkeypatch.context() as m:
        m.setattr(pipe, "unet", lambda *a, **kw: unet(*a, **kw))
        eager = [run(*group) for group in groups]
    profiling.enable()
    try:
        with profiling.phase("groups"):
            graphed = [run(*group) for group in groups]
    finally:
        profiling.disable()
        spans = profiling.take()
    for (want, n_want, calls_want), (got, n_got, calls_got) in zip(eager, graphed):
        assert torch.equal(got, want)
        assert n_got == n_want == smoke.SITES[model] * GRAPH_STEPS
        assert calls_got == calls_want
    counted = {k: sum(s.counts.get(k, 0) for s in spans) for k in ("graph_captures", "graph_replays")}
    assert counted == {"graph_captures": 1, "graph_replays": 2 * GRAPH_STEPS - 1}
