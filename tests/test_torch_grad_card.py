"""The gradient paths' last configurations on the card, at tiny width:
chip_smoke.py's ``grad_groups_path`` helpers (batched NTI of a group of 3
split by ``step0_epsilon`` with a stopped image's embedding frozen, the
batched pix2pix-zero edit on its embeddings, the group's f32 guided step
against each image's alone), SDXL's batched pix2pix-zero (``edit_batch``),
and parts (d) and (e) of ``cp_path`` on 2 rank processes over gloo on one
card (``torch_cp_workers.py suite_grad_card``: NTI and pix2pix-zero under
tensor parallelism and under the ring, the ring's f32 gradients through
the checkpointed UNet), each with exact launch counts.

Imports only torch, the port, chip_smoke.py and the rank launcher (none
imports JAX), so it runs on the GPU machine, which has no JAX:

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_grad_card.py

Without a card every test skips (the CPU suite holds the same functions
against JAX: tests/test_torch_serve.py, test_torch_xl_batched.py,
test_torch_cp_unet.py, test_torch_tp_edits.py; and rehearses the script's
parts on CPU ranks in test_torch_chip_smoke.py). Limit: 1e-3 · max|ref|,
chip_smoke.py's ``GRAD_RTOL`` (f32 kernels; no TF32).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

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


@pytest.mark.cuda
def test_tiny_grad_groups_on_the_card(smoke):
    """Batched NTI of a group of 3 on the card: the images stop apart at
    step 0, a stopped image keeps its embedding bit for bit, exact launches;
    the batched p2z edit on its embeddings launches one image's kernels;
    the group's f32 guided step within GRAD_RTOL of each image's alone."""
    from image_editing_framework_torch.core.config import NTIConfig
    from image_editing_framework_torch.eval import batched
    from image_editing_framework_torch.pipelines import tiny_pipeline

    pipe = tiny_pipeline(num_steps=10, device="cuda")
    sites = pipe.unet.config.num_transformer_blocks
    prompts = [p[0] for p in smoke.NTI_GROUP_PAIRS]
    scales = torch.tensor(smoke.TINY_NTI_SCALES, device="cuda")[:, None, None, None, None]
    lats = torch.from_numpy(np.random.RandomState(2).randn(3, 1, 16, 16, 4).astype(np.float32)).cuda() * scales
    inverted, trajs = batched.ddim_invert_batch(pipe, lats, prompts, return_trajectory=True)
    epsilon, _ = smoke.step0_epsilon(pipe, trajs, prompts)
    smoke.reset_launch_counts()
    with smoke.nti_recorded() as seen:
        seqs, stops = batched.nti_batch(pipe, trajs, prompts, NTIConfig(num_inner_steps=2, epsilon=epsilon),
                                        return_stops=True)
    inner = sum(max(step) for step in stops)
    assert smoke.launch_counts() == smoke.nti_launches(sites, sites - 1, 10, inner)
    assert sorted(set(stops[0])) == [1, 2]
    assert smoke.frozen_after_stop(stops, seen["embeddings"], seqs) >= 1
    pairs = smoke.NTI_GROUP_PAIRS[:2]
    smoke.reset_launch_counts()
    images = batched.edit_batch("p2z", pipe, pairs, inverted[:2], uncond_seqs=seqs[:2])
    assert smoke.launch_counts() == smoke.p2z_launches(sites, 10, inverted=False)
    assert images.shape == (2, 2, 32, 32, 3) and images.std() > 0
    held = smoke.grad_groups_f32_step(pipe, inverted[:2], pairs)
    assert len(held) == 6 and all(h["max_abs_err"] <= h["limit"] for h in held.values())


@pytest.mark.cuda
def test_tiny_xl_p2z_group_on_the_card(smoke):
    """SDXL's batched pix2pix-zero with its defaults (references made again
    each step) on the tiny SDXL pipeline on the card: a group of 2 launches
    one image's kernels, and its images are not constant."""
    from image_editing_framework_torch.eval import batched
    from image_editing_framework_torch.pipelines import tiny_pipeline

    pipe = tiny_pipeline(num_steps=10, model_type="xl", device="cuda")
    sites = pipe.unet.config.num_transformer_blocks
    lats = torch.from_numpy(np.random.RandomState(9).randn(2, 1, 16, 16, 4).astype(np.float32)).cuda()
    smoke.reset_launch_counts()
    images = batched.edit_batch("p2z", pipe, [["a cat", "a dog"], ["a horse", "a zebra"]], lats)
    assert smoke.launch_counts() == smoke.p2z_launches(sites, 10, recompute=True, inverted=False)
    assert images.shape == (2, 2, 32, 32, 3) and images.std() > 0


@pytest.mark.cuda
def test_grad_parts_on_two_ranks_of_one_card(tmp_path):
    """Parts (d) and (e) at tiny size on 2 ranks of one card: every gate of
    the script passes in the ranks (exact launches among them), and the
    ranks' gradients, embeddings, stops and images are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels run only there")
    from torch_cp_workers import launch

    ranks = launch("grad_card", 2, tmp_path)
    for res in ranks:
        per_forward = int(res["per_forward"])
        assert per_forward > 0 and int(res["ring_sites"]) > 0
        for batch in ("batch1", "batch2"):
            assert np.all(res[f"{batch}/errors"] <= res[f"{batch}/limits"]), batch
            assert res[f"{batch}/launches"].tolist() == [2 * per_forward, per_forward, per_forward]
        assert res["checkpointed"].tolist() == [True, True]
        assert res["tp/p2z_step/error"][0] <= res["tp/p2z_step/error"][1]
        assert all(n > 0 for n in res["tp/nti/launches"].tolist() + res["p2z/launches"].tolist())
    for key in ranks[0]:
        if not key.endswith("errors") and key not in ("rank", "tp/p2z_step/error"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
