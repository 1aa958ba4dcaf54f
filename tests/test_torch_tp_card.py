"""Tensor parallelism on the card: the tiny UNet split over tensor = 2 on 2
rank processes over gloo on one card (``torch_tp_workers.py suite_card``),
its forward and one ``make_sharded_train_step`` step with the flash kernels
(forward, dQ, dK/dV) on head shards, on the CPU (the kernels' plain
versions) and on the card, each against the same forward, loss and
gradients unsharded on the CPU, with exact launch counts.

Imports only torch, numpy and the rank launcher (which imports no JAX), so
it runs on the GPU machine, which has no JAX:

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_tp_card.py

Without a card the test skips (tests/test_torch_sharding.py and
tests/test_torch_sharding_train.py hold the same functions against JAX on
CPU ranks). Tolerance: 1e-3 · max|ref|, chip_smoke.py's ``TP_RTOL``; the
f32 kernels differ from their plain versions by rounding alone.
"""

import numpy as np
import pytest
import torch

RTOL = 1e-3
SITES = 4  # the tiny UNet's transformer blocks (configs.TINY_UNET.num_transformer_blocks)


@pytest.mark.cuda
def test_tp_forward_and_train_step_on_two_ranks_of_one_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels run only there")
    from torch_cp_workers import launch

    ranks = launch("tp_card", 2, tmp_path)
    for res in ranks:
        assert int(res["cuda/forward_launches"]) == SITES and int(res["cpu/forward_launches"]) == 0
        assert res["cuda/train_launches"].tolist() == [SITES] * 3
        assert res["cpu/train_launches"].tolist() == [0, 0, 0]
        grads = [k[len("ref/"):] for k in res if k.startswith("ref/grad/")]
        scale = max(np.abs(res[f"ref/{k}"]).max() for k in grads)
        for device in ("cpu", "cuda"):
            ref = res["ref/forward"]
            np.testing.assert_allclose(res[f"{device}/forward"], ref, atol=RTOL * np.abs(ref).max(), rtol=0)
            np.testing.assert_allclose(float(res[f"{device}/loss"]), float(res["ref/loss"]), rtol=RTOL)
            assert sorted(k for k in res if k.startswith(f"{device}/grad/")) == sorted(f"{device}/{k}" for k in grads)
            for key in grads:
                np.testing.assert_allclose(res[f"{device}/{key}"], res[f"ref/{key}"], atol=RTOL * scale, rtol=0,
                                           err_msg=f"{device} {key}")
    np.testing.assert_array_equal(ranks[0]["cuda/forward"], ranks[1]["cuda/forward"])
