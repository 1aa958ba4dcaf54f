"""Null-text inversion on the tiny XL pipeline, the port against the JAX
package: the resetting variant with the negative pooled embeds on every
unconditional evaluation, ``cli.invert(..., "null-text")`` with XL's two
learning-rate schedules, and the checkpointed UNet.

Both run in f32 on the CPU; the JAX side runs ``use_flash=False`` (its XLA
attention), the port's self-attention gradient goes through its
``FlashAttention`` Function, here the plain versions of the kernels.

Tolerances: the embeddings within a tenth of one Adam step, which moves an
element by about the learning rate: 5e-3 at base_lr 5e-2 (``masactrl``'s XL
schedule and the direct calls), 5e-2 at base_lr 0.5 (``p2p``'s). XL restarts
every step from the original embedding, so differences do not carry over
between steps. ``check_grad_margin`` checks that no gradient element of the
port lies within ``GRAD_MARGIN`` · max|g| of 0, where the sign could differ
between the frameworks (tests/test_torch_nti.py). Latents atol 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch import cli as tcli
from image_editing_framework_torch.core.config import NTIConfig as TNTIConfig
from image_editing_framework_torch.inversion import nti as tnti
from image_editing_framework_tpu import cli as jcli
from image_editing_framework_tpu.core.config import NTIConfig as JNTIConfig
from image_editing_framework_tpu.inversion.ddim import ddim_invert as j_invert
from image_editing_framework_tpu.inversion.nti import null_text_inversion as j_nti
from torch_port_helpers import check_grad_margin, n, recorded_grads, shared_pipelines, t

STEPS = 3
INNER = 3
GS = 7.5
PROMPT = "a cat sitting on the grass"
IMAGE = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
LR = 5e-2
ATOL_LAT = 1e-3


@pytest.fixture(scope="module")
def pipes():
    return shared_pipelines(num_steps=STEPS, model_type="xl")


@pytest.fixture(scope="module")
def inverted(pipes):
    """The JAX DDIM inversion of IMAGE: (trajectory, context, added_cond with
    ``uncond_text_embeds``), as numpy."""
    jpipe, _ = pipes
    _, traj, ctx, added = j_invert(jpipe, jpipe.image2latent(IMAGE), PROMPT, use_flash=False)
    return np.asarray(traj), np.asarray(ctx), {k: np.asarray(v) for k, v in added.items()}


def _short(nti_config_for, cfg_cls):
    """``nti_config_for`` with its own schedule and INNER inner iterations."""
    def config(method, pipe):
        c = nti_config_for(method, pipe)
        return cfg_cls(num_inner_steps=INNER, base_lr=c.base_lr, lr_decay_span=c.lr_decay_span)
    return config


def test_xl_null_text_inversion_matches_jax(pipes, inverted, monkeypatch):
    jpipe, tpipe = pipes
    traj, ctx, added = inverted
    ref = j_nti(jpipe, jnp.asarray(traj), jnp.asarray(ctx), JNTIConfig(num_inner_steps=INNER, base_lr=LR),
                guidance_scale=GS, added_cond={k: jnp.asarray(v) for k, v in added.items()}, use_flash=False)
    grads = recorded_grads(monkeypatch)
    before = tnti.null_text_inversion.inner_iterations
    seq = tnti.null_text_inversion(tpipe, t(traj), t(ctx), TNTIConfig(num_inner_steps=INNER, base_lr=LR), GS,
                                   added_cond={k: t(v) for k, v in added.items()})
    monkeypatch.undo()
    assert tnti.null_text_inversion.inner_iterations - before == STEPS * INNER
    check_grad_margin(grads, STEPS * INNER)
    assert seq.shape == (STEPS, 77, 32) and seq.dtype == torch.float32
    np.testing.assert_allclose(n(seq), n(ref), atol=LR / 10, rtol=0)
    assert np.abs(n(ref) - ctx[:1]).max() > LR  # the optimisation moved the embedding

    # the resetting variant: every step starts from the original embedding,
    # so after one iteration per step each step's embedding is one Adam step
    # of its own learning rate away from it
    one = tnti.null_text_inversion(tpipe, t(traj), t(ctx), TNTIConfig(num_inner_steps=1, base_lr=LR), GS,
                                   added_cond={k: t(v) for k, v in added.items()})
    moved = (one - t(ctx)[:1]).abs().amax(dim=(1, 2))
    lrs = torch.tensor([LR * (1 - i / 100.0) for i in range(STEPS)])
    assert torch.allclose(moved, lrs, rtol=1e-3)


def test_xl_nti_uses_negative_pooled_embeds(pipes, inverted):
    """The unconditional evaluations run with the negative pooled embeds
    (zeros here), the conditional one with the prompt's: optimising with the
    split differs from using the prompt's on both branches
    (tests/test_xl_pipeline.py:79)."""
    _, tpipe = pipes
    traj, ctx, added = inverted
    added = {k: t(v) for k, v in added.items()}
    assert not added["uncond_text_embeds"].any() and added["text_embeds"].abs().max() > 0
    cond, uncond = tnti._split_added(added)
    assert sorted(cond) == sorted(uncond) == ["text_embeds", "time_ids"]
    assert uncond["text_embeds"] is added["uncond_text_embeds"] and uncond["time_ids"] is added["time_ids"]
    assert tnti._split_added(cond) == (cond, None) and tnti._split_added(None) == (None, None)
    cfg = TNTIConfig(num_inner_steps=2, base_lr=LR)
    split = tnti.null_text_inversion(tpipe, t(traj), t(ctx), cfg, GS, added_cond=added)
    both_cond = tnti.null_text_inversion(tpipe, t(traj), t(ctx), cfg, GS, added_cond=cond)
    assert torch.isfinite(split).all()
    assert (split - both_cond).abs().max() > 0


@pytest.mark.parametrize("method", ["p2p", "masactrl"])
def test_xl_cli_invert_null_text_matches_jax(pipes, method, monkeypatch):
    """``cli.invert`` threads the XL added conditions into NTI, with p2p's
    schedule 0.5·(1 - i/500) and the other methods' 5e-2·(1 - i/100)."""
    jpipe, tpipe = pipes
    monkeypatch.setattr(jcli, "nti_config_for", _short(jcli.nti_config_for, JNTIConfig))
    monkeypatch.setattr(tcli, "nti_config_for", _short(tcli.nti_config_for, TNTIConfig))
    lr = tcli.nti_config_for(method, tpipe).base_lr
    assert lr == (0.5 if method == "p2p" else 5e-2) == jcli.nti_config_for(method, jpipe).base_lr
    jlast, jtraj, jseq = jcli.invert(jpipe, IMAGE, PROMPT, "null-text", method, use_flash=False)
    tlast, ttraj, tseq = tcli.invert(tpipe, IMAGE, PROMPT, "null-text", method)
    np.testing.assert_allclose(n(ttraj), n(jtraj), atol=ATOL_LAT, rtol=0)
    np.testing.assert_allclose(n(tlast), n(jlast), atol=ATOL_LAT, rtol=0)
    assert tseq.shape == (STEPS, 77, 32) and torch.isfinite(tseq).all()
    np.testing.assert_allclose(n(tseq), n(jseq), atol=lr / 10, rtol=0)


def test_xl_nti_checkpointed_equals_plain_bit_for_bit(pipes, inverted):
    _, tpipe = pipes
    traj, ctx, added = inverted
    added = {k: t(v) for k, v in added.items()}
    runs = [tnti.null_text_inversion(tpipe, t(traj), t(ctx),
                                     TNTIConfig(num_inner_steps=2, base_lr=LR, remat=remat), GS, added_cond=added)
            for remat in (False, True, None)]  # None: the auto rule, off at latent side 16
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_xl_nti_counts_attention_calls_with_and_without_checkpointing(pipes, inverted, monkeypatch):
    """What a launch count on the card must read: per inner iteration the
    flash forward runs once per self-attention site, and once more per site
    with checkpointing (the recomputation); the backward runs at every site
    but the first, which no gradient reaches."""
    from image_editing_framework_torch.ops import flash_attention as tfa

    _, tpipe = pipes
    traj, ctx, added = inverted
    added = {k: t(v) for k, v in added.items()}
    sites = tpipe.unet.config.num_transformer_blocks
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa._forward, tfa.flash_attention_bwd
    monkeypatch.setattr(tfa, "_forward", lambda *a: (calls.__setitem__("fwd", calls["fwd"] + 1), fwd(*a))[1])
    monkeypatch.setattr(tfa, "flash_attention_bwd",
                        lambda *a: (calls.__setitem__("bwd", calls["bwd"] + 1), bwd(*a))[1])
    for remat, per_iteration in ((False, sites), (True, 2 * sites)):
        calls.update(fwd=0, bwd=0)
        before = tnti.null_text_inversion.inner_iterations
        tnti.null_text_inversion(tpipe, t(traj), t(ctx), TNTIConfig(num_inner_steps=2, base_lr=LR, remat=remat), GS,
                                 added_cond=added)
        j = tnti.null_text_inversion.inner_iterations - before
        assert j == 2 * STEPS
        assert calls["fwd"] == sites * 2 * STEPS + per_iteration * j, (remat, calls)
        assert calls["bwd"] == (sites - 1) * j, (remat, calls)
