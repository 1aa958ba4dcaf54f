"""pix2pix-zero on the tiny XL pipeline, the port against the JAX package:
``cli.invert(..., "ddim", "p2z")`` then ``cli.run_method("p2z", ...)`` with
the XL default (the references recomputed from pass 1's trajectory) and
with the checkpointed UNet forced on, as at 1024²; the checkpointed
gradient equals the plain one bit for bit, also where the loss sits on the
maps that a checkpointed block returns; and the launches a guided step
makes with both.

Both run in f32 on the CPU; the JAX side runs ``use_flash=False`` (its XLA
attention). Tolerances as tests/test_torch_p2z.py: final latents atol
1e-3, images within 1 uint8 level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch import cli as tcli
from image_editing_framework_torch.core.config import P2ZConfig as TP2ZConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.methods import base as tbase
from image_editing_framework_torch.methods import common as tcommon
from image_editing_framework_torch.methods import p2z as tp2z
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_torch.ops import flash_attention as tfa
from image_editing_framework_tpu import cli as jcli
from image_editing_framework_tpu.core.config import P2ZConfig as JP2ZConfig
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.methods import p2z as jp2z
from torch_port_helpers import fix_vocab, n, shared_pipelines, t

STEPS = 3
GS = 7.5
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]
IMAGE = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
ATOL = 1e-3


@pytest.fixture(scope="module")
def pipes():
    pair = shared_pipelines(num_steps=STEPS, model_type="xl")
    fix_vocab(pair, PROMPTS)
    return pair


def test_nti_config_for_p2z():
    """p2z's null-text inversion schedule: 5e-2 · (1 − i/100) on XL (the
    masactrl/pnp/p2z variant, not p2p's 0.5 · (1 − i/500)), 1e-2 on SD;
    the JAX package's."""
    for model_type, lr in (("xl", 5e-2), ("sd", 1e-2)):
        pipe = type("Pipe", (), {"model_type": model_type})()
        cfg = tcli.nti_config_for("p2z", pipe)
        assert (cfg.base_lr, cfg.lr_decay_span) == (lr, 100.0)
        ref = jcli.nti_config_for("p2z", pipe)
        assert (cfg.base_lr, cfg.lr_decay_span, cfg.num_inner_steps) == (ref.base_lr, ref.lr_decay_span,
                                                                          ref.num_inner_steps)


def _recording(monkeypatch, module):
    """Each call of ``module._guided_scan`` from now on: (final latent,
    whether it got recorded references)."""
    seen, real = [], module._guided_scan
    refs_at = 5 if module is jp2z else 4  # the JAX function takes the params second

    def recording(*args, **kw):
        out = real(*args, **kw)
        seen.append((out[0] if isinstance(out, tuple) else out, args[refs_at] is not None))
        return out

    monkeypatch.setattr(module, "_guided_scan", recording)
    return seen


@pytest.mark.parametrize("config", [None, "checkpointed"])
def test_run_method_p2z_on_xl_matches_jax(pipes, monkeypatch, config):
    """The user entry points: DDIM inversion for p2z, then the edit with
    the XL default configuration (``recompute_refs``; the checkpointed UNet
    by the auto rule only at latent side 128, so forced here in the second
    case)."""
    jpipe, tpipe = pipes
    jkw = {"use_flash": False}
    tkw = {}
    if config == "checkpointed":
        jkw["config"] = JP2ZConfig(recompute_refs=True, remat_grad=True)
        tkw["config"] = TP2ZConfig(recompute_refs=True, remat_grad=True)
    jlast, _, jseq = jcli.invert(jpipe, IMAGE, PROMPTS[0], "ddim", "p2z", use_flash=False)
    tlast, _, tseq = tcli.invert(tpipe, IMAGE, PROMPTS[0], "ddim", "p2z")
    assert jseq is None and tseq is None
    np.testing.assert_allclose(n(tlast), n(jlast), atol=ATOL, rtol=0)
    jseen, tseen = _recording(monkeypatch, jp2z), _recording(monkeypatch, tp2z)
    jout = jcli.run_method("p2z", jpipe, PROMPTS, jlast, JSampler(height=32, width=32), method_kwargs=jkw)
    tout = tcli.run_method("p2z", tpipe, PROMPTS, t(n(jlast)), TSampler(height=32, width=32), method_kwargs=tkw)
    assert [recorded for _, recorded in tseen] == [recorded for _, recorded in jseen] == [False]
    np.testing.assert_allclose(n(tseen[0][0]), n(jseen[0][0]), atol=ATOL, rtol=0)
    for a, b in zip(tout, jout):
        assert a.shape == (32, 32, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1


def test_p2z_edit_on_xl_with_nti_embeddings_matches_jax(pipes, monkeypatch):
    """Recorded references, per-step unconditional embeddings swapped into
    the context of both passes (the added conditions stay those of the
    prompts, as in the JAX package)."""
    jpipe, tpipe = pipes
    rng = np.random.RandomState(1)
    latent = rng.randn(1, 16, 16, 4).astype(np.float32)
    uncond = (rng.randn(STEPS, 77, 32) * 0.5).astype(np.float32)
    jseen, tseen = _recording(monkeypatch, jp2z), _recording(monkeypatch, tp2z)
    jimgs = jp2z.p2z_edit(jpipe, PROMPTS, jnp.asarray(latent), JP2ZConfig(), JSampler(height=32, width=32),
                          uncond_seq=jnp.asarray(uncond), use_flash=False)
    timgs = tp2z.p2z_edit(tpipe, PROMPTS, t(latent), TP2ZConfig(), TSampler(height=32, width=32), uncond_seq=t(uncond))
    np.testing.assert_allclose(n(tseen[0][0]), n(jseen[0][0]), atol=ATOL, rtol=0)
    for a, b in zip(timgs, jimgs):
        assert a.shape == (1, 32, 32, 3) and np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1


def test_checkpointed_gradient_equals_plain_bit_for_bit(pipes, monkeypatch):
    """The loss sits on the cross-attention maps that each checkpointed
    block returns (NTI's sits on the noise alone): the checkpointed UNet
    gives the plain one's gradient and loss bit for bit (the JAX package's
    tests/test_grad_remat.py holds its remat twin so), and so the whole
    edit's final latent."""
    _, tpipe = pipes
    rng = np.random.RandomState(2)
    x = t(rng.randn(2, 16, 16, 4).astype(np.float32))
    ctx_src, added_src = tcommon.prepare_conditioning(tpipe, [PROMPTS[0]], 32, 32)
    ctx, added = tcommon.prepare_conditioning(tpipe, [PROMPTS[1]], 32, 32)
    _, refs, _ = tbase.denoise(tpipe, x[:1], ctx_src, tctl.P2ZControl(), GS, added_cond=added_src,
                               collect_records=True)
    ref = {k: v[1] for k, v in refs.items()}
    t1 = int(tpipe.scheduler.timesteps[1])
    plain = tp2z.guidance_gradient(tcommon.grad_unet(tpipe, 16, False), x, t1, ctx, ref, added)
    remat = tp2z.guidance_gradient(tcommon.grad_unet(tpipe, 16, True), x, t1, ctx, ref, added)
    assert torch.equal(plain[0], remat[0]) and torch.equal(plain[1], remat[1])
    assert plain[1].abs().max() > 0
    seen = _recording(monkeypatch, tp2z)
    for r in (False, True):
        tp2z.p2z_edit(tpipe, PROMPTS, x[:1], TP2ZConfig(remat_grad=r), TSampler(height=32, width=32))
    assert torch.equal(seen[0][0], seen[1][0])


def test_xl_guided_step_counts_attention_calls_when_checkpointed(pipes, monkeypatch):
    """The XL default at 1024²: recomputed references and the checkpointed
    UNet. Per guided step the flash forward runs four times per site (the
    references, the gradient's forward, its recomputation in the backward
    pass, the noise) and the backward once per site, the first included,
    at the CFG pair's batch of 2."""
    _, tpipe = pipes
    sites = tpipe.unet.config.num_transformer_blocks
    calls = {"fwd": 0, "bwd": 0, "bwd_batches": set()}
    fwd, bwd = tfa._forward, tfa.flash_attention_bwd

    def counting_bwd(*a):
        calls["bwd"] += 1
        calls["bwd_batches"].add(a[0].shape[0])
        return bwd(*a)

    monkeypatch.setattr(tfa, "_forward", lambda *a: (calls.__setitem__("fwd", calls["fwd"] + 1), fwd(*a))[1])
    monkeypatch.setattr(tfa, "flash_attention_bwd", counting_bwd)
    latent = t(np.random.RandomState(3).randn(1, 16, 16, 4).astype(np.float32))
    tp2z.p2z_edit(tpipe, PROMPTS, latent, TP2ZConfig(recompute_refs=True, remat_grad=True),
                  TSampler(height=32, width=32))
    # pass 1 (one forward a step), then pass 2
    assert calls["fwd"] == STEPS * sites * (1 + 4), calls
    assert calls["bwd"] == STEPS * sites and calls["bwd_batches"] == {2}, calls
