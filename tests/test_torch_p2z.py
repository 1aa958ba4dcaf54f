"""pix2pix-zero in the port against the JAX package on the tiny SD pipeline:
the configuration, the recording controls (``P2ZControl``, the attention
store), ``denoise``'s per-step records and trajectory, one guided step's
gradient and the whole guided pass with the JAX references injected, and
``p2z_edit`` in each of its modes; then the port's own invariants: the
recomputed references equal the recorded ones bit for bit, and every
self-attention site, the first included, gets a gradient.

Both run in f32 on the CPU; the JAX side runs ``use_flash=False`` (its XLA
attention, the plain reference of its Pallas kernel), the port's
self-attention gradient goes through its ``FlashAttention`` Function, here
the plain versions of the kernels.

Tolerances. ``P2ZStep`` stores the maps in bf16: a map that differs by an
f32 rounding error between the frameworks can round to the neighbouring
bf16 value, so records agree within one bf16 step (2^-7 of the value) and
no more than 0.1% of them differ at all. The gradient with the same
references: 1e-4 · max|g|. The guided pass with the same references:
latents (of magnitude ~20 after 4 steps) atol 2e-4. The whole edit, each
framework with its own references: latents atol 1e-3 (the bf16 references
add a gradient difference of a few bf16 steps), images within 1 uint8
level. The guided-pass test checks that a pass without the guidance
lands more than 10x its limit away, so the limit sees the guidance.

The tiny tokenizer numbers words in the order it first sees them, so the
module's pipelines get the prompts' words in one order first
(``fix_vocab``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.config import P2ZConfig as TP2ZConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.methods import base as tbase
from image_editing_framework_torch.methods import common as tcommon
from image_editing_framework_torch.methods import p2z as tp2z
from image_editing_framework_torch.ops import attention as tatt
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_torch.ops import flash_attention as tfa
from image_editing_framework_tpu.core.config import P2ZConfig as JP2ZConfig
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.methods import base as jbase
from image_editing_framework_tpu.methods import common as jcommon
from image_editing_framework_tpu.methods import p2z as jp2z
from image_editing_framework_tpu.ops import attention as jatt
from image_editing_framework_tpu.ops import controls as jctl
from torch_port_helpers import fix_vocab, n, shared_pipelines, t

STEPS = 4
GS = 7.5
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]
BF16_STEP = 2.0**-7  # spacing of bf16 values, relative to the value
ATOL_GUIDED = 2e-4
ATOL_EDIT = 1e-3
GRAD_RTOL = 1e-4


def _latent(seed=0):
    return np.random.RandomState(seed).randn(1, 16, 16, 4).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    pair = shared_pipelines(num_steps=STEPS)
    fix_vocab(pair, PROMPTS)
    return pair


@pytest.fixture(scope="module")
def jax_pass1(pipes):
    """The JAX pass 1 of ``_latent()`` under the source prompt: (final
    latent, records per site (S, 2, H, N, 77) bf16, trajectory (S, 1, h,
    w, 4)), as numpy (the records as f32)."""
    jpipe, _ = pipes
    ctx, _ = jcommon.prepare_conditioning(jpipe, [PROMPTS[0]], 32, 32)
    final, rec, traj = jbase.denoise(jpipe, jnp.asarray(_latent()), ctx, jctl.P2ZControl(), GS, use_flash=False,
                                     collect_records=True, collect_trajectory=True)
    return np.asarray(final), {k: np.asarray(v.astype(jnp.float32)) for k, v in rec.items()}, np.asarray(traj)


def _check_records(got, ref):
    """bf16 records: equal but for elements one bf16 step apart."""
    assert sorted(got) == sorted(ref)
    for k in ref:
        a, b = n(got[k].float()), ref[k]
        assert a.shape == b.shape, k
        assert np.all(np.abs(a - b) <= BF16_STEP * np.abs(b) + 1e-30), k
        assert (a != b).mean() < 1e-3, (k, (a != b).mean())


def test_p2z_config_defaults_equal():
    fields = [f.name for f in dataclasses.fields(JP2ZConfig)]
    assert [f.name for f in dataclasses.fields(TP2ZConfig)] == fields
    for name in fields:
        assert getattr(TP2ZConfig(), name) == getattr(JP2ZConfig(), name), name
    assert (TP2ZConfig().guidance_amount, TP2ZConfig().recompute_refs, TP2ZConfig().remat_grad) == (0.1, False, None)


def test_p2z_record_keys_and_dtype():
    """As the JAX package's tests/test_controls.py test_p2z_record_keys:
    cross sites only, maps stored in bf16."""
    for mod, ones, bf16 in ((tctl, torch.ones, torch.bfloat16), (jctl, jnp.ones, jnp.bfloat16)):
        att = tatt if mod is tctl else jatt
        step = mod.P2ZControl().at_step(0)
        cross = att.AttnSite(layer=3, place="down", seq_len=1024, is_cross=True)
        selfa = att.AttnSite(layer=3, place="down", seq_len=1024, is_cross=False)
        assert step.record_key(cross) == cross.key and step.record_key(selfa) is None
        assert step.record(cross, ones((2, 8, 1024, 77))).dtype == bf16
    assert isinstance(tctl.P2ZControl().at_step(7), tctl.P2ZStep)


@pytest.mark.parametrize("max_seq", [1024, 64])
def test_attention_store_and_average_match_jax(pipes, max_seq):
    """``AttentionStoreControl`` records the head-averaged maps of the
    sites up to ``max_seq`` tokens each step; ``average_attention``
    averages them over the steps. f32 maps: atol 1e-5 (the latents drift
    by ~1e-6 over the 4 steps)."""
    jpipe, tpipe = pipes
    jctx, _ = jcommon.prepare_conditioning(jpipe, PROMPTS, 32, 32)
    tctx, _ = tcommon.prepare_conditioning(tpipe, PROMPTS, 32, 32)
    lat = np.repeat(_latent(1), 2, axis=0)
    _, jrec = jbase.denoise(jpipe, jnp.asarray(lat), jctx, jctl.AttentionStoreControl(max_seq=max_seq), GS,
                            use_flash=False, collect_records=True)
    _, trec, _ = tbase.denoise(tpipe, t(lat), tctx, tctl.AttentionStoreControl(max_seq=max_seq), GS,
                               collect_records=True)
    assert sorted(trec) == sorted(jrec) and len(trec) == (4 if max_seq == 1024 else 1)
    for got, ref in ((trec, jrec), (tctl.average_attention(trec), jctl.average_attention(jrec))):
        for k in ref:
            assert got[k].dtype == torch.float32 and tuple(got[k].shape) == ref[k].shape
            np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), atol=1e-5, rtol=0, err_msg=k)
    assert tuple(trec[sorted(trec)[0]].shape[:2]) == (STEPS, 4)


def test_denoise_collects_records_and_trajectory_as_jax(pipes, jax_pass1):
    """``denoise(collect_records=True)`` returns (latents, records, None)
    and with ``collect_trajectory=True`` (latents, None, trajectory), the
    UNet input latent of each step; without either flag the final latents
    alone, as before."""
    jfinal, jrec, jtraj = jax_pass1
    _, tpipe = pipes
    ctx, _ = tcommon.prepare_conditioning(tpipe, [PROMPTS[0]], 32, 32)
    final, rec, no_traj = tbase.denoise(tpipe, t(_latent()), ctx, tctl.P2ZControl(), GS, collect_records=True)
    assert no_traj is None
    _check_records(rec, jrec)
    assert all(v.dtype == torch.bfloat16 and v.shape[:2] == (STEPS, 2) for v in rec.values())
    np.testing.assert_allclose(n(final), jfinal, atol=1e-4, rtol=0)
    final2, none, traj = tbase.denoise(tpipe, t(_latent()), ctx, None, GS, collect_trajectory=True)
    assert none is None and traj.shape == (STEPS, 1, 16, 16, 4)
    np.testing.assert_array_equal(n(traj[0]), _latent())  # the entry latent of step 0
    np.testing.assert_allclose(n(traj), jtraj, atol=1e-4, rtol=0)
    plain = tbase.denoise(tpipe, t(_latent()), ctx, None, GS)
    assert isinstance(plain, torch.Tensor) and torch.equal(plain, final2)


def test_trajectory_is_taken_after_the_replay(pipes):
    """With ``source_replay`` the trajectory holds the replayed latent that
    entered each step (JAX ``lat_entry``), as the JAX package returns it."""
    jpipe, tpipe = pipes
    rng = np.random.RandomState(2)
    lat = rng.randn(2, 16, 16, 4).astype(np.float32)
    replay = rng.randn(STEPS + 1, 1, 16, 16, 4).astype(np.float32)
    jctx, _ = jcommon.prepare_conditioning(jpipe, PROMPTS, 32, 32)
    tctx, _ = tcommon.prepare_conditioning(tpipe, PROMPTS, 32, 32)
    _, _, jtraj = jbase.denoise(jpipe, jnp.asarray(lat), jctx, None, GS, source_replay=jnp.asarray(replay),
                                use_flash=False, collect_trajectory=True)
    _, _, ttraj = tbase.denoise(tpipe, t(lat), tctx, None, GS, source_replay=t(replay), collect_trajectory=True)
    for i in range(STEPS):
        np.testing.assert_array_equal(n(ttraj[i, 0]), replay[STEPS - i, 0])
    np.testing.assert_allclose(n(ttraj), np.asarray(jtraj), atol=1e-4, rtol=0)


def _jax_guidance_gradient(jpipe, x, i, ctx, ref):
    """The JAX package's guided-step loss (methods/p2z.py ``attn_loss``) and
    its gradient with respect to ``x``, against the references ``ref``."""
    step = jctl.P2ZStep()

    def attn_loss(x_in):
        _, rec = jpipe.unet.apply(jpipe.unet_params, x_in, jpipe.scheduler.timesteps[i], ctx, step, None, False)
        loss = 0.0
        for k, cur in rec.items():
            d = cur.astype(jnp.float32) - ref[k].astype(jnp.float32)
            loss += jnp.square(d).sum(axis=(2, 3)).mean()
        return loss

    return jax.value_and_grad(attn_loss)(jnp.asarray(x))


@pytest.mark.parametrize("i", [0, 2])
def test_guided_step_gradient_with_jax_refs_matches_jax(pipes, jax_pass1, i):
    """One guided step's loss and gradient, both frameworks against the JAX
    pass 1's bf16 references of step i, on a CFG pair whose halves differ."""
    jpipe, tpipe = pipes
    _, jrec, _ = jax_pass1
    ref = {k: v[i] for k, v in jrec.items()}
    x = np.random.RandomState(3 + i).randn(2, 16, 16, 4).astype(np.float32)
    jctx, _ = jcommon.prepare_conditioning(jpipe, [PROMPTS[1]], 32, 32)
    tctx, _ = tcommon.prepare_conditioning(tpipe, [PROMPTS[1]], 32, 32)
    jl, jg = _jax_guidance_gradient(jpipe, x, i, jctx, {k: jnp.asarray(v, jnp.bfloat16) for k, v in ref.items()})
    tl, tg = tp2z.guidance_gradient(tpipe.unet, t(x), int(tpipe.scheduler.timesteps[i]), tctx,
                                    {k: t(v).to(torch.bfloat16) for k, v in ref.items()})
    jg = np.asarray(jg)
    assert tg.shape == (2, 16, 16, 4) and tg.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(n(tg), jg, atol=GRAD_RTOL * np.abs(jg).max(), rtol=0)
    assert np.abs(jg[0] - jg[1]).max() > 0.1 * np.abs(jg).max()  # the halves get different gradients


@pytest.mark.parametrize("with_uncond", [False, True])
def test_guided_scan_with_jax_refs_matches_jax(pipes, jax_pass1, with_uncond):
    """The whole pass 2 (guided SGD step, eps on the updated pair, its first
    half advanced) with the JAX references injected into both, with and
    without per-step NTI embeddings."""
    jpipe, tpipe = pipes
    _, jrec, _ = jax_pass1
    uncond = (np.random.RandomState(5).randn(STEPS, 77, 32) * 0.5).astype(np.float32) if with_uncond else None
    jctx, _ = jcommon.prepare_conditioning(jpipe, [PROMPTS[1]], 32, 32)
    tctx, _ = tcommon.prepare_conditioning(tpipe, [PROMPTS[1]], 32, 32)
    jfinal = jp2z._guided_scan(jpipe.unet, jpipe.unet_params, jpipe.scheduler, jnp.asarray(_latent()), jctx,
                               {k: jnp.asarray(v, jnp.bfloat16) for k, v in jrec.items()}, jnp.float32(GS),
                               jnp.float32(0.1), None, None if uncond is None else jnp.asarray(uncond), False)
    tfinal, losses = tp2z._guided_scan(tpipe.unet, tpipe.scheduler, t(_latent()), tctx,
                                       {k: t(v).to(torch.bfloat16) for k, v in jrec.items()}, GS, 0.1,
                                       uncond_seq=None if uncond is None else t(uncond))
    assert losses.shape == (STEPS,) and torch.isfinite(losses).all() and (losses > 0).all()
    np.testing.assert_allclose(n(tfinal), np.asarray(jfinal), atol=ATOL_GUIDED, rtol=0)
    # the limit sees the guidance: the same pass without it lands well outside
    unguided, _ = tp2z._guided_scan(tpipe.unet, tpipe.scheduler, t(_latent()), tctx,
                                    {k: t(v).to(torch.bfloat16) for k, v in jrec.items()}, GS, 0.0,
                                    uncond_seq=None if uncond is None else t(uncond))
    assert np.abs(n(unguided) - np.asarray(jfinal)).max() > 10 * ATOL_GUIDED


def _record_finals(monkeypatch, module, name):
    """The final latent each call of ``module.name`` returns from now on."""
    seen, real = [], getattr(module, name)

    def recording(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[0] if isinstance(out, tuple) else out)
        return out

    monkeypatch.setattr(module, name, recording)
    return seen


@pytest.mark.parametrize("mode", ["recorded", "recompute_refs", "uncond_seq", "edit_dir", "only_sample"])
def test_p2z_edit_matches_jax(pipes, monkeypatch, mode):
    """``p2z_edit``, each framework with its own pass 1: the reconstruction
    and the edit, final latents and images."""
    jpipe, tpipe = pipes
    rng = np.random.RandomState(6)
    kw = {}
    if mode == "uncond_seq":
        kw["uncond_seq"] = (rng.randn(STEPS, 77, 32) * 0.5).astype(np.float32)
    elif mode == "edit_dir":
        kw["edit_dir"] = (rng.randn(77, 32) * 0.5).astype(np.float32)
    elif mode == "only_sample":
        kw["only_sample"] = True
    recompute = mode == "recompute_refs"
    jfin, tfin = _record_finals(monkeypatch, jp2z, "_guided_scan"), _record_finals(monkeypatch, tp2z, "_guided_scan")
    jsrc, tsrc = _record_finals(monkeypatch, jp2z, "denoise"), _record_finals(monkeypatch, tp2z, "denoise")
    jrec, jedit = jp2z.p2z_edit(jpipe, PROMPTS, jnp.asarray(_latent()), JP2ZConfig(recompute_refs=recompute),
                                JSampler(height=32, width=32), use_flash=False,
                                **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    trec, tedit = tp2z.p2z_edit(tpipe, PROMPTS, t(_latent()), TP2ZConfig(recompute_refs=recompute),
                                TSampler(height=32, width=32),
                                **{k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    np.testing.assert_allclose(n(tsrc[0]), n(jsrc[0]), atol=1e-4, rtol=0)
    assert trec.shape == (1, 32, 32, 3) and trec.dtype == np.uint8
    assert np.abs(trec.astype(int) - np.asarray(jrec).astype(int)).max() <= 1
    if mode == "only_sample":
        assert tedit is None and jedit is None and not tfin and not jfin
        return
    assert torch.isfinite(tfin[0]).all()
    np.testing.assert_allclose(n(tfin[0]), n(jfin[0]), atol=ATOL_EDIT, rtol=0)
    assert tedit.shape == (1, 32, 32, 3) and tedit.dtype == np.uint8
    assert np.abs(tedit.astype(int) - np.asarray(jedit).astype(int)).max() <= 1
    assert np.abs(n(tfin[0]) - n(tsrc[0])).max() > 0.1  # the edit moved the latent away from pass 1's


def test_recompute_refs_equals_recorded_refs(pipes, monkeypatch):
    """Rematerialising each step's references from pass 1's trajectory
    gives the recorded references' bits: the same losses and the same
    final latent, with and without NTI embeddings."""
    _, tpipe = pipes
    uncond = t((np.random.RandomState(7).randn(STEPS, 77, 32) * 0.5).astype(np.float32))
    seen, real = [], tp2z._guided_scan
    monkeypatch.setattr(tp2z, "_guided_scan", lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1])
    for kw in ({}, {"uncond_seq": uncond}):
        seen.clear()
        images = [tp2z.p2z_edit(tpipe, PROMPTS, t(_latent()), TP2ZConfig(recompute_refs=r),
                                TSampler(height=32, width=32), **kw) for r in (False, True)]
        (lat0, loss0), (lat1, loss1) = seen
        assert torch.equal(lat0, lat1) and torch.equal(loss0, loss1)
        np.testing.assert_array_equal(images[0][1], images[1][1])


@pytest.mark.parametrize("recompute", [False, True])
def test_guided_step_counts_attention_calls(pipes, monkeypatch, recompute):
    """What a launch count on the card must read, per guided step: the flash
    forward once per self-attention site for the gradient and once for the
    noise (once more with recomputed references), and the backward at
    every site, the first included (the gradient flows to the input
    latent)."""
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
    ctx_src, _ = tcommon.prepare_conditioning(tpipe, [PROMPTS[0]], 32, 32)
    ctx, _ = tcommon.prepare_conditioning(tpipe, [PROMPTS[1]], 32, 32)
    _, refs, traj = tbase.denoise(tpipe, t(_latent()), ctx_src, tctl.P2ZControl(), GS, collect_records=True,
                                  collect_trajectory=True)
    calls["fwd"] = 0
    kw = dict(src_traj=traj, ctx_src=ctx_src) if recompute else {}
    tp2z._guided_scan(tpipe.unet, tpipe.scheduler, t(_latent()), ctx, None if recompute else refs, GS, 0.1, **kw)
    assert calls["fwd"] == STEPS * sites * (3 if recompute else 2), calls
    assert calls["bwd"] == STEPS * sites and calls["bwd_batches"] == {2}, calls
