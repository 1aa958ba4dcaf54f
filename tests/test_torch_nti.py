"""The null-text slice as a whole on the tiny pipeline: the port's NTI, the
NTI-driven P2P edit and ``cli.invert``, against the JAX package, with shared
weights, a shared image and shared prompts.

Both run in f32 on the CPU. The JAX side runs ``use_flash=False`` (its XLA
attention, the plain reference); tests/test_torch_flash_grad.py holds the
port's backward against the Pallas backward kernels in interpret mode, and
also holds there one NTI loss with its gradient and the resetting NTI
variant, so that the JAX NTI is compiled once in each file. The port's
self-attention gradient goes through its ``FlashAttention`` Function, here
the plain versions of the forward and backward kernels.

Tolerances: the embeddings within atol ``ATOL_EMB`` = 1e-3, a tenth of one
Adam step (lr 1e-2). Adam moves an element by lr · g / (|g| + 1e-8), so an
element whose gradient is within a few 1e-8 of 0 takes a step that depends
on its gradient's last digits: the frameworks' gradients differ by ~1e-6 of
max|g| (tests/test_torch_flash_grad.py), which moves such an element by up
to ~1e-4. Edit latents within atol 1e-3 and images within 1 uint8 level, as
tests/test_torch_pipeline.py.

A gradient element whose sign differed between the frameworks would move by
2·lr, twenty times the tolerance. ``check_grad_margin`` checks on the port's
gradients that no element lies within ``GRAD_MARGIN`` · max|g| (twice
Adam's 1e-8 here) of 0; with 2464 embedding elements a wider margin is not
to be had from any input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch import cli as tcli
from image_editing_framework_torch.core.config import NTIConfig as TNTIConfig
from image_editing_framework_torch.core.config import P2PConfig as TP2PConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.inversion import nti as tnti
from image_editing_framework_torch.methods import base as tbase
from image_editing_framework_torch.methods.p2p import p2p_edit as t_p2p_edit
from image_editing_framework_torch.methods.p2p import p2p_setup
from image_editing_framework_tpu import cli as jcli
from image_editing_framework_tpu.core.config import NTIConfig as JNTIConfig
from image_editing_framework_tpu.core.config import P2PConfig as JP2PConfig
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.methods import base as jbase
from image_editing_framework_tpu.methods import common as jcommon
from image_editing_framework_tpu.methods.p2p import p2p_edit as j_p2p_edit
from image_editing_framework_tpu.ops import controls as jctl
from image_editing_framework_tpu.ops import schedules as jsched
from torch_port_helpers import RecordingBlend, check_grad_margin, n, recorded_grads, shared_pipelines, t

STEPS = 4
INNER = 3
GS = 7.5
PROMPT = "a cat sitting on the grass"
PROMPTS = [PROMPT, "a dog sitting on the grass"]
BLEND = (("cat",), ("dog",))
IMAGE = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
ATOL_EMB = 1e-3
ATOL_LAT = 1e-3
BLEND_MARGIN = 1e-3


@pytest.fixture(scope="module")
def pipes():
    return shared_pipelines(num_steps=STEPS)


def _nti_config(cfg_cls):
    """``nti_config_for`` with 3 inner iterations, for both frameworks' ``cli``."""
    return lambda method, pipe: cfg_cls(num_inner_steps=INNER)


@pytest.fixture(scope="module")
def jax_runs(pipes):
    """JAX ``cli.invert`` of IMAGE for every inversion type (null-text with 3
    inner iterations) and the context, as numpy."""
    jpipe, _ = pipes
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "nti_config_for", _nti_config(JNTIConfig))
        for kind in ("ddim", "null-text", "direct"):
            runs[kind] = tuple(None if x is None else np.asarray(x)
                               for x in jcli.invert(jpipe, IMAGE, PROMPT, kind, "p2p", use_flash=False))
    runs["ctx"] = np.asarray(jpipe.encode_prompts([PROMPT])[0])
    return runs


@pytest.fixture(scope="module")
def inverted(jax_runs):
    """(last, trajectory, context) of the JAX DDIM inversion."""
    last, traj, _ = jax_runs["ddim"]
    return last, traj, jax_runs["ctx"]


def test_null_text_inversion_matches_jax(pipes, inverted, jax_runs, monkeypatch):
    _, tpipe = pipes
    _, traj, ctx = inverted
    grads = recorded_grads(monkeypatch)
    before = tnti.null_text_inversion.inner_iterations
    seq = tnti.null_text_inversion(tpipe, t(traj), t(ctx), TNTIConfig(num_inner_steps=INNER), GS)
    monkeypatch.undo()
    assert tnti.null_text_inversion.inner_iterations - before == STEPS * INNER  # random weights: no early stop
    check_grad_margin(grads, STEPS * INNER)
    assert seq.shape == (STEPS, 77, ctx.shape[-1]) and seq.dtype == torch.float32
    np.testing.assert_allclose(n(seq), jax_runs["null-text"][2], atol=ATOL_EMB, rtol=0)
    # the optimisation moved the embedding by far more than the tolerance
    assert np.abs(jax_runs["null-text"][2] - ctx[:1]).max() > 10 * ATOL_EMB


def test_nti_takes_bf16_inputs_and_returns_f32(pipes, inverted):
    """Production pipelines run bf16; NTI promotes the trajectory and the
    embeddings to f32 (mirrors tests/test_pipeline.py:100)."""
    _, tpipe = pipes
    _, traj, ctx = inverted
    seq = tnti.null_text_inversion(tpipe, t(traj).to(torch.bfloat16), t(ctx).to(torch.bfloat16),
                                   TNTIConfig(num_inner_steps=2), GS)
    assert seq.dtype == torch.float32 and seq.shape == (STEPS, 77, ctx.shape[-1])
    assert torch.isfinite(seq).all()


def test_nti_refuses_what_later_slices_bring(pipes, inverted):
    """Nothing of ``null_text_inversion`` is refused any more: a checkpointed
    UNet (``remat=True``) gives the plain one's embeddings bit for bit, and
    an SD pipeline ignores added conditions as the JAX UNet does. An unknown
    inversion type is still an error."""
    _, tpipe = pipes
    _, traj, ctx = inverted
    cfg = TNTIConfig(num_inner_steps=2)
    plain = tnti.null_text_inversion(tpipe, t(traj), t(ctx), cfg)
    assert torch.equal(tnti.null_text_inversion(tpipe, t(traj), t(ctx), TNTIConfig(num_inner_steps=2, remat=True)),
                       plain)
    assert torch.equal(tnti.null_text_inversion(tpipe, t(traj), t(ctx), cfg, added_cond={"text_embeds": t(ctx)}),
                       plain)
    with pytest.raises(ValueError, match="inversion type"):
        tcli.invert(tpipe, IMAGE, PROMPT, "negative-prompt", "p2p")


@pytest.mark.parametrize("mode", ["uncond_seq", "source_replay"])
def test_p2p_edit_with_inversion_outputs_matches_jax(pipes, inverted, jax_runs, mode):
    """The edit with NTI's per-step unconditional embeddings, or with the
    source branch replaying the inversion trajectory (direct inversion),
    from one shared start latent: latents and images against JAX."""
    jpipe, tpipe = pipes
    last, traj, _ = inverted
    extra = {"uncond_seq": jax_runs["null-text"][2]} if mode == "uncond_seq" else {"source_replay": traj}

    jcfg = JP2PConfig(blend_words=BLEND)
    alpha = jsched.blend_alpha_layers(PROMPTS, BLEND, jpipe.tokenizer)
    jblend = jbase.LocalBlend(jnp.asarray(alpha), threshold=jcfg.blend_threshold)
    jctrl = jctl.build_p2p_control(PROMPTS, jpipe.tokenizer, STEPS, jcfg, True)
    jctx, _ = jcommon.prepare_conditioning(jpipe, PROMPTS, 32, 32)
    jfinal, _ = jbase.denoise(jpipe, jcommon.expand_latent(jnp.asarray(last), 2), jctx, jctrl, blend=jblend,
                              use_flash=False, **{k: jnp.asarray(v) for k, v in extra.items()})

    sampler = TSampler(height=32, width=32)
    lat0, context, ctrl, blend, _ = p2p_setup(tpipe, PROMPTS, t(last), TP2PConfig(blend_words=BLEND), sampler)
    blend = RecordingBlend(blend.alpha_layers, blend.threshold)
    textra = {k: t(v) for k, v in extra.items()}
    tfinal = tbase.denoise(tpipe, lat0, context, ctrl, guidance_scale=sampler.guidance_scale, blend=blend, **textra)
    assert len(blend.gaps) == STEPS and min(blend.gaps) > BLEND_MARGIN, blend.gaps
    np.testing.assert_allclose(n(tfinal), n(jfinal), atol=ATOL_LAT, rtol=0)
    plain = tbase.denoise(tpipe, lat0, context, ctrl, guidance_scale=sampler.guidance_scale, blend=blend)
    assert not torch.allclose(tfinal, plain, atol=100 * ATOL_LAT)  # the option changed the edit

    jimg = j_p2p_edit(jpipe, PROMPTS, jnp.asarray(last), jcfg, JSampler(height=32, width=32), use_flash=False,
                      **{k: jnp.asarray(v) for k, v in extra.items()})
    timg = t_p2p_edit(tpipe, PROMPTS, t(last), TP2PConfig(blend_words=BLEND), sampler, **textra)
    assert timg.shape == (2, 32, 32, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1


@pytest.mark.parametrize("inversion_type", ["ddim", "null-text", "direct"])
def test_cli_invert_matches_jax(pipes, jax_runs, inversion_type, monkeypatch):
    """``cli.invert`` from the image for each inversion type, against JAX
    ``cli.invert`` (run once, in the ``jax_runs`` fixture). Both sides'
    ``nti_config_for`` give 3 inner iterations; the default schedules are
    compared in ``test_nti_config_for_matches_jax``."""
    _, tpipe = pipes
    monkeypatch.setattr(tcli, "nti_config_for", _nti_config(TNTIConfig))
    jlast, jtraj, jseq = jax_runs[inversion_type]
    tlast, ttraj, tseq = tcli.invert(tpipe, IMAGE, PROMPT, inversion_type, "p2p")
    assert ttraj.shape == (STEPS + 1, 1, 16, 16, 4)
    np.testing.assert_allclose(n(ttraj), jtraj, atol=ATOL_LAT, rtol=0)
    np.testing.assert_allclose(n(tlast), jlast, atol=ATOL_LAT, rtol=0)
    if inversion_type == "null-text":
        np.testing.assert_allclose(n(tseq), jseq, atol=ATOL_EMB, rtol=0)
    else:
        assert tseq is None and jseq is None


def test_nti_config_for_matches_jax(pipes):
    jpipe, tpipe = pipes

    class XL:
        model_type = "xl"

    for method in ("p2p", "masactrl"):
        for jp, tp in ((jpipe, tpipe), (XL(), XL())):
            jc, tc = jcli.nti_config_for(method, jp), tcli.nti_config_for(method, tp)
            assert (tc.num_inner_steps, tc.epsilon, tc.base_lr, tc.lr_decay_span, tc.remat) == (
                jc.num_inner_steps, jc.epsilon, jc.base_lr, jc.lr_decay_span, jc.remat)
    assert tcli.GUIDANCE_SCALE == jcli.GUIDANCE_SCALE
