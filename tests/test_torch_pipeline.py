"""The slice as a whole: real-image DDIM inversion + P2P replace edit with
LocalBlend on the tiny pipeline, JAX against the port, with shared weights,
a shared start latent and shared prompts.

Both run in f32 on the CPU; the JAX UNet runs its Pallas flash kernels in
interpret mode, the port its flash kernel's plain version. Tolerances: the
inversion trajectory step by step and the final edit latents within
atol 1e-3 (4 steps of f32 UNet differences, amplified by the DDIM
coefficients at high timesteps); decoded uint8 images within 1 level.

LocalBlend thresholds its normalised word mask at 0.3, so a mask value near
0.3 could flip between frameworks and change the result by far more than
rounding. The prompts and seeds below leave every mask value of every step
at least 1e-3 away from the threshold; the test checks that margin on the
port's masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.config import P2PConfig as TP2PConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.inversion.ddim import ddim_invert as t_invert
from image_editing_framework_torch.methods import base as tbase
from image_editing_framework_torch.methods.p2p import p2p_edit as t_p2p_edit
from image_editing_framework_torch.methods.p2p import p2p_setup
from image_editing_framework_tpu.core.config import P2PConfig as JP2PConfig
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.inversion.ddim import ddim_invert as j_invert
from image_editing_framework_tpu.methods import base as jbase
from image_editing_framework_tpu.methods import common as jcommon
from image_editing_framework_tpu.methods.p2p import p2p_edit as j_p2p_edit
from image_editing_framework_tpu.ops import controls as jctl
from image_editing_framework_tpu.ops import schedules as jsched
from torch_port_helpers import RecordingBlend, n, shared_pipelines, t

STEPS = 4
ATOL = 1e-3
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]
BLEND = (("cat",), ("dog",))
MARGIN = 1e-3


@pytest.fixture(scope="module")
def pipes():
    return shared_pipelines(num_steps=STEPS)


def _jax_edit_latents(jpipe, latent):
    """The JAX p2p_edit up to its final latents (methods/p2p.py:36-59)."""
    cfg = JP2PConfig(blend_words=BLEND)
    alpha = jsched.blend_alpha_layers(PROMPTS, cfg.blend_words, jpipe.tokenizer)
    blend = jbase.LocalBlend(jnp.asarray(alpha), threshold=cfg.blend_threshold)
    ctrl = jctl.build_p2p_control(PROMPTS, jpipe.tokenizer, STEPS, cfg, True)
    context, _ = jcommon.prepare_conditioning(jpipe, PROMPTS, 32, 32)
    final, _ = jbase.denoise(jpipe, jcommon.expand_latent(latent, 2), context, ctrl, blend=blend, use_flash=True)
    return final


def test_invert_and_p2p_edit_match_jax(pipes):
    jpipe, tpipe = pipes
    img = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    jlat = jpipe.image2latent(img)
    np.testing.assert_allclose(n(tpipe.image2latent(img)), n(jlat), atol=1e-4, rtol=0)
    start = np.asarray(jlat)  # the shared start latent

    jlast, jtraj, jctx, _ = j_invert(jpipe, jnp.asarray(start), PROMPTS[0], use_flash=True)
    tlast, ttraj, tctx, _ = t_invert(tpipe, t(start), PROMPTS[0])
    np.testing.assert_allclose(n(tctx), n(jctx), atol=1e-4, rtol=0)
    assert ttraj.shape == (STEPS + 1, 1, 16, 16, 4)
    for i in range(STEPS + 1):
        np.testing.assert_allclose(n(ttraj[i]), n(jtraj[i]), atol=ATOL, rtol=0, err_msg=f"inversion step {i}")

    shared = np.asarray(jlast)
    jfinal = _jax_edit_latents(jpipe, jnp.asarray(shared))
    sampler = TSampler(height=32, width=32)
    lat0, context, ctrl, blend, _ = p2p_setup(tpipe, PROMPTS, t(shared), TP2PConfig(blend_words=BLEND), sampler)
    blend = RecordingBlend(blend.alpha_layers, blend.threshold)
    tfinal = tbase.denoise(tpipe, lat0, context, ctrl, guidance_scale=sampler.guidance_scale, blend=blend)
    assert len(blend.gaps) == STEPS and min(blend.gaps) > MARGIN, blend.gaps
    assert torch.isfinite(tfinal).all()
    np.testing.assert_allclose(n(tfinal), n(jfinal), atol=ATOL, rtol=0)
    # the blend is live: outside the mask the target branch equals the source
    assert not torch.allclose(tfinal[0], tfinal[1])

    jimg = j_p2p_edit(jpipe, PROMPTS, jnp.asarray(shared), JP2PConfig(blend_words=BLEND),
                      JSampler(height=32, width=32), use_flash=True)
    timg = t_p2p_edit(tpipe, PROMPTS, t(shared), TP2PConfig(blend_words=BLEND), sampler)
    assert timg.shape == (2, 32, 32, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1


def test_refine_reweight_edit_matches_jax(pipes):
    """A refine edit with reweighting and a word-keyed cross-replace window,
    no LocalBlend, from one shared noise latent (seeded numpy)."""
    jpipe, tpipe = pipes
    prompts = ["a cat sitting on the grass", "a fluffy cat sitting on the green grass"]
    kw = dict(edit_type="refine", eq_words=("fluffy",), eq_values=(2.0,),
              cross_replace_steps={"default_": 0.8, "fluffy": (0.0, 0.5)}, self_replace_steps=0.5)
    start = np.random.RandomState(3).randn(1, 16, 16, 4).astype(np.float32)
    jcfg = JP2PConfig(**kw)
    ctrl = jctl.build_p2p_control(prompts, jpipe.tokenizer, STEPS, jcfg)
    context, _ = jcommon.prepare_conditioning(jpipe, prompts, 32, 32)
    jfinal, _ = jbase.denoise(jpipe, jcommon.expand_latent(jnp.asarray(start), 2), context, ctrl, use_flash=True)
    lat0, tctx, tctrl, blend, _ = p2p_setup(tpipe, prompts, t(start), TP2PConfig(**kw), TSampler(height=32, width=32))
    assert blend is None
    tfinal = tbase.denoise(tpipe, lat0, tctx, tctrl)
    np.testing.assert_allclose(n(tfinal), n(jfinal), atol=ATOL, rtol=0)
