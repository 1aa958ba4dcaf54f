"""The batched editors on the tiny SDXL pipeline, the port against the JAX
package (the cases of ``tests/test_batched.py``'s XL tests): the P2P edit of
a group, each image with its own added conditions (pooled embeds, and time
ids from the latents' size), pix2pix-zero of a group with the XL defaults
(references made again from pass 1's trajectory), and the batched DDIM
inversion followed by batched null-text inversion (XL's variant: the negative pooled embeds on
every unconditional evaluation, every step restarted from the original
embedding). One set of weights (``shared_pipelines``), 3 steps, 32² images
at a latent side of 16, a group of G = 2, f32 on both sides (the JAX side
``use_flash=False``).

Tolerances: images within ``LEVELS`` = 1 uint8 level of JAX's batched
result and of the port's per-image editor (``tests/test_batched.py``);
trajectories atol 1e-3 of JAX's and 1e-5 of the port's per-image
inversion; the embeddings within a tenth of one Adam step at lr 1e-2
(``tests/test_torch_xl_nti.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from image_editing_framework_torch.core.config import NTIConfig as TNTIConfig
from image_editing_framework_torch.core.config import P2PConfig as TP2PConfig
from image_editing_framework_torch.core.config import P2ZConfig as TP2ZConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.eval import batched as tb
from image_editing_framework_torch.inversion.ddim import ddim_invert as t_ddim_invert
from image_editing_framework_torch.inversion.nti import null_text_inversion as t_nti
from image_editing_framework_torch.methods.p2p import p2p_edit
from image_editing_framework_torch.methods.p2z import p2z_edit
from image_editing_framework_tpu.core.config import NTIConfig as JNTIConfig
from image_editing_framework_tpu.eval import batched as jb
from torch_port_helpers import fix_vocab, n, shared_pipelines, t

STEPS = 3
LEVELS = 1
ATOL_LAT = 1e-3
ATOL_EMB = 1e-2 / 10
# the serial editor takes the time ids from the sampler; the batched ones
# from the latents (16 · 8 = 128)
SAMPLER = TSampler(height=128, width=128)
PAIRS = [["a cat sat", "a dog sat"], ["a tree", "a rock"]]
PROMPTS = ["a cat", "a dog"]
P2Z_PAIRS = [["a cat", "a dog"], ["a horse", "a zebra"]]


@pytest.fixture(scope="module")
def pipes():
    jpipe, tpipe = shared_pipelines(num_steps=STEPS, model_type="xl")
    fix_vocab((jpipe, tpipe), [" ".join(p) for p in PAIRS + P2Z_PAIRS] + PROMPTS)
    return jpipe, tpipe


def _latents(seed):
    return (np.random.RandomState(seed).randn(2, 1, 16, 16, 4) * 0.1).astype(np.float32)


def _levels(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def test_xl_p2p_edit_batch(pipes):
    jpipe, tpipe = pipes
    lats = _latents(7)
    jout = jb.p2p_edit_batch(jpipe, PAIRS, jnp.asarray(lats), use_flash=False)
    tout = tb.p2p_edit_batch(tpipe, PAIRS, t(lats))
    assert tout.shape == (2, 2, 32, 32, 3) and tout.std() > 0
    assert _levels(tout, jout) <= LEVELS
    for i, pair in enumerate(PAIRS):
        assert _levels(tout[i], p2p_edit(tpipe, pair, t(lats[i]), TP2PConfig(), SAMPLER)) <= LEVELS


@pytest.fixture(scope="module")
def inversions(pipes):
    """Both packages' batched inversions of one group, and the port's per-image
    ones: (JAX's (last, trajectories), the port's, [(last, traj, context,
    added_cond)] per image)."""
    jpipe, tpipe = pipes
    lats = _latents(8)
    jout = jb.ddim_invert_batch(jpipe, jnp.asarray(lats), PROMPTS, use_flash=False, return_trajectory=True)
    tout = tb.ddim_invert_batch(tpipe, t(lats), PROMPTS, return_trajectory=True)
    return jout, tout, [t_ddim_invert(tpipe, t(lats[i]), p) for i, p in enumerate(PROMPTS)]


def test_xl_p2z_edit_batch(pipes):
    """SDXL's batched pix2pix-zero with its defaults (the references made
    again each step from pass 1's trajectory, ``recompute_refs``), each
    image with its own added conditions: against JAX's ``p2z_edit_batch``
    and against the port's per-image editor."""
    jpipe, tpipe = pipes
    lats = _latents(9)
    jout = jb.p2z_edit_batch(jpipe, P2Z_PAIRS, jnp.asarray(lats), use_flash=False)
    tout = tb.p2z_edit_batch(tpipe, P2Z_PAIRS, t(lats))
    assert tout.shape == np.asarray(jout).shape == (2, 2, 32, 32, 3) and tout.dtype == np.uint8 and tout.std() > 0
    assert _levels(tout, jout) <= LEVELS
    cfg = TP2ZConfig(recompute_refs=True)
    for i, pair in enumerate(P2Z_PAIRS):
        assert _levels(tout[i], np.concatenate(p2z_edit(tpipe, pair, t(lats[i]), cfg, SAMPLER))) <= LEVELS, i
    # the guidance shows: the same group without it gives other edits
    unguided = tb.p2z_edit_batch(tpipe, P2Z_PAIRS, t(lats), TP2ZConfig(recompute_refs=True, guidance_amount=0.0))
    assert _levels(unguided[:, 1], tout[:, 1]) > LEVELS


def test_xl_ddim_invert_batch(inversions):
    (jlast, jtraj), (tlast, ttraj), singles = inversions
    assert tuple(ttraj.shape) == (2, STEPS + 1, 1, 16, 16, 4)
    np.testing.assert_allclose(n(ttraj), n(jtraj), atol=ATOL_LAT, rtol=0)
    np.testing.assert_allclose(n(tlast), n(jlast), atol=ATOL_LAT, rtol=0)
    for i, (_, straj, _, _) in enumerate(singles):
        np.testing.assert_allclose(n(ttraj[i]), n(straj), atol=1e-5, rtol=0)


def test_xl_nti_batch(pipes, inversions):
    """Both packages' NTI from JAX's trajectories, so that the embeddings
    compare the NTI programs alone; then each image alone, with the added
    conditions its inversion returns, and ``nti_group_serial``."""
    jpipe, tpipe = pipes
    (_, jtraj), _, singles = inversions
    jseq = jb.nti_batch(jpipe, jtraj, PROMPTS, JNTIConfig(num_inner_steps=2), use_flash=False)
    tseq = tb.nti_batch(tpipe, t(np.asarray(jtraj)), PROMPTS, TNTIConfig(num_inner_steps=2))
    assert tuple(tseq.shape) == (2, STEPS, 77, 32)
    np.testing.assert_allclose(n(tseq), n(jseq), atol=ATOL_EMB, rtol=0)
    for i, (_, _, ctx, added) in enumerate(singles):
        single = t_nti(tpipe, t(np.asarray(jtraj[i])), ctx, TNTIConfig(num_inner_steps=2), added_cond=added)
        np.testing.assert_allclose(n(tseq[i]), n(single), atol=ATOL_EMB, rtol=0)
    grouped = tb.nti_group_serial(tpipe, t(np.asarray(jtraj)), PROMPTS, TNTIConfig(num_inner_steps=2))
    np.testing.assert_allclose(n(grouped), n(tseq), atol=ATOL_EMB, rtol=0)
