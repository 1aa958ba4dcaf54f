"""Batched null-text inversion in the port (``inversion/nti.py
null_text_inversion_batch``, ``eval/batched.py nti_batch`` and
``nti_group_serial``) against the JAX package's, on the tiny SD pipeline with
one set of weights (``shared_pipelines``), 4 steps, a group of G = 3 that
stops at different inner iterations, in f32 on both sides (the JAX side
``use_flash=False``; its batched NTI is a ``vmap``ped ``while_loop``). Both
packages start from JAX's batched inversion's trajectories, so that the
embeddings compare the NTI programs alone.

The group's losses at step 0 straddle ``EPSILON``: one image stops after one
inner iteration, one after three, one runs all four (the losses clear the
threshold by 1% or more, far beyond the frameworks' f32 differences), so an
image that has stopped must stay frozen while the others go on. Tolerance:
the embeddings within ``ATOL_EMB`` = 1e-3 of JAX's and of the port's
per-image NTI, a tenth of one Adam step at lr 1e-2
(``tests/test_torch_nti.py``). The host reads the group's loss vector once
per inner iteration, and nothing else of the card.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.config import NTIConfig as TNTIConfig
from image_editing_framework_torch.eval import batched as tb
from image_editing_framework_torch.inversion import nti as tnti
from image_editing_framework_tpu.core.config import NTIConfig as JNTIConfig
from image_editing_framework_tpu.eval import batched as jb
from image_editing_framework_tpu.inversion import nti as jnti
from torch_port_helpers import fix_vocab, n, shared_pipelines, t

STEPS = 4
INNER = 4
EPSILON = 1.35
ATOL_EMB = 1e-3
PROMPTS = ["a cat", "a dog", "a red bird"]
STOPS_AT_STEP_0 = [3, 1, 4]


@pytest.fixture(scope="module")
def case():
    """(jax pipe, port pipe, trajectories (G, S+1, 1, 16, 16, 4) numpy,
    contexts (G, 2, 77, 32) numpy, JAX's null_text_inversion_batch)."""
    jpipe, tpipe = shared_pipelines(num_steps=STEPS)
    fix_vocab((jpipe, tpipe), PROMPTS)
    rng = np.random.RandomState(2)
    lats = (rng.randn(3, 1, 16, 16, 4) * np.array([1.0, 0.3, 0.05])[:, None, None, None, None]).astype(np.float32)
    _, trajs = jb.ddim_invert_batch(jpipe, jnp.asarray(lats), PROMPTS, use_flash=False, return_trajectory=True)
    emb, _ = jpipe.encode_prompts(PROMPTS)
    contexts = np.stack([np.asarray(emb[:3]), np.asarray(emb[3:])], axis=1)
    cfg = JNTIConfig(num_inner_steps=INNER, epsilon=EPSILON)
    jseq = jnti.null_text_inversion_batch(jpipe, trajs, jnp.asarray(contexts), cfg, use_flash=False)
    return jpipe, tpipe, np.asarray(trajs), contexts, np.asarray(jseq)


def _cfg():
    return TNTIConfig(num_inner_steps=INNER, epsilon=EPSILON)


def test_null_text_inversion_batch_matches_jax_with_unequal_stops(case):
    _, tpipe, trajs, contexts, jseq = case
    tseq, stops = tnti.null_text_inversion_batch(tpipe, t(trajs), t(contexts), _cfg(), return_stops=True)
    assert tuple(tseq.shape) == (3, STEPS, 77, 32) and tseq.dtype == torch.float32
    assert stops[0] == STOPS_AT_STEP_0 and stops[1:] == [[INNER] * 3] * (STEPS - 1)
    np.testing.assert_allclose(n(tseq), jseq, atol=ATOL_EMB, rtol=0)
    # each image as alone, with its own stops
    for i in range(3):
        tnti.null_text_inversion.inner_iterations = 0
        single = tnti.null_text_inversion(tpipe, t(trajs[i]), t(contexts[i]), _cfg())
        assert tnti.null_text_inversion.inner_iterations == sum(s[i] for s in stops)
        np.testing.assert_allclose(n(tseq[i]), n(single), atol=ATOL_EMB, rtol=0)


def test_a_stopped_image_is_frozen(case):
    """The image that stops after one iteration at step 0 keeps its
    one-step embedding while the others take three more steps: one inner
    iteration of its own gives the same."""
    _, tpipe, trajs, contexts, _ = case
    tseq = tnti.null_text_inversion_batch(tpipe, t(trajs), t(contexts), _cfg())
    one = tnti.null_text_inversion_batch(tpipe, t(trajs[1:2]), t(contexts[1:2]),
                                         TNTIConfig(num_inner_steps=1, epsilon=EPSILON))
    np.testing.assert_allclose(n(tseq[1, 0]), n(one[0, 0]), atol=ATOL_EMB, rtol=0)
    # Adam's first step moves every element by about lr = 1e-2; four steps
    # would have moved the elements up to four times as far
    moved = (tseq[1, 0] - t(contexts[1, 0])).abs().max().item()
    assert abs(moved - 1e-2) < ATOL_EMB, moved


def test_nti_batch_matches_jax(case):
    jpipe, tpipe, trajs, _, jseq = case
    tseq = tb.nti_batch(tpipe, t(trajs), PROMPTS, _cfg())
    np.testing.assert_allclose(n(tseq), jseq, atol=ATOL_EMB, rtol=0)
    jnb = jb.nti_batch(jpipe, jnp.asarray(trajs), PROMPTS, JNTIConfig(num_inner_steps=INNER, epsilon=EPSILON),
                       use_flash=False)
    np.testing.assert_allclose(n(tseq), np.asarray(jnb), atol=ATOL_EMB, rtol=0)


def test_nti_group_serial_matches_jax_and_per_image(case):
    jpipe, tpipe, trajs, contexts, _ = case
    cfg = TNTIConfig(num_inner_steps=2)
    grouped = tb.nti_group_serial(tpipe, t(trajs), PROMPTS, cfg)
    assert tuple(grouped.shape) == (3, STEPS, 77, 32)
    jgrouped = jb.nti_group_serial(jpipe, jnp.asarray(trajs), PROMPTS, JNTIConfig(num_inner_steps=2),
                                   use_flash=False)
    np.testing.assert_allclose(n(grouped), np.asarray(jgrouped), atol=ATOL_EMB, rtol=0)
    for i in range(3):
        single = tnti.null_text_inversion(tpipe, t(trajs[i]), t(contexts[i]), cfg)
        np.testing.assert_allclose(n(grouped[i]), n(single), atol=ATOL_EMB, rtol=0)


def test_one_host_read_per_inner_iteration(case, monkeypatch):
    """Every read of a tensor's value to the host during the group's NTI:
    outside the schedule's scalars (``core/scheduler.py``, host tensors),
    one (G,) loss vector per inner iteration of the group, whatever G."""
    _, tpipe, trajs, contexts, _ = case
    reads = []
    for name in ("item", "tolist"):
        real = getattr(torch.Tensor, name)

        def reading(self, _real=real, _name=name):
            reads.append((_name, tuple(self.shape), sys._getframe(1).f_code.co_filename))
            return _real(self)

        monkeypatch.setattr(torch.Tensor, name, reading)
    tnti.null_text_inversion.inner_iterations = 0
    _, stops = tnti.null_text_inversion_batch(tpipe, t(trajs), t(contexts), _cfg(), return_stops=True)
    monkeypatch.undo()
    iterations = tnti.null_text_inversion.inner_iterations
    assert iterations == sum(max(s) for s in stops) == STEPS * INNER
    outside = [(name, shape) for name, shape, f in reads if not f.endswith("scheduler.py")]
    assert outside == [("tolist", (3,))] * iterations
