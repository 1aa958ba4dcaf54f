"""The port's batched editors (``eval/batched.py``) against the JAX
package's, on the tiny SD pipeline with one set of weights
(``shared_pipelines``), 4 steps at 32², a group of G = 2, in f32 on both
sides (the JAX side ``use_flash=False``, its XLA attention, the plain
reference of its Pallas kernel; jitted and ``vmap``ped as
``tests/test_batched.py`` runs it). Each JAX result is computed once per
module.

Tolerances: images within ``LEVELS`` = 1 uint8 level of JAX's batched
result and of the port's own per-image editor on the same image (the limit
``tests/test_batched.py`` holds JAX's batched results to its per-image
ones). The batched inversion's latents within ``ATOL_INV`` = 1e-3 of JAX's
(``tests/test_torch_pipeline.py``'s limit for 4 steps of f32 UNet
differences) and within 1e-5 of the port's per-image inversion
(``tests/test_batched.py``'s limit). A group of one gives the serial
editors' images bit for bit, on all four methods: the serial editors are
the group code at G = 1. The controls act within each image's block of the
group layout (``ops/controls.py``), checked against each image's own
control on its block, exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.config import MasaCtrlConfig as TMasaCfg
from image_editing_framework_torch.core.config import P2PConfig as TP2PConfig
from image_editing_framework_torch.core.config import P2ZConfig as TP2ZConfig
from image_editing_framework_torch.core.config import PnPConfig as TPnPConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.eval import batched as tb
from image_editing_framework_torch.inversion.ddim import ddim_invert as t_ddim_invert
from image_editing_framework_torch.methods.masactrl import masactrl_edit
from image_editing_framework_torch.methods.p2p import p2p_edit
from image_editing_framework_torch.methods.p2z import p2z_edit
from image_editing_framework_torch.methods.pnp import pnp_edit
from image_editing_framework_torch.ops import attention as tatt
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_tpu.core.config import MasaCtrlConfig as JMasaCfg
from image_editing_framework_tpu.core.config import P2PConfig as JP2PConfig
from image_editing_framework_tpu.core.config import P2ZConfig as JP2ZConfig
from image_editing_framework_tpu.core.config import PnPConfig as JPnPConfig
from image_editing_framework_tpu.eval import batched as jb
from torch_port_helpers import fix_vocab, n, shared_pipelines, t

STEPS = 4
LEVELS = 1
ATOL_INV = 1e-3
SAMPLER = TSampler(height=32, width=32)
PAIRS = [["a cat sat", "a dog sat"], ["a cat sat", "a fluffy cat sat"]]  # replace and refine in one group
EDIT_TYPES = ("replace", "refine")
WORDS = ["a cat sat dog fluffy standing running horse zebra"]
MASA = dict(start_step=1, start_layer=0)  # gated from the first step and layer: the tiny UNet's edit is controlled
PNP = dict(pnp_attn_t=0.5, pnp_f_t=0.8)
P2Z = dict(guidance_amount=0.05)


def _latents(seed, scale=1.0):
    return (np.random.RandomState(seed).randn(2, 1, 16, 16, 4) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    jpipe, tpipe = shared_pipelines(num_steps=STEPS)
    fix_vocab((jpipe, tpipe), WORDS)
    return jpipe, tpipe


def _levels(a, b):
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _check(port, jax_out, singles):
    """The port's (G, 2, H, W, 3) uint8 against JAX's and against its own
    per-image editor's (2, H, W, 3) images."""
    assert port.shape == np.asarray(jax_out).shape == (2, 2, 32, 32, 3) and port.dtype == np.uint8
    assert _levels(port, jax_out) <= LEVELS
    for i, single in enumerate(singles):
        assert _levels(port[i], single) <= LEVELS, i
    assert port.std() > 0


def _p2p_cfgs(cls):
    return [cls(edit_type=e) for e in EDIT_TYPES]


def test_p2p_edit_batch_mixes_replace_and_refine(pipes):
    jpipe, tpipe = pipes
    lats = _latents(0)
    jout = jb.p2p_edit_batch(jpipe, PAIRS, jnp.asarray(lats), _p2p_cfgs(JP2PConfig), use_flash=False)
    tout = tb.p2p_edit_batch(tpipe, PAIRS, t(lats), _p2p_cfgs(TP2PConfig))
    _check(tout, jout, [p2p_edit(tpipe, pair, t(lats[i]), cfg, SAMPLER)
                        for i, (pair, cfg) in enumerate(zip(PAIRS, _p2p_cfgs(TP2PConfig)))])


@pytest.mark.parametrize("mode", ["mutual", "union"])
def test_masactrl_edit_batch(pipes, mode):
    jpipe, tpipe = pipes
    lats = _latents(5)
    jcfg, tcfg = JMasaCfg(mode=mode, **MASA), TMasaCfg(mode=mode, **MASA)
    pairs = [["a cat", "a standing cat"], ["a dog", "a running dog"]]
    jout = jb.masactrl_edit_batch(jpipe, pairs, jnp.asarray(lats), jcfg, use_flash=False)
    tout = tb.masactrl_edit_batch(tpipe, pairs, t(lats), tcfg)
    _check(tout, jout, [masactrl_edit(tpipe, pair, t(lats[i]), tcfg, SAMPLER) for i, pair in enumerate(pairs)])


def test_pnp_edit_batch(pipes):
    jpipe, tpipe = pipes
    lats = _latents(6)
    pairs = [["a cat", "a dog"], ["a horse", "a zebra"]]
    jout = jb.pnp_edit_batch(jpipe, pairs, jnp.asarray(lats), JPnPConfig(**PNP), use_flash=False)
    tout = tb.pnp_edit_batch(tpipe, pairs, t(lats), TPnPConfig(**PNP))
    _check(tout, jout, [pnp_edit(tpipe, pair, t(lats[i]), TPnPConfig(**PNP), SAMPLER) for i, pair in enumerate(pairs)])


@pytest.mark.parametrize("recompute", [False, True], ids=["recorded", "recompute_refs"])
def test_p2z_edit_batch(pipes, recompute):
    """Each image's guided pass follows its own loss and gradient: a summed
    loss, never an average (an average would shrink each step by G, which
    the per-image editor and JAX's vmapped pass would see)."""
    jpipe, tpipe = pipes
    lats = _latents(7)
    pairs = [["a cat", "a dog"], ["a horse", "a zebra"]]
    jout = jb.p2z_edit_batch(jpipe, pairs, jnp.asarray(lats), JP2ZConfig(recompute_refs=recompute, **P2Z),
                             use_flash=False)
    tcfg = TP2ZConfig(recompute_refs=recompute, **P2Z)
    tout = tb.p2z_edit_batch(tpipe, pairs, t(lats), tcfg)
    _check(tout, jout, [np.concatenate(p2z_edit(tpipe, pair, t(lats[i]), tcfg, SAMPLER))
                        for i, pair in enumerate(pairs)])


def test_edit_batch_dispatch(pipes):
    """``edit_batch``: one p2p config serves every image; p2z ignores
    ``source_replays``; an unknown method raises."""
    _, tpipe = pipes
    lats = t(_latents(7))
    pairs = [["a cat", "a dog"], ["a horse", "a zebra"]]
    cfg = TP2PConfig(edit_type="replace")
    np.testing.assert_array_equal(tb.edit_batch("p2p", tpipe, pairs, lats, cfg),
                                  tb.p2p_edit_batch(tpipe, pairs, lats, [cfg, cfg]))
    junk = torch.full((2, STEPS + 1, 1, 16, 16, 4), float("nan"))
    np.testing.assert_array_equal(tb.edit_batch("p2z", tpipe, pairs, lats, TP2ZConfig(**P2Z), source_replays=junk),
                                  tb.p2z_edit_batch(tpipe, pairs, lats, TP2ZConfig(**P2Z)))
    with pytest.raises(ValueError, match="unknown method"):
        tb.edit_batch("nope", tpipe, pairs, lats)


@pytest.fixture(scope="module")
def inversions(pipes):
    """Both packages' batched DDIM inversions of one group: (the start
    latents, JAX's (last, trajectories), the port's)."""
    jpipe, tpipe = pipes
    lats = _latents(9, 0.1)
    prompts = [p[0] for p in PAIRS]
    jout = jb.ddim_invert_batch(jpipe, jnp.asarray(lats), prompts, use_flash=False, return_trajectory=True)
    return lats, jout, tb.ddim_invert_batch(tpipe, t(lats), prompts, return_trajectory=True)


def test_ddim_invert_batch(pipes, inversions):
    _, tpipe = pipes
    lats, (jlast, jtraj), (tlast, ttraj) = inversions
    assert tuple(ttraj.shape) == (2, STEPS + 1, 1, 16, 16, 4) and tuple(tlast.shape) == (2, 1, 16, 16, 4)
    np.testing.assert_allclose(n(tlast), n(jlast), atol=ATOL_INV, rtol=0)
    np.testing.assert_allclose(n(ttraj), n(jtraj), atol=ATOL_INV, rtol=0)
    assert torch.equal(tb.ddim_invert_batch(tpipe, t(lats), [p[0] for p in PAIRS]), tlast)
    for i, pair in enumerate(PAIRS):
        last, traj, _, _ = t_ddim_invert(tpipe, t(lats[i]), pair[0])
        np.testing.assert_allclose(n(tlast[i]), n(last), atol=1e-5, rtol=0)
        np.testing.assert_allclose(n(ttraj[i]), n(traj), atol=1e-5, rtol=0)


def test_direct_inversion_replays_each_image(pipes, inversions):
    jpipe, tpipe = pipes
    _, (jlast, jtraj), (tlast, ttraj) = inversions
    jout = jb.p2p_edit_batch(jpipe, PAIRS, jlast, _p2p_cfgs(JP2PConfig), use_flash=False, source_replays=jtraj)
    tout = tb.p2p_edit_batch(tpipe, PAIRS, tlast, _p2p_cfgs(TP2PConfig), source_replays=ttraj)
    _check(tout, jout, [p2p_edit(tpipe, pair, tlast[i], cfg, SAMPLER, source_replay=ttraj[i])
                        for i, (pair, cfg) in enumerate(zip(PAIRS, _p2p_cfgs(TP2PConfig)))])


def test_edit_on_nti_embeddings(pipes):
    """Each image's per-step unconditional embeddings replace its own
    unconditional half (random embeddings of the NTI shape)."""
    jpipe, tpipe = pipes
    lats = _latents(3)
    useqs = (np.random.RandomState(4).randn(2, STEPS, 77, 32) * 0.5).astype(np.float32)
    jout = jb.p2p_edit_batch(jpipe, PAIRS, jnp.asarray(lats), _p2p_cfgs(JP2PConfig), uncond_seqs=jnp.asarray(useqs),
                             use_flash=False)
    tout = tb.p2p_edit_batch(tpipe, PAIRS, t(lats), _p2p_cfgs(TP2PConfig), uncond_seqs=t(useqs))
    _check(tout, jout, [p2p_edit(tpipe, pair, t(lats[i]), cfg, SAMPLER, uncond_seq=t(useqs[i]))
                        for i, (pair, cfg) in enumerate(zip(PAIRS, _p2p_cfgs(TP2PConfig)))])
    masa = TMasaCfg(**MASA)
    tout = tb.masactrl_edit_batch(tpipe, PAIRS, t(lats), masa, uncond_seqs=t(useqs))
    for i, pair in enumerate(PAIRS):
        assert _levels(tout[i], masactrl_edit(tpipe, pair, t(lats[i]), masa, SAMPLER, uncond_seq=t(useqs[i]))) <= LEVELS


@pytest.mark.parametrize("method", ["p2p", "masactrl", "pnp", "p2z"])
def test_group_of_one_is_the_serial_editor_bit_for_bit(pipes, method):
    _, tpipe = pipes
    lat = t(_latents(11)[:1])
    pair = ["a cat sat", "a dog sat"]
    serial = {
        "p2p": lambda: p2p_edit(tpipe, pair, lat[0], TP2PConfig(), SAMPLER),
        "masactrl": lambda: masactrl_edit(tpipe, pair, lat[0], TMasaCfg(**MASA), SAMPLER),
        "pnp": lambda: pnp_edit(tpipe, pair, lat[0], TPnPConfig(**PNP), SAMPLER),
        "p2z": lambda: np.concatenate(p2z_edit(tpipe, pair, lat[0], TP2ZConfig(**P2Z), SAMPLER)),
    }[method]()
    cfg = {"p2p": TP2PConfig(), "masactrl": TMasaCfg(**MASA), "pnp": TPnPConfig(**PNP), "p2z": TP2ZConfig(**P2Z)}
    np.testing.assert_array_equal(tb.edit_batch(method, tpipe, [pair], lat, cfg[method])[0], serial)


# --------------------------------------------------------------- the controls


def _tokenizer(pipes):
    return pipes[1].tokenizer


def _p2p_controls(pipes):
    tok = _tokenizer(pipes)
    return [tctl.build_p2p_control(pair, tok, 10, TP2PConfig(edit_type=e)) for pair, e in zip(PAIRS, EDIT_TYPES)]


def test_stack_controls(pipes):
    controls = _p2p_controls(pipes)
    stacked = tb.stack_controls(controls)
    assert tuple(stacked.mapper.shape) == (2, 1, 77, 77)
    assert tuple(stacked.tok_alpha.shape) == tuple(stacked.equalizer.shape) == (2, 1, 77)
    assert tuple(stacked.cross_alpha.shape) == (11, 2, 1, 77)
    for i, c in enumerate(controls):
        assert torch.equal(stacked.mapper[i], c.mapper) and torch.equal(stacked.cross_alpha[:, i], c.cross_alpha)
    other = dataclasses.replace(controls[1], self_gate=~controls[1].self_gate)
    with pytest.raises(ValueError, match="self-replace gate"):
        tb.stack_controls([controls[0], other])


def _blocks(rng, g, p, shape):
    return torch.from_numpy(rng.rand(g * 2 * p, *shape).astype(np.float32))


@pytest.mark.parametrize("step", [0, 8])  # inside and outside the self-replace window
def test_p2p_step_acts_per_image(pipes, step):
    controls = _p2p_controls(pipes)
    group = tb.stack_controls(controls).at_step(step)
    probs = torch.softmax(_blocks(np.random.RandomState(step), 2, 2, (2, 256, 77)), dim=-1)
    site = tatt.AttnSite(layer=1, place="down", seq_len=256, is_cross=True)
    edited = group.edit_cross(site, probs)
    for i, c in enumerate(controls):
        torch.testing.assert_close(edited[4 * i: 4 * i + 4], c.at_step(step).edit_cross(site, probs[4 * i: 4 * i + 4]),
                                   atol=0, rtol=0)
    self_site = tatt.AttnSite(layer=1, place="down", seq_len=256, is_cross=False)
    plan, one = group.self_plan(self_site, 8), controls[0].at_step(step).self_plan(self_site, 4)
    assert torch.equal(plan.q_idx, torch.cat([one.q_idx, one.q_idx + 4]))
    assert torch.equal(plan.v_idx, torch.arange(8)[:, None])


@pytest.mark.parametrize("mode", ["mutual", "union"])
def test_masactrl_step_acts_per_image(mode):
    ctrl = tctl.build_masactrl_control(10, 4, TMasaCfg(mode=mode, **MASA), device="cpu")
    site = tatt.AttnSite(layer=2, place="up", seq_len=64, is_cross=False)
    for step in (0, 5):  # ungated and gated
        plan, one = ctrl.at_step(step).self_plan(site, 8), ctrl.at_step(step).self_plan(site, 4)
        assert torch.equal(plan.k_idx, torch.cat([one.k_idx, one.k_idx + 4]))
        assert torch.equal(plan.valid, torch.cat([one.valid, one.valid]))
        q, k, v = (_blocks(np.random.RandomState(step + j), 2, 2, (2, 64, 8)) for j in range(3))
        out = tatt.self_attention(q, k, v, plan)
        for i in range(2):
            rows = slice(4 * i, 4 * i + 4)
            torch.testing.assert_close(out[rows], tatt.self_attention(q[rows], k[rows], v[rows], one), atol=0, rtol=0)


def test_pnp_step_acts_per_image():
    ctrl = tctl.build_pnp_control(10, TPnPConfig(), (8,), ("up1_res1",), device="cpu")
    site = tatt.AttnSite(layer=8, place="up", seq_len=64, is_cross=False)
    h = _blocks(np.random.RandomState(0), 3, 2, (3, 5, 6))
    for step in (0, 9):  # injecting, and not
        st = ctrl.at_step(step)
        plan, one = st.self_plan(site, 12), st.self_plan(site, 4)
        assert torch.equal(plan.q_idx, torch.cat([one.q_idx + 4 * i for i in range(3)]))
        hooked = st.resnet_hook("up1_res1", h)
        for i in range(3):
            assert torch.equal(hooked[4 * i: 4 * i + 4], st.resnet_hook("up1_res1", h[4 * i: 4 * i + 4]))
    with pytest.raises(ValueError, match="blocks"):
        ctrl.at_step(0).self_plan(site, 6)
