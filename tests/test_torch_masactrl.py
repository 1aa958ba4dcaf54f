"""MasaCtrl in the port against the JAX package: the gate and control
tables exactly; the mutual and union plans exactly; ``masked_attention``,
the mask and auto-mask overrides and ``pca_direction`` within atol 1e-5
(f32); and, on the tiny SD pipeline, ``masactrl_edit`` in all four variants
(mutual, union, mask, auto-mask) and with ``source_replay``, ``uncond_seq``,
``direction_scale`` and a negative prompt: final latents within atol 1e-3
and images within 1 uint8 level, as tests/test_torch_pipeline.py.

Both run in f32 on the CPU; the JAX side runs its Pallas flash kernel in
interpret mode (``use_flash=True``), the port its kernel's plain version.

The auto-mask variant thresholds a normalised cross-attention map at
``thres``, so a map value near it could flip between frameworks and change
the result by far more than rounding. The tiny pipeline's random maps are
flat: a quarter to half of their values lie below the default 0.1, and no
seed or prompt left 1e-3 free around it (at best 1.6e-4). The end-to-end
case thresholds at ``AUTO_THRES`` = 0.9 instead, where the prompts, latent
and tokens below leave every value at every gated site of every step more
than ``MARGIN`` away (1.3e-2); the test checks that margin on the port's
maps. The unit test of the override uses 0.3 on maps it makes itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.config import MasaCtrlConfig as TMasaCfg
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.methods import masactrl as tmasa
from image_editing_framework_torch.ops import attention as tatt
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_torch.ops import schedules as tsched
from image_editing_framework_torch.ops.flash_attention import NEG_INF
from image_editing_framework_tpu.core.config import MasaCtrlConfig as JMasaCfg
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.methods import masactrl as jmasa
from image_editing_framework_tpu.ops import attention as jatt
from image_editing_framework_tpu.ops import controls as jctl
from image_editing_framework_tpu.ops import schedules as jsched
from torch_port_helpers import n, recorded_latents, shared_pipelines, t

STEPS = 4
ATOL = 1e-3
ATOL_UNIT = 1e-5
MARGIN = 1e-3
AUTO_THRES = 0.9
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]


def _sites(layer, n):
    return (jatt.AttnSite(layer=layer, place="up", seq_len=n, is_cross=False),
            tatt.AttnSite(layer=layer, place="up", seq_len=n, is_cross=False))


def _qkv(seed, b=4, h=2, n=64, d=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, n, d).astype(np.float32) for _ in range(3)]


def _asymmetric_mask(seed, shape=(16, 16)):
    """A random 0/1 mask: no symmetry that would hide which pixel a resize
    picks."""
    return (np.random.RandomState(seed).rand(*shape) > 0.5).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(start_step=1, start_layer=2),
                                dict(step_idx=(0, 3), layer_idx=(1, 5, 9))])
def test_masactrl_gate_and_control_tables_equal(kw):
    np.testing.assert_array_equal(tsched.masactrl_gate(10, 16, **kw), jsched.masactrl_gate(10, 16, **kw))
    for mode in ("mutual", "union"):
        jc = jctl.build_masactrl_control(10, 16, JMasaCfg(mode=mode, **kw))
        tc = tctl.build_masactrl_control(10, 16, TMasaCfg(mode=mode, **kw), device="cpu")
        np.testing.assert_array_equal(n(tc.step_gate), n(jc.step_gate))
        assert (tc.layers, tc.union, tc.num_prompts) == (jc.layers, jc.union, jc.num_prompts)
    mask = _asymmetric_mask(0)
    jc = jctl.build_masactrl_control(10, 16, JMasaCfg(**kw), mask_s=mask, mask_t=mask[::-1])
    tc = tctl.build_masactrl_control(10, 16, TMasaCfg(**kw), mask_s=mask, mask_t=mask[::-1].copy())
    np.testing.assert_array_equal(n(tc.mask_s), n(jc.mask_s))
    np.testing.assert_array_equal(n(tc.mask_t), n(jc.mask_t))
    assert type(tc.at_step(3)).__name__ == type(jc.at_step(3)).__name__ == "MasaCtrlMaskStep"
    tc = tctl.build_masactrl_control(10, 16, TMasaCfg(**kw), auto_mask=True, thres=0.2, ref_token_idx=(2, 3))
    assert type(tc.at_step(0)).__name__ == "MasaCtrlAutoStep"
    assert (tc.thres, tc.ref_idx, tc.cur_idx) == (0.2, (2, 3), (1,))


@pytest.mark.parametrize("mode", ["mutual", "union"])
@pytest.mark.parametrize("num_prompts", [2, 3])
def test_mutual_and_union_plans_equal(mode, num_prompts):
    jc = jctl.build_masactrl_control(10, 16, JMasaCfg(mode=mode), num_prompts=num_prompts)
    tc = tctl.build_masactrl_control(10, 16, TMasaCfg(mode=mode), num_prompts=num_prompts, device="cpu")
    batch = 2 * num_prompts
    for i in (0, 3, 4, 9):  # ungated and gated steps
        js, ts = jc.at_step(i), tc.at_step(i)
        for layer in (3, 10, 15):  # ungated and gated layers
            jsite, tsite = _sites(layer, 64)
            jp, tp = js.self_plan(jsite, batch), ts.self_plan(tsite, batch)
            assert (jp is None) == (tp is None) == (layer < 10)
            if jp is not None:
                for name in ("q_idx", "k_idx", "v_idx", "valid"):
                    np.testing.assert_array_equal(n(getattr(tp, name)), n(getattr(jp, name)), err_msg=name)


def test_masked_attention_matches_jax():
    """Per-key bias with NEG_INF segments, a fully masked row (averaged over
    the real keys) and an all-open row."""
    q, k, v = _qkv(0, b=3, n=80)
    bias = np.zeros((3, 80), np.float32)
    bias[0, 10:50] = NEG_INF
    bias[1] = NEG_INF
    out_j = jatt.masked_attention(*map(jnp.asarray, (q, k, v, bias)), use_flash=True)
    out_t = tatt.masked_attention(t(q), t(k), t(v), t(bias))
    np.testing.assert_allclose(n(out_t), n(out_j), atol=ATOL_UNIT, rtol=0)
    np.testing.assert_allclose(n(out_t[1]), n(t(v[1]).mean(dim=1, keepdim=True).expand(2, 80, 16)), atol=1e-5)


@pytest.fixture
def recorded_bias(monkeypatch):
    """The bias of every call that reaches ``flash_attention`` from the
    attention dispatch (the CUDA kernel takes only a contiguous f32 bias;
    the plain version would take a broadcast view as well)."""
    seen = []
    real = tatt.flash_attention

    def recording(q, k, v, bias=None, *args, **kw):
        seen.append(bias)
        return real(q, k, v, bias, *args, **kw)

    monkeypatch.setattr(tatt, "flash_attention", recording)
    return seen


def _check_biases(seen, batch, nk_choices):
    biased = [b for b in seen if b is not None]
    assert biased
    for b in biased:
        assert b.dtype == torch.float32 and b.is_contiguous() and b.shape[0] == batch and b.shape[1] in nk_choices
        assert b.stride() == (b.shape[1], 1)


@pytest.mark.parametrize("side,seq", [(16, 64), (16, 256), (16, 1024), (32, 256)])
def test_mask_override_matches_jax(side, seq, recorded_bias):
    """Masks resized down, kept and up (nearest with half-pixel centres),
    at a gated and an ungated step, and at a layer outside the set."""
    mask_s, mask_t = _asymmetric_mask(1, (side, side)), _asymmetric_mask(2, (side, side))
    jc = jctl.build_masactrl_control(10, 16, JMasaCfg(), mask_s=mask_s, mask_t=mask_t)
    tc = tctl.build_masactrl_control(10, 16, TMasaCfg(), mask_s=mask_s, mask_t=mask_t, device="cpu")
    q, k, v = _qkv(3, n=seq)
    jsite, tsite = _sites(12, seq)
    for i in (0, 7):
        out_j = jc.at_step(i).self_override(jsite, *map(jnp.asarray, (q, k, v)), use_flash=True)
        out_t = tc.at_step(i).self_override(tsite, t(q), t(k), t(v))
        np.testing.assert_allclose(n(out_t), n(out_j), atol=ATOL_UNIT, rtol=0)
    _check_biases(recorded_bias, 4, (seq,))
    assert tc.at_step(7).self_override(_sites(3, seq)[1], t(q), t(k), t(v)) is None


def test_mask_override_all_background_source_mask():
    """mask_s all background: the fg call sees only NEG_INF keys, so its rows
    average the real keys (the JAX XLA path's rule, not the TPU kernel's
    padded one) — blended in only where mask_t is 1."""
    mask_s, mask_t = np.zeros((16, 16), np.float32), _asymmetric_mask(4)
    tc = tctl.build_masactrl_control(10, 16, TMasaCfg(), mask_s=mask_s, mask_t=mask_t, device="cpu")
    q, k, v = _qkv(5)
    out = tc.at_step(7).self_override(_sites(12, 64)[1], t(q), t(k), t(v))
    mt = tctl._resize_nearest(torch.from_numpy(mask_t), 8) > 0.5
    src_mean = t(v[0]).mean(dim=1)  # (H, D): target 1 of the first CFG half reads source 0
    np.testing.assert_allclose(n(out[1][:, mt]), n(src_mean[:, None].expand(2, int(mt.sum()), 16)), atol=1e-5)
    assert torch.isfinite(out).all()


def test_nearest_resize_picks_jax_pixels():
    """4x4 -> 2x2 picks pixels [5, 7, 13, 15] (half-pixel centres); 4x4 ->
    8x8 and 16 -> 24 as well."""
    import jax

    for src, side in ((4, 2), (4, 8), (16, 24), (16, 64)):
        m = np.arange(src * src, dtype=np.float32).reshape(src, src)
        expect = np.asarray(jax.image.resize(jnp.asarray(m), (side, side), "nearest")).reshape(-1)
        np.testing.assert_array_equal(n(tctl._resize_nearest(torch.from_numpy(m), side)), expect)
    assert n(tctl._resize_nearest(torch.arange(16.0).reshape(4, 4), 2)).tolist() == [5, 7, 13, 15]


def _auto_controls(**kw):
    jc = jctl.build_masactrl_control(10, 16, JMasaCfg(), auto_mask=True, **kw)
    tc = tctl.build_masactrl_control(10, 16, TMasaCfg(), auto_mask=True, device="cpu", **kw)
    return jc, tc


@pytest.mark.parametrize("seq", [64, 256, 1024])
def test_auto_override_matches_jax(seq, recorded_bias):
    """Masks from two recorded 256-token cross maps (token 1 for the source,
    tokens 1 and 2 for the target), resized to the site; with nothing
    recorded, plain mutual attention; ungated, normal attention."""
    jc, tc = _auto_controls(thres=0.3, cur_token_idx=(1, 2))
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 4, 2, 256, 77).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cross_j = jatt.AttnSite(layer=4, place="down", seq_len=256, is_cross=True)
    cross_t = tatt.AttnSite(layer=4, place="down", seq_len=256, is_cross=True)
    js, ts = jc.at_step(7), tc.at_step(7)
    assert ts.record_key(cross_t) == js.record_key(cross_j) == cross_t.key
    assert ts.record_key(tatt.AttnSite(2, "down", 1024, True)) is None
    running_j = {f"k{j}": js.record(cross_j, jnp.asarray(p)) for j, p in enumerate(probs)}
    running_t = {f"k{j}": ts.record(cross_t, t(p)) for j, p in enumerate(probs)}
    for key in running_j:
        np.testing.assert_allclose(n(running_t[key]), n(running_j[key]), atol=1e-7, rtol=0)
    for a, b in zip(ts.masks_from(running_t), js._masks_from(running_j)):
        np.testing.assert_allclose(n(a), n(b), atol=1e-6, rtol=0)
        assert (a - 0.3).abs().min() > MARGIN
    q, k, v = _qkv(7, n=seq)
    jsite, tsite = _sites(12, seq)
    for step, running in ((7, True), (7, False), (0, True)):
        out_j = jc.at_step(step).self_override(jsite, *map(jnp.asarray, (q, k, v)), running_j if running else {},
                                               use_flash=True)
        out_t = tc.at_step(step).self_override(tsite, t(q), t(k), t(v), running_t if running else {})
        np.testing.assert_allclose(n(out_t), n(out_j), atol=ATOL_UNIT, rtol=0)
    _check_biases(recorded_bias, 4, (seq,))


def test_union_bias_reaches_the_kernel_materialised(recorded_bias):
    """The union plan's segment bias is a (B, 2N) contiguous f32 tensor:
    sources see their own keys only, gated targets both segments."""
    tc = tctl.build_masactrl_control(10, 16, TMasaCfg(mode="union"), device="cpu")
    q, k, v = _qkv(8)
    tatt.self_attention(t(q), t(k), t(v), tc.at_step(7).self_plan(_sites(12, 64)[1], 4))
    _check_biases(recorded_bias, 4, (128,))
    bias = recorded_bias[0]
    assert (bias[0, :64] == NEG_INF).all() and (bias[0, 64:] == 0).all() and (bias[1] == 0).all()


@pytest.mark.parametrize("width", [32, 768, 2048])
def test_pca_direction_matches_jax(width):
    """Same vector, same sign, for three random (3, 77, D) embeddings: the
    tiny pipelines' D = 32 (where torch's own LAPACK picks the other sign),
    SD1.5's 768 and SDXL's 2048."""
    for seed in range(3):
        emb = np.random.RandomState(seed).randn(3, 77, width).astype(np.float32)
        vj, vt = np.asarray(jmasa.pca_direction(jnp.asarray(emb))), n(tmasa.pca_direction(t(emb)))
        np.testing.assert_allclose(vt, vj, atol=ATOL_UNIT, rtol=0)
        assert np.abs(vt + vj).max() > 100 * ATOL_UNIT  # the opposite sign would be far off


# ------------------------------------------------------------------ end to end


@pytest.fixture(scope="module")
def pipes():
    return shared_pipelines(num_steps=STEPS)


@pytest.fixture
def auto_margins(monkeypatch):
    """Each (mask_s16, mask_t16)'s distance from the threshold, as the
    port's auto-mask sites compute them."""
    gaps = []
    real = tctl.MasaCtrlAutoStep.masks_from

    def recording(self, running):
        out = real(self, running)
        gaps.append(min((m - self.thres).abs().min().item() for m in out))
        return out

    monkeypatch.setattr(tctl.MasaCtrlAutoStep, "masks_from", recording)
    return gaps


def _inputs(seed, side=16, width=32):
    rng = np.random.RandomState(seed)
    return dict(
        latent=rng.randn(1, side, side, 4).astype(np.float32),
        replay=rng.randn(STEPS + 1, 1, side, side, 4).astype(np.float32),
        uncond=(rng.randn(STEPS, 77, width) * 0.5).astype(np.float32),
        mask_s=_asymmetric_mask(seed + 10, (2 * side, 2 * side)),
        mask_t=_asymmetric_mask(seed + 11, (2 * side, 2 * side)),
    )


# (name, config kwargs, masactrl_edit kwargs built from the inputs)
VARIANTS = {
    "mutual": ({}, lambda x: {}),
    "union": (dict(mode="union"), lambda x: {}),
    "mask": ({}, lambda x: dict(mask_s=x["mask_s"], mask_t=x["mask_t"])),
    "auto": ({}, lambda x: dict(auto_mask=True, thres=AUTO_THRES, cur_token_idx=(2,))),
    "source_replay": ({}, lambda x: dict(source_replay=x["replay"])),
    "uncond_seq": (dict(mode="union"), lambda x: dict(uncond_seq=x["uncond"])),
    "direction": ({}, lambda x: dict(direction_scale=2.0, neg_prompt="a blurry photo")),
}


def run_both(pipes, monkeypatch, variant, inputs, start_layer, height):
    """masactrl_edit on both pipelines from the same inputs: (JAX latents,
    port latents, JAX images, port images)."""
    jpipe, tpipe = pipes
    cfg_kw, edit_kw = VARIANTS[variant]
    cfg_kw = dict(start_step=1, start_layer=start_layer, **cfg_kw)
    kw = edit_kw(inputs)
    jlat, tlat = recorded_latents(monkeypatch, jmasa), recorded_latents(monkeypatch, tmasa)
    jimg = jmasa.masactrl_edit(jpipe, PROMPTS, jnp.asarray(inputs["latent"]), JMasaCfg(**cfg_kw),
                               JSampler(height=height, width=height),
                               **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
                               use_flash=True)
    timg = tmasa.masactrl_edit(tpipe, PROMPTS, t(inputs["latent"]), TMasaCfg(**cfg_kw),
                               TSampler(height=height, width=height),
                               **{k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    return jlat[0], tlat[0], jimg, timg


def check_edit(jlat, tlat, jimg, timg, height):
    assert torch.isfinite(tlat).all()
    np.testing.assert_allclose(n(tlat), n(jlat), atol=ATOL, rtol=0)
    assert timg.shape == (2, height, height, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_masactrl_edit_matches_jax(pipes, monkeypatch, auto_margins, variant):
    """The tiny SD UNet's gated layers (from 2 of 4, every step from 1) sit
    at 256 tokens, where the auto-mask variant finds the down block's
    256-token cross-attention maps recorded earlier in the same forward."""
    jlat, tlat, jimg, timg = run_both(pipes, monkeypatch, variant, _inputs(0), start_layer=2, height=32)
    check_edit(jlat, tlat, jimg, timg, 32)
    if variant == "auto":
        assert len(auto_margins) == 2 * STEPS and min(auto_margins) > MARGIN, auto_margins


def test_default_config_clamps_to_tiny_nets(pipes):
    jpipe, tpipe = pipes
    assert tmasa.default_masactrl_config(tpipe) == TMasaCfg(start_step=4, start_layer=2)
    assert jmasa.default_masactrl_config(jpipe).start_layer == 2
