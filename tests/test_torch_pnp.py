"""Plug-and-Play in the port against the JAX package: the gates, control
tables and site tuples exactly; the Q/K-injection plan and the ResNet hook
exactly; ``pnp_edit`` on the tiny SD and SDXL pipelines (and with NTI
embeddings and a direct-inversion trajectory), and ``cli.run_method`` for
``pnp``, final latents within atol 1e-3 and images within 1 uint8 level,
as tests/test_torch_pipeline.py. Both run in f32 on the CPU; the JAX side
runs its Pallas flash kernel in interpret mode (``use_flash=True``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch import cli as tcli
from image_editing_framework_torch.core.config import PnPConfig as TPnPConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.methods import pnp as tpnp
from image_editing_framework_torch.models import configs as tconfigs
from image_editing_framework_torch.ops import attention as tatt
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_torch.ops import schedules as tsched
from image_editing_framework_tpu import cli as jcli
from image_editing_framework_tpu.core.config import PnPConfig as JPnPConfig
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.methods import pnp as jpnp
from image_editing_framework_tpu.models import configs as jconfigs
from image_editing_framework_tpu.ops import attention as jatt
from image_editing_framework_tpu.ops import controls as jctl
from image_editing_framework_tpu.ops import schedules as jsched
from torch_port_helpers import n, recorded_latents, shared_pipelines, t

STEPS = 4
ATOL = 1e-3
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]
PRESETS = ["SD15_UNET", "SD21_UNET", "SDXL_UNET", "SDXL_REFINER_UNET", "TINY_UNET", "TINY_XL_UNET",
           "TINY_REFINER_UNET"]


@pytest.mark.parametrize("steps,attn_t,f_t", [(50, 0.5, 0.8), (10, 1.0, 1.0), (7, 0.3, 0.0)])
def test_pnp_gates_and_control_tables_equal(steps, attn_t, f_t):
    for a, b in zip(tsched.pnp_gates(steps, attn_t, f_t), jsched.pnp_gates(steps, attn_t, f_t)):
        np.testing.assert_array_equal(a, b)
    jc = jctl.build_pnp_control(steps, JPnPConfig(attn_t, f_t), (8, 9), ("up1_res1",))
    tc = tctl.build_pnp_control(steps, TPnPConfig(attn_t, f_t), (8, 9), ("up1_res1",), device="cpu")
    np.testing.assert_array_equal(n(tc.qk_gate), n(jc.qk_gate))
    np.testing.assert_array_equal(n(tc.conv_gate), n(jc.conv_gate))
    assert (tc.attn_layers, tc.conv_keys) == (jc.attn_layers, jc.conv_keys)


@pytest.mark.parametrize("preset", PRESETS)
def test_pnp_sites_equal(preset):
    for sites in ("pnp_sites_sd", "pnp_sites_xl"):
        assert getattr(tconfigs, sites)(getattr(tconfigs, preset)) == getattr(jconfigs, sites)(
            getattr(jconfigs, preset))
    assert tconfigs.pnp_sites_sd() == ((8, 9, 10, 11, 12, 13, 14, 15), ("up1_res1",))
    assert tconfigs.pnp_sites_xl() == ((64, 65, 66, 67, 68, 69), ("up1_res0",))


def test_pnp_plan_and_resnet_hook_equal():
    jc = jctl.build_pnp_control(10, JPnPConfig(), (8, 9), ("up1_res1",))
    tc = tctl.build_pnp_control(10, TPnPConfig(), (8, 9), ("up1_res1",), device="cpu")
    h = np.random.RandomState(0).randn(4, 3, 5, 6).astype(np.float32)
    for i in (0, 4, 5, 7, 8, 9):  # both gates on, Q/K off, both off
        js, ts = jc.at_step(i), tc.at_step(i)
        for layer in (7, 8, 9):
            site_j = jatt.AttnSite(layer=layer, place="up", seq_len=64, is_cross=False)
            site_t = tatt.AttnSite(layer=layer, place="up", seq_len=64, is_cross=False)
            jp, tp = js.self_plan(site_j, 4), ts.self_plan(site_t, 4)
            assert (jp is None) == (tp is None) == (layer == 7)
            if jp is not None:
                for name in ("q_idx", "k_idx", "v_idx", "valid"):
                    np.testing.assert_array_equal(n(getattr(tp, name)), n(getattr(jp, name)), err_msg=name)
        for key in ("up1_res1", "up1_res0"):
            np.testing.assert_array_equal(n(ts.resnet_hook(key, t(h))), n(js.resnet_hook(key, jnp.asarray(h))))
    with pytest.raises(ValueError):
        tc.at_step(0).self_plan(tatt.AttnSite(8, "up", 64, False), 6)


@pytest.fixture(scope="module")
def pipes():
    return {kind: shared_pipelines(num_steps=STEPS, model_type=kind) for kind in ("sd", "xl")}


@pytest.mark.parametrize("kind,extra", [("sd", None), ("sd", "uncond_seq"), ("sd", "source_replay"), ("xl", None)])
def test_pnp_edit_matches_jax(pipes, monkeypatch, kind, extra):
    """SD: Q/K injected at layer 3 of the tiny net, features at up1_res1;
    XL: the tiny net's second up block has no attention, so only the
    features at up1_res0 are injected. The gates run for the first 2 and 3
    of 4 steps (the defaults 0.5 and 0.8)."""
    jpipe, tpipe = pipes[kind]
    rng = np.random.RandomState(4)
    latent = rng.randn(1, 16, 16, 4).astype(np.float32)
    kw = {}
    if extra == "uncond_seq":
        kw[extra] = (rng.randn(STEPS, 77, 32) * 0.5).astype(np.float32)
    elif extra == "source_replay":
        kw[extra] = rng.randn(STEPS + 1, 1, 16, 16, 4).astype(np.float32)
    jlat, tlat = recorded_latents(monkeypatch, jpnp), recorded_latents(monkeypatch, tpnp)
    jimg = jpnp.pnp_edit(jpipe, PROMPTS, jnp.asarray(latent), JPnPConfig(), JSampler(height=32, width=32),
                         use_flash=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    timg = tpnp.pnp_edit(tpipe, PROMPTS, t(latent), TPnPConfig(), TSampler(height=32, width=32),
                         **{k: t(v) for k, v in kw.items()})
    assert torch.isfinite(tlat[0]).all()
    np.testing.assert_allclose(n(tlat[0]), n(jlat[0]), atol=ATOL, rtol=0)
    assert timg.shape == (2, 32, 32, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1


def test_run_method_pnp_and_p2p_match_jax(pipes):
    """``cli.run_method`` for PnP (with the direct-inversion trajectory as
    ``source_replay``), P2P and pix2pix-zero (which ignores the trajectory;
    the JAX side on its XLA attention) on the tiny SD pipeline; an unknown
    method is refused."""
    jpipe, tpipe = pipes["sd"]
    rng = np.random.RandomState(5)
    latent = rng.randn(1, 16, 16, 4).astype(np.float32)
    replay = rng.randn(STEPS + 1, 1, 16, 16, 4).astype(np.float32)
    for method, replay_arg in (("pnp", replay), ("p2p", None)):
        jout = jcli.run_method(method, jpipe, PROMPTS, jnp.asarray(latent), JSampler(height=32, width=32),
                               source_replay=None if replay_arg is None else jnp.asarray(replay_arg))
        tout = tcli.run_method(method, tpipe, PROMPTS, t(latent), TSampler(height=32, width=32),
                               source_replay=None if replay_arg is None else t(replay_arg))
        for a, b in zip(tout, jout):
            assert a.shape == (32, 32, 3) and a.dtype == np.uint8
            assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1, method
    jout = jcli.run_method("p2z", jpipe, PROMPTS, jnp.asarray(latent), JSampler(height=32, width=32),
                           method_kwargs={"use_flash": False}, source_replay=jnp.asarray(replay))
    tout = tcli.run_method("p2z", tpipe, PROMPTS, t(latent), TSampler(height=32, width=32), source_replay=t(replay))
    for a, b in zip(tout, jout):
        assert a.shape == (32, 32, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1, "p2z"
    with pytest.raises(ValueError):
        tcli.run_method("sdedit", tpipe, PROMPTS, t(latent), TSampler(height=32, width=32))
