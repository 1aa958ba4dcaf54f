"""MasaCtrl on the tiny SDXL pipeline, the port against the JAX package:
``masactrl_edit`` in all four variants and with ``source_replay`` and
``uncond_seq``, and through ``cli.run_method`` with the MasaCtrl
command-line options. Final latents within atol 1e-3 and images within 1 uint8
level (tests/test_torch_masactrl.py, whose helpers this file shares).

The tiny XL UNet's attention sites all sit at 64 tokens: the masks are
resized from 32 x 32 to 8 x 8, and the auto-mask variant finds no 256-token
cross-attention map, so it runs plain mutual attention, as the JAX package
does (and as SDXL at 1024², which has no 256-token site, does on the card).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_masactrl as base
from image_editing_framework_torch import cli as tcli
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.methods import masactrl as tmasa
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_tpu import cli as jcli
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.methods import masactrl as jmasa
from torch_port_helpers import n, shared_pipelines, t


@pytest.fixture(scope="module")
def pipes():
    return shared_pipelines(num_steps=base.STEPS, model_type="xl")


@pytest.mark.parametrize("variant", ["mutual", "union", "mask", "auto", "source_replay", "uncond_seq"])
def test_xl_masactrl_edit_matches_jax(pipes, monkeypatch, variant):
    """Gated from layer 4 of 8 (the up block's four), every step from 1."""
    seen = []
    monkeypatch.setattr(tctl.MasaCtrlAutoStep, "masks_from", lambda self, running: seen.append(running))
    jlat, tlat, jimg, timg = base.run_both(pipes, monkeypatch, variant, base._inputs(1), start_layer=4, height=32)
    base.check_edit(jlat, tlat, jimg, timg, 32)
    assert not seen  # no 256-token cross map: no auto mask is built


def test_xl_run_method_masactrl_matches_jax(pipes):
    """The normal entry with the MasaCtrl command-line options merged in
    (explicit steps and layers, a negative prompt); the default
    configuration's layers clamped to the tiny net alike."""
    jpipe, tpipe = pipes
    assert tmasa.default_masactrl_config(tpipe).start_layer == jmasa.default_masactrl_config(jpipe).start_layer == 6
    args = types.SimpleNamespace(neg_prompt="a blurry photo", step_idx="1,2,3", layer_idx="4,6,7")
    kw_t, kw_j = tcli._masactrl_cli_kwargs(args, tpipe, None), jcli._masactrl_cli_kwargs(args, jpipe, None)
    assert dataclasses.asdict(kw_t.pop("config")) == dataclasses.asdict(cfg_j := kw_j.pop("config"))
    assert kw_t == kw_j == {"neg_prompt": "a blurry photo"}
    assert (cfg_j.step_idx, cfg_j.layer_idx) == ((1, 2, 3), (4, 6, 7))
    assert tcli._int_list("") is None and tcli._int_list("3, 5,") == jcli._int_list("3, 5,") == (3, 5)
    x = base._inputs(2)
    kw_t = tcli._masactrl_cli_kwargs(args, tpipe, None)
    jout = jcli.run_method("masactrl", jpipe, base.PROMPTS, jnp.asarray(x["latent"]), JSampler(height=32, width=32),
                           method_kwargs=jcli._masactrl_cli_kwargs(args, jpipe, None))
    tout = tcli.run_method("masactrl", tpipe, base.PROMPTS, t(x["latent"]), TSampler(height=32, width=32),
                           method_kwargs=kw_t)
    for a, b in zip(tout, jout):
        assert a.shape == (32, 32, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1
