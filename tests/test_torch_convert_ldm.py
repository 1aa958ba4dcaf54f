"""The port's LDM single-file conversion (``models/convert_ldm.py``) against
the JAX package's, function by function, on the tiny LDM state dicts that
``tests/test_convert_ldm.py`` builds (equal keys, bitwise-equal arrays), and
its full-width key coverage on ``meta`` modules (no memory): the rename
table equals JAX's for SD1.5, SD2.1, SDXL and the refiner, and the inverse
rename of every ``state_dict()`` key of the port's full-width UNet, VAE,
CLIP-L, OpenCLIP-H and bigG comes back through the converter with its
shape."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from image_editing_framework_torch.models import configs as port_configs
from image_editing_framework_torch.models import convert_ldm as port
from image_editing_framework_torch.models.clip import CLIP_VIT_L, OPEN_CLIP_BIG_G, OPEN_CLIP_VIT_H, CLIPTextModel
from image_editing_framework_torch.models.unet import UNet2DCondition
from image_editing_framework_torch.models.vae import AutoencoderKL, VAEConfig
from image_editing_framework_tpu.models import configs as jax_configs
from image_editing_framework_tpu.models import convert_ldm as ref
from image_editing_framework_tpu.models import loader
from image_editing_framework_tpu.models.clip import TINY_CLIP, CLIPTextModel as JCLIP
from image_editing_framework_tpu.models.unet import UNet2DCondition as JUNet
from image_editing_framework_tpu.models.vae import TINY_VAE, AutoencoderKL as JVAE
from test_convert_ldm import to_ldm_unet, to_ldm_vae
from torch_port_helpers import chip_smoke, export_random

UNETS = {"sd15": "SD15_UNET", "sd21": "SD21_UNET", "sdxl": "SDXL_UNET", "refiner": "SDXL_REFINER_UNET",
         "tiny": "TINY_UNET", "tiny_xl": "TINY_XL_UNET", "tiny_refiner": "TINY_REFINER_UNET"}


def _as_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _same(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) else np.asarray(got[key])
        assert g.dtype == value.dtype and g.shape == value.shape, key
        np.testing.assert_array_equal(g, value, err_msg=key)


@pytest.fixture(scope="module")
def tiny_dicts():
    """diffusers-keyed tiny UNet (SD and XL), VAE and CLIP dicts of JAX
    params, numpy f32."""
    added = {"text_embeds": jnp.zeros((1, 16)), "time_ids": jnp.zeros((1, 6))}
    x, ctx = jnp.zeros((1, 16, 16, 4)), jnp.zeros((1, 77, 32))
    return {"unet": export_random(JUNet(jax_configs.TINY_UNET), 0, loader.unet_key, x, 0, ctx),
            "xl": export_random(JUNet(jax_configs.TINY_XL_UNET), 1, loader.unet_key, x, 0, ctx, None, added, False),
            "vae": export_random(JVAE(TINY_VAE), 2, loader.vae_key, jnp.zeros((1, 32, 32, 3))),
            "clip": export_random(JCLIP(TINY_CLIP), 3, loader.clip_key, jnp.zeros((1, 77), jnp.int32))}


@pytest.mark.parametrize("name", sorted(UNETS))
def test_rename_table_equals_jax(name):
    attr = UNETS[name]
    assert port.unet_rename_table(getattr(port_configs, attr)) == ref.unet_rename_table(getattr(jax_configs, attr))


@pytest.mark.parametrize("which", ["unet", "xl"])
def test_convert_ldm_unet_matches_jax(tiny_dicts, which):
    cfg_name = "TINY_UNET" if which == "unet" else "TINY_XL_UNET"
    diff = tiny_dicts[which]
    ldm = to_ldm_unet(diff, getattr(jax_configs, cfg_name))
    # chip_smoke.py's inverse rename (the port's tables) gives the same file
    assert set(chip_smoke().to_ldm_unet(diff, getattr(port_configs, cfg_name))) == set(ldm)
    want = ref.convert_ldm_unet(ldm, getattr(jax_configs, cfg_name))
    _same(port.convert_ldm_unet(_as_torch(ldm), getattr(port_configs, cfg_name)), want)
    table_p, table_j = (port.unet_rename_table(getattr(port_configs, cfg_name)),
                        ref.unet_rename_table(getattr(jax_configs, cfg_name)))
    for key in diff:
        assert port._translate_unet_key(key, table_p) == ref._translate_unet_key(key, table_j), key
    with pytest.raises(KeyError):
        port._translate_unet_key("nowhere.weight", table_p)


def test_convert_ldm_vae_matches_jax(tiny_dicts):
    ldm = to_ldm_vae(tiny_dicts["vae"], TINY_VAE)
    mine = chip_smoke().to_ldm_vae(_as_torch(tiny_dicts["vae"]), VAEConfig(block_out_channels=(16, 32)))
    _same(mine, ldm)  # chip_smoke.py's inverse: the same keys, the 1x1 convs
    want = ref.convert_ldm_vae(ldm, TINY_VAE)
    got = port.convert_ldm_vae(_as_torch(ldm), VAEConfig(block_out_channels=(16, 32), layers_per_block=1))
    _same(got, want)
    assert got["encoder.mid_block.attentions.0.to_q.weight"].dim() == 2  # squeezed to a linear


def test_convert_text_matches_jax(tiny_dicts):
    clip = tiny_dicts["clip"]
    sd1 = {f"cond_stage_model.transformer.{k}": v for k, v in clip.items()}
    sd1["model.diffusion_model.out.0.weight"] = np.ones(4, np.float32)
    _same(port.convert_ldm_text(_as_torch(sd1)), ref.convert_ldm_text(sd1))
    sd2 = chip_smoke().to_open_clip(clip, "cond_stage_model.model.")
    got, want = port.convert_ldm_text(_as_torch(sd2)), ref.convert_ldm_text(sd2)
    _same(got, want)
    _same(got, clip)  # the inverse above undone, text_projection included
    xl = chip_smoke().to_open_clip(clip, "conditioner.embedders.1.model.")
    _same(port.convert_open_clip_text(_as_torch(xl), "conditioner.embedders.1.model."),
          ref.convert_open_clip_text(xl, "conditioner.embedders.1.model."))
    assert port.convert_open_clip_text(_as_torch(xl), "cond_stage_model.model.") == {}
    with pytest.raises(KeyError):
        port.convert_ldm_text({"model.diffusion_model.out.0.weight": torch.ones(4)})


def test_convert_single_file_matches_jax(tiny_dicts, tmp_path):
    ucfg_j, ucfg_p = jax_configs.TINY_UNET, port_configs.TINY_UNET
    vcfg_p = VAEConfig(block_out_channels=(16, 32), layers_per_block=1)
    state = {**to_ldm_unet(tiny_dicts["unet"], ucfg_j), **to_ldm_vae(tiny_dicts["vae"], TINY_VAE),
             **{f"cond_stage_model.transformer.{k}": v for k, v in tiny_dicts["clip"].items()}}
    path = str(tmp_path / "sd.safetensors")
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, path)
    for got, want in zip(port.convert_single_file(path, ucfg_p, vcfg_p), ref.convert_single_file(path, ucfg_j,
                                                                                                  TINY_VAE)):
        _same(got, want)

    ucfg_j, ucfg_p = jax_configs.TINY_XL_UNET, port_configs.TINY_XL_UNET
    state = {**to_ldm_unet(tiny_dicts["xl"], ucfg_j), **to_ldm_vae(tiny_dicts["vae"], TINY_VAE),
             **{f"conditioner.embedders.0.transformer.{k}": v for k, v in tiny_dicts["clip"].items()},
             **chip_smoke().to_open_clip(tiny_dicts["clip"], "conditioner.embedders.1.model.")}
    path = str(tmp_path / "xl.safetensors")
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, path)
    got, want = (port.convert_single_file_xl(path, ucfg_p, vcfg_p),
                 ref.convert_single_file_xl(path, ucfg_j, TINY_VAE))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same(g, w)


def _meta(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)


def _covers(got, module):
    """``got`` fills every tensor of ``module`` (which holds parameters only,
    so a checkpoint load leaves nothing of ``to_empty`` unfilled)."""
    assert not list(module.buffers())
    want = module.state_dict()
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for key, value in want.items():
        assert tuple(got[key].shape) == tuple(value.shape), key


@pytest.mark.parametrize("name", ["sd15", "sd21", "sdxl", "refiner"])
def test_full_width_unet_keys_round_trip_on_meta(name):
    cfg = getattr(port_configs, UNETS[name])
    module = _meta(UNet2DCondition, cfg)
    _covers(port.convert_ldm_unet(chip_smoke().to_ldm_unet(module.state_dict(), cfg), cfg), module)


def test_full_width_vae_and_text_keys_round_trip_on_meta():
    vae = _meta(AutoencoderKL, VAEConfig())
    _covers(port.convert_ldm_vae(chip_smoke().to_ldm_vae(vae.state_dict(), VAEConfig()), VAEConfig()), vae)
    clip_l = _meta(CLIPTextModel, CLIP_VIT_L)
    state = {f"cond_stage_model.transformer.{k}": v for k, v in clip_l.state_dict().items()}
    _covers(port.convert_ldm_text(state), clip_l)
    for cfg, prefix in ((OPEN_CLIP_VIT_H, "cond_stage_model.model."), (OPEN_CLIP_BIG_G,
                                                                       "conditioner.embedders.1.model.")):
        tower = _meta(CLIPTextModel, cfg)
        _covers(port.convert_open_clip_text(chip_smoke().to_open_clip(tower.state_dict(), prefix), prefix), tower)
