"""The SDXL modules of the port against the JAX package's: the UNet with
``added_cond`` on the tiny XL and tiny refiner configurations, the OpenCLIP
flavour of the text encoder (exact gelu, a pooled projection), the tiled VAE
decode, and the checkpointed UNet.

Everything runs in f32 on the CPU with the JAX tiny pipelines' weights
carried across by the port's strict loader; the JAX UNet takes its explicit
XLA self-attention path. Tolerance: atol 1e-4, as tests/test_torch_models.py
(f32 sums through ~20 layers in another order). The checkpointed UNet is
held to the plain one bit for bit, the claim of tests/test_grad_remat.py:39.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.methods.common import grad_unet as t_grad_unet
from image_editing_framework_torch.models import configs as tconfigs
from image_editing_framework_torch.models.clip import TINY_CLIP as T_TINY_CLIP
from image_editing_framework_torch.models.clip import CLIPTextModel as TCLIP
from image_editing_framework_torch.models.unet import UNet2DCondition as TUNet
from image_editing_framework_torch.models.vae import decode_tiled as t_decode_tiled
from image_editing_framework_torch.models.weights import load_weights
from image_editing_framework_tpu.models import configs as jconfigs
from image_editing_framework_tpu.models import loader
from image_editing_framework_tpu.models.clip import TINY_CLIP as J_TINY_CLIP
from image_editing_framework_tpu.models.clip import CLIPTextModel as JCLIP
from image_editing_framework_tpu.models.vae import AutoencoderKL as JVAE
from image_editing_framework_tpu.models.vae import decode_tiled as j_decode_tiled
from torch_port_helpers import n, shared_pipelines, t

ATOL = 1e-4


@pytest.fixture(scope="module")
def pipes():
    return {kind: shared_pipelines(num_steps=4, model_type=kind) for kind in ("xl", "xl-refiner")}


def _inputs(kind, batch, seed):
    rng = np.random.RandomState(seed)
    lat = rng.randn(batch, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(batch, 77, 32).astype(np.float32)
    ids = [[128, 96, 0, 8, 6.0]] if kind == "xl-refiner" else [[128, 96, 0, 8, 128, 96]]
    added = {"text_embeds": rng.randn(batch, 16).astype(np.float32),
             "time_ids": np.tile(np.asarray(ids, np.float32), (batch, 1))}
    return lat, ctx, added


@pytest.mark.parametrize("kind", ["xl", "xl-refiner"])
def test_xl_unet_with_added_cond_matches_jax(pipes, kind):
    """Linear projections, 2 transformer layers per site, attention-free
    outermost blocks (and innermost, for the refiner), the add_embedding."""
    jpipe, tpipe = pipes[kind]
    lat, ctx, added = _inputs(kind, 2, 0)
    ref, _ = jpipe.unet_apply(jnp.asarray(lat), 501, jnp.asarray(ctx), None,
                              {k: jnp.asarray(v) for k, v in added.items()}, use_flash=False)
    out, rec = tpipe.unet_apply(t(lat), 501, t(ctx), None, {k: t(v) for k, v in added.items()})
    assert rec == {}
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)
    # the added conditions are live: other time ids, another output
    other = dict(added, time_ids=added["time_ids"] * 0.5)
    moved, _ = tpipe.unet_apply(t(lat), 501, t(ctx), None, {k: t(v) for k, v in other.items()})
    assert not torch.allclose(moved, out, atol=1e-3)


def test_xl_unet_needs_added_cond_and_keeps_diffusers_keys(pipes):
    _, tpipe = pipes["xl"]
    lat, ctx, _ = _inputs("xl", 1, 1)
    with pytest.raises(ValueError, match="added_cond"):
        tpipe.unet_apply(t(lat), 501, t(ctx))
    keys = set(tpipe.unet.state_dict())
    assert {"add_embedding.linear_1.weight", "add_embedding.linear_2.bias"} <= keys
    assert "down_blocks.1.attentions.0.transformer_blocks.1.attn2.to_k.weight" in keys
    assert tpipe.unet.state_dict()["down_blocks.1.attentions.0.proj_in.weight"].dim() == 2  # linear projection


@pytest.mark.parametrize("name", ["SD21_UNET", "SDXL_UNET", "SDXL_REFINER_UNET", "TINY_XL_UNET",
                                  "TINY_REFINER_UNET", "SD15_UNET", "TINY_UNET"])
def test_unet_presets_match_jax(name):
    jc, tc = getattr(jconfigs, name), getattr(tconfigs, name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.forward_layout() == jc.forward_layout()
    assert tc.num_transformer_blocks == jc.num_transformer_blocks


def test_full_width_xl_unets_build_on_the_meta_device():
    """The production presets construct (no memory is taken on the meta
    device): parameter counts and the number of self-attention sites."""
    assert (tconfigs.SD_VAE_SCALING, tconfigs.SDXL_VAE_SCALING) == (jconfigs.SD_VAE_SCALING, jconfigs.SDXL_VAE_SCALING)
    with torch.device("meta"):
        xl, refiner = TUNet(tconfigs.SDXL_UNET), TUNet(tconfigs.SDXL_REFINER_UNET)
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert 2.5e9 < count(xl) < 2.7e9 and 2.2e9 < count(refiner) < 2.4e9
    assert tconfigs.SDXL_UNET.num_transformer_blocks == 70
    heads = {m.heads for m in xl.modules() if hasattr(m, "heads")}
    assert heads == {10, 20}  # head dim 64 at 640 and 1280 channels


def test_openclip_flavour_matches_jax():
    """Exact gelu and a pooled text projection (the OpenCLIP towers of SD2.1
    and SDXL), penultimate and pooled outputs included."""
    jcfg = dataclasses.replace(J_TINY_CLIP, hidden_act="gelu", projection_dim=16)
    tcfg = dataclasses.replace(T_TINY_CLIP, hidden_act="gelu", projection_dim=16)
    jm = JCLIP(jcfg)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 77), jnp.int32))
    tm = load_weights(TCLIP(tcfg), loader.export_params(params, loader.clip_key))
    ids = np.random.RandomState(1).randint(0, 63, (2, 77)).astype(np.int32)
    ids[0, 9] = ids[1, 30] = 63  # the EOS position the pooled output reads
    ref = jm.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        out = tm(t(ids).long())
    for key in ("last_hidden_state", "penultimate", "pooled"):
        np.testing.assert_allclose(n(out[key]), n(ref[key]), atol=ATOL, rtol=0, err_msg=key)
    assert out["pooled"].shape == (2, 16)
    quick = load_weights(TCLIP(dataclasses.replace(tcfg, hidden_act="quick_gelu")),
                         loader.export_params(params, loader.clip_key))
    with torch.no_grad():
        assert not torch.allclose(quick(t(ids).long())["pooled"], out["pooled"], atol=1e-3)


def test_openclip_presets_match_jax():
    from image_editing_framework_torch.models import clip as tclip
    from image_editing_framework_tpu.models import clip as jclip

    for name in ("CLIP_VIT_L", "OPEN_CLIP_VIT_H", "OPEN_CLIP_BIG_G", "TINY_CLIP"):
        assert dataclasses.asdict(getattr(tclip, name)) == dataclasses.asdict(getattr(jclip, name))


def test_xl_text_towers_match_jax(pipes):
    """Both towers of the tiny XL pipeline: penultimate states and the
    second tower's projected pooled embedding."""
    jpipe, tpipe = pipes["xl"]
    ids = tpipe._token_ids(["a cat sitting on a mat", ""], tpipe.tokenizer_2)
    for tower, jparams, jmod in ((tpipe.text_encoder, jpipe.text_params, jpipe.text_encoder),
                                 (tpipe.text_encoder_2, jpipe.text_params_2, jpipe.text_encoder_2)):
        ref = jmod.apply(jparams, jnp.asarray(n(ids), jnp.int32))
        with torch.no_grad():
            out = tower(ids)
        for key in ("penultimate", "pooled"):
            np.testing.assert_allclose(n(out[key]), n(ref[key]), atol=ATOL, rtol=0, err_msg=key)
    assert "text_projection.weight" in tpipe.text_encoder_2.state_dict()
    assert "text_projection.weight" not in tpipe.text_encoder.state_dict()


def test_decode_tiled_matches_jax_and_the_full_frame(pipes):
    jpipe, tpipe = pipes["xl"]
    z = (np.random.RandomState(2).randn(2, 24, 20, 4) * 0.5).astype(np.float32)
    full = tpipe.vae.decode(t(z)).detach()
    one_tile = t_decode_tiled(tpipe.vae, t(z), tile=24)
    assert torch.equal(one_tile, full)  # one tile covers the latent: the plain decode
    for tile, overlap in ((16, 8), (8, 16)):  # the second caps the overlap at half the tile
        ref = j_decode_tiled(jpipe.vae, jpipe.vae_params, jnp.asarray(z), tile=tile, overlap=overlap)
        out = t_decode_tiled(tpipe.vae, t(z), tile=tile, overlap=overlap)
        assert out.shape == full.shape
        np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)
        # close to the full-frame decode: the tiles' GroupNorm statistics and
        # border padding differ near seams (tests/test_models.py:137 asks the
        # same of the JAX decode; the smaller tile sees less of the frame)
        assert (out - full).abs().median().item() < (0.05 if tile == 16 else 0.15)
    ref_img = jpipe.latent2image(jnp.asarray(z), tile_latent=16)
    img = tpipe.latent2image(t(z), tile_latent=16)
    assert img.dtype == np.uint8 and np.abs(img.astype(int) - ref_img.astype(int)).max() <= 1
    tpipe.decode_tile_latent = 16  # the pipeline's default tile
    try:
        assert np.array_equal(tpipe.latent2image(t(z)), img)
    finally:
        tpipe.decode_tile_latent = None
    np.testing.assert_allclose(n(full), n(jpipe.vae.apply(jpipe.vae_params, jnp.asarray(z), method=JVAE.decode)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["xl", "xl-refiner"])
def test_checkpointed_unet_is_bitwise_identical(pipes, kind):
    """Output and gradients (with respect to the latent and the context) of
    the UNet with every transformer block checkpointed, against the plain
    one: the same bits."""
    _, tpipe = pipes[kind]
    lat, ctx, added = _inputs(kind, 2, 3)
    added = {k: t(v) for k, v in added.items()}
    results = []
    for remat in (False, True):
        x, c = t(lat).requires_grad_(True), t(ctx).requires_grad_(True)
        eps, _ = tpipe.unet(x, 5, c, None, added, remat=remat)
        gx, gc = torch.autograd.grad(eps.square().mean(), (x, c))
        results.append((eps.detach(), gx, gc))
    for plain, ckpt in zip(*results):
        assert torch.equal(plain, ckpt)
    assert results[0][2].abs().max() > 0
    with torch.no_grad():
        assert torch.equal(tpipe.unet(t(lat), 5, t(ctx), None, added, remat=True)[0], results[0][0])


def test_grad_unet_auto_rule(pipes):
    """SD never checkpoints; XL only at latent side >= 128 (1024² pixels);
    an explicit override wins both ways (tests/test_grad_remat.py:27)."""
    _, xl = pipes["xl"]
    _, sd = shared_pipelines(num_steps=4)
    is_remat = lambda f: getattr(f, "keywords", {}).get("remat", False)  # noqa: E731
    assert t_grad_unet(sd, 64) is sd.unet and t_grad_unet(sd, 128) is sd.unet
    assert t_grad_unet(xl, 64) is xl.unet
    assert is_remat(t_grad_unet(xl, 128)) and t_grad_unet(xl, 128).func is xl.unet
    assert is_remat(t_grad_unet(sd, 64, force=True))
    assert t_grad_unet(xl, 128, force=False) is xl.unet
