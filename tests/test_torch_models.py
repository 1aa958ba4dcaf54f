"""The port's UNet, CLIP and VAE against the JAX package's, with the JAX
tiny pipeline's weights carried across by the port's strict loader.

Everything runs in f32 on the CPU; the JAX UNet takes its explicit XLA
self-attention path (the Pallas kernels' plain reference; the kernels
themselves are held against the port in test_torch_flash_attention.py).
Tolerance: atol 1e-4 (f32 sums through ~20 layers in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.config import P2PConfig as TP2PConfig
from image_editing_framework_torch.models.clip import TINY_CLIP as T_TINY_CLIP
from image_editing_framework_torch.models.clip import CLIPTextModel as TCLIP
from image_editing_framework_torch.models.weights import load_weights, random_init_
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_tpu.core.config import P2PConfig as JP2PConfig
from image_editing_framework_tpu.models import loader
from image_editing_framework_tpu.models.clip import TINY_CLIP as J_TINY_CLIP
from image_editing_framework_tpu.models.clip import CLIPTextModel as JCLIP
from image_editing_framework_tpu.ops import controls as jctl
from torch_port_helpers import n, shared_pipelines, t

ATOL = 1e-4


@pytest.fixture(scope="module")
def pipes():
    return shared_pipelines(num_steps=4)


def _inputs(batch, seed):
    rng = np.random.RandomState(seed)
    lat = rng.randn(batch, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(batch, 77, 32).astype(np.float32)
    return lat, ctx


def test_unet_none_control_matches_jax(pipes):
    jpipe, tpipe = pipes
    lat, ctx = _inputs(2, 0)
    ref, _ = jpipe.unet_apply(jnp.asarray(lat), 501, jnp.asarray(ctx), use_flash=False)
    out, rec = tpipe.unet_apply(t(lat), 501, t(ctx))
    assert rec == {}
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)


def test_unet_p2p_step_matches_jax(pipes):
    """A P2P step with the self-replace gate on (the <=256-token self sites
    take the source's Q/K) and LocalBlend recording on."""
    jpipe, tpipe = pipes
    prompts = ["a cat sitting", "a dog sitting"]
    jc = jctl.build_p2p_control(prompts, jpipe.tokenizer, 4, JP2PConfig(), record_blend=True)
    tc = tctl.build_p2p_control(prompts, tpipe.tokenizer, 4, TP2PConfig(), record_blend=True)
    assert bool(jc.self_gate[1]) and tc.at_step(1).self_gate
    lat, ctx = _inputs(4, 1)
    ref, jrec = jpipe.unet_apply(jnp.asarray(lat), 721, jnp.asarray(ctx), jc.at_step(1), use_flash=False)
    out, trec = tpipe.unet_apply(t(lat), 721, t(ctx), tc.at_step(1))
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)
    assert sorted(trec) == sorted(jrec) and len(trec) == 3  # the three 16x16 cross sites
    for key in trec:
        np.testing.assert_allclose(n(trec[key]), n(jrec[key]), atol=1e-5, rtol=0)
    ungated, _ = tpipe.unet_apply(t(lat), 721, t(ctx))
    assert not torch.allclose(out, ungated, atol=1e-3)  # the edit is live


def test_clip_matches_jax(pipes):
    jpipe, tpipe = pipes
    ids = tpipe._token_ids(["a cat sitting on a mat", ""])
    ref = jpipe.text_encoder.apply(jpipe.text_params, jnp.asarray(n(ids), jnp.int32))
    out = tpipe.text_encoder(ids)
    for key in ("last_hidden_state", "penultimate", "pooled"):
        np.testing.assert_allclose(n(out[key]), n(ref[key]), atol=ATOL, rtol=0, err_msg=key)
    ctx = tpipe.encode_prompts_sd(["a cat sitting on a mat"])
    np.testing.assert_allclose(n(ctx), n(jpipe.encode_prompts_sd(["a cat sitting on a mat"])), atol=ATOL, rtol=0)


def test_clip_with_projection_matches_jax():
    """TINY_CLIP as defined (with a pooled text projection)."""
    import jax

    jm = JCLIP(J_TINY_CLIP)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 77), jnp.int32))
    tm = TCLIP(T_TINY_CLIP)
    load_weights(tm, loader.export_params(params, loader.clip_key))
    ids = np.random.RandomState(0).randint(0, 63, (2, 77)).astype(np.int32)
    ids[:, 10] = 63
    ref, out = jm.apply(params, jnp.asarray(ids)), tm(t(ids).long())
    for key in ("last_hidden_state", "pooled"):
        np.testing.assert_allclose(n(out[key]).astype(np.float32), n(ref[key]), atol=ATOL, rtol=0, err_msg=key)


def test_vae_encode_decode_match_jax(pipes):
    jpipe, tpipe = pipes
    img = (np.random.RandomState(4).rand(2, 32, 32, 3) * 255).astype(np.uint8)
    ref = jpipe.image2latent(img)
    out = tpipe.image2latent(img)
    assert tuple(out.shape) == (2, 16, 16, 4)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)
    lat = np.random.RandomState(5).randn(2, 16, 16, 4).astype(np.float32)
    from image_editing_framework_tpu.models.vae import AutoencoderKL as JVAE

    ref_img = jpipe.vae.apply(jpipe.vae_params, jnp.asarray(lat), method=JVAE.decode)
    with torch.no_grad():
        out_img = tpipe.vae.decode(t(lat))
    np.testing.assert_allclose(n(out_img), n(ref_img), atol=ATOL, rtol=0)
    u8_ref, u8 = jpipe.latent2image(jnp.asarray(lat)), tpipe.latent2image(t(lat))
    assert u8.dtype == np.uint8 and np.abs(u8.astype(int) - u8_ref.astype(int)).max() <= 1


def test_loader_is_strict(pipes):
    jpipe, tpipe = pipes
    arrays = loader.export_params(jpipe.vae_params, loader.vae_key)
    missing = dict(arrays)
    missing.pop("decoder.conv_out.bias")
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        load_weights(tpipe.vae, missing)
    with pytest.raises(KeyError, match="extra"):
        load_weights(tpipe.vae, dict(arrays, **{"decoder.spare.weight": np.zeros(3, np.float32)}))
    wrong = dict(arrays, **{"quant_conv.bias": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="quant_conv.bias"):
        load_weights(tpipe.vae, wrong)


def test_random_init_is_seeded_and_live():
    a, b = TCLIP(T_TINY_CLIP), TCLIP(T_TINY_CLIP)
    random_init_(a, seed=7)
    random_init_(b, seed=7)
    for (ka, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), ka
    norm = a.text_model.final_layer_norm
    assert abs(norm.weight.mean().item() - 1.0) < 0.02 and norm.bias.abs().mean().item() < 0.05
    random_init_(b, seed=8)
    assert not torch.equal(a.text_model.final_layer_norm.weight, b.text_model.final_layer_norm.weight)


def test_entry_points_default_to_the_card():
    """Without a device argument the port runs on cuda, and raises where
    there is no card rather than carrying on on the CPU."""
    from image_editing_framework_torch.core.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
