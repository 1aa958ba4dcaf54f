"""The port's UNets and VAE at production width against the JAX package's,
one forward each, in f32 on the CPU: SD1.5, SD2.1, SDXL base and refiner
UNets and the SD VAE (encode and decode).

The port's module is built with seeded random weights (``random_init_``);
its ``state_dict`` goes to JAX through the JAX package's production
``loader.load_params`` (on the ``eval_shape`` skeleton), so the key mapping
and the layout transposes are exercised at full width too. The JAX UNet
takes its plain XLA attention (``use_flash=False``). Limits as the JAX
package's full-width oracle tests hold theirs
(``tests/test_unet_torch_parity.py``): atol = rtol = 2e-3 for SD1.x/2.1 and
the VAE, 3e-3 for the SDXL UNets.

The full-width cases are marked ``slow`` (each holds three f32 copies of
its weights on the host); ``test_parity_helpers_at_tiny_width`` runs the
same helpers on the tiny configurations in the fast suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.models import configs as tconfigs
from image_editing_framework_torch.models.unet import UNet2DCondition as TUNet
from image_editing_framework_torch.models.vae import TINY_VAE as T_TINY_VAE
from image_editing_framework_torch.models.vae import AutoencoderKL as TVAE
from image_editing_framework_torch.models.vae import VAEConfig as TVAEConfig
from image_editing_framework_torch.models.weights import random_init_
from image_editing_framework_tpu.models import configs as jconfigs
from image_editing_framework_tpu.models import loader
from image_editing_framework_tpu.models.unet import UNet2DCondition as JUNet
from image_editing_framework_tpu.models.vae import TINY_VAE as J_TINY_VAE
from image_editing_framework_tpu.models.vae import AutoencoderKL as JVAE
from image_editing_framework_tpu.models.vae import VAEConfig as JVAEConfig


def _state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def unet_parity(name, side, seed, tol, time_ids=None, pooled=None):
    """One f32 UNet forward of configuration ``name`` at a ``side``² latent,
    the port against JAX on the port's random weights."""
    tcfg, jcfg = getattr(tconfigs, name), getattr(jconfigs, name)
    port = random_init_(TUNet(tcfg), seed).eval().requires_grad_(False)
    rng = np.random.RandomState(seed)
    x = rng.randn(1, side, side, 4).astype(np.float32)
    ctx = rng.randn(1, 77, tcfg.cross_attention_dim).astype(np.float32)
    added = None
    if time_ids is not None:
        added = {"text_embeds": rng.randn(1, pooled).astype(np.float32),
                 "time_ids": np.asarray([time_ids], np.float32)}
    jadded = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    m = JUNet(jcfg)
    skeleton = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.asarray(x), 0, jnp.asarray(ctx), None,
                                             jadded, False))
    params = loader.load_params(skeleton, _state(port), loader.unet_key)
    ref, _ = m.apply(params, jnp.asarray(x), jnp.asarray([421]), jnp.asarray(ctx), None, jadded, False)
    with torch.no_grad():
        out, _ = port(torch.from_numpy(x), 421, torch.from_numpy(ctx), None,
                      None if added is None else {k: torch.from_numpy(v) for k, v in added.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol, rtol=tol)


def vae_parity(tcfg, jcfg, side, seed, tol):
    """The VAE's scaled encode mean and decode, port against JAX."""
    port = random_init_(TVAE(tcfg), seed).eval().requires_grad_(False)
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (1, side, side, 3)).astype(np.float32)
    vae = JVAE(jcfg)
    skeleton = jax.eval_shape(lambda: vae.init(jax.random.PRNGKey(0), jnp.asarray(img)))
    params = loader.load_params(skeleton, _state(port), loader.vae_key)
    with torch.no_grad():
        mean = port.encode(torch.from_numpy(img))
        z = torch.from_numpy(rng.randn(*mean.shape).astype(np.float32))
        dec = port.decode(z)
    np.testing.assert_allclose(mean.numpy(), np.asarray(vae.apply(params, jnp.asarray(img), method=JVAE.encode)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(dec.numpy(), np.asarray(vae.apply(params, jnp.asarray(z.numpy()),
                                                                 method=JVAE.decode)), atol=tol, rtol=tol)


def test_parity_helpers_at_tiny_width():
    unet_parity("TINY_UNET", 16, 0, 2e-4)
    unet_parity("TINY_XL_UNET", 16, 1, 2e-4, time_ids=(32, 32, 0, 0, 32, 32), pooled=16)
    vae_parity(T_TINY_VAE, J_TINY_VAE, 32, 2, 2e-4)


@pytest.mark.slow
def test_sd15_unet_full_width_matches_jax():
    unet_parity("SD15_UNET", 64, 0, 2e-3)


@pytest.mark.slow
def test_sd21_unet_full_width_matches_jax():
    unet_parity("SD21_UNET", 48, 1, 2e-3)


@pytest.mark.slow
def test_sdxl_unet_full_width_matches_jax():
    unet_parity("SDXL_UNET", 32, 2, 3e-3, time_ids=(1024, 1024, 0, 0, 1024, 1024), pooled=1280)


@pytest.mark.slow
def test_sdxl_refiner_unet_full_width_matches_jax():
    unet_parity("SDXL_REFINER_UNET", 32, 3, 3e-3, time_ids=(1024, 1024, 0, 0, 6.0), pooled=1280)


@pytest.mark.slow
def test_sd_vae_full_width_matches_jax():
    vae_parity(TVAEConfig(), JVAEConfig(), 256, 4, 2e-3)
