"""The port's cubic resize (``utils/images.py resize``), the runway's
synthetic source image, the CLIP vision tower and ``clip_preprocess``
against the JAX package, on the CPU in float32.

- ``resize`` against ``jax.image.resize`` (Keys cubic, with and without
  antialias) within ``RESIZE_ATOL`` = 1e-5 on [0, 1] data; its weight
  matrices against JAX's compiled ``compute_weight_mat`` within 2.5e-7 (two
  float32 ulps of 1; the suite compiles JAX without XLA's optimisations,
  ``tests/conftest.py``, so both compute the kernel op by op, and XLA sums
  in its own order);
- ``synth_source_image`` byte for byte against JAX's (a rounding tie could
  flip a byte: at most 1 level on at most 1e-4 of the bytes is allowed,
  and none flipped at these seeds);
- the vision tower at ``TINY_CLIP_VISION`` from a transformers-random
  ``CLIPVisionModelWithProjection`` state dict: ``pooled`` and
  ``image_embeds`` within 1e-5 of JAX's (and of transformers');
- ``clip_preprocess`` on uint8 64² and 512² within 1e-5 of JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from image_editing_framework_torch.eval import validate as tvalidate
from image_editing_framework_torch.models import clip as tclip
from image_editing_framework_torch.models.loader import load_params
from image_editing_framework_torch.utils.images import resize, resize_weights
from image_editing_framework_tpu.eval import validate as jvalidate
from image_editing_framework_tpu.models import clip as jclip
from image_editing_framework_tpu.models import loader as jloader

RESIZE_ATOL = 1e-5
WEIGHTS_ATOL = 2.5e-7
TOWER_ATOL = 1e-5
PREPROCESS_ATOL = 1e-5


@pytest.mark.parametrize("src,dst,method,antialias", [
    ((1, 512, 512, 3), (1, 224, 224, 3), "bicubic", True),
    ((2, 1024, 1024, 3), (2, 224, 224, 3), "bicubic", True),
    ((1, 37, 37, 3), (1, 224, 224, 3), "bicubic", True),
    ((32, 32, 3), (512, 512, 3), "cubic", True),
    ((1, 512, 384, 3), (1, 224, 224, 3), "bicubic", False),
])
def test_resize_matches_jax(src, dst, method, antialias):
    x = np.random.RandomState(sum(src)).rand(*src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, method, antialias=antialias))
    got = resize(torch.from_numpy(x), dst, method, antialias=antialias)
    assert got.dtype == torch.float32 and tuple(got.shape) == dst
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("m,n", [(512, 224), (1024, 224), (64, 224), (37, 224), (4, 64), (32, 512)])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_weights_are_jaxs(m, n, antialias):
    want = jax.jit(lambda: jax_scale.compute_weight_mat(m, n, n / m, 0.0, jax_scale._fill_keys_cubic_kernel,
                                                        antialias))()
    got = resize_weights(m, n, antialias)
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=WEIGHTS_ATOL)


def test_resize_refuses_other_methods():
    with pytest.raises(ValueError, match="cubic"):
        resize(torch.zeros(1, 8, 8, 3), (1, 4, 4, 3), "linear")
    with pytest.raises(ValueError, match="rank"):
        resize(torch.zeros(1, 8, 8, 3), (4, 4, 3))


@pytest.mark.parametrize("seed,res", [(42, 64), (7, 512), (43, 64)])
def test_synth_source_image_is_jaxs(seed, res):
    want = jvalidate.synth_source_image(seed, res)
    got = tvalidate.synth_source_image(seed, res)
    assert got.shape == want.shape == (res, res, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size, (diff.max(), np.count_nonzero(diff))


@pytest.fixture(scope="module")
def hf_vision():
    """A transformers-random CLIPVisionModelWithProjection at TINY_CLIP_VISION
    and its state dict as numpy arrays."""
    os.environ.setdefault("USE_TF", "0")
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    cfg = tclip.TINY_CLIP_VISION
    torch.manual_seed(0)
    hf = CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, image_size=cfg.image_size, patch_size=cfg.patch_size,
        projection_dim=cfg.projection_dim, hidden_act=cfg.hidden_act)).eval()
    return hf, {k: v.numpy() for k, v in hf.state_dict().items()}


def test_vision_tower_matches_jax_and_transformers(hf_vision):
    hf, ckpt = hf_vision
    port = tclip.CLIPVisionModel(tclip.TINY_CLIP_VISION)
    assert set(port.state_dict()) == set(ckpt) - {"vision_model.embeddings.position_ids"}
    assert "vision_model.pre_layrnorm.weight" in port.state_dict()  # the upstream spelling
    load_params(port, ckpt, strict=False)
    jmodel = jclip.CLIPVisionModel(jclip.TINY_CLIP_VISION)
    skeleton = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = jloader.load_params(skeleton, ckpt, jloader.clip_vision_key)
    px = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(px))
    with torch.no_grad():
        got = port(torch.from_numpy(px))
        hf_out = hf(pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2)))
    for key in ("pooled", "image_embeds"):
        assert tuple(got[key].shape) == (3, 32)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=TOWER_ATOL)
    np.testing.assert_allclose(got["image_embeds"].numpy(), hf_out.image_embeds.numpy(), rtol=0, atol=TOWER_ATOL)


def test_clip_score_text_tower_is_not_openai_b32s():
    """ROADMAP C3: both packages' CLIPScore build a 768-wide, 12-head text
    tower with a 3072 MLP beside ViT-B/32; openai/clip-vit-base-patch32's is
    transformers' CLIPTextConfig() default, 512 wide, 8 heads, MLP 2048."""
    from transformers import CLIPTextConfig as HFTextConfig

    hf = HFTextConfig()
    openai = (hf.hidden_size, hf.num_attention_heads, hf.intermediate_size, hf.projection_dim)
    assert openai == (512, 8, 2048, 512)
    for clip in (jclip, tclip):
        text = clip.CLIPTextConfig(projection_dim=clip.CLIP_VIT_B32_VISION.projection_dim)
        assert (text.hidden_size, text.num_heads, text.intermediate_size, text.projection_dim) == (768, 12, 3072, 512)
        assert clip.CLIP_VIT_B32_VISION == clip.CLIPVisionConfig()


def test_vision_constants_are_jaxs():
    for name in ("CLIP_VIT_B32_VISION", "TINY_CLIP_VISION"):
        assert getattr(tclip, name).__dict__ == getattr(jclip, name).__dict__
    assert tclip.CLIP_IMAGE_MEAN == jclip.CLIP_IMAGE_MEAN and tclip.CLIP_IMAGE_STD == jclip.CLIP_IMAGE_STD


@pytest.mark.parametrize("side", [64, 512])
def test_clip_preprocess_matches_jax(side):
    imgs = np.random.RandomState(side).randint(0, 256, (2, side, side, 3)).astype(np.uint8)
    want = np.asarray(jclip.clip_preprocess(jnp.asarray(imgs)))
    got = tclip.clip_preprocess(torch.from_numpy(imgs))
    assert tuple(got.shape) == (2, 224, 224, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PREPROCESS_ATOL)
