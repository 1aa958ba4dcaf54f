"""The SDXL slice as a whole on the tiny XL and tiny refiner pipelines: prompt
encoding, addition time ids, DDIM inversion, the Prompt-to-Prompt edit and
img2img refinement, JAX against the port, with shared weights, shared
latents and shared noise (mirrors tests/test_xl_pipeline.py:30-124,149-199).

Both run in f32 on the CPU; the JAX UNet takes its explicit XLA
self-attention (the Pallas kernels are held against the port in
tests/test_torch_flash_attention.py), the port its flash kernel's plain
version. Tolerances: encodings atol 1e-4; the inversion trajectory and the
final latents atol 1e-3 (4 steps of f32 UNet differences, amplified by the
DDIM coefficients at high timesteps), as tests/test_torch_pipeline.py;
decoded uint8 images within 1 level. The tiny XL UNet has no 16 x 16
cross-attention site, so LocalBlend has nothing to record there and the
edits run without it, as the JAX package's own XL tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch import pipelines as tpipelines
from image_editing_framework_torch.core.config import P2PConfig as TP2PConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.core.scheduler import add_noise as t_add_noise
from image_editing_framework_torch.inversion.ddim import ddim_invert as t_invert
from image_editing_framework_torch.methods import base as tbase
from image_editing_framework_torch.methods import common as tcommon
from image_editing_framework_torch.methods.img2img import img2img as t_img2img
from image_editing_framework_torch.methods.img2img import refiner_time_ids as t_refiner_time_ids
from image_editing_framework_torch.methods.p2p import p2p_edit as t_p2p_edit
from image_editing_framework_torch.methods.p2p import p2p_setup
from image_editing_framework_tpu.core.config import P2PConfig as JP2PConfig
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.core.scheduler import add_noise as j_add_noise
from image_editing_framework_tpu.inversion.ddim import ddim_invert as j_invert
from image_editing_framework_tpu.methods import base as jbase
from image_editing_framework_tpu.methods import common as jcommon
from image_editing_framework_tpu.methods.img2img import img2img as j_img2img
from image_editing_framework_tpu.methods.img2img import refiner_time_ids as j_refiner_time_ids
from image_editing_framework_tpu.methods.p2p import p2p_edit as j_p2p_edit
from image_editing_framework_tpu.ops import controls as jctl
from torch_port_helpers import n, shared_pipelines, t

STEPS = 4
ATOL_ENC = 1e-4
ATOL_LAT = 1e-3
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]


@pytest.fixture(scope="module")
def pipes():
    return {kind: shared_pipelines(num_steps=STEPS, model_type=kind) for kind in ("xl", "xl-refiner")}


def _close(a, b, atol):
    np.testing.assert_allclose(n(a), n(b), atol=atol, rtol=0)


def test_xl_encode_prompts_matches_jax(pipes):
    jpipe, tpipe = pipes["xl"]
    jctx, jadded = jpipe.encode_prompts(PROMPTS)
    ctx, added = tpipe.encode_prompts(PROMPTS)
    assert ctx.shape == (4, 77, 32) and added["text_embeds"].shape == (4, 16) and sorted(added) == ["text_embeds"]
    # zeros for the empty negative prompt (force_zeros_for_empty_prompt)
    assert not ctx[:2].any() and not added["text_embeds"][:2].any()
    assert ctx[2:].abs().max() > 0 and added["text_embeds"][2:].abs().max() > 0
    _close(ctx, jctx, ATOL_ENC)
    _close(added["text_embeds"], jadded["text_embeds"], ATOL_ENC)
    # a negative prompt is encoded, not zeroed
    jctx, jadded = jpipe.encode_prompts(PROMPTS[:1], "a blurry photo")
    ctx, added = tpipe.encode_prompts(PROMPTS[:1], "a blurry photo")
    assert ctx[0].abs().max() > 0 and added["text_embeds"][0].abs().max() > 0
    _close(ctx, jctx, ATOL_ENC)
    _close(added["text_embeds"], jadded["text_embeds"], ATOL_ENC)


def test_refiner_encode_prompts_matches_jax(pipes):
    """Single tower, full-width context, and an encoded (non-zero) empty
    prompt on the unconditional half."""
    jpipe, tpipe = pipes["xl-refiner"]
    assert tpipe.is_refiner and tpipe.text_encoder_2 is tpipe.text_encoder
    jctx, jadded = jpipe.encode_prompts(PROMPTS[:1])
    ctx, added = tpipe.encode_prompts(PROMPTS[:1])
    assert ctx.shape == (2, 77, 32) and added["text_embeds"].shape == (2, 16)
    assert ctx[0].abs().max() > 0
    _close(ctx, jctx, ATOL_ENC)
    _close(added["text_embeds"], jadded["text_embeds"], ATOL_ENC)
    with torch.no_grad():
        empty = tpipe.text_encoder_2(tpipe._token_ids([""]))["penultimate"][0]
    _close(ctx[0], empty, 1e-6)


def test_add_time_ids_match_jax(pipes):
    (jbase_pipe, tbase_pipe), (jref, tref) = pipes["xl"], pipes["xl-refiner"]
    ids = tbase_pipe.add_time_ids(128, 96, 3)
    assert ids.shape == (3, 6) and ids.dtype == torch.float32
    assert np.array_equal(n(ids), n(jbase_pipe.add_time_ids(128, 96, 3)))
    assert np.array_equal(n(ids[0]), [128, 96, 0, 0, 128, 96])
    rids = tref.add_time_ids(1024, 1024, 2, 2.5)
    assert np.array_equal(n(rids), n(jref.add_time_ids(1024, 1024, 2, 2.5)))
    assert np.array_equal(n(rids[1]), [1024, 1024, 0, 0, 2.5])
    assert np.array_equal(n(t_refiner_time_ids(1024, 1024, 2)), n(j_refiner_time_ids(1024, 1024, 2)))
    assert np.array_equal(n(t_refiner_time_ids(1024, 1024, 2, 6.0)), n(tref.add_time_ids(1024, 1024, 2, 6.0)))


def test_prepare_conditioning_matches_jax(pipes):
    jpipe, tpipe = pipes["xl"]
    jctx, jadded = jcommon.prepare_conditioning(jpipe, PROMPTS, 128, 128)
    ctx, added = tcommon.prepare_conditioning(tpipe, PROMPTS, 128, 128)
    assert sorted(added) == ["text_embeds", "time_ids"] and added["time_ids"].shape == (4, 6)
    _close(ctx, jctx, ATOL_ENC)
    for key in added:
        _close(added[key], jadded[key], ATOL_ENC)
    _, sd = shared_pipelines(num_steps=STEPS)
    assert tcommon.prepare_conditioning(sd, PROMPTS, 32, 32)[1] is None


def test_xl_invert_and_p2p_edit_match_jax(pipes):
    jpipe, tpipe = pipes["xl"]
    img = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    start = np.asarray(jpipe.image2latent(img))
    _close(tpipe.image2latent(img), start, ATOL_ENC)

    jlast, jtraj, jctx, jadded = j_invert(jpipe, jnp.asarray(start), PROMPTS[0], use_flash=False)
    tlast, ttraj, tctx, tadded = t_invert(tpipe, t(start), PROMPTS[0])
    assert sorted(tadded) == sorted(jadded) == ["text_embeds", "time_ids", "uncond_text_embeds"]
    # XL force-zeros the empty prompt's pooled embeds, so the two halves differ
    assert not tadded["uncond_text_embeds"].any() and tadded["text_embeds"].abs().max() > 0
    for key in tadded:
        assert tadded[key].shape[0] == 1
        _close(tadded[key], jadded[key], ATOL_ENC)
    _close(tctx, jctx, ATOL_ENC)
    assert ttraj.shape == (STEPS + 1, 1, 16, 16, 4)
    for i in range(STEPS + 1):
        np.testing.assert_allclose(n(ttraj[i]), n(jtraj[i]), atol=ATOL_LAT, rtol=0, err_msg=f"inversion step {i}")
    _close(tlast, jlast, ATOL_LAT)

    shared = np.asarray(jlast)
    jcfg, tcfg = JP2PConfig(edit_type="replace"), TP2PConfig(edit_type="replace")
    jctrl = jctl.build_p2p_control(PROMPTS, jpipe.tokenizer, STEPS, jcfg)
    jc, ja = jcommon.prepare_conditioning(jpipe, PROMPTS, 32, 32)
    jfinal, _ = jbase.denoise(jpipe, jcommon.expand_latent(jnp.asarray(shared), 2), jc, jctrl, added_cond=ja,
                              use_flash=False)
    sampler = TSampler(height=32, width=32)
    lat0, context, ctrl, blend, added = p2p_setup(tpipe, PROMPTS, t(shared), tcfg, sampler)
    assert blend is None and added["time_ids"].shape == (4, 6)
    tfinal = tbase.denoise(tpipe, lat0, context, ctrl, guidance_scale=sampler.guidance_scale, added_cond=added)
    _close(tfinal, jfinal, ATOL_LAT)
    assert not torch.allclose(tfinal[0], tfinal[1], atol=10 * ATOL_LAT)
    unedited = tbase.denoise(tpipe, lat0, context, None, guidance_scale=sampler.guidance_scale, added_cond=added)
    assert not torch.allclose(tfinal, unedited, atol=10 * ATOL_LAT)  # the control is live

    jimg = j_p2p_edit(jpipe, PROMPTS, jnp.asarray(shared), jcfg, JSampler(height=32, width=32), use_flash=False)
    timg = t_p2p_edit(tpipe, PROMPTS, t(shared), tcfg, sampler)
    assert timg.shape == (2, 32, 32, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1


@pytest.mark.parametrize("kind", ["xl", "xl-refiner"])
def test_img2img_matches_jax(pipes, kind):
    """img2img on the base and on the refiner flavour (5 time ids, single
    tower, the unconditional half at the negative aesthetic score), with the
    noise the JAX function draws from its seed handed to the port."""
    jpipe, tpipe = pipes[kind]
    img = np.random.RandomState(3).randint(0, 255, (32, 32, 3), np.uint8)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1, 16, 16, 4), jnp.float32))
    ref = j_img2img(jpipe, img, "a cat", strength=0.5, seed=7, use_flash=False)
    out = t_img2img(tpipe, img, "a cat", strength=0.5, noise=t(noise))
    assert out.shape == (1, 32, 32, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    other = t_img2img(tpipe, img, "a cat", strength=0.5, noise=t(noise[:, ::-1].copy()))
    assert np.abs(other.astype(int) - out.astype(int)).max() > 1  # the noise is live


def test_img2img_takes_noise_or_a_generator(pipes):
    _, tpipe = pipes["xl-refiner"]
    img = np.random.RandomState(4).randint(0, 255, (32, 32, 3), np.uint8)
    with pytest.raises(ValueError, match="noise"):
        t_img2img(tpipe, img, "a cat")
    a = t_img2img(tpipe, img, "a cat", strength=0.5, generator=torch.Generator().manual_seed(1))
    b = t_img2img(tpipe, img, "a cat", strength=0.5, generator=torch.Generator().manual_seed(1))
    c = t_img2img(tpipe, img, "a cat", strength=0.5, generator=torch.Generator().manual_seed(2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_add_noise_matches_jax(pipes):
    jpipe, tpipe = pipes["xl"]
    rng = np.random.RandomState(5)
    x0, noise = rng.randn(1, 16, 16, 4).astype(np.float32), rng.randn(1, 16, 16, 4).astype(np.float32)
    for step in (0, STEPS - 1):
        ts = int(tpipe.scheduler.timesteps[step])
        ref = j_add_noise(jpipe.scheduler, jnp.asarray(x0), jnp.asarray(noise), jpipe.scheduler.timesteps[step])
        _close(t_add_noise(tpipe.scheduler, t(x0), t(noise), ts), ref, 1e-6)


@pytest.mark.parametrize("version,model_type,unet,towers", [
    ("1.5", "sd", "SD15_UNET", ("CLIP_VIT_L",)),
    ("2.1", "sd", "SD21_UNET", ("OPEN_CLIP_VIT_H",)),
    ("xl", "xl", "SDXL_UNET", ("CLIP_VIT_L", "OPEN_CLIP_BIG_G")),
    ("xl-refiner", "xl", "SDXL_REFINER_UNET", ("OPEN_CLIP_BIG_G",)),
])
def test_random_pipeline_builds_every_family(monkeypatch, version, model_type, unet, towers):
    """Which architectures ``random_pipeline`` assembles for each family; the
    modules themselves are not built (no full-width model on the CPU)."""
    from image_editing_framework_torch.models import clip as tclip
    from image_editing_framework_torch.models import configs as tconfigs

    built = []

    def build(cls, config, device, dtype, seed):
        built.append(config)
        return (cls.__name__, config, seed)

    monkeypatch.setattr(tpipelines, "_build", build)
    pipe = tpipelines.random_pipeline(version, num_steps=3, device="cpu")
    assert pipe.model_type == model_type and pipe.is_refiner == (version == "xl-refiner")
    assert pipe.unet[1] is getattr(tconfigs, unet)
    assert pipe.text_encoder[1] is getattr(tclip, towers[0])
    if model_type == "xl":
        assert pipe.text_encoder_2[1] is tclip.OPEN_CLIP_BIG_G and pipe.tokenizer_2 is pipe.tokenizer
        assert (pipe.text_encoder_2 is pipe.text_encoder) == pipe.is_refiner
    else:
        assert pipe.text_encoder_2 is None and pipe.tokenizer_2 is None
    assert len(built) == 2 + len(towers) and pipe.scheduler.num_steps == 3


def test_pipeline_builders_refuse_unknown_families():
    with pytest.raises(ValueError, match="sd_version"):
        tpipelines.random_pipeline("3.0", device="cpu")
    with pytest.raises(ValueError, match="model_type"):
        tpipelines.tiny_pipeline(model_type="xxl", device="cpu")
