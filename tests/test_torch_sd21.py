"""SD2.1 in the port against the JAX package, on the CPU.

SD2.1's UNet differs from SD1.5's in three ways that the tiny SD1.5-shaped
pipeline never reaches: a fixed head dim of 64 at every level (5/10/20/20
heads), linear (not 1x1-conv) projections around each transformer, and a
1024-wide cross-attention from OpenCLIP-H, an exact-gelu text tower with no
pooled projection. Its 768² latent (96²) gives self-attention sites of
9216/2304/576/144 tokens, with no 256-token site: LocalBlend's and MasaCtrl's
auto mask's 16x16 maps are never recorded, so both idle, in JAX as in the
port, while P2P's self-replacement (at <= 256 tokens) acts at the 144-token
mid-block site alone.

The tests here hold a tiny model of that shape: two levels of 32 and 64
channels at 2 and 4 heads (head dim 16 at both), linear projections, a
3-layer gelu tower; at a 24² latent its sites are 576 and 144 tokens. Weights
come from seeded numpy draws into the JAX parameter tree (``eval_shape``, no
init compiled), carried to the port by ``export_params`` and the strict
loader. f32; tolerances as the SD1.5 tests hold them (UNet and tower 1e-4,
four steps of inversion and edit 1e-3, images within one level).

The full-width family is built once on ``meta`` (``random_pipeline("2.1",
device="meta")``) and its every parameter shape held to JAX's tree. An
SD2.x single file of the tiny model loads through both registries alike,
and through the port's conversion tool bitwise as from the file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch import pipelines as tpipelines
from image_editing_framework_torch.core.config import MasaCtrlConfig as TMasaCfg
from image_editing_framework_torch.core.config import P2PConfig as TP2PConfig
from image_editing_framework_torch.core.config import SamplerConfig as TSampler
from image_editing_framework_torch.inversion.ddim import ddim_invert as t_invert
from image_editing_framework_torch.methods import base as tbase
from image_editing_framework_torch.methods import masactrl as tmasa
from image_editing_framework_torch.methods.p2p import p2p_edit as t_p2p_edit
from image_editing_framework_torch.methods.p2p import p2p_setup
from image_editing_framework_torch.models import clip as tclip
from image_editing_framework_torch.models import configs as tconfigs
from image_editing_framework_torch.models.unet import UNet2DCondition as TUNet
from image_editing_framework_torch.models.unet import UNetConfig as TUNetConfig
from image_editing_framework_torch.models.vae import TINY_VAE as T_TINY_VAE
from image_editing_framework_torch.models.weights import load_weights
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_torch.pipelines import tiny_pipeline as torch_tiny_pipeline
from image_editing_framework_tpu.core.config import MasaCtrlConfig as JMasaCfg
from image_editing_framework_tpu.core.config import P2PConfig as JP2PConfig
from image_editing_framework_tpu.core.config import SamplerConfig as JSampler
from image_editing_framework_tpu.inversion.ddim import ddim_invert as j_invert
from image_editing_framework_tpu.methods import masactrl as jmasa
from image_editing_framework_tpu.methods.p2p import p2p_edit as j_p2p_edit
from image_editing_framework_tpu.models import clip as jclip
from image_editing_framework_tpu.models import configs as jconfigs
from image_editing_framework_tpu.models import loader
from image_editing_framework_tpu.models.clip import CLIPTextModel as JCLIP
from image_editing_framework_tpu.models.unet import UNet2DCondition as JUNet
from image_editing_framework_tpu.models.unet import UNetConfig as JUNetConfig
from image_editing_framework_tpu.models.vae import AutoencoderKL as JVAE
from image_editing_framework_tpu.models.vae import VAEConfig as JVAEConfig
from image_editing_framework_tpu.ops import controls as jctl
from image_editing_framework_tpu.pipelines import tiny_pipeline as jax_tiny_pipeline
from torch_port_helpers import n, recorded_latents, t

STEPS = 4
ATOL = 1e-4  # one UNet forward or tower, f32
EDIT_ATOL = 1e-3  # four steps of inversion or edit, f32
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]
BLEND = (("cat",), ("dog",))
SIDE = 24  # latent side: 576 tokens at the outer level, 144 at the mid block; no 256-token site
IMAGE = 2 * SIDE  # the tiny VAE halves the side
# SD2.1's structure at tiny width: a fixed head dim (16) at both levels,
# linear projections; the mid block runs at the inner level's 4 heads
TINY_SD21 = dict(block_out_channels=(32, 64), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1, num_heads=(2, 4),
                 transformer_layers=(1, 1), cross_attention_dim=32, use_linear_projection=True)
# OPEN_CLIP_VIT_H's settings (exact gelu, 4x MLP, no pooled projection) at tiny width and depth
TINY_H = dict(hidden_size=32, num_layers=3, num_heads=2, intermediate_size=128, hidden_act="gelu",
              projection_dim=None, vocab_size=64)


def random_params(module, seed, *args):
    """Flax params of ``module`` with its tree's shapes (``eval_shape``: no
    init runs) and N(0, 0.02²) values from a seeded numpy generator, norm
    scales centred at 1."""
    skeleton = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)
    flat = {path: jnp.asarray((rng.randn(*leaf.shape) * 0.02 + (path[-1] == "scale")).astype(np.float32))
            for path, leaf in loader._flatten(skeleton["params"]).items()}
    return {"params": loader._unflatten(flat)}


def _frozen(module):
    return module.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipe, port pipe): the tiny SD pipelines with the SD2.1-shaped
    UNet and the gelu tower in place of theirs, one set of weights."""
    junet = JUNet(JUNetConfig(**TINY_SD21))
    uparams = random_params(junet, 0, jnp.zeros((1, 16, 16, 4)), 0, jnp.zeros((1, 77, 32)), None, None, False)
    jtext = JCLIP(dataclasses.replace(jclip.TINY_CLIP, **TINY_H))
    tparams = random_params(jtext, 1, jnp.zeros((1, 77), jnp.int32))
    jpipe = dataclasses.replace(jax_tiny_pipeline(num_steps=STEPS), unet=junet, unet_params=uparams,
                                text_encoder=jtext, text_params=tparams)
    tpipe = torch_tiny_pipeline(num_steps=STEPS, device="cpu")
    tpipe.unet = _frozen(load_weights(TUNet(TUNetConfig(**TINY_SD21)), loader.export_params(uparams,
                                                                                            loader.unet_key)))
    tpipe.text_encoder = _frozen(load_weights(tclip.CLIPTextModel(dataclasses.replace(tclip.TINY_CLIP, **TINY_H)),
                                              loader.export_params(tparams, loader.clip_key)))
    load_weights(tpipe.vae, loader.export_params(jpipe.vae_params, loader.vae_key))
    return jpipe, tpipe


def _sites(tpipe, lat, ctx):
    """Self-attention sites' token counts of one port forward."""
    seen = []
    real = tctl.NoneStep.self_plan

    def spy(self, site, batch, device=None):
        if not site.is_cross:
            seen.append(site.seq_len)
        return real(self, site, batch, device)

    tctl.NoneStep.self_plan = spy
    try:
        tpipe.unet_apply(lat, 501, ctx)
    finally:
        tctl.NoneStep.self_plan = real
    return seen


@pytest.mark.parametrize("control", ["none", "p2p_self_gated"])
def test_sd21_shaped_unet_matches_jax(pipes, control):
    """One forward at the 24² latent: no control, and a P2P step with its
    self-replace gate on and LocalBlend recording on: no 256-token cross
    site, so neither framework records a map; the 144-token site takes the
    source's Q/K."""
    jpipe, tpipe = pipes
    rng = np.random.RandomState(2)
    lat = rng.randn(4, SIDE, SIDE, 4).astype(np.float32)
    ctx = rng.randn(4, 77, 32).astype(np.float32)
    assert sorted(set(_sites(tpipe, t(lat[:1]), t(ctx[:1])))) == [144, 576]
    jstep = tstep = None
    if control != "none":
        jc = jctl.build_p2p_control(PROMPTS, jpipe.tokenizer, STEPS, JP2PConfig(), record_blend=True)
        tc = tctl.build_p2p_control(PROMPTS, tpipe.tokenizer, STEPS, TP2PConfig(), record_blend=True)
        assert bool(jc.self_gate[1]) and tc.at_step(1).self_gate
        jstep, tstep = jc.at_step(1), tc.at_step(1)
    ref, jrec = jpipe.unet_apply(jnp.asarray(lat), 721, jnp.asarray(ctx), jstep, use_flash=False)
    out, trec = tpipe.unet_apply(t(lat), 721, t(ctx), tstep)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)
    assert trec == {} and not jrec
    if control != "none":
        # the 144-token site's self-replacement is live: the same step with
        # its gate off gives another output
        ungated, _ = tpipe.unet_apply(t(lat), 721, t(ctx), dataclasses.replace(tstep, self_gate=False))
        assert (out - ungated).abs().max().item() > 1e-5


def test_gelu_tower_at_open_clip_h_settings_matches_jax(pipes):
    jpipe, tpipe = pipes
    assert tpipe.text_encoder.config.hidden_act == "gelu" and not hasattr(tpipe.text_encoder, "text_projection")
    ids = tpipe._token_ids(["a cat sitting on the grass", ""])
    ref = jpipe.text_encoder.apply(jpipe.text_params, jnp.asarray(n(ids), jnp.int32))
    with torch.no_grad():
        out = tpipe.text_encoder(ids)
    for key in ("last_hidden_state", "penultimate"):
        np.testing.assert_allclose(n(out[key]), n(ref[key]), atol=ATOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(n(tpipe.encode_prompts_sd(PROMPTS)), n(jpipe.encode_prompts_sd(PROMPTS)), atol=ATOL,
                               rtol=0)


def test_sd21_invert_and_p2p_edit_match_jax(pipes):
    """DDIM inversion at batch 1 and the P2P replace edit at CFG batch 4 with
    LocalBlend's words given, at the 24² latent. LocalBlend idles in both
    (no 256-token maps): the edit equals the one without blend words."""
    jpipe, tpipe = pipes
    img = (np.random.RandomState(0).rand(IMAGE, IMAGE, 3) * 255).astype(np.uint8)
    jlat = jpipe.image2latent(img)
    np.testing.assert_allclose(n(tpipe.image2latent(img)), n(jlat), atol=ATOL, rtol=0)
    start = np.asarray(jlat)
    assert start.shape == (1, SIDE, SIDE, 4)

    jlast, jtraj, _, _ = j_invert(jpipe, jnp.asarray(start), PROMPTS[0], use_flash=False)
    tlast, ttraj, _, _ = t_invert(tpipe, t(start), PROMPTS[0])
    assert ttraj.shape == (STEPS + 1, 1, SIDE, SIDE, 4)
    for i in range(STEPS + 1):
        np.testing.assert_allclose(n(ttraj[i]), n(jtraj[i]), atol=EDIT_ATOL, rtol=0, err_msg=f"inversion step {i}")

    shared = np.asarray(jlast)
    sampler = TSampler(height=IMAGE, width=IMAGE)
    jimg = j_p2p_edit(jpipe, PROMPTS, jnp.asarray(shared), JP2PConfig(blend_words=BLEND),
                      JSampler(height=IMAGE, width=IMAGE), use_flash=False)
    timg = t_p2p_edit(tpipe, PROMPTS, t(shared), TP2PConfig(blend_words=BLEND), sampler)
    assert timg.shape == (2, IMAGE, IMAGE, 3) and timg.dtype == np.uint8 and timg.std() > 0
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1

    lat0, ctx, ctrl, blend, _ = p2p_setup(tpipe, PROMPTS, t(shared), TP2PConfig(blend_words=BLEND), sampler)
    assert blend is not None and ctrl.record_blend
    with_blend = tbase.denoise(tpipe, lat0, ctx, ctrl, guidance_scale=sampler.guidance_scale, blend=blend)
    lat0, ctx, ctrl, none, _ = p2p_setup(tpipe, PROMPTS, t(shared), TP2PConfig(), sampler)
    assert none is None
    without = tbase.denoise(tpipe, lat0, ctx, ctrl, guidance_scale=sampler.guidance_scale)
    assert torch.equal(with_blend, without)


def test_masactrl_auto_mask_idles_without_256_token_maps(pipes, monkeypatch):
    """MasaCtrl's auto mask reads the 256-token cross maps of the forward so
    far; at the 24² latent there are none, and both frameworks fall back to
    plain mutual attention (masactrl/model/attention_control.py:293-296)."""
    jpipe, tpipe = pipes
    latent = np.random.RandomState(4).randn(1, SIDE, SIDE, 4).astype(np.float32)
    cfg = dict(start_step=1, start_layer=0)
    jlat, tlat = recorded_latents(monkeypatch, jmasa), recorded_latents(monkeypatch, tmasa)
    jimg = jmasa.masactrl_edit(jpipe, PROMPTS, jnp.asarray(latent), JMasaCfg(**cfg),
                               JSampler(height=IMAGE, width=IMAGE), auto_mask=True, use_flash=False)
    timg = tmasa.masactrl_edit(tpipe, PROMPTS, t(latent), TMasaCfg(**cfg), TSampler(height=IMAGE, width=IMAGE),
                               auto_mask=True)
    np.testing.assert_allclose(n(tlat[0]), n(jlat[0]), atol=EDIT_ATOL, rtol=0)
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1
    tmasa.masactrl_edit(tpipe, PROMPTS, t(latent), TMasaCfg(**cfg), TSampler(height=IMAGE, width=IMAGE))
    assert torch.equal(tlat[0], tlat[1])  # the auto mask idled: plain mutual attention


def _jax_shapes(module, key_fn, *args):
    """{diffusers key: torch-layout shape} of a JAX module's parameter tree,
    from ``eval_shape`` (nothing is allocated: zero-stride views)."""
    skeleton = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    zero = np.zeros((), np.float32)
    return {key_fn(path): tuple(loader.to_torch_tensor(np.broadcast_to(zero, leaf.shape), path[-1]).shape)
            for path, leaf in loader._flatten(skeleton["params"]).items()}


def test_full_width_sd21_on_meta_matches_jax_shapes():
    """``random_pipeline("2.1")`` at full width on ``meta``: the SD2.1 UNet
    (865.9M parameters), OpenCLIP-H (23 layers, 1024 wide, gelu) and the VAE,
    every parameter's shape equal to JAX's, leaf by leaf."""
    pipe = tpipelines.random_pipeline("2.1", num_steps=3, device="meta")
    assert pipe.unet.config is tconfigs.SD21_UNET and pipe.text_encoder.config is tclip.OPEN_CLIP_VIT_H
    assert dataclasses.asdict(tconfigs.SD21_UNET) == dataclasses.asdict(jconfigs.SD21_UNET)
    ctx = jnp.zeros((1, 77, 1024))
    want = {"unet": _jax_shapes(JUNet(jconfigs.SD21_UNET), loader.unet_key, jnp.zeros((1, 16, 16, 4)), 0, ctx, None,
                                None, False),
            "text_encoder": _jax_shapes(JCLIP(jclip.OPEN_CLIP_VIT_H), loader.clip_key, jnp.zeros((1, 77), jnp.int32)),
            "vae": _jax_shapes(JVAE(JVAEConfig()), loader.vae_key, jnp.zeros((1, 64, 64, 3)))}
    for name, shapes in want.items():
        got = {k: tuple(v.shape) for k, v in getattr(pipe, name).state_dict().items()}
        assert got == shapes, (name, sorted(set(got) ^ set(shapes))[:8])
        assert all(v.is_meta for v in getattr(pipe, name).state_dict().values())
    count = sum(p.numel() for p in pipe.unet.parameters())
    assert count == sum(int(np.prod(s)) for s in want["unet"].values()) and 8.6e8 < count < 8.7e8
    assert {m.heads for m in pipe.unet.modules() if hasattr(m, "heads")} == {5, 10, 20}  # head dim 64 throughout
    assert len(pipe.text_encoder.text_model.encoder.layers) == 23


def test_sd21_single_file_and_its_conversion_load_as_in_jax(pipes, tmp_path, monkeypatch):
    """``load_pipeline("2.1")`` from an SD2.x single file (OpenCLIP text
    tower under ``cond_stage_model.model.``, one resblock more than the
    tower runs, a tokenizer beside it) in the port and in JAX: the same
    embeddings and UNet output (1e-4); and the port's
    ``tools/convert_checkpoint.py --family sd21`` output, loaded as a
    snapshot, bitwise equal to the single-file load (the family's configs
    swapped for the tiny ones here)."""
    from safetensors.numpy import save_file

    from image_editing_framework_torch.models import registry as tregistry
    from image_editing_framework_torch.models import vae as tvae
    from image_editing_framework_torch.tools import convert_checkpoint
    from image_editing_framework_tpu.models import registry as jregistry
    from image_editing_framework_tpu.models.vae import TINY_VAE as J_TINY_VAE
    from torch_port_helpers import chip_smoke

    smoke, vocab_size = chip_smoke(), 600
    jpipe, _ = pipes
    jtext_cfg = dataclasses.replace(jclip.TINY_CLIP, **dict(TINY_H, vocab_size=vocab_size))
    ttext_cfg = dataclasses.replace(tclip.TINY_CLIP, **dict(TINY_H, vocab_size=vocab_size))
    text = {k: np.asarray(v) for k, v in loader.export_params(
        random_params(JCLIP(jtext_cfg), 3, jnp.zeros((1, 77), jnp.int32)), loader.clip_key).items()}
    last = TINY_H["num_layers"] - 1
    text.update({k.replace(f"layers.{last}.", f"layers.{last + 1}."): v for k, v in list(text.items())
                 if f"layers.{last}." in k})
    ucfg = JUNetConfig(**TINY_SD21)
    def tensors(params, key_fn):
        return {k: torch.tensor(np.asarray(v)) for k, v in loader.export_params(params, key_fn).items()}

    state = {**smoke.to_ldm_unet(tensors(jpipe.unet_params, loader.unet_key), TUNetConfig(**TINY_SD21)),
             **smoke.to_ldm_vae(tensors(jpipe.vae_params, loader.vae_key), T_TINY_VAE),
             **smoke.to_open_clip(text, "cond_stage_model.model.")}
    single = tmp_path / "single" / "model.safetensors"
    single.parent.mkdir()
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in state.items()}, str(single))
    vocab, merges = smoke.synthetic_clip_vocab(" ".join(PROMPTS).split(), vocab_size)
    smoke.write_tokenizer(str(tmp_path / "single" / "tokenizer"), vocab, merges)

    jspec = jregistry.VersionSpec("sd", ucfg, jtext_cfg, vae=J_TINY_VAE, sample_size=768)
    tspec = tregistry.VersionSpec("sd", TUNetConfig(**TINY_SD21), ttext_cfg, vae=T_TINY_VAE,
                                  sample_size=768)
    jload = jregistry.load_pipeline("2.1", STEPS, path=str(single), spec=jspec)
    tload = tregistry.load_pipeline("2.1", STEPS, path=str(single), spec=tspec, device="cpu")
    assert len(tload.text_encoder.text_model.encoder.layers) == TINY_H["num_layers"]
    jctx, _ = jload.encode_prompts(PROMPTS)
    ctx, _ = tload.encode_prompts(PROMPTS)
    np.testing.assert_allclose(n(ctx), n(jctx), atol=ATOL, rtol=0)
    lat = np.random.RandomState(5).randn(4, SIDE, SIDE, 4).astype(np.float32)
    ref, _ = jload.unet_apply(jnp.asarray(lat), 500, jctx, None, None, use_flash=False)
    out, _ = tload.unet_apply(t(lat), 500, ctx)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)

    monkeypatch.setattr(tconfigs, "SD21_UNET", TUNetConfig(**TINY_SD21))
    monkeypatch.setattr(tvae, "VAEConfig", lambda scaling_factor: dataclasses.replace(
        T_TINY_VAE, scaling_factor=scaling_factor))
    snapshot = str(tmp_path / "converted")
    assert convert_checkpoint.main([str(single), snapshot, "--family", "sd21"]) == 0
    smoke.write_tokenizer(str(tmp_path / "converted" / "tokenizer"), vocab, merges)
    again = tregistry.load_pipeline("2.1", STEPS, path=snapshot, spec=tspec, device="cpu")
    for name in ("unet", "vae", "text_encoder"):
        a, b = getattr(tload, name).state_dict(), getattr(again, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name
