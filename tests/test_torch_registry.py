"""The port's ``load_pipeline`` against the JAX package's on the same fake
checkpoints, written from JAX tiny params (``export_params``; the values
from numpy, ``torch_port_helpers.export_random``) as
``tests/test_registry.py`` writes them: HF-snapshot directories (SD, and XL
base beside a refiner) and single LDM files (SD and XL), loaded by both
packages in f32. Limits: prompt embeddings, UNet output and VAE decode
within 1e-4 (f32 on both sides; the models' own parity tests hold the same
modules to 1e-4 and tighter)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from image_editing_framework_torch import sd_mapping as port_sd_mapping
from image_editing_framework_torch.models import configs as port_configs
from image_editing_framework_torch.models import registry as port
from image_editing_framework_torch.models.clip import TINY_CLIP as PORT_TINY_CLIP
from image_editing_framework_torch.models.vae import VAEConfig
from image_editing_framework_tpu import sd_mapping as jax_sd_mapping
from image_editing_framework_tpu.models import configs as jax_configs
from image_editing_framework_tpu.models import loader
from image_editing_framework_tpu.models import registry as ref
from image_editing_framework_tpu.models.clip import TINY_CLIP, CLIPTextModel
from image_editing_framework_tpu.models.unet import UNet2DCondition
from image_editing_framework_tpu.models.vae import TINY_VAE, AutoencoderKL
from test_convert_ldm import to_ldm_unet, to_ldm_vae
from torch_port_helpers import chip_smoke, export_random, n, t

ATOL = 1e-4
VOCAB_SIZE = 600
WORDS = "a cat dog sitting on the grass photo".split()
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]
PORT_VAE = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, scaling_factor=TINY_VAE.scaling_factor)


def _write(directory, arrays, base):
    os.makedirs(directory, exist_ok=True)
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in arrays.items()},
              os.path.join(directory, base + ".safetensors"))


def _text_cfgs(hidden, projection):
    """(JAX, port) tiny text-tower configs."""
    kw = dict(hidden_size=hidden, projection_dim=projection, vocab_size=VOCAB_SIZE)
    return dataclasses.replace(TINY_CLIP, **kw), dataclasses.replace(PORT_TINY_CLIP, **kw)


def _specs(model_type, unet, text, text_2=None):
    """(JAX VersionSpec, port VersionSpec) for the tiny architectures."""
    jspec = ref.VersionSpec(model_type, getattr(jax_configs, unet) if isinstance(unet, str) else unet[0],
                            text[0], text_2 and text_2[0], vae_scaling=TINY_VAE.scaling_factor, sample_size=128,
                            vae=TINY_VAE)
    pspec = port.VersionSpec(model_type, getattr(port_configs, unet) if isinstance(unet, str) else unet[1],
                             text[1], text_2 and text_2[1], vae_scaling=TINY_VAE.scaling_factor, sample_size=128,
                             vae=PORT_VAE)
    return jspec, pspec


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Snapshot directories and single files, with their specs."""
    smoke = chip_smoke()
    tmp = tmp_path_factory.mktemp("ckpts")
    vocab, merges = smoke.synthetic_clip_vocab(WORDS, VOCAB_SIZE)
    ids = jnp.zeros((1, 77), jnp.int32)

    sd_text = _text_cfgs(32, None)
    t1, t2 = _text_cfgs(16, None), _text_cfgs(16, 16)
    ref_unet = dataclasses.replace(jax_configs.TINY_REFINER_UNET, cross_attention_dim=16)
    port_ref_unet = dataclasses.replace(port_configs.TINY_REFINER_UNET, cross_attention_dim=16)
    x, added = jnp.zeros((1, 16, 16, 4)), {"text_embeds": jnp.zeros((1, 16)), "time_ids": jnp.zeros((1, 6))}
    radded = {"text_embeds": jnp.zeros((1, 16)), "time_ids": jnp.zeros((1, 5))}
    arrays = {
        "unet": export_random(UNet2DCondition(jax_configs.TINY_UNET), 0, loader.unet_key, x, 0,
                              jnp.zeros((1, 77, 32))),
        "vae": export_random(AutoencoderKL(TINY_VAE), 1, loader.vae_key, jnp.zeros((1, 32, 32, 3))),
        "text": export_random(CLIPTextModel(sd_text[0]), 2, loader.clip_key, ids),
        "xl_unet": export_random(UNet2DCondition(jax_configs.TINY_XL_UNET), 3, loader.unet_key, x, 0,
                                 jnp.zeros((1, 77, 32)), None, added, False),
        "text1": export_random(CLIPTextModel(t1[0]), 4, loader.clip_key, ids),
        "text2": export_random(CLIPTextModel(t2[0]), 5, loader.clip_key, ids),
        "ref_unet": export_random(UNet2DCondition(ref_unet), 6, loader.unet_key, x, 0, jnp.zeros((1, 77, 16)),
                                  None, radded, False),
    }
    position_ids = {k: v.numpy() for k, v in smoke.clip_position_ids().items()}
    sd = str(tmp / "sd")
    _write(os.path.join(sd, "unet"), arrays["unet"], "diffusion_pytorch_model.fp16")  # the .fp16 name
    _write(os.path.join(sd, "vae"), arrays["vae"], "diffusion_pytorch_model")
    os.makedirs(os.path.join(sd, "text_encoder"))  # with the extra key real CLIP checkpoints carry
    save_file({**arrays["text"], **position_ids}, os.path.join(sd, "text_encoder", "model.safetensors"))
    smoke.write_tokenizer(os.path.join(sd, "tokenizer"), vocab, merges)

    xl, refiner = str(tmp / "xl"), str(tmp / "refiner")
    _write(os.path.join(xl, "unet"), arrays["xl_unet"], "diffusion_pytorch_model")
    _write(os.path.join(xl, "vae"), arrays["vae"], "diffusion_pytorch_model")
    _write(os.path.join(xl, "text_encoder"), arrays["text1"], "model")
    _write(os.path.join(xl, "text_encoder_2"), arrays["text2"], "model")
    for sub in ("tokenizer", "tokenizer_2"):
        smoke.write_tokenizer(os.path.join(xl, sub), vocab, merges)
    _write(os.path.join(refiner, "unet"), arrays["ref_unet"], "diffusion_pytorch_model")

    single_sd = str(tmp / "single_sd" / "model.safetensors")
    _write(os.path.dirname(single_sd), {**to_ldm_unet(arrays["unet"], jax_configs.TINY_UNET),
                                        **to_ldm_vae(arrays["vae"], TINY_VAE),
                                        **{f"cond_stage_model.transformer.{k}": v
                                           for k, v in arrays["text"].items()}}, "model")
    smoke.write_tokenizer(os.path.join(os.path.dirname(single_sd), "tokenizer"), vocab, merges)
    single_xl = str(tmp / "single_xl" / "model.safetensors")
    _write(os.path.dirname(single_xl), {**to_ldm_unet(arrays["xl_unet"], jax_configs.TINY_XL_UNET),
                                        **to_ldm_vae(arrays["vae"], TINY_VAE),
                                        **{f"conditioner.embedders.0.transformer.{k}": v
                                           for k, v in arrays["text1"].items()},
                                        **smoke.to_open_clip(arrays["text2"], "conditioner.embedders.1.model.")}, "model")
    smoke.write_tokenizer(os.path.join(os.path.dirname(single_xl), "tokenizer"), vocab, merges)
    return dict(sd=sd, xl=xl, refiner=refiner, single_sd=single_sd, single_xl=single_xl,
                sd_spec=_specs("sd", "TINY_UNET", sd_text), xl_spec=_specs("xl", "TINY_XL_UNET", t1, t2),
                ref_spec=_specs("xl", (ref_unet, port_ref_unet), t2), vocab=vocab)


def _load_both(version, path, specs, **kw):
    jspec, pspec = specs
    jpipe = ref.load_pipeline(version, 4, path=path, spec=jspec, **{k: v[0] for k, v in kw.items()})
    tpipe = port.load_pipeline(version, 4, path=path, spec=pspec, device="cpu", **{k: v[1] for k, v in kw.items()})
    return jpipe, tpipe


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(n(a), n(b), atol=atol, rtol=0)


def _same_outputs(jpipe, tpipe, ctx_width):
    """Embeddings, UNet output and VAE decode of the two packages' loads."""
    jctx, jadded = jpipe.encode_prompts(PROMPTS)
    ctx, added = tpipe.encode_prompts(PROMPTS)
    assert ctx.shape == (4, 77, ctx_width) and ctx.abs().max() > 0
    _close(ctx, jctx)
    lat = np.random.RandomState(0).randn(4, 16, 16, 4).astype(np.float32)
    if added is not None:
        added = dict(added, time_ids=tpipe.add_time_ids(32, 32, 4))
        jadded = dict(jadded, time_ids=jpipe.add_time_ids(32, 32, 4))
        _close(added["text_embeds"], jadded["text_embeds"])
    want = jpipe.unet_apply(jnp.asarray(lat), 500, jctx, None, jadded, use_flash=False)[0]
    _close(tpipe.unet_apply(t(lat), 500, ctx, None, added)[0], want)
    jimg = jpipe.vae.apply(jpipe.vae_params, jnp.asarray(lat[:1]), method=AutoencoderKL.decode)
    with torch.no_grad():
        _close(tpipe.vae.decode(t(lat[:1])), jimg)


def test_sd_snapshot_and_single_file_match_jax(ckpts):
    jpipe, tpipe = _load_both("1.5", ckpts["sd"], ckpts["sd_spec"])
    assert tpipe.device.type == "cpu" and tpipe.dtype == torch.float32 and tpipe.model_type == "sd"
    assert tpipe.tokenizer.encode(PROMPTS[0]) == jpipe.tokenizer.encode(PROMPTS[0])
    assert tpipe.tokenizer.encode(PROMPTS[0])[2] == ckpts["vocab"]["cat</w>"]
    _same_outputs(jpipe, tpipe, 32)
    jsingle, tsingle = _load_both("ghostv2", ckpts["single_sd"], ckpts["sd_spec"])
    _same_outputs(jsingle, tsingle, 32)
    for name in ("unet", "vae", "text_encoder"):  # the two layouts give the same weights, bit for bit
        a, b = getattr(tpipe, name).state_dict(), getattr(tsingle, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name


def test_xl_refiner_matches_jax_and_shares_the_base(ckpts):
    """The port's 'xl-refiner' from the XL snapshot directory against the JAX
    package's XL single-file load of the same weights with the refiner
    attached: the JAX ``load_pipeline`` cannot load an XL snapshot directory
    (``registry.py:275`` reads ``tok_dir``, which only its single-file
    branch sets)."""
    (jspec, pspec), (jref_spec, pref_spec) = ckpts["xl_spec"], ckpts["ref_spec"]
    tpipe = port.load_pipeline("xl-refiner", 4, path=ckpts["xl"], spec=pspec, refiner_path=ckpts["refiner"],
                               refiner_spec=pref_spec, device="cpu")
    jpipe = ref.load_pipeline("animagineXL", 4, path=ckpts["single_xl"], spec=jspec)
    jpipe.refiner = ref.load_refiner_pipeline(path=ckpts["refiner"], base=jpipe, num_inference_steps=4,
                                              spec=jref_spec)
    assert tpipe.model_type == "xl" and not tpipe.is_refiner
    _same_outputs(jpipe, tpipe, 32)
    r, jr = tpipe.refiner, jpipe.refiner
    assert r.is_refiner and r.vae is tpipe.vae and r.text_encoder_2 is tpipe.text_encoder_2
    assert r.tokenizer_2 is tpipe.tokenizer_2 and r.scheduler is tpipe.scheduler and r.device == tpipe.device
    rctx, radded = r.encode_prompts(PROMPTS[:1])
    jctx, jadded = jr.encode_prompts(PROMPTS[:1])
    assert rctx.shape == (2, 77, 16) and rctx[0].abs().max() > 0
    _close(rctx, jctx)
    _close(radded["text_embeds"], jadded["text_embeds"])
    lat = np.random.RandomState(1).randn(2, 16, 16, 4).astype(np.float32)
    radded = dict(radded, time_ids=r.add_time_ids(32, 32, 2))
    jadded = dict(jadded, time_ids=jr.add_time_ids(32, 32, 2))
    _close(r.unet_apply(t(lat), 300, rctx, None, radded)[0],
           jr.unet_apply(jnp.asarray(lat), 300, jctx, None, jadded, use_flash=False)[0])


def test_xl_single_file_matches_jax(ckpts):
    jpipe, tpipe = _load_both("animagineXL", ckpts["single_xl"], ckpts["xl_spec"])
    assert tpipe.tokenizer_2 is not None and tpipe.text_encoder_2 is not None
    _same_outputs(jpipe, tpipe, 32)


def test_standalone_refiner_reads_its_own_towers(ckpts, tmp_path):
    import shutil

    root = tmp_path / "refiner"
    shutil.copytree(ckpts["refiner"], root)
    for sub in ("vae", "text_encoder_2", "tokenizer_2"):
        shutil.copytree(os.path.join(ckpts["xl"], sub), root / sub)
    r = port.load_refiner_pipeline(path=str(root), num_inference_steps=4, spec=ckpts["ref_spec"][1], device="cpu")
    jr = ref.load_refiner_pipeline(path=str(root), num_inference_steps=4, spec=ckpts["ref_spec"][0])
    assert r.is_refiner and r.text_encoder is r.text_encoder_2
    (rctx, radded), (jctx, jadded) = r.encode_prompts(PROMPTS[:1]), jr.encode_prompts(PROMPTS[:1])
    _close(rctx, jctx)
    _close(radded["text_embeds"], jadded["text_embeds"])


def test_single_file_without_tokenizer_fails_early_and_clearly(tmp_path, monkeypatch):
    """A lone .safetensors with no tokenizer/ beside it and a base entry that
    points nowhere fails before the conversion, naming both paths and the
    remedy (the JAX package's message, test_registry.py)."""
    lone = tmp_path / "communityModel.safetensors"
    lone.write_bytes(b"")  # never read: the check fails before conversion
    monkeypatch.setitem(port_sd_mapping.sd_maps, "1.5", str(tmp_path / "missing-base"))
    monkeypatch.setitem(jax_sd_mapping.sd_maps, "1.5", str(tmp_path / "missing-base"))
    with pytest.raises(FileNotFoundError) as e:
        port.load_pipeline("1.5", path=str(lone), device="cpu")
    with pytest.raises(FileNotFoundError) as e_ref:
        ref.load_pipeline("1.5", path=str(lone))
    assert str(e.value) == str(e_ref.value)
    assert str(tmp_path / "tokenizer") in str(e.value) and "sd_mapping.py" in str(e.value)
    chip_smoke().write_tokenizer(str(tmp_path / "tokenizer"), *chip_smoke().synthetic_clip_vocab(WORDS, 600))
    with pytest.raises(Exception) as e2:  # past the check: the conversion reads the empty file
        port.load_pipeline("1.5", path=str(lone), device="cpu")
    assert not isinstance(e2.value, FileNotFoundError)


def test_version_table_and_tokenizer2_dir_match_jax(tmp_path):
    assert sorted(port.VERSION_SPECS) == sorted(ref.VERSION_SPECS) == sorted(port_sd_mapping.sd_maps)
    assert port_sd_mapping.sd_maps == jax_sd_mapping.sd_maps and port_sd_mapping.refiner_key == \
        jax_sd_mapping.refiner_key
    for name, spec in list(port.VERSION_SPECS.items()) + [("refiner", port.REFINER_SPEC)]:
        jspec = ref.REFINER_SPEC if name == "refiner" else ref.VERSION_SPECS[name]
        assert (spec.model_type, spec.vae_scaling, spec.sample_size) == (jspec.model_type, jspec.vae_scaling,
                                                                          jspec.sample_size), name
        assert dataclasses.asdict(spec.unet) == dataclasses.asdict(jspec.unet), name
        for mine, theirs in ((spec.text, jspec.text), (spec.text_2, jspec.text_2)):
            assert (mine is None) == (theirs is None), name
            if mine is not None:
                assert {k: v for k, v in dataclasses.asdict(mine).items()} == {
                    k: v for k, v in dataclasses.asdict(theirs).items() if k in dataclasses.asdict(mine)}, name
        assert spec.vae_config.scaling_factor == jspec.vae_config.scaling_factor
    with pytest.raises(ValueError, match="sd_version"):
        port.load_pipeline("3.0", device="cpu")
    root = tmp_path / "tokenizer-lab"  # a "tokenizer" substring elsewhere in the path
    (root / "tokenizer").mkdir(parents=True)
    (root / "tokenizer_2").mkdir()
    tok = str(root / "tokenizer")
    for single in (True, False):
        assert port._tokenizer2_dir(tok, str(root), single) == ref._tokenizer2_dir(tok, str(root), single)
    assert port._tokenizer2_dir(tok, str(root), True) == str(root / "tokenizer_2")
    (root / "tokenizer_2").rmdir()
    assert port._tokenizer2_dir(tok, str(root), True) == ref._tokenizer2_dir(tok, str(root), True) == tok
