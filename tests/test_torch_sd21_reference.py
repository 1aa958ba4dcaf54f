"""SD2.1 in the port against the benchmark's plain reference, on the CPU.

The benchmark's ``sd21`` configuration (``perfbench/configs/sd21.json``) is
built by the harness (``perfbench.harness.build_pipeline``) from the file's
widths, and judged against ``perfbench/reference/`` computed from the same
file. Here a tiny configuration of SD2.1's structure holds the two to each
other in f32 on seeded random weights: linear projections around every
transformer, per-level heads at one head dim (16), a 1024-style wide
cross-attention from an exact-gelu tower with no pooled projection whose
last hidden state is the context. Two levels at a 24² latent give
self-attention sites of 576 and 144 tokens, so P2P's self-replacement (at
sites of at most 256 tokens) acts at the inner level alone, as at 768²,
where only the 144-token mid site takes it.

Tolerances are those of ``perfbench/tests/test_perfbench_reference.py`` for
the same reasons: one UNet forward or VAE encode to 1e-4 of the largest
output, the tower to 1e-5 (f32 sums in another order), the decode to 1e-2
(its GroupNorms over 16 channels amplify the order of the sums). A step of
the inversion or the edit is a forward and a DDIM update, held to 1e-4.

The full-width file, built on ``meta``, has exactly the parameters of the
registry's ``"2.1"`` (``models/registry.py``), so the cell measures the
SD2.1 that users load. No JAX here.
"""

import json
import os

import pytest
import torch

from perfbench import gen, harness
from perfbench.hooks import Recorder
from perfbench.reference import editing, nets
from perfbench.reference.tokenizer import BPETokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
SIDE = 24  # latent side: 576 tokens at the outer level, 144 at the inner
TINY_SD21 = {
    "source": "tiny test configuration: two UNet levels, the SD2.1 structure",
    "dtype": "float32",
    "resolution": 2 * SIDE,
    "num_inference_steps": STEPS,
    "guidance_scale": 7.5,
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "layers_per_block": 1,
             "attention_head_dim": [2, 4], "cross_attention_dim": 48, "use_linear_projection": True},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": [16, 32],
            "layers_per_block": 1, "scaling_factor": 0.18215},
    "text_encoder": {"vocab_size": 49408, "hidden_size": 48, "intermediate_size": 192, "num_hidden_layers": 2,
                     "num_attention_heads": 3, "max_position_embeddings": 77, "hidden_act": "gelu",
                     "projection_dim": 24, "with_projection": False},
    "scheduler": {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                  "beta_schedule": "scaled_linear", "steps_offset": 1, "set_alpha_to_one": False},
}
SRC, TGT = "a photo of the cat", "a photo of the dog"  # equal word counts: P2P's replace
# The benchmark's N(0, 0.02²) weights leave every attention map near uniform,
# where replacing one map by another changes nothing; the UNet's query and key
# projections are drawn this many times wider here
QK_GAIN = 20.0


def _close(a, b, rtol):
    return float((a - b).abs().max()) <= rtol * float(b.abs().max())


def _nchw(x):
    return x.float().permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    with open(os.path.join(REPO, "perfbench", "traffic", "p2p-sweep-b4.json")) as f:
        words = json.load(f)["words"]
    return gen.write_vocab(str(tmp_path_factory.mktemp("vocab")), words)


@pytest.fixture(scope="module")
def built(vocab_dir):
    """(weights, the port's pipeline, the reference's model) of the tiny
    configuration, one set of weights from one seed."""
    cfg = TINY_SD21
    w = harness.make_weights(cfg, 2024, "cpu", torch.float32)
    for k, v in w["unet"].items():  # peaked attention, so that P2P's replacements move the noise
        if ".to_q." in k or ".to_k." in k:
            v.mul_(QK_GAIN)
    pipe = harness.build_pipeline(cfg, w, vocab_dir, "cpu", torch.float32)
    model = editing.Model(cfg, w, BPETokenizer.from_dir(vocab_dir), torch.device("cpu"))
    return w, pipe, model


def test_the_tiny_configuration_has_sd21s_structure(built):
    _, pipe, _ = built
    ucfg = pipe.unet.config
    heads = ucfg.num_heads
    assert ucfg.use_linear_projection and len(set(c // h for c, h in zip(ucfg.block_out_channels, heads))) == 1
    assert pipe.model_type == "sd" and pipe.text_encoder_2 is None
    sites = nets.self_attention_sites(TINY_SD21["unet"], SIDE)
    assert sorted({n for n, _, _ in sites}) == [144, 576]


def test_networks_match_the_reference(built, vocab_dir):
    w, pipe, _ = built
    cfg = TINY_SD21
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, SIDE, SIDE, 4, generator=g)
    ctx = torch.randn(2, 77, cfg["unet"]["cross_attention_dim"], generator=g)
    eps, _ = pipe.unet(x, 501, ctx, None, None)
    assert _close(eps.permute(0, 3, 1, 2), nets.unet(w["unet"], cfg["unet"], _nchw(x), 501, ctx), 1e-4)

    tok = BPETokenizer.from_dir(vocab_dir)
    ids = torch.tensor([tok.padded(SRC), tok.padded("")])
    out, want = pipe.text_encoder(ids), nets.clip_text(w["text_encoder"], cfg["text_encoder"], ids)
    assert _close(out["last_hidden_state"], want["last"], 1e-5)
    # the context the pipeline hands the UNet is the last hidden state: [uncond, cond]
    context, added = pipe.encode_prompts([SRC])
    assert added is None
    assert _close(context, torch.cat([want["last"][1:], want["last"][:1]]), 1e-5)

    img = torch.rand(1, cfg["resolution"], cfg["resolution"], 3, generator=g) * 2 - 1
    z = pipe.vae.encode(img)
    assert _close(_nchw(z), nets.vae_encode(w["vae"], cfg["vae"], _nchw(img)), 1e-4)
    assert _close(_nchw(pipe.vae.decode(z)), nets.vae_decode(w["vae"], cfg["vae"], _nchw(z)), 1e-2)


@pytest.fixture(scope="module")
def captured(built):
    """The port's batched inversion and P2P edit of one image, the states of
    inversion step 1 and edit step 1 kept by the harness's own hooks."""
    from image_editing_framework_torch.core.config import P2PConfig
    from image_editing_framework_torch.eval import batched

    _, pipe, _ = built
    rec = Recorder(STEPS, [1], [1])
    rec.group = 0
    rec.install()
    try:
        lat = torch.randn(1, 1, SIDE, SIDE, 4, generator=torch.Generator().manual_seed(3))
        inverted, _ = batched.ddim_invert_batch(pipe, lat, [SRC], return_trajectory=True)
        batched.edit_batch("p2p", pipe, [[SRC, TGT]], inverted, [P2PConfig(edit_type="replace")], 7.5)
    finally:
        rec.restore()
    return rec.captures[0]


def test_an_inversion_step_matches_the_reference(built, captured):
    _, _, model = built
    sch = editing.schedule(STEPS, TINY_SD21["scheduler"])
    st = captured["invert"][1]
    x = _nchw(st["x"])
    ctx, _ = model.conditioning([SRC])
    eps_ref = model.eps(x, editing.invert_timestep(sch, 1), ctx)
    assert _close(_nchw(st["eps"]), eps_ref, 1e-4)
    assert _close(_nchw(st["next"]), editing.invert_step(sch, eps_ref, 1, x), 1e-4)


def test_a_p2p_replace_step_matches_the_reference(built, captured):
    """Edit step 1, inside both of P2P's windows (the branches' latents
    already apart): the target's cross-attention probabilities are the
    source's, and at the 144-token site (of at most 256) its self-attention
    probabilities too. Without the reference's P2P hooks, or without the
    self-replacement alone, the guided noise differs ten times the limit
    or more."""
    _, _, model = built
    sch = editing.schedule(STEPS, TINY_SD21["scheduler"])
    st = captured["edit"][1]
    x = _nchw(st["x"][0])  # (2, 4, h, w): source, target
    u_ctx, _ = model.uncond()
    c_ctx, _ = model.conditioning([SRC, TGT])
    ctx = torch.cat([u_ctx.expand(2, -1, -1), c_ctx])
    edit = editing.P2PEdit.build(SRC, TGT, model.tok, STEPS, torch.device("cpu"))
    t = int(sch.timesteps[1])

    def guided(hooks):
        e = model.eps(torch.cat([x, x]), t, ctx, None, hooks)
        return e[:2] + TINY_SD21["guidance_scale"] * (e[2:] - e[:2])

    hooks = edit.hooks(1)
    assert hooks.cross_on and hooks.self_on
    eps_ref = guided(hooks)
    eps = _nchw(st["eps"][0])
    assert _close(eps, eps_ref, 1e-4)
    assert not _close(eps, guided(None), 1e-2)
    assert _close(_nchw(st["next"][0]), editing.denoise_step(sch, eps_ref, 1, x), 1e-4)
    cross_only = editing.P2PHooks(edit.mapper, edit.tok_alpha, True, False)
    assert not _close(eps[1:], guided(cross_only)[1:], 1e-3)


# ------------------------------------------------- the full-width file


def _sd21():
    with open(os.path.join(REPO, "perfbench", "configs", "sd21.json")) as f:
        return json.load(f)


def test_the_benchmark_file_is_the_registry_sd21(vocab_dir):
    from image_editing_framework_torch.models.clip import CLIPTextModel
    from image_editing_framework_torch.models.registry import VERSION_SPECS
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.models.vae import AutoencoderKL

    cfg = _sd21()
    meta = torch.device("meta")
    shapes = harness.module_shapes(cfg)
    weights = {m: {k: torch.empty(s, device=meta) for k, s in sh.items()} for m, sh in shapes.items()}
    pipe = harness.build_pipeline(cfg, weights, vocab_dir, meta, torch.bfloat16)
    spec = VERSION_SPECS["2.1"]
    with meta:
        registry = {"unet": UNet2DCondition(spec.unet), "vae": AutoencoderKL(spec.vae_config),
                    "text_encoder": CLIPTextModel(spec.text)}
    built_ = {"unet": pipe.unet, "vae": pipe.vae, "text_encoder": pipe.text_encoder}
    assert sorted(shapes) == sorted(registry)
    for name, module in registry.items():
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in built_[name].state_dict().items()} == want, name
        # the harness draws exactly the tensors the port's module holds
        assert {k: tuple(s) for k, s in shapes[name].items()} == want, name
    assert (spec.sample_size, spec.vae_scaling) == (cfg["resolution"], cfg["vae"]["scaling_factor"])
    assert cfg["unet"]["sample_size"] * 8 == cfg["resolution"] == cfg["vae"]["sample_size"]


def test_the_benchmark_file_states_sd21s_parameter_counts():
    cfg = _sd21()
    counts = {m: sum(int(torch.Size(s).numel()) for s in sh.values()) for m, sh in harness.module_shapes(cfg).items()}
    assert counts == cfg["parameters"]
    assert round(counts["unet"] / 1e6, 1) == 865.9
    assert round(counts["text_encoder"] / 1e6) == 340
    assert cfg["reduced"] == []
    sites = nets.self_attention_sites(cfg["unet"], harness.latent_side(cfg))
    assert len(sites) == 16 and {d for _, _, d in sites} == {64}
    assert sorted({n for n, _, _ in sites}) == [144, 576, 2304, 9216]
    assert sum(n > 4096 for n, _, _ in sites) == 5
