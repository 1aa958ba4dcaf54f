"""The plain reference against the port at tiny width, on the CPU in f32."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch
from conftest import REPO, TINY

from perfbench import gen, harness
from perfbench.reference import editing, nets
from perfbench.reference.tokenizer import BPETokenizer


def _cfg(name):
    with open(os.path.join(TINY, f"{name}.json")) as f:
        return json.load(f)


def _traffic():
    with open(os.path.join(REPO, "perfbench", "traffic", "p2p-sweep-b4.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def vocab_dir():
    return gen.write_vocab(tempfile.mkdtemp(), _traffic()["words"])


def _pipe_and_weights(name, vocab_dir):
    cfg = _cfg(name)
    w = harness.make_weights(cfg, 123, "cpu", torch.float32)
    return cfg, w, harness.build_pipeline(cfg, w, vocab_dir, "cpu", torch.float32)


def _close(a, b, rtol):
    return float((a - b).abs().max()) <= rtol * float(b.abs().max())


@pytest.mark.parametrize("name", ["sd", "xl"])
def test_networks_match_the_port(name, vocab_dir):
    cfg, w, pipe = _pipe_and_weights(name, vocab_dir)
    g = torch.Generator().manual_seed(0)
    side = harness.latent_side(cfg)
    x = torch.randn(2, side, side, 4, generator=g)
    ctx = torch.randn(2, 77, cfg["unet"]["cross_attention_dim"], generator=g)
    added = None
    if name == "xl":
        res = cfg["resolution"]
        added = {"text_embeds": torch.randn(2, cfg["text_encoder_2"]["projection_dim"], generator=g),
                 "time_ids": torch.tensor([[res, res, 0, 0, res, res]], dtype=torch.float32).expand(2, -1)}
    eps, _ = pipe.unet(x, 501, ctx, None, added)
    ref = nets.unet(w["unet"], cfg["unet"], x.permute(0, 3, 1, 2), 501, ctx, None, added)
    assert _close(eps.permute(0, 3, 1, 2), ref, 1e-4)

    tok = BPETokenizer.from_dir(vocab_dir)
    ids = torch.tensor([tok.padded("a photo of the cat"), tok.padded("")])
    out, want = pipe.text_encoder(ids), nets.clip_text(w["text_encoder"], cfg["text_encoder"], ids)
    assert torch.equal(torch.as_tensor(pipe.tokenizer.encode_padded(["a photo of the cat", ""]), dtype=torch.int64), ids)
    assert _close(out["last_hidden_state"], want["last"], 1e-5)
    assert _close(out["penultimate"], want["penultimate"], 1e-5)
    if name == "xl":
        out2 = pipe.text_encoder_2(ids)
        want2 = nets.clip_text(w["text_encoder_2"], cfg["text_encoder_2"], ids)
        assert _close(out2["pooled"], want2["pooled"], 1e-5)

    img = torch.rand(1, cfg["resolution"], cfg["resolution"], 3, generator=g) * 2 - 1
    z = pipe.vae.encode(img)
    assert _close(z.permute(0, 3, 1, 2), nets.vae_encode(w["vae"], cfg["vae"], img.permute(0, 3, 1, 2)), 1e-4)
    dec = pipe.vae.decode(z)
    assert _close(dec.permute(0, 3, 1, 2), nets.vae_decode(w["vae"], cfg["vae"], z.permute(0, 3, 1, 2)), 1e-2)


def test_tiled_decode_matches_the_port(vocab_dir):
    from image_editing_framework_torch.models.vae import decode_tiled

    cfg, w, pipe = _pipe_and_weights("xl", vocab_dir)
    z = torch.randn(1, 12, 12, 4, generator=torch.Generator().manual_seed(1)) * 0.1
    got = decode_tiled(pipe.vae, z, tile=8, overlap=2)
    scale = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    want = nets.vae_decode_tiled(lambda zz: nets.vae_decode(w["vae"], cfg["vae"], zz), z.permute(0, 3, 1, 2), 8,
                                 overlap=2, scale=scale)
    assert _close(got.permute(0, 3, 1, 2), want, 1e-2)


def test_tokenizer_matches_the_port(vocab_dir):
    from image_editing_framework_torch.models.tokenizer import CLIPTokenizer

    port, ref = CLIPTokenizer.from_dir(vocab_dir), BPETokenizer.from_dir(vocab_dir)
    for it in gen.items(_traffic(), 5):
        for text in (it["source"], it["target"], "A  Photo, of the CAT!"):
            assert port.encode(text) == ref.encode(text)


def test_p2p_tables_match_the_port(vocab_dir):
    from image_editing_framework_torch.core.config import P2PConfig
    from image_editing_framework_torch.models.tokenizer import CLIPTokenizer
    from image_editing_framework_torch.ops.controls import build_p2p_control

    port_tok, ref_tok = CLIPTokenizer.from_dir(vocab_dir), BPETokenizer.from_dir(vocab_dir)
    for it in gen.items(dict(_traffic(), items=24), 9):
        src, tgt = it["source"], it["target"]
        kind = "replace" if len(src.split()) == len(tgt.split()) else "refine"
        ctrl = build_p2p_control([src, tgt], port_tok, 50, P2PConfig(edit_type=kind))
        edit = editing.P2PEdit.build(src, tgt, ref_tok, 50, "cpu")
        assert torch.equal(ctrl.mapper[0], edit.mapper), (src, tgt)
        assert torch.equal(ctrl.tok_alpha[0], edit.tok_alpha), (src, tgt)
        cross = ctrl.cross_alpha[:, 0, 0].numpy()
        assert int(cross[:-1].sum()) == edit.cross_steps
        assert int(ctrl.self_gate.sum()) == edit.self_steps


def test_schedule_matches_the_port():
    from image_editing_framework_torch.core.scheduler import ddim_reverse_step, ddim_step, make_ddim_schedule

    cfg = _cfg("sd")
    port, ref = make_ddim_schedule(50), editing.schedule(50, cfg["scheduler"])
    assert np.array_equal(port.timesteps.numpy(), ref.timesteps)
    x = torch.randn(1, 4, 8, 8, dtype=torch.float64)
    eps = torch.randn(1, 4, 8, 8, dtype=torch.float64)
    for i in (0, 17, 49):
        assert torch.allclose(ddim_step(port, eps, i, x), editing.denoise_step(ref, eps, i, x), rtol=1e-6, atol=1e-6)
        assert torch.allclose(ddim_reverse_step(port, eps, i, x), editing.invert_step(ref, eps, i, x), rtol=1e-6,
                              atol=1e-6)


def test_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import perfbench.check, perfbench.reference.editing, "
            "perfbench.yardstick, perfbench.gen; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'image_editing_framework_tpu', 'image_editing_framework_torch'}))") % REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
