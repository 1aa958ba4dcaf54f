"""The editing work under tensor parallelism: the four places that reduce a
recorded cross-attention map over its heads, and the JAX dryrun's editing
work (``__graft_entry__.py dryrun_multichip``: a MasaCtrl denoise and NTI on
TP'd parameters), on the tiny SD pipeline, in f32 on the CPU.

Two gloo rank processes (``torch_tp_workers.py suite_edits``, started once
for the file) load the JAX tiny pipeline's weights, run every case
unsharded, split the UNet and the text tower over tensor = 2 and run them
again:

* a P2P replace edit with LocalBlend (``P2PStep.record``'s mean over the
  heads), a MasaCtrl auto-mask edit (``MasaCtrlAutoStep.record``), the
  attention store (``AttentionStoreStep.record``) and one pix2pix-zero
  guided step's loss and latent gradient (``attn_loss`` over the per-head
  maps ``P2ZStep.record`` stores): each site records the maps of every head
  (``parallel/sharding.py gather_heads``);
* the dryrun's MasaCtrl denoise (start_step 1, start_layer 0) and NTI with
  ``num_inner_steps=2``; and NTI with rank 1's losses skewed by 1e3, where
  every rank must stop where rank 0 stops (``lockstep`` over the TP mesh);
* the planted fault: the records of the local heads alone, so that
  LocalBlend's mean is over half the heads; it must land far outside the
  limit.

Tolerances: against the same case unsharded in the rank, the TP split's own
error (two partial sums all-reduced where one product summed them),
``SELF_RTOL`` = 2e-5 of max|ref| for latents, maps and the encode (the 4
DDIM steps amplify the f32 rounding to ~7e-6 of the latents' scale); the
guided step's gradient at 1e-4 · max|ref| and NTI's embeddings at 1e-3 as
against JAX, since both pass through values that round to another bf16
value (p2z's maps are stored in bf16) or another Adam sign (NTI's first
step is about lr · sign(g)) when f32 rounding moves them. Against JAX, the limits of the unsharded slice's tests,
which hold the port's tiny pipeline to JAX's: edit latents 1e-3
(tests/test_torch_pipeline.py; 4 steps of f32 UNet differences amplified by
the DDIM coefficients), the attention store 1e-5 (tests/test_torch_p2z.py),
the guided step's loss at 1e-5 relative and its gradient at 1e-4 · max|ref|
(tests/test_torch_p2z.py), NTI's embeddings at 1e-3 (a tenth of one Adam
step, tests/test_torch_nti.py), the encode at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_editing_framework_tpu.core.config import MasaCtrlConfig, NTIConfig, P2PConfig, SamplerConfig
from image_editing_framework_tpu.inversion.nti import null_text_inversion
from image_editing_framework_tpu.methods import base as jbase
from image_editing_framework_tpu.methods import common as jcommon
from image_editing_framework_tpu.methods import masactrl as jmasa
from image_editing_framework_tpu.models import loader
from image_editing_framework_tpu.ops import controls as jctl
from image_editing_framework_tpu.ops import schedules as jsched
from image_editing_framework_tpu.pipelines import tiny_pipeline
from torch_cp_workers import launch
from torch_tp_workers import AUTO_THRES, BLEND, GS, PROMPTS, STEPS, WORDS

SELF_RTOL = 2e-5
ATOL_EDIT = 1e-3
ATOL_STORE = 1e-5
GRAD_RTOL = 1e-4
ATOL_EMB = 1e-3
ATOL_ENCODE = 1e-4
EPSILON = 5.3  # NTI's stop for the skewed run: some steps stop early, some do not


def _inputs(jpipe):
    rng = np.random.RandomState(0)
    f32 = np.float32
    inp = {
        "latent": rng.randn(1, 16, 16, 4).astype(f32),
        "lat2": rng.randn(2, 16, 16, 4).astype(f32),
        "p2z_x": rng.randn(2, 16, 16, 4).astype(f32),
        "traj": (rng.standard_normal((STEPS + 1, 1, 16, 16, 4)) * 0.5).astype(f32),
        "context": rng.standard_normal((2, 77, 32)).astype(f32),
        "epsilon": np.array(EPSILON),
    }
    # pix2pix-zero's references: the per-head maps of another latent
    ctx, _ = jcommon.prepare_conditioning(jpipe, [PROMPTS[0]], 32, 32)
    _, rec = jpipe.unet.apply(jpipe.unet_params, jnp.asarray(rng.randn(2, 16, 16, 4).astype(f32)),
                              jpipe.scheduler.timesteps[1], ctx, jctl.P2ZStep(), None, False)
    for key, val in rec.items():
        inp[f"p2z_ref/{key}"] = np.asarray(val.astype(jnp.float32))
    return inp


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_edits")
    jpipe = tiny_pipeline(num_steps=STEPS)
    jpipe.tokenizer.encode(WORDS)
    inp = _inputs(jpipe)
    np.savez(tmp / "inputs.npz", **inp)
    for name, params, key in (("unet", jpipe.unet_params, loader.unet_key), ("vae", jpipe.vae_params,
                                                                            loader.vae_key),
                              ("text", jpipe.text_params, loader.clip_key)):
        np.savez(tmp / f"{name}.npz", **{k: np.ascontiguousarray(v) for k, v in
                                         loader.export_params(params, key).items()})
    return jpipe, inp, launch("tp_edits", 2, tmp, in_dir=tmp)


def _check(ranks, key, ref, atol, self_atol=None):
    """Each rank's TP result within ``self_atol`` (default SELF_RTOL ·
    max|ref|) of its unsharded one and within ``atol`` of JAX's ``ref``; the
    ranks' results equal."""
    if self_atol is None:
        self_atol = SELF_RTOL * np.abs(ref).max()
    for res in ranks:
        np.testing.assert_allclose(res[f"tp/{key}"], res[f"plain/{key}"], atol=self_atol, rtol=0, err_msg=key)
        np.testing.assert_allclose(res[f"tp/{key}"], ref, atol=atol, rtol=0, err_msg=key)
    np.testing.assert_array_equal(ranks[0][f"tp/{key}"], ranks[1][f"tp/{key}"])


def _jax_blend_edit(jpipe, latent):
    cfg = P2PConfig(blend_words=BLEND)
    alpha = jsched.blend_alpha_layers(PROMPTS, cfg.blend_words, jpipe.tokenizer)
    blend = jbase.LocalBlend(jnp.asarray(alpha), threshold=cfg.blend_threshold)
    ctrl = jctl.build_p2p_control(PROMPTS, jpipe.tokenizer, STEPS, cfg, True)
    context, _ = jcommon.prepare_conditioning(jpipe, PROMPTS, 32, 32)
    final, _ = jbase.denoise(jpipe, jcommon.expand_latent(jnp.asarray(latent), 2), context, ctrl, GS, blend=blend,
                             use_flash=False)
    return np.asarray(final)


def test_local_blend_edit_under_tp_matches_jax(setup):
    jpipe, inp, ranks = setup
    ref = _jax_blend_edit(jpipe, inp["latent"])
    _check(ranks, "p2p_blend", ref, ATOL_EDIT)
    assert np.abs(ref[0] - ref[1]).max() > 0.1  # the edit is live


def test_local_blend_over_local_heads_is_rejected(setup):
    """The planted fault: LocalBlend's head mean over this rank's heads."""
    _, _, ranks = setup
    for res in ranks:
        assert np.abs(res["fault/p2p_blend"] - res["plain/p2p_blend"]).max() > 100 * ATOL_EDIT


def test_masactrl_auto_mask_edit_under_tp_matches_jax(setup):
    jpipe, inp, ranks = setup
    seen, real = [], jmasa.denoise
    jmasa.denoise = lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1]
    try:
        jmasa.masactrl_edit(jpipe, PROMPTS, jnp.asarray(inp["latent"]), MasaCtrlConfig(start_step=1, start_layer=2),
                            SamplerConfig(height=32, width=32), auto_mask=True, thres=AUTO_THRES,
                            cur_token_idx=(2,), use_flash=False)
    finally:
        jmasa.denoise = real
    _check(ranks, "masactrl_auto", np.asarray(seen[0][0]), ATOL_EDIT)


def test_attention_store_under_tp_matches_jax(setup):
    jpipe, inp, ranks = setup
    ctx, _ = jcommon.prepare_conditioning(jpipe, PROMPTS, 32, 32)
    lat = np.repeat(inp["latent"], 2, axis=0)
    _, rec = jbase.denoise(jpipe, jnp.asarray(lat), ctx, jctl.AttentionStoreControl(max_seq=1024), GS,
                           use_flash=False, collect_records=True)
    assert len(rec) == 4
    for key, val in rec.items():
        _check(ranks, f"store/{key}", np.asarray(val), ATOL_STORE)


def test_p2z_guided_step_under_tp_matches_jax(setup):
    """``attn_loss``: the mean over rows x heads of per-head maps, each rank
    seeing every head; its latent gradient flows back through the gather."""
    jpipe, inp, ranks = setup
    refs = {k[len("p2z_ref/"):]: jnp.asarray(v, jnp.bfloat16) for k, v in inp.items() if k.startswith("p2z_ref/")}
    ctx, _ = jcommon.prepare_conditioning(jpipe, [PROMPTS[1]], 32, 32)
    step = jctl.P2ZStep()

    def attn_loss(x_in):
        _, rec = jpipe.unet.apply(jpipe.unet_params, x_in, jpipe.scheduler.timesteps[1], ctx, step, None, False)
        loss = 0.0
        for k, cur in rec.items():
            loss += jnp.square(cur.astype(jnp.float32) - refs[k].astype(jnp.float32)).sum(axis=(2, 3)).mean()
        return loss

    loss, grad = jax.value_and_grad(attn_loss)(jnp.asarray(inp["p2z_x"]))
    grad = np.asarray(grad)
    scale = np.abs(grad).max()
    for res in ranks:
        np.testing.assert_allclose(float(res["tp/p2z_loss"]), float(loss), rtol=1e-5)
        np.testing.assert_allclose(float(res["tp/p2z_loss"]), float(res["plain/p2z_loss"]), rtol=SELF_RTOL)
    _check(ranks, "p2z_grad", grad, GRAD_RTOL * scale, GRAD_RTOL * scale)


def test_dryrun_masactrl_denoise_under_tp_matches_jax(setup):
    jpipe, inp, ranks = setup
    ctrl = jctl.build_masactrl_control(STEPS, jpipe.unet.config.num_transformer_blocks,
                                       MasaCtrlConfig(start_step=1, start_layer=0))
    ctx, _ = jcommon.prepare_conditioning(jpipe, ["a cat", "a standing cat"], 32, 32)
    final, _ = jbase.denoise(jpipe, jnp.asarray(inp["lat2"]), ctx, ctrl, guidance_scale=GS, use_flash=False)
    _check(ranks, "masactrl_denoise", np.asarray(final), ATOL_EDIT)


def test_dryrun_nti_under_tp_matches_jax(setup):
    jpipe, inp, ranks = setup
    ref = np.asarray(null_text_inversion(jpipe, jnp.asarray(inp["traj"]), jnp.asarray(inp["context"]),
                                         NTIConfig(num_inner_steps=2), use_flash=False))
    _check(ranks, "nti", ref, ATOL_EMB, ATOL_EMB)
    assert ranks[0]["tp/nti_stops"].tolist() == ranks[1]["tp/nti_stops"].tolist()


def test_nti_ranks_stop_in_lockstep_under_tp(setup):
    """Rank 1's losses skewed by 1e3 (alone it would never stop early):
    both ranks stop where rank 0 stops."""
    _, _, ranks = setup
    stops = ranks[0]["nti_skewed_stops"].tolist()
    assert ranks[1]["nti_skewed_stops"].tolist() == stops
    flat = [s for step in stops for s in step]
    assert min(flat) < 4 and max(flat) == 4, stops


def test_prompt_encode_under_tp_matches_jax(setup):
    jpipe, _, ranks = setup
    ctx, _ = jcommon.prepare_conditioning(jpipe, PROMPTS, 32, 32)
    _check(ranks, "encode", np.asarray(ctx), ATOL_ENCODE)
