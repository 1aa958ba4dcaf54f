"""Context parallelism threaded through the port's UNet and controls, against
the JAX package's, in f32 on the CPU (the JAX package's own cases:
tests/test_ring_attention.py:197-290).

Two gloo rank processes (``torch_cp_workers.py suite_unet``, started once
for the file) load the JAX tiny pipeline's UNet weights and run, with
``cp_min_seq=64``:

* the tiny UNet with the ring and with Ulysses, and under a masked
  MasaCtrl control with the ring, against JAX's ``UNet2DCondition(...,
  cp_mesh=..., cp_min_seq=64)`` on 2 virtual devices;
* ``MasaCtrlMaskStep`` / ``MasaCtrlAutoStep.self_override`` with
  ``cp_mesh`` (ring and Ulysses), against JAX's with its ``cp_mesh``;
* null-text inversion under the ring (``null_text_inversion_batch`` of one
  image, its stops returned) against JAX's ``null_text_inversion``; then
  again with rank 1's losses skewed by 1e3, where every rank must stop
  where rank 0 stops (``parallel/ring_attention.py lockstep``);
* pix2pix-zero under the ring through the checkpointed UNet
  (``grad_unet(..., force=True)``): one guided step's loss and gradient
  against references the ranks made unsharded (JAX takes the same), and
  pass 2 over the schedule with its references made again from a stored
  trajectory (``recompute_refs``), against JAX's unsharded
  ``methods/p2z.py``; the ranks' results bitwise equal.

Tolerances: the UNet and the overrides within ``ATOL`` = 2e-5, the JAX
package's limit for its CP UNet against its plain one; the NTI embeddings
within ``ATOL_EMB`` = 1e-3, a tenth of one Adam step, as
tests/test_torch_nti.py states it; the p2z gradient within ``GRAD_RTOL`` =
1e-4 of its max and its loss within 1e-5 relative, the final latent within
``ATOL_EDIT`` = 1e-3, as tests/test_torch_p2z.py holds them unsharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from image_editing_framework_tpu.core.config import MasaCtrlConfig, NTIConfig
from image_editing_framework_tpu.inversion.nti import null_text_inversion
from image_editing_framework_tpu.methods import p2z as jp2z
from image_editing_framework_tpu.models import configs, loader
from image_editing_framework_tpu.models.unet import UNet2DCondition
from image_editing_framework_tpu.ops.attention import AttnSite
from image_editing_framework_tpu.ops.controls import MasaCtrlAutoStep, MasaCtrlMaskStep, P2ZStep, build_masactrl_control
from image_editing_framework_tpu.pipelines import tiny_pipeline
from torch_cp_workers import launch

ATOL = 2e-5
ATOL_EMB = 1e-3
STEPS = 3
INNER = 4
EPSILON = 5.3  # between the steps' losses (5.7-5.06 at step 0, 9.5-9.2 after): step 0 stops after 3 iterations
GRAD_RTOL = 1e-4
ATOL_EDIT = 1e-3
GS = 7.5


def _inputs():
    rng = np.random.RandomState(0)
    f32 = np.float32
    return {
        "x": rng.standard_normal((2, 16, 16, 4)).astype(f32),
        "ctx": rng.standard_normal((2, 77, 32)).astype(f32),
        "x4": (rng.standard_normal((4, 16, 16, 4)) * 0.1).astype(f32),
        "ctx4": rng.standard_normal((4, 77, 32)).astype(f32),
        "mask_s": (rng.rand(16, 16) > 0.5).astype(f32),
        "mask_t": (rng.rand(16, 16) > 0.5).astype(f32),
        "q": rng.standard_normal((4, 2, 256, 16)).astype(f32),
        "k": rng.standard_normal((4, 2, 256, 16)).astype(f32),
        "v": rng.standard_normal((4, 2, 256, 16)).astype(f32),
        "running": rng.rand(4, 256, 77).astype(f32),
        "traj": (rng.standard_normal((STEPS + 1, 1, 16, 16, 4)) * 0.5).astype(f32),
        "context": rng.standard_normal((2, 77, 32)).astype(f32),
        "steps": np.array(STEPS),
        "inner": np.array(INNER),
        "epsilon": np.array(EPSILON),
        "p2z_x": rng.standard_normal((2, 16, 16, 4)).astype(f32),  # a CFG pair whose halves differ
        "p2z_src": rng.standard_normal((2, 16, 16, 4)).astype(f32),
        "p2z_ctx": rng.standard_normal((2, 77, 32)).astype(f32),
        "p2z_ctx_src": rng.standard_normal((2, 77, 32)).astype(f32),
        "p2z_lat": rng.standard_normal((1, 16, 16, 4)).astype(f32),
        "p2z_src_traj": rng.standard_normal((STEPS, 1, 16, 16, 4)).astype(f32),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX tiny pipeline, the inputs, the two ranks' results)."""
    tmp = tmp_path_factory.mktemp("cp_unet")
    jpipe = tiny_pipeline(num_steps=STEPS)
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    np.savez(tmp / "unet.npz", **{k: np.ascontiguousarray(v) for k, v in
                                  loader.export_params(jpipe.unet_params, loader.unet_key).items()})
    return jpipe, inp, launch("unet", 2, tmp, in_dir=tmp)


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _jax_unet(jpipe, mesh, mode, x, ctx, step=None):
    unet = UNet2DCondition(configs.TINY_UNET, cp_mesh=mesh, cp_min_seq=64, cp_mode=mode)
    fn = jax.jit(lambda p, x, c: unet.apply(p, x, 10, c, step, None, False)[0])
    return np.asarray(fn(jpipe.unet_params, x, ctx))


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_unet_with_context_parallel_matches_jax(setup, mesh2, mode):
    jpipe, inp, ranks = setup
    ref = _jax_unet(jpipe, mesh2, mode, inp["x"], inp["ctx"])
    for res in ranks:
        np.testing.assert_allclose(res[f"unet_{mode}"], ref, atol=ATOL, rtol=0)


def test_unet_masked_masactrl_with_cp_matches_jax(setup, mesh2):
    jpipe, inp, ranks = setup
    ctrl = build_masactrl_control(4, configs.TINY_UNET.num_transformer_blocks,
                                  MasaCtrlConfig(start_step=0, start_layer=0), mask_s=inp["mask_s"],
                                  mask_t=inp["mask_t"])
    ref = _jax_unet(jpipe, mesh2, "ring", inp["x4"], inp["ctx4"], ctrl.at_step(1))
    for res in ranks:
        np.testing.assert_allclose(res["unet_masactrl_mask"], ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_masked_overrides_under_cp_match_jax(setup, mesh2, mode):
    _, inp, ranks = setup
    site = AttnSite(layer=0, place="down", seq_len=256, is_cross=False)
    q, k, v = (jnp.asarray(inp[n]) for n in "qkv")
    gate = jnp.asarray(True)
    mask = MasaCtrlMaskStep(step_gate=gate, layers=(0,), num_prompts=2, mask_s=jnp.asarray(inp["mask_s"]),
                            mask_t=jnp.asarray(inp["mask_t"]))
    auto = MasaCtrlAutoStep(step_gate=gate, layers=(0,), num_prompts=2)
    running = {"down_l0_cross": jnp.asarray(inp["running"])}
    ref_mask = jax.jit(lambda q, k, v: mask.self_override(site, q, k, v, None, use_flash=False, cp_mesh=mesh2,
                                                          cp_mode=mode))(q, k, v)
    ref_auto = jax.jit(lambda q, k, v: auto.self_override(site, q, k, v, running, use_flash=False, cp_mesh=mesh2,
                                                          cp_mode=mode))(q, k, v)
    for res in ranks:
        np.testing.assert_allclose(res[f"override_mask_{mode}"], np.asarray(ref_mask), atol=ATOL, rtol=0)
        np.testing.assert_allclose(res[f"override_auto_{mode}"], np.asarray(ref_auto), atol=ATOL, rtol=0)
    if mode == "ring":
        ref = jax.jit(lambda q, k, v: auto.self_override(site, q, k, v, None, use_flash=False, cp_mesh=mesh2))(q, k, v)
        for res in ranks:
            np.testing.assert_allclose(res["override_auto_no_maps"], np.asarray(ref), atol=ATOL, rtol=0)


def test_nti_under_the_ring_matches_jax(setup):
    jpipe, inp, ranks = setup
    cfg = NTIConfig(num_inner_steps=INNER, epsilon=EPSILON)
    ref = np.asarray(null_text_inversion(jpipe, jnp.asarray(inp["traj"]), jnp.asarray(inp["context"]), cfg,
                                         use_flash=False))
    for res in ranks:
        np.testing.assert_allclose(res["nti_ring"], ref, atol=ATOL_EMB, rtol=0)
    stops = [res["nti_ring_stops"].tolist() for res in ranks]
    assert stops[0] == stops[1]
    # the early stop is exercised: some steps stop before INNER, some do not
    flat = [s for step in stops[0] for s in step]
    assert min(flat) < INNER and max(flat) == INNER, stops[0]


def test_nti_ranks_stop_in_lockstep(setup):
    """Rank 1's losses skewed by 1e3 (it alone would never stop early):
    both ranks stop where rank 0 stops unskewed."""
    _, _, ranks = setup
    for res in ranks:
        assert res["nti_ring_skewed_stops"].tolist() == ranks[0]["nti_ring_stops"].tolist()


def test_p2z_guided_step_under_the_ring_matches_jax(setup):
    """One guided step's loss and gradient with respect to the CFG pair,
    through the checkpointed UNet under the ring, against JAX's unsharded
    ``attn_loss`` and its gradient on the same references."""
    jpipe, inp, ranks = setup
    refs = {k[len("p2z_refs/"):]: jnp.asarray(v, jnp.bfloat16) for k, v in ranks[0].items()
            if k.startswith("p2z_refs/")}
    assert refs
    t = jpipe.scheduler.timesteps[1]
    ctx = jnp.asarray(inp["p2z_ctx"])

    def attn_loss(x):
        _, rec = jpipe.unet.apply(jpipe.unet_params, x, t, ctx, P2ZStep(), None, False)
        return sum(jnp.square(cur.astype(jnp.float32) - refs[k].astype(jnp.float32)).sum(axis=(2, 3)).mean()
                   for k, cur in rec.items())

    loss, grad = jax.jit(jax.value_and_grad(attn_loss))(jnp.asarray(inp["p2z_x"]))
    grad = np.asarray(grad)
    for res in ranks:
        np.testing.assert_allclose(float(res["p2z_ring_loss"]), float(loss), rtol=1e-5)
        np.testing.assert_allclose(res["p2z_ring_grad"], grad, atol=GRAD_RTOL * np.abs(grad).max(), rtol=0)
    assert np.abs(grad[0] - grad[1]).max() > 0.1 * np.abs(grad).max()  # the halves get their own gradients


def test_p2z_pass_two_under_the_ring_matches_jax(setup):
    """Pass 2 over the schedule under the ring, each step's references made
    again from the stored trajectory, against JAX's unsharded
    ``_guided_scan`` in its ``recompute_refs`` mode."""
    jpipe, inp, ranks = setup
    ref = jp2z._guided_scan(jpipe.unet, jpipe.unet_params, jpipe.scheduler, jnp.asarray(inp["p2z_lat"]),
                            jnp.asarray(inp["p2z_ctx"]), None, jnp.float32(GS), jnp.float32(0.1), None, None, False,
                            src_traj=jnp.asarray(inp["p2z_src_traj"]), ctx_src=jnp.asarray(inp["p2z_ctx_src"]))
    ref = np.asarray(ref)
    for res in ranks:
        assert res["p2z_ring_losses"].shape == (STEPS,) and np.all(np.isfinite(res["p2z_ring_losses"]))
        np.testing.assert_allclose(res["p2z_ring_final"], ref, atol=ATOL_EDIT, rtol=0)
    assert np.abs(ref - inp["p2z_lat"]).max() > 10 * ATOL_EDIT  # the pass moves the latent


@pytest.mark.parametrize("key", ["p2z_ring_loss", "p2z_ring_grad", "p2z_ring_final", "p2z_ring_losses"])
def test_p2z_under_the_ring_is_bitwise_equal_on_both_ranks(setup, key):
    _, _, ranks = setup
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
