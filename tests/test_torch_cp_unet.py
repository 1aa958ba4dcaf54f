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
  where rank 0 stops (``parallel/ring_attention.py lockstep``).

Tolerances: the UNet and the overrides within ``ATOL`` = 2e-5, the JAX
package's limit for its CP UNet against its plain one; the NTI embeddings
within ``ATOL_EMB`` = 1e-3, a tenth of one Adam step, as
tests/test_torch_nti.py states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from image_editing_framework_tpu.core.config import MasaCtrlConfig, NTIConfig
from image_editing_framework_tpu.inversion.nti import null_text_inversion
from image_editing_framework_tpu.models import configs, loader
from image_editing_framework_tpu.models.unet import UNet2DCondition
from image_editing_framework_tpu.ops.attention import AttnSite
from image_editing_framework_tpu.ops.controls import MasaCtrlAutoStep, MasaCtrlMaskStep, build_masactrl_control
from image_editing_framework_tpu.pipelines import tiny_pipeline
from torch_cp_workers import launch

ATOL = 2e-5
ATOL_EMB = 1e-3
STEPS = 3
INNER = 4
EPSILON = 5.3  # between the steps' losses (5.7-5.06 at step 0, 9.5-9.2 after): step 0 stops after 3 iterations


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
