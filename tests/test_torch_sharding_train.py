"""``make_sharded_train_step`` and tensor parallelism x the ring on 4 gloo
rank processes (data 2 x tensor 2, ``torch_tp_workers.py suite_train``),
against the JAX package's ``make_sharded_train_step`` on
``make_mesh(tensor=2, devices=devices[:4])`` and JAX's unsharded UNet, in f32
on the CPU.

Tolerances:

* the loss within ``ATOL`` = 2e-5 (JAX's limit for its sharded forward);
* every weight gradient within ``GRAD_RTOL`` = 1e-4 of the whole
  gradient's max|ref| against ``jax.grad`` of the same loss (f32 sums over
  the batch and the tokens in another order). The whole gradient's scale,
  not each tensor's: some tensors' gradients are 0 up to rounding (a conv
  bias in front of a GroupNorm of one channel a group: ~1e-9, pure noise);
* the weights after the step within ``2 * LR`` + ``ATOL``: Adam's first step
  moves each weight by lr · g / (|g| + 1e-8), about lr · sign(g), so an
  element whose gradient lies within f32 noise of 0 (or near eps) may step
  either way in either framework. The weights must have moved, and the
  replicated ones must be bitwise equal on every rank.
* TP x the ring (the 256-token sites context-parallel over "data", heads
  split over "tensor") within ``ATOL`` of JAX's unsharded forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_editing_framework_tpu.models import configs, loader
from image_editing_framework_tpu.models.unet import UNet2DCondition
from image_editing_framework_tpu.parallel import mesh as jmesh
from image_editing_framework_tpu.parallel import sharding as jsharding
from image_editing_framework_tpu.pipelines import tiny_pipeline
from torch_cp_workers import launch

ATOL = 2e-5
GRAD_RTOL = 1e-4
LR = 1e-4


def _inputs():
    rng = np.random.RandomState(1)
    f32 = np.float32
    return {
        "x4": rng.standard_normal((4, 16, 16, 4)).astype(f32),
        "ctx4": rng.standard_normal((4, 77, 32)).astype(f32),
        "tgt4": rng.standard_normal((4, 16, 16, 4)).astype(f32),
        "x": rng.standard_normal((2, 16, 16, 4)).astype(f32),
        "ctx": rng.standard_normal((2, 77, 32)).astype(f32),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    jpipe = tiny_pipeline(num_steps=4)
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    np.savez(tmp / "unet.npz", **{k: np.ascontiguousarray(v) for k, v in
                                  loader.export_params(jpipe.unet_params, loader.unet_key).items()})
    return jpipe, inp, launch("tp_train", 4, tmp, in_dir=tmp)


@pytest.fixture(scope="module")
def jax_step(setup):
    """(loss, {key: grad}, {key: updated weight}) of JAX's sharded step."""
    jpipe, inp, _ = setup
    unet = UNet2DCondition(configs.TINY_UNET)
    mesh = jmesh.make_mesh(tensor=2, devices=jax.devices()[:4])
    args = (jnp.asarray(inp["x4"]), jnp.asarray(10), jnp.asarray(inp["ctx4"]), jnp.asarray(inp["tgt4"]))

    def loss_fn(params):
        eps, _ = unet.apply(params, args[0], args[1], args[2], None, None, False)
        return jnp.mean((eps - args[3]) ** 2)

    grads = jax.jit(jax.grad(loss_fn))(jpipe.unet_params)
    init, jitted = jsharding.make_sharded_train_step(unet, mesh)
    sp, opt_state = init(jpipe.unet_params)
    sp2, _, loss = jitted(sp, opt_state)(sp, opt_state, *args)
    export = {k: np.asarray(v) for k, v in loader.export_params(grads, loader.unet_key).items()}
    updated = {k: np.asarray(v) for k, v in loader.export_params(sp2, loader.unet_key).items()}
    return float(loss), export, updated


def test_train_step_loss_matches_jax(setup, jax_step):
    _, _, ranks = setup
    loss, _, _ = jax_step
    for res in ranks:
        np.testing.assert_allclose(float(res["loss"]), loss, atol=ATOL, rtol=0)


def test_train_step_gradients_match_jax(setup, jax_step):
    """The weights' gradients gathered to full shape, after the mean over
    "data": each against ``jax.grad`` of the same loss."""
    _, _, ranks = setup
    _, grads, _ = jax_step
    scale = max(np.abs(ref).max() for ref in grads.values())
    for res in ranks:
        got = {k[len("grad/"):]: v for k, v in res.items() if k.startswith("grad/")}
        assert sorted(got) == sorted(grads)
        for key, ref in grads.items():
            np.testing.assert_allclose(got[key], ref, atol=GRAD_RTOL * scale, rtol=0, err_msg=key)


def test_train_step_updates_weights_as_jax(setup, jax_step):
    jpipe, _, ranks = setup
    _, _, updated = jax_step
    before = loader.export_params(jpipe.unet_params, loader.unet_key)
    for res in ranks:
        moved = 0
        for key, ref in updated.items():
            got = res[f"param/{key}"]
            np.testing.assert_allclose(got, ref, atol=2 * LR + ATOL, rtol=0, err_msg=key)
            moved += int(np.abs(got - before[key]).max() > 0)
        assert moved == len(updated)
    replicated = sorted(k for k in ranks[0] if k.startswith("replicated/"))
    assert replicated and all(sorted(k for k in res if k.startswith("replicated/")) == replicated for res in ranks)
    for res in ranks[1:]:
        for key in replicated:
            np.testing.assert_array_equal(res[key], ranks[0][key], err_msg=key)


def test_tp_with_the_ring_matches_jax(setup):
    jpipe, inp, ranks = setup
    unet = UNet2DCondition(configs.TINY_UNET)
    ref = np.asarray(jax.jit(lambda p, a, c: unet.apply(p, a, 10, c, None, None, False)[0])(
        jpipe.unet_params, inp["x"], inp["ctx"]))
    for res in ranks:
        np.testing.assert_allclose(res["unet_tp_ring"], ref, atol=ATOL, rtol=0)
