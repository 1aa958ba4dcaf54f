"""Tensor parallelism (``parallel/sharding.py``) against the JAX package's, in
f32 on the CPU.

* ``unet_param_specs`` against JAX's on ``TINY_UNET`` and the tiny CLIP
  towers, mapped through the diffusers keys: every split key, and the count
  of replicated ones (JAX replicates every bias; the port splits a
  column-parallel layer's bias with its rows).
* Two gloo rank processes (``torch_tp_workers.py suite_unet``, started once
  for the file) split the tiny UNet over tensor = 2 and run its forward and
  its input gradients, against JAX's ``shard_params`` forward on a 1 x 2 mesh
  and JAX's unsharded one, and against the same forward unsharded in the
  rank; the planted fault (GEGLU's concatenated projection split as one
  matrix) must land far outside the limit; a head count that 2 does not
  divide and ``"ulysses_ring"`` with tensor > 1 raise; a second split cuts
  nothing (the same mesh) or raises (a split part); the tiny CLIP text
  and vision towers under TP against JAX's.

Tolerances: outputs within ``ATOL`` = 2e-5, the limit of JAX's own
``test_sharded_unet_forward_matches_single_device``; input gradients within
``GRAD_RTOL`` = 1e-4 of max|ref| (f32 sums over 77 tokens and two heads in
another order, as tests/test_torch_p2z.py holds its gradients); against the
same module unsharded in the rank, 1e-5 (one f32 all-reduce per block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from image_editing_framework_torch.models import clip as tclip
from image_editing_framework_torch.models import configs as tconfigs
from image_editing_framework_torch.models.unet import UNet2DCondition as TUNet
from image_editing_framework_torch.parallel import sharding as tsharding
from image_editing_framework_tpu.models import clip as jclip
from image_editing_framework_tpu.models import configs, loader
from image_editing_framework_tpu.models.unet import UNet2DCondition
from image_editing_framework_tpu.parallel import mesh as jmesh
from image_editing_framework_tpu.parallel import sharding as jsharding
from image_editing_framework_tpu.pipelines import tiny_pipeline
from torch_cp_workers import launch
from torch_port_helpers import export_random

ATOL = 2e-5
GRAD_RTOL = 1e-4
SELF_ATOL = 1e-5


def _inputs():
    rng = np.random.RandomState(0)
    f32 = np.float32
    return {
        "x": rng.standard_normal((2, 16, 16, 4)).astype(f32),
        "ctx": rng.standard_normal((2, 77, 32)).astype(f32),
        "tgt": rng.standard_normal((2, 16, 16, 4)).astype(f32),
        "ids": rng.randint(0, 63, size=(2, 77)).astype(np.int64),
        "pixels": rng.standard_normal((2, 32, 32, 3)).astype(f32),
    }


def _jax_vision():
    x = np.zeros((1, 32, 32, 3), np.float32)
    module = jclip.CLIPVisionModel(jclip.TINY_CLIP_VISION)
    arrays = export_random(module, 7, loader.clip_vision_key, x)
    return module, arrays


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX tiny pipeline, inputs, the vision tower's (module, arrays), the
    two ranks' results)."""
    tmp = tmp_path_factory.mktemp("tp_unet")
    jpipe = tiny_pipeline(num_steps=4)
    inp = _inputs()
    vision = _jax_vision()
    np.savez(tmp / "inputs.npz", **inp)
    for name, params, key in (("unet", jpipe.unet_params, loader.unet_key), ("text", jpipe.text_params,
                                                                            loader.clip_key)):
        np.savez(tmp / f"{name}.npz", **{k: np.ascontiguousarray(v) for k, v in
                                         loader.export_params(params, key).items()})
    np.savez(tmp / "vision.npz", **vision[1])
    return jpipe, inp, vision, launch("tp_unet", 2, tmp, in_dir=tmp)


def _jax_specs(params, key_fn):
    """{diffusers key: JAX PartitionSpec} of a param tree."""
    specs = jsharding.unet_param_specs(params)
    return {key_fn(path): spec for path, spec in loader._flatten(specs["params"] if "params" in specs else
                                                                  specs).items()}


@pytest.mark.parametrize("model", ["unet", "text", "vision"])
def test_param_specs_match_jax(model):
    P = jax.sharding.PartitionSpec
    if model == "unet":
        skeleton = jax.eval_shape(lambda: UNet2DCondition(configs.TINY_UNET).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), 0, jnp.zeros((1, 77, 32))))
        jspecs, module = _jax_specs(skeleton, loader.unet_key), TUNet(tconfigs.TINY_UNET)
    elif model == "text":
        skeleton = jax.eval_shape(lambda: jclip.CLIPTextModel(jclip.TINY_CLIP).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))
        jspecs, module = _jax_specs(skeleton, loader.clip_key), tclip.CLIPTextModel(tclip.TINY_CLIP)
    else:
        skeleton = jax.eval_shape(lambda: jclip.CLIPVisionModel(jclip.TINY_CLIP_VISION).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
        jspecs, module = _jax_specs(skeleton, loader.clip_vision_key), tclip.CLIPVisionModel(tclip.TINY_CLIP_VISION)
    specs = tsharding.unet_param_specs(module)
    assert sorted(specs) == sorted(jspecs)
    col = {k for k, s in jspecs.items() if s == P(None, "tensor")}
    row = {k for k, s in jspecs.items() if s == P("tensor", None)}
    assert col and row
    for key in col:
        assert specs[key] == Shard(0), key
        bias = key[: -len("weight")] + "bias"
        if bias in specs:  # split with its rows; JAX replicates it
            assert specs[bias] == Shard(0) and jspecs[bias] == P(), bias
    for key in row:
        assert specs[key] == Shard(1), key
    col_biases = {k[: -len("weight")] + "bias" for k in col} & set(specs)
    replicated = [k for k, s in specs.items() if s == Replicate()]
    assert len(replicated) == sum(s == P() for s in jspecs.values()) - len(col_biases)
    assert all(jspecs[k] == P() for k in replicated)


def _jax_forward(jpipe, x, ctx, mesh=None):
    unet = UNet2DCondition(configs.TINY_UNET)
    params = jpipe.unet_params if mesh is None else jsharding.shard_params(jpipe.unet_params, mesh)
    return np.asarray(jax.jit(lambda p, a, c: unet.apply(p, a, 10, c, None, None, False)[0])(params, x, ctx))


def test_tp_unet_forward_matches_jax(setup):
    jpipe, inp, _, ranks = setup
    ref = _jax_forward(jpipe, inp["x"], inp["ctx"])
    sharded = _jax_forward(jpipe, inp["x"], inp["ctx"], jmesh.make_mesh(tensor=2, devices=jax.devices()[:2]))
    np.testing.assert_allclose(sharded, ref, atol=ATOL, rtol=0)
    for res in ranks:
        np.testing.assert_allclose(res["unet_tp"], ref, atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["unet_tp"], sharded, atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["unet_tp"], res["unet_plain"], atol=SELF_ATOL, rtol=0)
    np.testing.assert_array_equal(ranks[0]["unet_tp"], ranks[1]["unet_tp"])


def test_tp_unet_input_gradients_match_jax(setup):
    """d sum(eps · tgt) / d (x, context): the context feeds the
    column-parallel to_k / to_v, whose input gradient is all-reduced."""
    jpipe, inp, _, ranks = setup
    unet = UNet2DCondition(configs.TINY_UNET)

    def f(x, c):
        return jnp.sum(unet.apply(jpipe.unet_params, x, 10, c, None, None, False)[0] * inp["tgt"])

    gx, gc = (np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1)))(inp["x"], inp["ctx"]))
    for res in ranks:
        for name, ref in (("x", gx), ("ctx", gc)):
            np.testing.assert_allclose(res[f"grad_{name}_tp"], ref, atol=GRAD_RTOL * np.abs(ref).max(), rtol=0)
            np.testing.assert_allclose(res[f"grad_{name}_tp"], res[f"grad_{name}_plain"],
                                       atol=SELF_ATOL * np.abs(ref).max(), rtol=0)


def test_split_keeps_this_ranks_rows_and_gathers_back(setup):
    """Rank r holds rows r of to_q's weight, and of GEGLU's hidden half and
    gate half each; gathering gives back the unsharded weights bitwise."""
    jpipe, _, _, ranks = setup
    full = loader.export_params(jpipe.unet_params, loader.unet_key)
    prefix = "down_blocks.0.attentions.0.transformer_blocks.0."
    to_q, geglu = full[prefix + "attn1.to_q.weight"], full[prefix + "ff.net.0.proj.weight"]
    half = geglu.shape[0] // 2
    for r, res in enumerate(ranks):
        assert bool(res["gathered_equal"])
        rows = to_q.shape[0] // 2
        np.testing.assert_array_equal(res["local_to_q"], to_q[r * rows:(r + 1) * rows])
        h, g = geglu[:half], geglu[half:]
        q = half // 2
        np.testing.assert_array_equal(res["local_geglu"], np.concatenate([h[r * q:(r + 1) * q], g[r * q:(r + 1) * q]]))


def test_a_second_split_cuts_nothing(setup):
    """``shard_params`` on a module already split over the mesh gives it
    back with this rank's rows as they were; on a module that holds a split
    part it raises."""
    _, _, _, ranks = setup
    for res in ranks:
        assert bool(res["second_split_same"])
        np.testing.assert_array_equal(res["local_to_q_again"], res["local_to_q"])
        assert "already split" in str(res["second_split_part"]), res["second_split_part"]


def test_geglu_split_together_is_rejected(setup):
    """The planted fault: rank 0 holding all of GEGLU's hidden half and rank
    1 all of its gate lands far outside the limit."""
    _, _, _, ranks = setup
    for res in ranks:
        assert np.abs(res["unet_geglu_fault"] - res["unet_plain"]).max() > 100 * ATOL


def test_refusals_name_their_cause(setup):
    _, _, _, ranks = setup
    for res in ranks:
        msg = str(res["heads_error"])
        assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1" in msg and "1 heads" in msg, msg
        for key in ("ulysses_ring_before", "ulysses_ring_after"):
            assert "ulysses_ring" in str(res[key]), res[key]


def test_tp_clip_towers_match_jax(setup):
    jpipe, inp, (vmodule, varrays), ranks = setup
    text = jpipe.text_encoder.apply(jpipe.text_params, jnp.asarray(inp["ids"], jnp.int32))
    vparams = loader.load_params(jax.eval_shape(lambda: vmodule.init(jax.random.PRNGKey(0), inp["pixels"][:1])),
                                 varrays, loader.clip_vision_key)
    vision = vmodule.apply(vparams, inp["pixels"])
    for res in ranks:
        for key in ("last_hidden_state", "penultimate", "pooled"):
            np.testing.assert_allclose(res[f"text_tp/{key}"], np.asarray(text[key]), atol=ATOL, rtol=0)
            np.testing.assert_allclose(res[f"text_tp/{key}"], res[f"text_plain/{key}"], atol=SELF_ATOL, rtol=0)
        for key in ("pooled", "image_embeds"):
            np.testing.assert_allclose(res[f"vision_tp/{key}"], np.asarray(vision[key]), atol=ATOL, rtol=0)
            np.testing.assert_allclose(res[f"vision_tp/{key}"], res[f"vision_plain/{key}"], atol=SELF_ATOL, rtol=0)
