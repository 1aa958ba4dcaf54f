"""Rank processes for the port's tensor-parallel CPU tests.

The ranks start as ``torch_cp_workers.py``'s do (``launch``: a gloo group on
a ``file://`` store, a 60 s collective timeout, every rank killed at the
join timeout); a suite whose name starts with ``tp_`` runs from here. The
ranks load the JAX tiny pipeline's weights from the test's ``in_dir``
(diffusers-keyed ``.npz`` files), run each case unsharded first and then
split over "tensor" (``parallel/sharding.py shard_params``), and write this
rank's results. This module imports neither JAX nor a test module, so a
rank process imports no JAX.

Suites: ``tp_unet`` (world 2: the tiny UNet's forward and input gradients,
GEGLU's planted fault, the refusals, the tiny CLIP towers), ``tp_train``
(world 4, data 2 x tensor 2: ``make_sharded_train_step`` and TP x the
ring), ``tp_edits`` (world 2: the four record sites, the dryrun's MasaCtrl
denoise and NTI, the planted fault of a head mean over local heads).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

STEPS = 4
GS = 7.5
PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]
BLEND = (("cat",), ("dog",))
AUTO_THRES = 0.9  # tests/test_torch_masactrl.py: every auto-mask value 1.3e-2 or more away from it
# every word the edit suite encodes, given its id in this order first in every
# tiny tokenizer (it numbers words in the order it first sees them)
WORDS = " ".join(PROMPTS + ["a standing cat", "a blurry photo"])


def _npz(in_dir, name):
    return dict(np.load(os.path.join(in_dir, name)))


def _t(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def _n(x):
    return x.detach().cpu().float().numpy()


def _unet(in_dir, cfg=None):
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.models.weights import load_weights

    unet = UNet2DCondition(cfg or configs.TINY_UNET)
    return load_weights(unet, _npz(in_dir, "unet.npz"))


def _pipe(in_dir):
    from image_editing_framework_torch.models.weights import load_weights
    from image_editing_framework_torch.pipelines import tiny_pipeline

    pipe = tiny_pipeline(num_steps=STEPS, device="cpu")
    for attr, name in (("unet", "unet"), ("vae", "vae"), ("text_encoder", "text")):
        load_weights(getattr(pipe, attr), _npz(in_dir, f"{name}.npz"))
    pipe.tokenizer.encode(WORDS)
    return pipe


def _tp_mesh():
    """tensor = 2 over the group: data 1 on 2 ranks, data 2 on 4."""
    from image_editing_framework_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(tensor=2, device_type="cpu")


@contextlib.contextmanager
def geglu_split_together():
    """The planted fault: GEGLU's concatenated projection split as one
    matrix (at tensor = 2 rank 0 holds all of hidden, rank 1 all of gate)."""
    from image_editing_framework_torch.parallel import sharding

    real = sharding._HALVES
    sharding._HALVES = ()
    try:
        yield
    finally:
        sharding._HALVES = real


@contextlib.contextmanager
def records_of_local_heads():
    """The planted fault: the recorded maps of this rank's heads alone, so
    every head mean is over the local heads."""
    from image_editing_framework_torch.models import unet as unet_mod

    real = unet_mod.gather_heads
    unet_mod.gather_heads = lambda probs, group: probs
    try:
        yield
    finally:
        unet_mod.gather_heads = real


@contextlib.contextmanager
def copy_without_all_reduce():
    """The planted fault: a column-parallel layer's input gradient left as
    this rank's heads' share (``copy_to_tensor_parallel``'s backward
    without its all-reduce)."""
    from image_editing_framework_torch.parallel import sharding

    real = sharding._CopyToTensorParallel.backward
    sharding._CopyToTensorParallel.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        sharding._CopyToTensorParallel.backward = staticmethod(real)


def _input_grads(unet, x, ctx, tgt):
    import torch

    xr, cr = x.clone().requires_grad_(True), ctx.clone().requires_grad_(True)
    eps, _ = unet(xr, 10, cr)
    (eps * tgt).sum().backward()
    return _n(xr.grad), _n(cr.grad)


def _value_error(fn):
    try:
        fn()
    except ValueError as e:
        return np.array(str(e))
    return np.array("no error")


def suite_unet(in_dir):
    import torch

    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.clip import TINY_CLIP, TINY_CLIP_VISION, CLIPTextModel, CLIPVisionModel
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.models.weights import load_weights
    from image_editing_framework_torch.parallel import sharding

    mesh = _tp_mesh()
    inp = {k: _t(v) for k, v in _npz(in_dir, "inputs.npz").items()}
    x, ctx, tgt = inp["x"], inp["ctx"], inp["tgt"]
    res = {}
    unet = _unet(in_dir)
    full = {k: v.clone() for k, v in unet.state_dict().items()}
    with torch.no_grad():
        res["unet_plain"] = _n(unet(x, 10, ctx)[0])
    res["grad_x_plain"], res["grad_ctx_plain"] = _input_grads(unet, x, ctx, tgt)
    sharding.shard_params(unet, mesh)
    with torch.no_grad():
        res["unet_tp"] = _n(unet(x, 10, ctx)[0])
    res["grad_x_tp"], res["grad_ctx_tp"] = _input_grads(unet, x, ctx, tgt)
    gathered = sharding.gather_params(unet, mesh)
    res["gathered_equal"] = np.array(sorted(gathered) == sorted(full) and all(
        torch.equal(gathered[k], full[k]) for k in full))
    res["local_to_q"] = _n(unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q.weight)
    res["local_geglu"] = _n(unet.down_blocks[0].attentions[0].transformer_blocks[0].ff.net[0].proj.weight)
    res["ulysses_ring_after"] = _value_error(lambda: unet.set_context_parallel(mesh, 64, "ulysses_ring"))
    # a second split: over the same mesh the module comes back as it is;
    # a module holding a split part is refused
    res["second_split_same"] = np.array(sharding.shard_params(unet, mesh) is unet)
    res["local_to_q_again"] = _n(unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q.weight)
    res["second_split_part"] = _value_error(lambda: sharding.shard_params(torch.nn.ModuleDict({"unet": unet}), mesh))

    with geglu_split_together(), torch.no_grad():
        res["unet_geglu_fault"] = _n(sharding.shard_params(_unet(in_dir), mesh)(x, 10, ctx)[0])
    odd = dataclasses.replace(configs.TINY_UNET, num_heads=(1, 2))
    res["heads_error"] = _value_error(lambda: sharding.shard_params(UNet2DCondition(odd), mesh))
    ring2d = UNet2DCondition(configs.TINY_UNET, cp_mesh=mesh, cp_min_seq=64, cp_mode="ulysses_ring")
    res["ulysses_ring_before"] = _value_error(lambda: sharding.shard_params(ring2d, mesh))

    tiny_text = dataclasses.replace(TINY_CLIP, projection_dim=None, vocab_size=64)  # the tiny SD pipeline's tower
    text = load_weights(CLIPTextModel(tiny_text), _npz(in_dir, "text.npz"))
    vision = load_weights(CLIPVisionModel(TINY_CLIP_VISION), _npz(in_dir, "vision.npz"))
    ids, pixels = inp["ids"].long(), inp["pixels"]
    for tag in ("plain", "tp"):
        if tag == "tp":
            sharding.shard_params(text, mesh)
            sharding.shard_params(vision, mesh)
        with torch.no_grad():
            for key, val in text(ids).items():
                res[f"text_{tag}/{key}"] = _n(val)
            for key, val in vision(pixels).items():
                res[f"vision_{tag}/{key}"] = _n(val)
    return res


def suite_train(in_dir):
    import torch

    from image_editing_framework_torch.parallel import sharding

    mesh = _tp_mesh()
    inp = {k: _t(v) for k, v in _npz(in_dir, "inputs.npz").items()}
    res = {}
    unet = _unet(in_dir)
    init, step = sharding.make_sharded_train_step(unet, mesh)
    init(unet)
    res["loss"] = _n(step(inp["x4"], 10, inp["ctx4"], inp["tgt4"]))
    specs = sharding.unet_param_specs(unet)
    for name, g in sharding.gather_params(unet, mesh, grads=True).items():
        res[f"grad/{name}"] = _n(g)
    for name, p in sharding.gather_params(unet, mesh).items():
        res[f"param/{name}"] = _n(p)
    for name, p in unet.named_parameters():
        if not isinstance(specs[name], sharding.Shard):
            res[f"replicated/{name}"] = _n(p)

    ring = sharding.shard_params(_unet(in_dir), mesh)
    ring.set_context_parallel(mesh, 64, "ring")
    with torch.no_grad():
        res["unet_tp_ring"] = _n(ring(inp["x"], 10, inp["ctx"])[0])
    return res


def _edits(pipe, inp, res, tag):
    """Every editing case on ``pipe``; results under ``tag/``."""
    import torch

    from image_editing_framework_torch.core.config import MasaCtrlConfig, NTIConfig, P2PConfig, SamplerConfig
    from image_editing_framework_torch.inversion import nti
    from image_editing_framework_torch.methods import base, common, masactrl, p2z
    from image_editing_framework_torch.methods.p2p import p2p_setup
    from image_editing_framework_torch.ops import controls

    sampler = SamplerConfig(height=32, width=32)
    # P2P replace with LocalBlend
    lat0, context, ctrl, blend, _ = p2p_setup(pipe, PROMPTS, inp["latent"], P2PConfig(blend_words=BLEND), sampler)
    res[f"{tag}/p2p_blend"] = _n(base.denoise(pipe, lat0, context, ctrl, guidance_scale=GS, blend=blend))
    # MasaCtrl with the auto mask (the masked override reads the records)
    seen, real = [], masactrl.denoise
    masactrl.denoise = lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1]
    try:
        masactrl.masactrl_edit(pipe, PROMPTS, inp["latent"], MasaCtrlConfig(start_step=1, start_layer=2), sampler,
                               auto_mask=True, thres=AUTO_THRES, cur_token_idx=(2,))
    finally:
        masactrl.denoise = real
    res[f"{tag}/masactrl_auto"] = _n(seen[0][0] if isinstance(seen[0], tuple) else seen[0])
    # the attention store
    ctx2, _ = common.prepare_conditioning(pipe, PROMPTS, 32, 32)
    lat2 = inp["latent"].repeat(2, 1, 1, 1)
    _, rec, _ = base.denoise(pipe, lat2, ctx2, controls.AttentionStoreControl(max_seq=1024), GS,
                             collect_records=True)
    for key, val in rec.items():
        res[f"{tag}/store/{key}"] = _n(val)
    # one p2z guided step: the loss and the latent's gradient
    ctx1, _ = common.prepare_conditioning(pipe, [PROMPTS[1]], 32, 32)
    refs = {key[len("p2z_ref/"):]: _t(val).to(torch.bfloat16) for key, val in inp.items() if key.startswith("p2z_ref/")}
    loss, grad = p2z.guidance_gradient(pipe.unet, inp["p2z_x"], int(pipe.scheduler.timesteps[1]), ctx1, refs)
    res[f"{tag}/p2z_loss"], res[f"{tag}/p2z_grad"] = _n(loss), _n(grad)
    # the dryrun's MasaCtrl denoise (start_step 1, start_layer 0) and NTI
    ctrl = controls.build_masactrl_control(STEPS, pipe.unet.config.num_transformer_blocks,
                                           MasaCtrlConfig(start_step=1, start_layer=0), device="cpu")
    ctxm, _ = common.prepare_conditioning(pipe, ["a cat", "a standing cat"], 32, 32)
    res[f"{tag}/masactrl_denoise"] = _n(base.denoise(pipe, inp["lat2"], ctxm, ctrl, guidance_scale=GS))
    cfg = NTIConfig(num_inner_steps=2)
    seq, stops = nti.null_text_inversion_batch(pipe, inp["traj"][None], inp["context"][None], cfg,
                                               return_stops=True)
    res[f"{tag}/nti"], res[f"{tag}/nti_stops"] = _n(seq[0]), np.array(stops)
    res[f"{tag}/encode"] = _n(ctx2)


def suite_edits(rank, in_dir):
    from image_editing_framework_torch.core.config import NTIConfig, P2PConfig, SamplerConfig
    from image_editing_framework_torch.inversion import nti
    from image_editing_framework_torch.methods import base
    from image_editing_framework_torch.methods.p2p import p2p_setup
    from image_editing_framework_torch.parallel import sharding

    mesh = _tp_mesh()
    inp = {k: _t(v) for k, v in _npz(in_dir, "inputs.npz").items()}
    pipe = _pipe(in_dir)
    res = {}
    _edits(pipe, inp, res, "plain")
    sharding.shard_params(pipe.unet, mesh)
    sharding.shard_params(pipe.text_encoder, mesh)
    _edits(pipe, inp, res, "tp")
    with records_of_local_heads():
        lat0, context, ctrl, blend, _ = p2p_setup(pipe, PROMPTS, inp["latent"], P2PConfig(blend_words=BLEND),
                                                  SamplerConfig(height=32, width=32))
        res["fault/p2p_blend"] = _n(base.denoise(pipe, lat0, context, ctrl, guidance_scale=GS, blend=blend))

    # NTI with this rank's losses skewed (rank 0's stay): every rank must
    # stop where rank 0 stops, or the ranks' collectives fall apart
    losses = nti.nti_losses
    nti.nti_losses = lambda *a, **kw: losses(*a, **kw) + 1e3 * rank
    try:
        _, stops = nti.null_text_inversion_batch(pipe, inp["traj"][None], inp["context"][None],
                                                 NTIConfig(num_inner_steps=4, epsilon=float(inp["epsilon"])),
                                                 return_stops=True)
    finally:
        nti.nti_losses = losses
    res["nti_skewed_stops"] = np.array(stops)
    return res


def _smoke_checks(smoke, mesh):
    """chip_smoke.py's part (d) at tiny size on the CPU: (d1) on a tiny UNet
    after its unsharded forward, then (d2), the p2z guided step, (d4),
    (d5) and (d3) (``tp_parts``)."""
    import torch

    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.pipelines import _build

    device = torch.device("cpu")
    unet = _build(UNet2DCondition, configs.TINY_UNET, device, torch.float32, 0)
    gen = torch.Generator().manual_seed(16)
    lat, ctx = torch.randn(4, 16, 16, 4, generator=gen), torch.randn(4, 77, 32, generator=gen)
    with torch.no_grad():
        ref = unet(lat, 501, ctx)[0]
    res = smoke.tp_parts(mesh, device, tiny=True)
    res["unet"] = smoke.tp_unet_forward(unet, mesh, lat, 501, ctx, None, ref)
    return res


def suite_smoke():
    """chip_smoke.py's tensor-parallel checks rehearsed on CPU ranks: as
    they are (every check passes; the results the ranks compare), with
    GEGLU's halves split together and with the column-parallel input
    gradients left unreduced (a check must fail)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mesh = _tp_mesh()
    res = {}
    for tag, planted in (("sound", contextlib.nullcontext), ("geglu_fault", geglu_split_together),
                         ("copy_fault", copy_without_all_reduce)):
        try:
            with planted():
                got = _smoke_checks(smoke, mesh)
        except AssertionError as e:
            res[f"{tag}/error"] = np.array(str(e))
            continue
        res[f"{tag}/error"] = np.array("")
        for key in ("unet", "control", "train", "p2z_step", "nti", "p2z"):
            for field in ("digest", "blend_digest", "replicated_digest", "loss", "stops"):
                if field in got[key]:
                    res[f"{tag}/{key}/{field}"] = np.array(got[key][field])
        res[f"{tag}/errors"] = np.array([got["unet"]["max_abs_err"], got["control"]["eps"]["max_abs_err"],
                                         got["control"]["encode"]["max_abs_err"], got["train"]["grad_max_abs_err"],
                                         got["p2z_step"]["gradient"]["max_abs_err"]])
    return res


def suite_card():
    """The card twin (tests/test_torch_tp_card.py): the tiny UNet split over
    tensor = 2, its forward and one ``make_sharded_train_step`` step, on the
    CPU and on the card (the flash kernels; gloo stages the card's tensors
    through host memory), with the card's launch counts; and the same
    forward, loss and gradients unsharded on the CPU (``ref/``)."""
    import torch

    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.parallel import mesh as mesh_lib
    from image_editing_framework_torch.parallel import sharding
    from image_editing_framework_torch.pipelines import _build

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_mesh(tensor=2, device_type="cuda")
    gen = torch.Generator().manual_seed(3)
    lat, ctx, tgt = (torch.randn(*shape, generator=gen) for shape in ((2, 16, 16, 4), (2, 77, 32), (2, 16, 16, 4)))
    # built on the CPU for every run: a CUDA generator draws other weights
    unet = _build(UNet2DCondition, configs.TINY_UNET, torch.device("cpu"), torch.float32, 0)
    with torch.no_grad():
        res = {"ref/forward": _n(unet(lat, 10, ctx)[0])}
    unet.requires_grad_(True)
    loss = torch.mean((unet(lat, 10, ctx)[0] - tgt) ** 2)
    loss.backward()
    res["ref/loss"] = _n(loss)
    for name, p in unet.named_parameters():
        res[f"ref/grad/{name}"] = _n(p.grad)
    for device in (torch.device("cpu"), torch.device("cuda")):
        unet = _build(UNet2DCondition, configs.TINY_UNET, torch.device("cpu"), torch.float32, 0).to(device)
        unet = sharding.shard_params(unet, mesh)
        fa.flash_attention.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
        with torch.no_grad():
            res[f"{device.type}/forward"] = _n(unet(lat.to(device), 10, ctx.to(device))[0])
        res[f"{device.type}/forward_launches"] = np.array(fa.flash_attention.launches)
        unet.requires_grad_(True)
        init, step = sharding.make_sharded_train_step(unet, mesh)
        init(unet)  # already split over the mesh: init keeps the split as it is
        fa.flash_attention.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
        res[f"{device.type}/loss"] = _n(step(lat.to(device), 10, ctx.to(device), tgt.to(device)))
        res[f"{device.type}/train_launches"] = np.array(
            [fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches])
        for name, g in sharding.gather_params(unet, mesh, grads=True).items():
            res[f"{device.type}/grad/{name}"] = _n(g)
    return res


def run(suite, rank, in_dir):
    if suite == "tp_card":
        return suite_card()
    if suite == "tp_smoke":
        return suite_smoke()
    if suite == "tp_unet":
        return suite_unet(in_dir)
    if suite == "tp_train":
        return suite_train(in_dir)
    return suite_edits(rank, in_dir)
