"""Rank processes for the port's context-parallel CPU tests.

Each test file starts its ranks once (``launch``): one process per rank, a
gloo group on a ``file://`` store under the test's temporary directory, a
60 s collective timeout, and a join timeout after which every rank is
killed. The ranks run every case of their suite on inputs made from a seed
with numpy (``ring_inputs``, which the tests call too) and write this
rank's results to ``<out>/<suite>_<rank>.npz``. The tensor-parallel
suites (``tp_*``) live in ``torch_tp_workers.py``. This module imports neither
JAX nor a test module, so a rank process imports no JAX.

    python tests/torch_cp_workers.py SUITE RANK WORLD STORE OUT [IN]
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
JOIN_TIMEOUT_S = 240

# name -> (seed, B, H, Nq, Nk, D, bias kind, mode, worlds, grad)
RING_CASES = {
    "ring": (0, 2, 4, 128, 128, 16, None, "ring", (2, 4), False),
    "ring_segment_bias": (1, 2, 4, 128, 128, 16, "segment", "ring", (2, 4), False),
    "ring_union_bias": (2, 2, 2, 64, 128, 16, "union", "ring", (2, 4), False),
    "ring_neg_inf_shards": (3, 1, 2, 128, 128, 16, "neg_inf_half", "ring", (4,), False),
    "ulysses_bias": (4, 1, 4, 128, 128, 16, "segment", "ulysses", (2, 4), False),
    "ulysses_ring": (5, 1, 4, 128, 128, 16, None, "ulysses_ring", (4,), False),
    "ulysses_ring_bias": (6, 1, 4, 128, 128, 16, "segment", "ulysses_ring", (4,), False),
    "ring_grad": (7, 1, 2, 128, 128, 16, "segment", "ring", (2, 4), True),
    "ulysses_grad": (8, 1, 4, 128, 128, 16, "segment", "ulysses", (2,), True),
    "ulysses_ring_grad": (9, 1, 4, 128, 128, 16, None, "ulysses_ring", (4,), True),
}


def ring_inputs(name):
    """Global numpy inputs of a case: q, k, v, bias (or None), the loss's
    target (of q's shape)."""
    seed, b, h, nq, nk, d, kind, *_ = RING_CASES[name]
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, nk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, nk, d)).astype(np.float32)
    tgt = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    keys = np.arange(nk)
    if kind is None:
        bias = None
    elif kind == "segment":  # MasaCtrl-union-like segments: a quarter of each 64 keys off
        bias = np.where(keys % 64 < 48, 0.0, NEG_INF)
    elif kind == "union":  # two segments of nq keys, the first off for batch row 0
        bias = np.stack([np.where(keys < nq, NEG_INF, 0.0), np.zeros(nk)])
    else:  # the first half of the keys truly -inf: two ring shards whose rows see no live key
        bias = np.where(keys < nk // 2, -np.inf, 0.0)
    if bias is not None:
        bias = np.broadcast_to(bias, (b, nk)).astype(np.float32).copy()
    return q, k, v, bias, tgt


def launch(suite, world, tmp, in_dir="", timeout=JOIN_TIMEOUT_S):
    """Run ``suite`` on ``world`` rank processes; returns each rank's results
    (a list of dicts). Raises with the ranks' output if one fails or the
    join times out (every rank is killed first)."""
    out = os.path.join(str(tmp), f"{suite}_{world}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(rank), str(world), store,
                                        out, str(in_dir)], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    codes = [proc.returncode for proc, _ in procs]
    if any(codes):
        logs = "".join(open(os.path.join(out, f"rank{r}.log")).read()[-3000:] for r in range(world))
        raise AssertionError(f"{suite} on {world} ranks: exit codes {codes}\n{logs}")
    return [dict(np.load(os.path.join(out, f"{suite}_{rank}.npz"))) for rank in range(world)]


# ---------------------------------------------------------------------------
# rank side


def _torch_inputs(name):
    import torch

    return [None if x is None else torch.from_numpy(x) for x in ring_inputs(name)]


def _chunk(mesh, mode):
    from image_editing_framework_torch.parallel.ring_attention import _chunk

    index, count, _, _ = _chunk(mesh, mode, "data")
    return index, count


def suite_ring(mesh1d, mesh2d, world):
    """Every ring case for this world: this rank's output shard (and for the
    grad cases its dq, dk, dv shards), the chunk it holds."""
    import torch

    from image_editing_framework_torch.parallel import ring_attention as ra

    res = {}
    for name, (_, _, h, _, _, _, _, mode, worlds, grad) in RING_CASES.items():
        if world not in worlds:
            continue
        mesh = mesh2d if mode == "ulysses_ring" else mesh1d
        index, count = _chunk(mesh, mode)
        q, k, v, bias, tgt = _torch_inputs(name)

        def shard(x, dim=2):
            size = x.shape[dim] // count
            return x.narrow(dim, index * size, size).contiguous()

        qs, ks, vs = (shard(x).requires_grad_(grad) for x in (q, k, v))
        bs = None if bias is None else shard(bias, 1)
        if mode == "ring":
            out = ra.ring_self_attention(qs, ks, vs, mesh, "data", bias=bs)
        elif mode == "ulysses":
            out = ra.ulysses_self_attention(qs, ks, vs, mesh, "data", bias=bs)
        else:
            out = ra.ulysses_ring_attention(qs, ks, vs, mesh, "tensor", "data", bias=bs)
        res[f"{name}/out"] = out.detach().numpy()
        res[f"{name}/chunk"] = np.array(index)
        if grad:
            ((out - shard(tgt)) ** 2).sum().backward()
            for t, x in (("dq", qs), ("dk", ks), ("dv", vs)):
                res[f"{name}/{t}"] = x.grad.numpy()
    # Ulysses with H % n != 0: every rank raises before any collective
    try:
        q = torch.zeros((1, world + 1, 8, 16))
        ra.ulysses_self_attention(q, q, q, mesh1d, "data")
        res["ulysses_bad_heads"] = np.array("no error")
    except AssertionError as e:
        res["ulysses_bad_heads"] = np.array(str(e))
    return res


def _unet_inputs(in_dir):
    return dict(np.load(os.path.join(in_dir, "inputs.npz")))


def suite_unet(mesh1d, rank, in_dir):
    """The tiny UNet with CP (ring, Ulysses; a masked MasaCtrl control), the
    masked overrides under CP, NTI and pix2pix-zero under the ring."""
    import torch

    from image_editing_framework_torch.core.config import MasaCtrlConfig, NTIConfig
    from image_editing_framework_torch.inversion import nti
    from image_editing_framework_torch.methods import p2z
    from image_editing_framework_torch.methods.common import grad_unet
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.weights import load_weights
    from image_editing_framework_torch.ops.attention import AttnSite
    from image_editing_framework_torch.ops.controls import (MasaCtrlAutoStep, MasaCtrlMaskStep, P2ZStep,
                                                            build_masactrl_control)
    from image_editing_framework_torch.pipelines import tiny_pipeline

    inp = _unet_inputs(in_dir)
    weights = dict(np.load(os.path.join(in_dir, "unet.npz")))
    t = {key: torch.from_numpy(val) for key, val in inp.items()}
    pipe = tiny_pipeline(num_steps=int(inp["steps"]), device="cpu")
    load_weights(pipe.unet, weights)
    unet = pipe.unet
    res = {}
    with torch.no_grad():
        for mode in ("ring", "ulysses"):
            unet.set_context_parallel(mesh1d, 64, mode)
            res[f"unet_{mode}"] = unet(t["x"], 10, t["ctx"])[0].numpy()
        unet.set_context_parallel(mesh1d, 64, "ring")
        ctrl = build_masactrl_control(4, configs.TINY_UNET.num_transformer_blocks,
                                      MasaCtrlConfig(start_step=0, start_layer=0), mask_s=t["mask_s"],
                                      mask_t=t["mask_t"], device="cpu")
        res["unet_masactrl_mask"] = unet(t["x4"], 10, t["ctx4"], ctrl.at_step(1))[0].numpy()
        unet.set_context_parallel(None)

        site = AttnSite(layer=0, place="down", seq_len=256, is_cross=False)
        q, k, v = t["q"], t["k"], t["v"]
        gate = torch.tensor(True)
        mask = MasaCtrlMaskStep(step_gate=gate, layers=(0,), num_prompts=2, mask_s=t["mask_s"], mask_t=t["mask_t"])
        auto = MasaCtrlAutoStep(step_gate=gate, layers=(0,), num_prompts=2)
        running = {"down_l0_cross": t["running"]}
        for mode in ("ring", "ulysses"):
            res[f"override_mask_{mode}"] = mask.self_override(site, q, k, v, None, mesh1d, mode).numpy()
            res[f"override_auto_{mode}"] = auto.self_override(site, q, k, v, running, mesh1d, mode).numpy()
        res["override_auto_no_maps"] = auto.self_override(site, q, k, v, None, mesh1d).numpy()

    # NTI under the ring: the embeddings and each step's inner iterations,
    # then again with this rank's losses skewed (rank 0's stay): every rank
    # must stop where rank 0 stops, or the ranks' collectives fall apart.
    cfg = NTIConfig(num_inner_steps=int(inp["inner"]), epsilon=float(inp["epsilon"]))
    unet.set_context_parallel(mesh1d, 64, "ring")
    seq, stops = nti.null_text_inversion_batch(pipe, t["traj"][None], t["context"][None], cfg, return_stops=True)
    res["nti_ring"], res["nti_ring_stops"] = seq[0].numpy(), np.array(stops)
    losses = nti.nti_losses

    def skewed(*args, **kwargs):
        return losses(*args, **kwargs) + 1e3 * rank

    nti.nti_losses = skewed
    try:
        _, stops = nti.null_text_inversion_batch(pipe, t["traj"][None], t["context"][None], cfg, return_stops=True)
    finally:
        nti.nti_losses = losses
    res["nti_ring_skewed_stops"] = np.array(stops)

    # pix2pix-zero under the ring, the checkpointed UNet forced on: one
    # guided step's loss and gradient against references made unsharded
    # (returned, for JAX to take the same), then pass 2 over the schedule
    # with its references made again under the ring from a stored
    # trajectory (``recompute_refs``)
    unet.set_context_parallel(None)
    with torch.no_grad():
        _, refs = unet(t["p2z_src"], int(pipe.scheduler.timesteps[1]), t["p2z_ctx_src"], P2ZStep())
    for key, ref in refs.items():
        res[f"p2z_refs/{key}"] = ref.float().numpy()
    unet.set_context_parallel(mesh1d, 64, "ring")
    checkpointed = grad_unet(pipe, 16, force=True)
    loss, grad = p2z.guidance_gradient(checkpointed, t["p2z_x"], int(pipe.scheduler.timesteps[1]), t["p2z_ctx"], refs)
    res["p2z_ring_loss"], res["p2z_ring_grad"] = loss.numpy(), grad.numpy()
    final, losses = p2z._guided_scan(checkpointed, pipe.scheduler, t["p2z_lat"], t["p2z_ctx"], None, 7.5, 0.1,
                                     src_traj=t["p2z_src_traj"], ctx_src=t["p2z_ctx_src"])
    res["p2z_ring_final"], res["p2z_ring_losses"] = final.numpy(), losses.numpy()
    unet.set_context_parallel(None)
    return res


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _ring_checks(smoke, mesh, device):
    """chip_smoke.py's part (e) at tiny size on ``device``: (e1) on the tiny
    UNet, then (c)'s DDIM inversion and (e2), (e3) on the tiny pipeline
    under the ring (``cp_min_seq`` 64, the checkpointed UNet forced on),
    with exact launch counts on the card (a forward's under the ring counted
    first); the digests, stops and images the ranks compare."""
    import torch

    from image_editing_framework_torch import cli
    from image_editing_framework_torch.pipelines import tiny_pipeline

    world = torch.distributed.get_world_size()
    pipe = tiny_pipeline(num_steps=smoke.STEPS // smoke.XL_NTI_STRIDE, device=device)
    pipe.tokenizer.encode(" ".join(smoke.PROMPTS))
    gen = torch.Generator().manual_seed(19)
    lat, ctx = (torch.randn(*shape, generator=gen).to(device) for shape in ((2, 16, 16, 4), (2, 77, 32)))
    sites = pipe.unet.config.num_transformer_blocks
    pipe.unet.set_context_parallel(mesh, 64, "ring")
    smoke.reset_launch_counts()
    with torch.no_grad():
        pipe.unet(lat, 501, ctx)
    per_forward = smoke.tp_counts(device)[0]
    pipe.unet.set_context_parallel(None)
    ring_sites = (per_forward - sites) // (world - 1)
    grads = smoke.cp_unet_gradients(pipe.unet, mesh, lat, ctx, None, min_seq=64, big_sites=ring_sites)
    pipe.unet.set_context_parallel(mesh, 64, "ring")
    image = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    last, traj, _ = cli.invert(pipe, image, smoke.PROMPTS[0], "ddim", "p2p")
    # the tiny UNet's first site runs on the ring and takes no NTI gradient
    paths = smoke.ring_grad_paths(pipe, 32, last, traj, smoke.CP_NTI_EPSILON, per_forward, per_forward - world,
                                  per_forward, remat=True)
    res = {"per_forward": np.array(per_forward), "ring_sites": np.array(ring_sites)}
    for batch, got in grads.items():
        res[f"{batch}/digest"] = np.array(got["digest"])
        res[f"{batch}/errors"] = np.array([got["latent"]["max_abs_err"], got["context"]["max_abs_err"]])
        res[f"{batch}/limits"] = np.array([got["latent"]["limit"], got["context"]["limit"]])
        res[f"{batch}/launches"] = np.array(got["launches"])
    res["nti/digest"], res["nti/stops"] = np.array(paths["nti"]["digest"]), np.array(paths["nti"]["stops"])
    res["nti/losses"] = np.array([loss[0] for loss in paths["nti"]["losses"]])
    res["nti/launches"], res["p2z/launches"] = np.array(paths["nti"]["launches"]), np.array(paths["p2z"]["launches"])
    res["p2z/images"] = np.array(paths["p2z"]["image_sha256"])
    res["checkpointed"] = np.array([paths["nti"]["checkpointed_unet"], paths["p2z"]["checkpointed_unet"]])
    return res


def suite_cp_smoke(mesh1d):
    """chip_smoke.py's part (e) rehearsed on CPU ranks at tiny size
    (``_ring_checks``): every gate passes."""
    import torch

    return _ring_checks(_chip_smoke(), mesh1d, torch.device("cpu"))


def suite_grad_card():
    """The card twin of parts (d) and (e) (tests/test_torch_grad_card.py):
    chip_smoke.py's tensor-parallel checks at tiny size (``tp_parts``, its
    p2z guided step, NTI and p2z included) on a data 1 x tensor 2 mesh, and
    part (e) at tiny size (``_ring_checks``), on the card over gloo (CUDA
    tensors staged through host memory, NTI's lockstep included), with
    exact launch counts."""
    import torch

    from image_editing_framework_torch.parallel import mesh as mesh_lib

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # as chip_smoke.py's rank processes: the ranks' gradients through the
    # layers outside the ring are bitwise equal only on deterministic cuDNN
    torch.backends.cudnn.deterministic = True
    smoke = _chip_smoke()
    device = torch.device("cuda")
    tp = smoke.tp_parts(mesh_lib.make_mesh(data=1, tensor=2, device_type="cuda"), device, tiny=True)
    res = _ring_checks(smoke, mesh_lib.make_mesh(device_type="cuda"), device)
    for key in ("p2z_step", "nti", "p2z", "train"):
        res[f"tp/{key}/launches"] = np.array(tp[key]["launches"])
        res[f"tp/{key}/digest"] = np.array(tp[key].get("digest", ""))
    res["tp/nti/stops"] = np.array(tp["nti"]["stops"])
    res["tp/p2z_step/error"] = np.array([tp["p2z_step"]["gradient"]["max_abs_err"], tp["p2z_step"]["gradient"]["limit"]])
    return res


def suite_mesh():
    """``make_mesh``'s shapes and placements on this group."""
    from image_editing_framework_torch.parallel import mesh as mesh_lib

    res = {}
    for name, kwargs in (("default", {}), ("tensor2", {"tensor": 2})):
        m = mesh_lib.make_mesh(device_type="cpu", **kwargs)
        res[f"{name}/names"] = np.array(m.mesh_dim_names)
        res[f"{name}/shape"] = np.array(m.shape)
        res[f"{name}/data_sharding"] = np.array([repr(p) for p in mesh_lib.data_sharding(m)])
        res[f"{name}/replicated"] = np.array([repr(p) for p in mesh_lib.replicated(m)])
    try:
        mesh_lib.make_mesh(data=3, device_type="cpu")
        res["bad_product"] = np.array("no error")
    except ValueError as e:
        res["bad_product"] = np.array(str(e))
    return res


def main(argv):
    suite, rank, world, store, out = argv[:5]
    in_dir = argv[5] if len(argv) > 5 else ""
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    from image_editing_framework_torch.parallel import mesh as mesh_lib

    got = mesh_lib.initialize_distributed(f"file://{store}", world, rank, backend="gloo",
                                          timeout=datetime.timedelta(seconds=60))
    try:
        if suite.startswith("tp_"):
            import torch_tp_workers

            res = torch_tp_workers.run(suite, rank, in_dir)
        elif suite == "mesh":
            res = suite_mesh()
        elif suite == "cp_smoke":
            res = suite_cp_smoke(mesh_lib.make_mesh(device_type="cpu"))
        elif suite == "grad_card":
            res = suite_grad_card()
        elif suite == "ring":
            mesh2d = mesh_lib.make_mesh(data=2, tensor=2, device_type="cpu") if world == 4 else None
            res = suite_ring(mesh_lib.make_mesh(device_type="cpu"), mesh2d, world)
        else:
            res = suite_unet(mesh_lib.make_mesh(device_type="cpu"), rank, in_dir)
        res["rank"] = np.array(got)
        np.savez(os.path.join(out, f"{suite}_{rank}.npz"), **res)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
