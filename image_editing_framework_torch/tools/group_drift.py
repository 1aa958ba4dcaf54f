"""How far a batched edit strays from the serial one on the card, against
how far a one-ulp nudge of the start moves the serial one, and which
operation makes a row's result depend on its place in the batch. A
diagnostic run by hand; the tests run ``row_dependence`` on the CPU.

    python3 -m image_editing_framework_torch.tools.group_drift

First ``row_dependence``: one SD1.5 UNet forward at batch 4 and 16 in bf16
and at batch 4 in f32, every leaf module and attention call rerun on inputs
whose rows are all equal and on its first row alone, and the calls that
give unequal rows, or a first row unlike batch 1's, named (one JSON line
each). Then the drift, SD1.5 at 512² with seeded random weights,
50 steps, in bf16 and then f32:
one smooth seeded image inverted by DDIM at batch 1 and, four copies of it,
by ``ddim_invert_batch`` at batch 4 (the latents' largest distance per 5
steps); the P2P replace edit from the serial inversion's latent alone and as
a group of four copies (``p2p_edit_batch``: the images' largest and mean
distance in uint8 levels, for the reconstruction and the edit); the serial
inversion and edit again from a start one ulp of the dtype away (the same
readings); whether the batch's identical rows came out identical, and
whether a group of one gives the serial edit's bits. One JSON line per
dtype, then the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import collections
import json
import subprocess

import numpy as np
import torch

from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
from image_editing_framework_torch.eval import batched
from image_editing_framework_torch.inversion.ddim import ddim_invert
from image_editing_framework_torch.methods.p2p import p2p_edit
from image_editing_framework_torch.models import unet as unet_module
from image_editing_framework_torch.pipelines import random_pipeline

SOURCE, TARGET = "a cat sitting on the grass", "a dog sitting on the grass"
GROUP = 4
# the attention calls of the UNet that no leaf module makes
ATTENTION_CALLS = ("self_attention", "cross_attention_probs", "apply_probs")


def _equal_rows(x: torch.Tensor) -> bool:
    return all(torch.equal(x[0], x[i]) for i in range(1, x.shape[0]))


def row_dependence(pipe, batch: int, side: int = 64, t: int = 981) -> dict:
    """One SD UNet forward at ``batch`` rows of a ``side``² latent (512²
    images at the default; no control). Every call of a
    leaf module and of the attention functions is run a second time with
    each of its batch-indexed inputs replaced by its first row repeated
    (copied, so each row has memory of its own), and once more with the
    first row alone (batch 1). Returns the calls counted per operation and,
    per operation, the input shapes where equal rows came out unequal
    (``row_dependent``: the result depends on a row's place in the batch)
    and where the first row differs from the same call at batch 1
    (``batch_dependent``: it depends on the batch's size). Both empty means
    a group gives each image the bits it gets alone, at these shapes."""
    unet = pipe.unet
    calls = collections.Counter()
    found = {"row_dependent": collections.defaultdict(set), "batch_dependent": collections.defaultdict(set)}
    busy = [False]

    def rerun(name, fn, args, kwargs):
        if busy[0]:
            return
        busy[0] = True
        try:
            rows = [isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == batch for a in args]
            out = fn(*[a[:1].expand_as(a).contiguous() if r else a for a, r in zip(args, rows)], **kwargs)
            alone = fn(*[a[:1].contiguous() if r else a for a, r in zip(args, rows)], **kwargs)
        finally:
            busy[0] = False
        calls[name] += 1
        shape = tuple(args[0].shape)
        if not _equal_rows(out):
            found["row_dependent"][name].add(shape)
        if not torch.equal(out[:1], alone):
            found["batch_dependent"][name].add(shape)

    def hook(mod, args, _out):
        if isinstance(args[0], torch.Tensor) and args[0].shape[0] == batch:
            rerun(type(mod).__name__, mod, args, {})

    def wrapped(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            rerun(name, fn, args, kwargs)
            return out
        return call

    originals = {name: getattr(unet_module, name) for name in ATTENTION_CALLS}
    handles = [m.register_forward_hook(hook) for m in unet.modules() if not any(m.children())]
    try:
        for name, fn in originals.items():
            setattr(unet_module, name, wrapped(name, fn))
        gen = torch.Generator(pipe.device).manual_seed(0)
        lat = torch.randn(1, side, side, unet.config.in_channels, device=pipe.device, generator=gen)
        context = pipe.encode_prompts([SOURCE])[0][1:]
        with torch.no_grad():
            unet(lat.expand(batch, -1, -1, -1).contiguous(), t, context.expand(batch, -1, -1).contiguous())
    finally:
        for name, fn in originals.items():
            setattr(unet_module, name, fn)
        for h in handles:
            h.remove()
    return dict(dtype=str(unet.conv_in.weight.dtype).split(".")[1], batch=batch, calls=dict(calls),
                **{key: {name: sorted(shapes) for name, shapes in per.items()} for key, per in found.items()})


def levels(a: np.ndarray, b: np.ndarray) -> list:
    """[largest, mean] distance of two uint8 images in levels."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return [int(d.max()), float(d.mean())]


def drift(dtype: torch.dtype, image: np.ndarray) -> dict:
    pipe = random_pipeline("1.5", num_steps=50, dtype=dtype, seed=0, device="cuda")
    sampler, cfg = SamplerConfig(height=512, width=512), P2PConfig(edit_type="replace")
    lat = pipe.image2latent(image)
    last, traj, _, _ = ddim_invert(pipe, lat, SOURCE)
    _, trajs = batched.ddim_invert_batch(pipe, lat[None].expand(GROUP, -1, -1, -1, -1).contiguous(),
                                         [SOURCE] * GROUP, return_trajectory=True)
    ulp = 1 + torch.finfo(dtype).eps
    _, nudged_traj, _, _ = ddim_invert(pipe, lat * ulp, SOURCE)
    one = p2p_edit(pipe, [SOURCE, TARGET], last, cfg, sampler)
    group = batched.p2p_edit_batch(pipe, [[SOURCE, TARGET]] * GROUP,
                                   last[None].expand(GROUP, -1, -1, -1, -1).contiguous(), [cfg] * GROUP)
    nudged = p2p_edit(pipe, [SOURCE, TARGET], last * ulp, cfg, sampler)
    group_of_one = batched.p2p_edit_batch(pipe, [[SOURCE, TARGET]], last[None], [cfg])
    steps = range(0, 51, 5)
    return dict(
        dtype=str(dtype).split(".")[1],
        inversion_group_vs_one_by_5_steps=[(trajs[0, k].float() - traj[k].float()).abs().max().item() for k in steps],
        inversion_nudged_vs_one_by_5_steps=[(nudged_traj[k].float() - traj[k].float()).abs().max().item()
                                            for k in steps],
        latent_max_by_10_steps=[traj[k].float().abs().max().item() for k in range(0, 51, 10)],
        inversion_rows_equal=all(torch.equal(trajs[0], trajs[g]) for g in range(GROUP)),
        edit_group_vs_one_levels=[levels(group[0][k], one[k]) for k in range(2)],
        edit_nudged_vs_one_levels=[levels(nudged[k], one[k]) for k in range(2)],
        edit_rows_equal=all(np.array_equal(group[0], group[g]) for g in range(GROUP)),
        group_of_one_bitwise=bool(np.array_equal(group_of_one[0], one)))


def main() -> int:
    from PIL import Image

    if not torch.cuda.is_available():
        raise SystemExit("group_drift: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype, batches in ((torch.bfloat16, (GROUP, 4 * GROUP)), (torch.float32, (GROUP,))):
        pipe = random_pipeline("1.5", num_steps=50, dtype=dtype, seed=0, device="cuda")
        for b in batches:
            print(json.dumps(row_dependence(pipe, b)), flush=True)
        del pipe
        torch.cuda.empty_cache()
    grid = np.random.RandomState(11).randint(0, 256, (8, 8, 3)).astype(np.uint8)
    image = np.array(Image.fromarray(grid).resize((512, 512), Image.BICUBIC))
    for dtype in (torch.bfloat16, torch.float32):
        print(json.dumps(drift(dtype, image)), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
