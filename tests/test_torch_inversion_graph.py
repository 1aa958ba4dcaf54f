"""The inversion's graphed UNet forward (``inversion/graphs.py``) on the CPU.

A CUDA graph captures and replays only on a card, so here the capture/replay
object is replaced by an eager stand-in (its warm-up runs the forward, its
capture keeps the forward and its output, a replay runs the forward again
into that output) and the graph's device type is set to the CPU's. That
holds the path's own logic: one capture per shape, reused across groups and
kept within its bound, the static latent and timestep refreshed every step
and the context every scan, the DDIM update called through
``inversion.ddim.ddim_reverse_step`` at every step with that step's noise,
and the trajectory equal to the eager scan's; and it shows where the scan
keeps its eager forward. The control a capture splits the forward with
meets every self-attention site and changes nothing else. The card's twin
is ``tests/test_torch_batched_card.py`` (bit for bit, launch counts, the
attention calls).
"""

import weakref

import pytest
import torch

from image_editing_framework_torch.core.scheduler import inversion_timestep
from image_editing_framework_torch.eval import batched
from image_editing_framework_torch.inversion import ddim, graphs
from image_editing_framework_torch.models import unet as unet_module
from image_editing_framework_torch.pipelines import tiny_pipeline
from image_editing_framework_torch.utils import profiling

STEPS = 4
PROMPTS = ["a cat sat on the mat", "a dog sat on the rug", "a fox sat on the grass", "a cow sat in the field",
           "an owl sat on the branch"]


class EagerGraph:
    """The capture/replay object's stand-in (module doc)."""

    made: list = []

    def __init__(self, shared, device):
        self.fn = self.out = None
        self.replays = 0
        type(self).made.append(self)

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        self.out.copy_(self.fn())
        self.replays += 1


@pytest.fixture(scope="module")
def pipes():
    return {m: tiny_pipeline(num_steps=STEPS, model_type=m, device="cpu") for m in ("sd", "xl")}


@pytest.fixture
def graphed(monkeypatch):
    """The graph path on the CPU, with a fresh cache; yields the stand-ins made."""
    made = []
    monkeypatch.setattr(graphs, "CudaGraph", type("Stand", (EagerGraph,), {"made": made}))
    monkeypatch.setattr(graphs, "CAPTURE_DEVICE", "cpu")
    monkeypatch.setattr(graphs, "_CACHES", weakref.WeakKeyDictionary())
    yield made


def latents(g, seed=0):
    return torch.randn(g, 1, 16, 16, 4, generator=torch.Generator().manual_seed(seed))


def invert(pipe, g, seed=0):
    return batched.ddim_invert_batch(pipe, latents(g, seed), PROMPTS[seed:seed + g], return_trajectory=True)[1]


def recording(monkeypatch, unet):
    """Patches ``ddim.ddim_reverse_step`` and hooks the UNet: the updates'
    (step, eps) and the forwards' (latent, timesteps) in call order."""
    steps, inputs = [], []
    orig = ddim.ddim_reverse_step

    def reverse_step(sched, eps, i, sample):
        steps.append((i, eps.clone()))
        return orig(sched, eps, i, sample)

    monkeypatch.setattr(ddim, "ddim_reverse_step", reverse_step)

    def pre(module, args):
        lat, t = args[0], args[1]
        inputs.append((lat.clone(), torch.as_tensor(t).expand(lat.shape[0]).clone()))

    handle = unet.register_forward_pre_hook(pre)
    return steps, inputs, handle


@pytest.mark.parametrize("model_type", ["sd", "xl"])
def test_the_graphed_scan_is_the_eager_scan(pipes, graphed, monkeypatch, model_type):
    pipe, g = pipes[model_type], 2
    with monkeypatch.context() as m:
        m.setattr(graphs, "CAPTURE_DEVICE", "cuda")  # the CPU keeps the eager loop
        eager_steps, _, handle = recording(m, pipe.unet)
        want = invert(pipe, g)
        handle.remove()
    assert graphed == []
    got_steps, inputs, handle = recording(monkeypatch, pipe.unet)
    try:
        got = invert(pipe, g)
    finally:
        handle.remove()
    assert torch.equal(got, want)
    assert len(graphed) == 1 and graphed[0].replays == STEPS - 1
    # the update, through the module attribute, at every step with that step's noise
    assert [i for i, _ in got_steps] == list(range(STEPS))
    for (_, eps), (_, eps_eager) in zip(got_steps, eager_steps):
        assert torch.equal(eps, eps_eager)
    # the forwards' inputs: step 0's warm-up and capture, then one replay a step
    traj = got[:, :, 0].transpose(0, 1)  # (S+1, G, h, w, 4)
    order = [0, 0] + list(range(1, STEPS))
    assert len(inputs) == len(order)
    for (lat, t), i in zip(inputs, order):
        assert torch.equal(lat, traj[i])
        assert torch.equal(t, torch.full((g,), inversion_timestep(pipe.scheduler, i)))


def test_one_capture_per_shape_reused_across_groups(pipes, graphed, monkeypatch):
    """Two groups of 2 (other images and prompts: the context is copied in
    each scan) share one capture, a group of 3 takes a second; the tracer
    counts them under the steps."""
    pipe = pipes["sd"]
    with monkeypatch.context() as m:
        m.setattr(graphs, "CAPTURE_DEVICE", "cuda")
        want = [invert(pipe, 2, 0), invert(pipe, 2, 1), invert(pipe, 3, 2)]
    profiling.enable()
    try:
        got = []
        for g, seed in ((2, 0), (2, 1), (3, 2)):
            with profiling.phase("group"):
                got.append(invert(pipe, g, seed))
    finally:
        profiling.disable()
        spans = profiling.take()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the first group's step 0 is its warm-up, the second's a replay
    assert len(graphed) == 2 and [s.replays for s in graphed] == [2 * STEPS - 1, STEPS - 1]
    by_name = {}
    for s in spans:
        for k, n in s.counts.items():
            by_name.setdefault((s.name, k), 0)
            by_name[s.name, k] += n
    assert by_name == {("step", "graph_captures"): 2, ("step", "graph_replays"): 3 * STEPS - 2}


def test_the_cache_stays_within_its_bound(pipes, graphed):
    pipe = pipes["sd"]
    n = graphs.MAX_GRAPHS
    for g in range(1, n + 2):
        invert(pipe, g)
    cache = graphs._CACHES[pipe.unet]
    assert len(graphed) == n + 1 and len(cache.graphs) == n
    invert(pipe, n + 1)  # the newest is kept
    assert len(graphed) == n + 1
    invert(pipe, 1)  # the oldest was dropped
    assert len(graphed) == n + 2 and len(cache.graphs) == n
    # parameters moved to other storage: every graph of the UNet is dropped
    param = next(pipe.unet.parameters())
    old = param.data
    param.data = old.clone()
    try:
        invert(pipe, 1)
        assert len(graphed) == n + 3 and len(cache.graphs) == 1
    finally:
        param.data = old


@pytest.mark.parametrize("case", ["cpu", "cp_mesh", "tp_mesh", "stand-in unet"])
def test_where_the_scan_keeps_its_eager_forward(pipes, graphed, monkeypatch, case):
    pipe = pipes["sd"]
    unet = pipe.unet
    lat, ctx = latents(2)[:, 0], torch.randn(2, 77, pipe.unet.config.cross_attention_dim)
    if case == "cpu":
        monkeypatch.setattr(graphs, "CAPTURE_DEVICE", "cuda")
    elif case in ("cp_mesh", "tp_mesh"):
        monkeypatch.setattr(unet, case, object())
    elif case == "stand-in unet":
        unet = lambda *a, **kw: pipe.unet(*a, **kw)  # noqa: E731
    assert not graphs.usable(unet, lat)
    t = inversion_timestep(pipe.scheduler, 1)
    with torch.no_grad():
        got = graphs.forward_for(unet, lat, ctx)(lat, t)
        if case not in ("cp_mesh", "tp_mesh"):  # a mesh's forward needs its process group
            assert torch.equal(got, pipe.unet(lat, t, ctx)[0])
            ddim._invert_scan(unet, pipe.scheduler, lat, ctx)
    assert graphed == []


class Sites:
    """``CudaGraph.site``'s stand-in: the site's attention, eagerly, as a
    replay calls it."""

    def __init__(self):
        self.seen = []

    def site(self, q, k, v):
        self.seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return unet_module.self_attention(q, k, v, None)


@pytest.mark.parametrize("model_type", ["sd", "xl"])
def test_the_split_meets_every_self_attention_site_and_changes_nothing_else(pipes, monkeypatch, model_type):
    """Under the control a capture runs the forward with, every
    self-attention site goes to the graph's ``site`` (which closes a piece
    there) and the forward's output is the plain forward's bit for bit."""
    pipe = pipes[model_type]
    g, h = 2, 16
    lat = latents(g)[:, 0]
    context, added = pipe.encode_prompts(PROMPTS[:g])
    ctx = context[g:]
    if model_type == "xl":  # as ddim_invert_batch conditions the UNet
        added = {k: v[:, 0] for k, v in batched._xl_added(pipe, added, g, h * 8, h * 8).items()}
    else:
        added = None
    t = torch.full((g,), inversion_timestep(pipe.scheduler, 2), dtype=torch.long)
    calls = []
    orig = unet_module.self_attention
    monkeypatch.setattr(unet_module, "self_attention", lambda q, k, v, *a, **kw: calls.append(q.shape) or orig(
        q, k, v, *a, **kw))
    sites = Sites()
    with torch.no_grad():
        want = pipe.unet(lat, t, ctx, None, added)[0]
        n = len(calls)
        got = pipe.unet(lat, t, ctx, graphs._Split(sites), added)[0]
    assert torch.equal(got, want)
    assert n == len(sites.seen) == pipe.unet.config.num_transformer_blocks > 0
    assert len(calls) == 2 * n and calls[n:] == calls[:n]
