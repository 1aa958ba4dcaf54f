"""The DDIM inversion's UNet forward replayed as CUDA graphs.

An inversion step runs the UNet at batch G without CFG, so on the card the
host's launching of the forward's few thousand kernels, not the device,
sets the step's time. ``forward_for`` hands ``inversion/ddim.py
_invert_scan`` a step function ``(lat, t) -> eps``: where the inputs allow
it, one that replays the forward, captured once per input shape; else the
eager forward. The graph is used only where the latent is on a CUDA device
and the UNet is the port's ``UNet2DCondition`` with no context- or
tensor-parallel mesh (their gloo collectives cannot be captured). The scan
runs without grad and without an attention control.

The forward is captured in pieces, split at its self-attention sites: a
replay runs the pieces' graphs and, between them, each site's attention as
the eager forward calls it, ``models.unet.self_attention`` looked up on its
module with the plan None. So the flash forward runs, and is counted, as in
the eager forward, and whatever watches that function sees every call.
Between two pieces the graph's intermediates stay in the graph's memory
pool: a site's q, k, v and output are kept as tensors that do not own their
memory (``_alias``), so the pool reuses it as in one graph, and the replay
order, the one stream, keeps each read before the next write. The
attention's output is copied into the place the next piece reads (one copy
kernel a site).

The graph reads static device buffers: the latent, the timestep as a (B,)
int64 tensor (an int would be baked into the graph by the UNet's
``torch.full``), the context and SDXL's added conditions. A scan copies its
context and added conditions in once; each step copies its latent in, fills
the timestep and replays. The DDIM update stays outside the graph, an eager
call of the scan's. The first step of a new shape runs the forward eagerly
on the capture stream (the warm-up, whose result that step uses), then
captures it with ``capture_error_mode="thread_local"``, so that threads
that do not touch the card cannot break a capture.

Graphs are kept per UNet (they die with it), at most ``MAX_GRAPHS`` shapes
(the least recently used is dropped), all in one memory pool, and dropped
when the UNet's parameters move to other storage (a cast, ``.to``): a
graph holds their addresses. A replay adds to the kernels' launch counters
(``ops/flash_attention.py launch_counts``) what its pieces launch, and
counts ``graph_replays`` in the program's tracer (a capture:
``graph_captures``).
"""

from __future__ import annotations

import itertools
import types
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch

from image_editing_framework_torch.models import unet as unet_module
from image_editing_framework_torch.models.unet import UNet2DCondition
from image_editing_framework_torch.ops.controls import NoneStep
from image_editing_framework_torch.ops.flash_attention import add_launches, launch_counts
from image_editing_framework_torch.utils.profiling import count

MAX_GRAPHS = 4  # shapes kept per UNet: the service's group sizes vary, a sweep uses one
CAPTURE_DEVICE = "cuda"  # the device type whose latents take the graph


def _alias(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as a tensor that does not own their memory, through
    the CUDA array interface (integers of the element's size, viewed back
    as ``t``'s dtype)."""
    size = t.element_size()
    memory = types.SimpleNamespace(__cuda_array_interface__={
        "shape": tuple(t.shape), "strides": tuple(s * size for s in t.stride()), "typestr": f"<i{size}",
        "data": (t.data_ptr(), False), "version": 2})
    return torch.as_tensor(memory, device=t.device).view(t.dtype)


class _Split(NoneStep):
    """The control a capture runs the forward under: no edit, and at each
    self-attention site the graph's ``site`` in place of the attention."""

    def __init__(self, graph: "CudaGraph"):
        self.graph = graph

    def self_override(self, site, q, k, v, running=None, cp_mesh=None, cp_mode="ring"):
        return self.graph.site(q, k, v)


class CudaGraph:
    """One forward's pieces: warm-up and capture on the cache's side stream,
    into its memory pool, and replay on the current stream (the CPU tests
    substitute an eager stand-in)."""

    def __init__(self, shared: dict, device: torch.device):
        self.device = device
        if "pool" not in shared:
            shared["pool"] = torch.cuda.graph_pool_handle()
            shared["stream"] = torch.cuda.Stream(device)
        self.pool, self.stream = shared["pool"], shared["stream"]
        self.pieces: List[torch.cuda.CUDAGraph] = []
        self.sites: List[tuple] = []  # (q, k, v, out) of each site, aliases into the pool
        self._open = False

    def warm_up(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn()
        main.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable[..., torch.Tensor]) -> torch.Tensor:
        """Capture ``fn(ctrl)``, the forward under the splitting control."""
        with torch.cuda.device(self.device):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            with torch.cuda.stream(self.stream):
                self._begin()
                try:
                    return fn(_Split(self))
                finally:
                    self._end()

    def _begin(self) -> None:
        piece = torch.cuda.CUDAGraph()
        piece.capture_begin(self.pool, capture_error_mode="thread_local")
        self.pieces.append(piece)
        self._open = True

    def _end(self) -> None:
        if self._open:
            self._open = False
            self.pieces[-1].capture_end()

    def site(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Close the piece at a self-attention site and open the next; the
        site's output, as the flash forward lays it out, in the pool."""
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        self._end()
        self.sites.append((_alias(q), _alias(k), _alias(v), _alias(out)))
        self._begin()
        return out

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            for piece, (q, k, v, out) in zip(self.pieces, self.sites):
                piece.replay()
                out.copy_(unet_module.self_attention(q, k, v, None))
            self.pieces[-1].replay()


class StepGraph:
    """The static inputs, the captured forward and its output of one shape."""

    def __init__(self, graph, latent: torch.Tensor, context: torch.Tensor,
                 added_cond: Optional[Dict[str, torch.Tensor]]):
        self.graph = graph
        self.latent = torch.empty(latent.shape, dtype=latent.dtype, device=latent.device)
        self.t = torch.zeros(latent.shape[0], dtype=torch.long, device=latent.device)
        self.context = torch.empty(context.shape, dtype=context.dtype, device=latent.device)
        self.added = None if added_cond is None else {
            k: torch.empty(v.shape, dtype=v.dtype, device=latent.device) for k, v in added_cond.items()}
        self.eps: Optional[torch.Tensor] = None  # the graph's output, once captured
        self.launches = (0, 0, 0)  # counted kernels inside the pieces, launched by each replay

    def load(self, context: torch.Tensor, added_cond: Optional[Dict[str, torch.Tensor]]) -> None:
        self.context.copy_(context)
        if self.added is not None:
            for k, v in self.added.items():
                v.copy_(added_cond[k])

    def __call__(self, unet, lat: torch.Tensor, t: int) -> torch.Tensor:
        self.latent.copy_(lat)
        self.t.fill_(t)
        if self.eps is None:
            return self._capture(unet)
        self.graph.replay()
        add_launches(self.launches)
        count("graph_replays")
        return self.eps

    def _capture(self, unet) -> torch.Tensor:
        def forward(ctrl=None):
            return unet(self.latent, self.t, self.context, ctrl, self.added)[0]

        eps = self.graph.warm_up(forward)  # this step's forward
        before = launch_counts()
        self.eps = self.graph.capture(forward)
        self.launches = tuple(n - m for n, m in zip(launch_counts(), before))
        add_launches(tuple(-n for n in self.launches))  # the capture ran no kernel
        count("graph_captures")
        return eps


class _Cache:
    """One UNet's graphs by shape, least recently used first."""

    def __init__(self):
        self.graphs: "OrderedDict[tuple, StepGraph]" = OrderedDict()
        self.shared: dict = {}  # the memory pool and side stream its graphs share
        self.params: tuple = ()  # the parameters' addresses the graphs read


_CACHES: "weakref.WeakKeyDictionary[UNet2DCondition, _Cache]" = weakref.WeakKeyDictionary()


def usable(unet, latent: torch.Tensor) -> bool:
    """Whether the forward may be replayed as a graph (module doc)."""
    return (latent.device.type == CAPTURE_DEVICE and isinstance(unet, UNet2DCondition)
            and unet.cp_mesh is None and unet.tp_mesh is None)


def _shape(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype


def forward_for(unet, latent: torch.Tensor, context: torch.Tensor,
                added_cond: Optional[Dict[str, torch.Tensor]] = None) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """The step function ``(lat, t) -> eps`` of a scan over latents shaped
    as ``latent`` on ``context`` and ``added_cond``: the graph's replay
    (the conditions copied in now) where ``usable``, else the eager
    forward."""
    if not usable(unet, latent):
        return lambda lat, t: unet(lat, t, context, None, added_cond)[0]
    cache = _CACHES.get(unet)
    if cache is None:
        cache = _CACHES[unet] = _Cache()
    params = tuple(p.data_ptr() for p in itertools.chain(unet.parameters(), unet.buffers()))
    if params != cache.params:
        cache.graphs.clear()
        cache.params = params
    key = (_shape(latent), latent.device, _shape(context),
           None if added_cond is None else tuple((k, _shape(v)) for k, v in sorted(added_cond.items())))
    entry = cache.graphs.get(key)
    if entry is None:
        entry = cache.graphs[key] = StepGraph(CudaGraph(cache.shared, latent.device), latent, context, added_cond)
        while len(cache.graphs) > MAX_GRAPHS:
            cache.graphs.popitem(last=False)
    cache.graphs.move_to_end(key)
    entry.load(context, added_cond)
    return lambda lat, t: entry(unet, lat, t)
