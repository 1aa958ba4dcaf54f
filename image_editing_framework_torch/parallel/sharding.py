"""Tensor parallelism: per-rank Megatron splits of the UNet's and CLIP's
projections, their collectives, and the sharded train step.

Counterpart of ``image_editing_framework_tpu/parallel/sharding.py``. The JAX
package states the split as shardings and lets GSPMD insert the
collectives; ``torch.distributed`` has no such compiler, so here every rank
holds *its slice* of each split weight as a plain tensor (the hand-written
kernels take their operands as they are) and the layers call the
collectives themselves:

* **Column-parallel** (``_COL_PARALLEL``: ``to_q`` / ``to_k`` / ``to_v``,
  the GEGLU up-projection ``ff.net.0.proj``, CLIP's ``q_proj`` /
  ``k_proj`` / ``v_proj`` / ``fc1``): rank r keeps rows r of n of
  ``nn.Linear.weight`` (out, in) and of the bias, so it computes its heads or
  its hidden columns locally. The layer's input goes through
  ``copy_to_tensor_parallel`` (identity forward, gradient all-reduced
  backward: each rank's input gradient is its heads' share). GEGLU's
  hidden and gate halves are split each on its own, so that rank r holds
  hidden and gate columns of the same indices.
* **Row-parallel** (``_ROW_PARALLEL``: ``to_out.0``, ``ff.net.2``, CLIP's
  ``out_proj`` / ``fc2``): rank r keeps columns r of n of the weight; the
  partial products are summed (``row_parallel_linear``: all-reduce forward,
  identity backward), and the whole bias is added once, after the sum.
* Norms, convolutions, embeddings and every other weight stay replicated, as
  in the JAX package.

A layer's heads are its local heads (H/n); a head count that n does not
divide raises ``ValueError`` (GSPMD splits unevenly, this port does not). A
cross-attention site whose map a control records gathers the probabilities
of every head first (``gather_heads``), so the controls see all H heads as
under JAX. Collectives on a gloo group copy CUDA tensors through host
memory (``ring_attention._send_form``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from image_editing_framework_torch.parallel.mesh import axis
from image_editing_framework_torch.parallel.ring_attention import _FromShards, _all_gather, _send_form

# diffusers / transformers layer names (the last dotted components)
_COL_PARALLEL = ("to_q", "to_k", "to_v", "ff.net.0.proj", "q_proj", "k_proj", "v_proj", "fc1")
_ROW_PARALLEL = ("to_out.0", "ff.net.2", "out_proj", "fc2")
# column-parallel layers whose output is two halves split each on its own
_HALVES = ("ff.net.0.proj",)


# ---------------------------------------------------------------------------
# collectives


def tensor_parallel_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's x, in a new tensor on x's device."""
    s = _send_form(x, group)
    if s is x:
        s = s.clone()
    dist.all_reduce(s, group=group)
    return s.to(x.device)


class _CopyToTensorParallel(torch.autograd.Function):
    """The input of a column-parallel layer: identity forward; backward, the
    all-reduce of the ranks' input gradients (each holds its heads' share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTensorParallel(torch.autograd.Function):
    """The output of a row-parallel layer: all-reduce forward; backward,
    identity (the replicated cotangent is every partial sum's)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor_parallel(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTensorParallel.apply(x, group)


def row_parallel_linear(layer: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``layer(x)`` for a row-parallel layer: this rank's partial product,
    summed over the group, then the whole bias once."""
    if group is None:
        return layer(x)
    out = _ReduceFromTensorParallel.apply(F.linear(x, layer.weight), group)
    return out if layer.bias is None else out + layer.bias


def gather_heads(probs: torch.Tensor, group) -> torch.Tensor:
    """(B, H/n, N, K) of this rank's heads -> (B, H, N, K) of every head in
    rank order. Backward: this rank's heads' share of the replicated
    cotangent."""
    if group is None:
        return probs
    return _FromShards.apply(probs, [group], dist.get_rank(group), 1)


# ---------------------------------------------------------------------------
# the split


def _layer_of(param_name: str) -> Tuple[str, str]:
    layer, _, leaf = param_name.rpartition(".")
    return layer, leaf


def _matches(layer: str, names) -> Optional[str]:
    for name in names:
        if layer == name or layer.endswith("." + name):
            return name
    return None


def unet_param_specs(module: nn.Module) -> Dict[str, object]:
    """{parameter name: ``Shard(0)`` | ``Shard(1)`` | ``Replicate()``} for a
    UNet, a CLIP text model or a CLIP vision tower. ``nn.Linear.weight`` is
    (out, in): a column split is ``Shard(0)`` (JAX's ``P(None, "tensor")``
    on its (in, out) kernel), a row split ``Shard(1)`` (``P("tensor",
    None)``). A column-parallel layer's bias is split with its rows; a
    row-parallel layer's stays whole (JAX replicates every bias)."""
    specs = {}
    for name, _ in module.named_parameters():
        layer, leaf = _layer_of(name)
        if _matches(layer, _COL_PARALLEL):
            specs[name] = Shard(0)
        elif _matches(layer, _ROW_PARALLEL):
            specs[name] = Shard(1) if leaf == "weight" else Replicate()
        else:
            specs[name] = Replicate()
    return specs


def _halves(name: str) -> int:
    return 2 if _matches(_layer_of(name)[0], _HALVES) else 1


def _split(x: torch.Tensor, dim: int, index: int, count: int, halves: int) -> torch.Tensor:
    """Rank ``index``'s slice along ``dim``: of each of ``halves`` parts, its
    ``count``-th."""
    parts = [part.chunk(count, dim)[index] for part in x.chunk(halves, dim)]
    return torch.cat(parts, dim).contiguous()


def _check(module: nn.Module, specs: Dict[str, object], count: int) -> None:
    """Every split layer's heads and split dimension divide by ``count``;
    raises ``ValueError`` naming the first that does not."""
    for name, m in module.named_modules():
        heads = getattr(m, "heads", None)
        if hasattr(m, "tp_group") and heads is not None and heads % count:
            raise ValueError(f"{name or type(m).__name__}: {heads} heads do not split over tensor = {count}")
    params = dict(module.named_parameters())
    for name, spec in specs.items():
        if isinstance(spec, Shard) and params[name].shape[spec.dim] % (count * _halves(name)):
            raise ValueError(f"{name}: dimension {spec.dim} of {tuple(params[name].shape)} does not split over "
                             f"tensor = {count}")
    refuse_ulysses_ring(getattr(module, "cp_mesh", None), getattr(module, "cp_mode", None))


def refuse_ulysses_ring(cp_mesh, cp_mode) -> None:
    """Context parallelism's 'ulysses_ring' takes the "tensor" axis for
    heads: with tensor parallelism it raises ``ValueError``."""
    if cp_mesh is not None and cp_mode == "ulysses_ring":
        raise ValueError("cp_mode 'ulysses_ring' takes the 'tensor' axis for heads; it cannot run with tensor > 1")


def shard_params(module: nn.Module, mesh) -> nn.Module:
    """Split ``module`` (a UNet, a CLIP text model or vision tower) in place
    over ``mesh``'s "tensor" axis: keep this rank's rows or columns of every
    split parameter (``unet_param_specs``), and record the tensor group on
    the layers that run the collectives (``tp_group``) and the mesh on the
    module (``tp_mesh``). Returns the module. With tensor = 1 it changes
    nothing. A module already split over ``mesh`` comes back as it is (as
    JAX's ``device_put`` of a sharded array); one split over another mesh,
    or holding a part already split, raises ``ValueError``: a second split
    would cut the split weights again."""
    group, index, count = axis(mesh, "tensor")
    if count == 1:
        return module
    split = getattr(module, "tp_mesh", None)
    if split is mesh:
        return module
    if split is not None or any(getattr(m, "tp_group", None) is not None for m in module.modules()):
        raise ValueError(f"{type(module).__name__} is already split over tensor parallelism; shard_params splits "
                         "an unsplit module once")
    specs = unet_param_specs(module)
    _check(module, specs, count)
    for name, p in list(module.named_parameters()):
        spec = specs[name]
        if not isinstance(spec, Shard):
            continue
        layer_name, leaf = _layer_of(name)
        layer = module.get_submodule(layer_name)
        local = _split(p.detach(), spec.dim, index, count, _halves(name))
        setattr(layer, leaf, nn.Parameter(local, requires_grad=p.requires_grad))
        if leaf == "weight":
            layer.out_features, layer.in_features = local.shape
    for m in module.modules():
        if hasattr(m, "tp_group"):
            m.tp_group = group
    module.tp_mesh = mesh
    return module


def gather_params(module: nn.Module, mesh, grads: bool = False) -> Dict[str, torch.Tensor]:
    """The full-shape parameters (or, with ``grads``, their gradients) of a
    module that ``shard_params`` split, every split one all-gathered over
    "tensor" and joined as it was split. A collective: every rank of the
    axis calls it."""
    group, _, count = axis(mesh, "tensor")
    specs = unet_param_specs(module)
    out = {}
    for name, p in module.named_parameters():
        x = (p.grad if grads else p).detach()
        spec = specs[name]
        if isinstance(spec, Shard) and count > 1:
            halves = _halves(name)
            pieces = [piece.chunk(halves, spec.dim) for piece in _all_gather(x, group).unbind(0)]
            x = torch.cat([pieces[r][h] for h in range(halves) for r in range(count)], spec.dim)
        out[name] = x
    return out


# ---------------------------------------------------------------------------
# the train step


def make_sharded_train_step(unet: nn.Module, mesh, learning_rate: float = 1e-4):
    """A data x tensor parallel training step over the UNet: the
    noise-prediction MSE and Adam (``torch.optim.Adam``, whose defaults are
    optax's), the batch split over "data", the weights over "tensor" (JAX
    ``make_sharded_train_step``). Returns ``(init, step)``:

    * ``init(unet)`` splits the module (``shard_params``) and builds the
      optimizer over this rank's parameters; returns (module, optimizer);
    * ``step(latents, t, context, target)`` takes the global batch
      (replicated on every rank), runs this rank's "data" chunk of it,
      all-reduces the weights' gradients as means over "data", updates the
      weights and returns the loss, the mean over the global batch.

    The replicated weights' gradients come out equal on the tensor ranks:
    every input gradient of a split layer is all-reduced."""
    data_group, data_index, data_count = axis(mesh, "data")
    state = {"module": unet}

    def init(module: nn.Module):
        state["module"] = shard_params(module, mesh)
        state["opt"] = torch.optim.Adam(module.parameters(), lr=learning_rate)
        return module, state["opt"]

    def chunk(x, batch):
        if not isinstance(x, torch.Tensor) or x.ndim == 0 or x.shape[0] != batch:
            return x
        size = batch // data_count
        return x.narrow(0, data_index * size, size)

    def step(latents: torch.Tensor, t, context: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        module, opt = state["module"], state["opt"]
        batch = latents.shape[0]
        if batch % data_count:
            raise ValueError(f"batch {batch} does not split over data = {data_count}")
        lat, tt, ctx, tgt = (chunk(x, batch) for x in (latents, t, context, target))
        opt.zero_grad(set_to_none=True)
        eps, _ = module(lat, tt, ctx)
        loss = torch.mean((eps - tgt) ** 2)
        loss.backward()
        if data_count > 1:
            params = [p for p in module.parameters() if p.grad is not None]
            flat = _all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), data_group) / data_count
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p.grad))
            loss = _all_reduce(loss.detach(), data_group) / data_count
        opt.step()
        return loss.detach()

    return init, step
