"""Process group and device mesh construction.

Counterpart of ``image_editing_framework_tpu/parallel/mesh.py``. The mesh has
the JAX package's axes: "data" (data parallelism: the PIE-Bench sweep's
shards, the train step's batch, context parallelism's sequence split) and
"tensor" (tensor parallelism's weight splits, the head axis of 2D context
parallelism). ``torch.distributed`` has no global device list:
one process drives one card (or, with ``device_type="cpu"``, one CPU rank),
and the mesh spans the processes of the default group. The backend is the
caller's choice: NCCL between cards, gloo on CPUs or several ranks on one
card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    timeout: Optional[datetime.timedelta] = None,
) -> int:
    """Join the process group; returns this process's rank.

    One process (``num_processes`` None or 1) is a no-op returning 0, or the
    rank of a group that is already up. Otherwise ``init_process_group``
    with ``coordinator_address`` as its rendezvous: ``host:port`` (TCP, the
    JAX package's form) or a URL such as ``tcp://host:port`` or
    ``file:///shared/path``."""
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator_address and process_id")
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id, **kwargs)
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(data: Optional[int] = None, tensor: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """Mesh over ('data', 'tensor') of every process of the default group.
    Defaults to all processes on data. ``device_type`` is "cuda" unless the
    caller asks for "cpu"."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // tensor
    if data * tensor != world:
        raise ValueError((data, tensor, world))
    return init_device_mesh(device_type, (data, tensor), mesh_dim_names=("data", "tensor"))


def data_sharding(mesh: DeviceMesh) -> Tuple:
    """DTensor placements that shard the leading batch axis over 'data' and
    replicate over the other mesh axes."""
    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(),) * mesh.ndim


def axis(mesh: DeviceMesh, name: str):
    """(process group, this rank's index in it, its size) of the mesh axis
    ``name``: "tensor" for tensor parallelism's splits and collectives,
    "data" for context parallelism's and the batch's."""
    group = mesh.get_group(name)
    return group, dist.get_rank(group), dist.get_world_size(group)
