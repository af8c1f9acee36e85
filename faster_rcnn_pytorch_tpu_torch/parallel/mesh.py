"""Process groups of the port's data and tensor parallelism.

Counterpart of ``faster_rcnn_pytorch_tpu/parallel/mesh.py``. The JAX
package runs one SPMD program over a ``(data, model)`` device mesh; the
port runs one process per card, as the reference does (``mp.spawn`` and
DDP over NCCL): ``main`` and ``test`` start ``--num_devices`` processes
on each of ``--num_hosts`` hosts, and each joins the process group here.

* Global rank ``host_id * local_world + local_rank``; world
  ``num_hosts * local_world``; the rendezvous is ``--coordinator``
  (``host:port`` means ``tcp://host:port``; a URL such as
  ``file:///path`` is used as it is).
* ``model_parallel`` consecutive ranks form a model group (the mesh's
  ``reshape(n // mp, mp)``): they hold one data shard and split fc6/fc7
  (``parallel/tensor_parallel.py``). The ranks with the same place in
  their model group form a data group, over which gradients of the split
  parameters and the loss's counts are reduced.
* The backend is NCCL for CUDA and gloo for the CPU. ``backend=`` names
  another explicitly; nothing falls back to gloo when NCCL fails.

Without a process group (one process, the default), :func:`layout` is a
world of 1 and every collective here is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Layout:
    """This process's place in the run: ranks, sizes and groups."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    model_parallel: int = 1
    data_group: object = None  # ProcessGroup, or None without one
    model_group: object = None  # None unless model_parallel > 1

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel

    @property
    def data_size(self) -> int:
        return self.world // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel

    @property
    def local_data_rank(self) -> int:
        return self.local_rank // self.model_parallel

    @property
    def local_data_size(self) -> int:
        return self.local_world // self.model_parallel

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


_LAYOUT = Layout()


def layout() -> Layout:
    """The layout :func:`init_distributed` set up (one process if none)."""
    return _LAYOUT


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_method_for(coordinator: str) -> str:
    """``--coordinator`` as an ``init_method``: ``host:port`` is TCP."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(
    local_rank: int,
    local_world: int,
    device: torch.device,
    num_hosts: int = 1,
    host_id: int = 0,
    init_method: str = "",
    model_parallel: int = 1,
    backend: str | None = None,
    timeout_s: float = 600.0,
) -> Layout:
    """Join the process group as global rank ``host_id * local_world +
    local_rank`` of ``num_hosts * local_world`` and build the groups
    (:func:`make_groups`). ``device`` is this rank's card (made current,
    so NCCL's object collectives use it) or the CPU."""
    global _LAYOUT
    mp = max(model_parallel, 1)
    if local_world % mp:
        raise ValueError(
            f"--model_parallel {mp} must divide the {local_world} processes of a host"
        )
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or default_backend(device),
        init_method=init_method_for(init_method),
        rank=host_id * local_world + local_rank,
        world_size=num_hosts * local_world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _LAYOUT = make_groups(mp, local_rank, local_world)
    return _LAYOUT


def make_groups(model_parallel: int, local_rank: int = 0, local_world: int = 1) -> Layout:
    """The data and model groups of the initialised process group. Every
    rank creates every group, in the same order, as ``new_group`` needs."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mp = model_parallel
    if world % mp:
        raise ValueError(f"--model_parallel {mp} must divide the world size {world}")
    if mp == 1:
        data_group, model_group = dist.group.WORLD, None
    else:
        model_group = data_group = None
        for start in range(0, world, mp):
            g = dist.new_group(list(range(start, start + mp)))
            if start <= rank < start + mp:
                model_group = g
        for j in range(mp):
            g = dist.new_group(list(range(j, world, mp)))
            if rank % mp == j:
                data_group = g
    return Layout(rank, world, local_rank, local_world, mp, data_group, model_group)


def shutdown() -> None:
    """Leave the process group (the end of a rank's run)."""
    global _LAYOUT
    if dist.is_initialized():
        dist.destroy_process_group()
    _LAYOUT = Layout()


def allgather_pyobj(obj, group=None) -> list:
    """One picklable object from every rank of ``group`` (default: the
    data group, whose ranks hold disjoint rows), in rank order; ``[obj]``
    without a process group. The reference's pickled ``all_gather``."""
    lay = layout()
    group = group or lay.data_group
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def device_count(num_devices: int, device_type: str) -> int:
    """``--num_devices`` on this host: 0 means every local card (one CPU
    process on the CPU)."""
    if num_devices:
        return num_devices
    return torch.cuda.device_count() if device_type == "cuda" else 1
