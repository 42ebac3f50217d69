"""Process groups and the host mesh.

One process per device, as ``torchrun`` starts them: :func:`init_distributed`
joins (or, with no ``torchrun`` environment, creates a world of one) and
:func:`make_host_mesh` lays the world out as the reference's
``("data", "model")`` mesh, a ``torch.distributed`` ``DeviceMesh``.

NCCL takes one rank per card. Several ranks on one card (a tensor-parallel
check on a single card) ask for gloo explicitly: ``init_distributed("cuda",
backend="gloo")`` puts rank ``LOCAL_RANK`` on card ``LOCAL_RANK`` modulo the
card count, and gloo moves CUDA tensors through the host.

:class:`DryMesh` is the mesh of a world that is not there: the same
``mesh_dim_names``, ``shape`` and ``get_group``, its groups
``collectives.DryGroup``s, for a dry run of one rank's step
(``launch/dryrun.py``).

Usage, one card per process:
  torchrun --nproc-per-node N -m repro_torch.launch.train --arch yi-9b ...
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.collectives import DryGroup

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Dist:
    rank: int
    world_size: int
    local_rank: int
    device: torch.device


# the device type of this process, as init_distributed set it up
_DEVICE_TYPE: str | None = None


def init_distributed(device="cuda", init_method: str | None = None,
                     backend: str | None = None) -> Dist:
    """Join the process group of ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR``/``MASTER_PORT`` unless
    ``init_method`` says where to meet) -> this process's :class:`Dist`.
    With no ``RANK`` in the environment it creates a world of one.
    ``backend`` defaults to NCCL for a CUDA device (each process on card
    ``LOCAL_RANK``) and gloo for the CPU; an explicit ``"gloo"`` on a CUDA
    device lets ranks share a card (card ``LOCAL_RANK`` modulo the card
    count). A failed initialisation raises, nothing falls back to another
    backend, and a group that already exists must have the backend asked
    for."""
    global _DEVICE_TYPE
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    backend = backend or BACKENDS[kind]
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", 0))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs a CUDA card; pass "
                               "device='cpu' to run on the CPU")
        index = local_rank % torch.cuda.device_count() if backend == "gloo" else local_rank
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    nccl_dev = dev if backend == "nccl" else None
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group exists; device "
                               f"{device!r} asks for {backend}")
    elif "RANK" in env:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
                                device_id=nccl_dev)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                device_id=nccl_dev)
    _DEVICE_TYPE = kind
    return Dist(dist.get_rank(), dist.get_world_size(), local_rank, dev)


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """The world as a ``(world // model, model)`` mesh with axes ``("data",
    "model")``, on this process's device type (the one
    :func:`init_distributed` was given; for a group made elsewhere, CUDA
    under NCCL and the CPU otherwise)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world size {n} is not a multiple of the model axis {model}")
    kind = _DEVICE_TYPE or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(kind, (n // model, model), mesh_dim_names=("data", "model"))


@dataclass(frozen=True)
class DryMesh:
    """A ``("data", "model")`` mesh of ``data x model`` ranks laid out as
    ``make_host_mesh`` lays them out (rank = data index x model + model
    index), seen from global rank ``rank``: ``get_group(axis)`` is the
    ``DryGroup`` of that rank's row or column."""

    data: int
    model: int
    rank: int = 0

    mesh_dim_names = ("data", "model")

    def __post_init__(self):
        if not 0 <= self.rank < self.data * self.model:
            raise ValueError(f"rank {self.rank} outside a {self.data} x {self.model} mesh")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)

    @property
    def name(self) -> str:
        return f"{self.data}x{self.model}"

    def get_local_rank(self, axis: str) -> int:
        return self.rank // self.model if axis == "data" else self.rank % self.model

    def get_group(self, axis: str) -> DryGroup:
        size = self.data if axis == "data" else self.model
        return DryGroup(size, self.get_local_rank(axis), axis)
