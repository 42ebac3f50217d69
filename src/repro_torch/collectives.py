"""The one door of the port's collectives, real or dry.

Every collective a step makes (the tensor-parallel operators and FSDP's
weight gather of ``models/common.py``, the vocab-parallel cross entropy and
the clip norm of ``train/``, the data-parallel gradient mean and
``gather_tree`` of ``launch/sharding.py``) calls this module. On a ``torch.distributed``
process group (or ``None``, the world) each function makes exactly the
``torch.distributed`` call it names. On a :class:`DryGroup`, the stand-in
a dry run (``launch/dryrun.py``) gives the step instead of a process group,
nothing is sent: the call is handed to the installed recorder (kind,
operand bytes, group, call site) and the tensors keep their shapes, so a
step traced on the ``meta`` device sees the shapes it would see on the
card.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

ReduceOp = dist.ReduceOp


@dataclass(frozen=True)
class DryGroup:
    """A process group that is not there: ``size`` ranks along mesh axis
    ``axis``, this process standing for rank ``rank`` of them."""

    size: int
    rank: int
    axis: str


@dataclass(frozen=True)
class Collective:
    """One recorded call: its kind, the bytes of its operand on this rank
    (all_reduce and reduce_scatter: the whole tensor; all_gather and gather:
    this rank's part), the group and the file:line that made it."""

    kind: str
    nbytes: int
    group: DryGroup
    site: str


_RECORDER: Optional[Callable[[Collective], None]] = None


def set_recorder(fn: Optional[Callable[[Collective], None]]) -> None:
    """Install fn(Collective), called for each collective on a
    :class:`DryGroup` (``None`` removes it)."""
    global _RECORDER
    _RECORDER = fn


def is_dry(group) -> bool:
    return isinstance(group, DryGroup)


_PKG = os.path.dirname(os.path.abspath(__file__))


def _site() -> str:
    """The first frame outside this module: the call site, as a path in
    the package where it is one."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return "?"
    path = f.f_code.co_filename
    if path.startswith(_PKG + os.sep):
        path = path[len(_PKG) + 1:]
    return f"{path}:{f.f_lineno}"


def _record(kind: str, t: torch.Tensor, group: DryGroup) -> None:
    if _RECORDER is not None:
        _RECORDER(Collective(kind, t.numel() * t.element_size(), group, _site()))


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (``None``: the world)."""
    return group.rank if is_dry(group) else dist.get_rank(group)


def get_world_size(group=None) -> int:
    return group.size if is_dry(group) else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, op=ReduceOp.SUM, group=None) -> None:
    """``dist.all_reduce(t, op, group)``, in place."""
    if is_dry(group):
        _record("all_reduce", t, group)
        return
    dist.all_reduce(t, op=op, group=group)


def all_gather(parts: list, t: torch.Tensor, group=None) -> None:
    """``dist.all_gather(parts, t, group)``: ``parts`` (one tensor of
    ``t``'s shape a rank) receives every rank's ``t``."""
    if is_dry(group):
        _record("all_gather", t, group)
        return
    dist.all_gather(parts, t, group=group)


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group=None) -> None:
    """``dist.all_gather_into_tensor(out, t, group)``: ``out`` (the group's
    size times ``t`` along dim 0) receives every rank's ``t`` in rank order.
    Recorded as an ``all_gather``."""
    if is_dry(group):
        _record("all_gather", t, group)
        return
    dist.all_gather_into_tensor(out, t, group=group)


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, op=ReduceOp.SUM, group=None) -> None:
    """``dist.reduce_scatter_tensor(out, t, op, group)``: ``out`` (``t``'s
    dim 0 over the group's size) receives this rank's contiguous part of
    the reduction of every rank's ``t``."""
    if is_dry(group):
        _record("reduce_scatter", t, group)
        return
    dist.reduce_scatter_tensor(out, t, op=op, group=group)


def gather(t: torch.Tensor, parts: Optional[list], dst: int, group=None) -> None:
    """``dist.gather(t, parts, dst, group)``: ``parts`` on global rank
    ``dst`` receives every rank's ``t``."""
    if is_dry(group):
        _record("gather", t, group)
        return
    dist.gather(t, parts, dst=dst, group=group)
