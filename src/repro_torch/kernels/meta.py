"""The kernels on the ``meta`` device: what a dry run sees of a kernel call.

A dry run (``launch/dryrun.py``) traces one rank's step on the ``meta``
device. There a kernel's wrapper neither launches its kernel nor runs its
plain version: its ``*_meta`` function returns an empty meta output of the
kernel's shape and dtype and reports the kernel's cost — the module's
``cost`` function, the FLOPs it does and the bytes it must move, each input
read once and each output written once — to the sink installed here. The
launch counters (``*_cuda.launches``) count only real launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class KernelCall:
    """One kernel call seen on the meta device: the kernel, its FLOPs and
    bytes (its module's ``cost``) and the dtype its FLOPs are done in."""

    name: str
    flops: float
    nbytes: float
    dtype: torch.dtype


_SINK: Optional[Callable[[KernelCall], None]] = None


def set_sink(fn: Optional[Callable[[KernelCall], None]]) -> None:
    """Install fn(KernelCall), called for each kernel call on meta tensors
    (``None`` removes it)."""
    global _SINK
    _SINK = fn


def report(name: str, cost: tuple[float, float], dtype: torch.dtype) -> None:
    if _SINK is not None:
        _SINK(KernelCall(name, float(cost[0]), float(cost[1]), dtype))
