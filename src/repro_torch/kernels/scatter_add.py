"""Sorted-id scatter-accumulate, ``table[ids[i]] += grads[i]``: the CUDA
kernel's wrapper (``csrc/scatter_add.cu``, replacing the reference's
``scatter_add_pallas``) and its plain PyTorch version.

Both update ``table`` in place and return it; ``ops.scatter_add`` is the
functional entry point. Ids must be sorted (duplicates adjacent): each run
of equal ids adds onto its row's starting value in position order, the
order of the reference's ``scatter_add_ref`` on sorted ids. Ids outside
``[0, N)`` are dropped, as the reference's scatter drops them.

The wrapper checks what it is given and raises on anything the kernel does
not take (fp32 tables and grads only), launches on PyTorch's current stream
and counts its launches in ``scatter_add_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ref import scatter_add_ref


def scatter_add_plain_(table: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """The plain version: the oracle's sums written back into ``table``."""
    return table.copy_(scatter_add_ref(table, ids, grads))


def cost(n_ids: int, dim: int, distinct_rows: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch, fp32: ``n_ids`` int32 ids and their
    gradient rows read, each of the ``distinct_rows`` rows they name read
    and written once; one add per gradient element."""
    return float(n_ids * dim), float(n_ids * 4 + n_ids * dim * 4 + 2 * distinct_rows * dim * 4)


def scatter_add_meta_(table: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """The kernel on the meta device: ``table`` itself, and the cost
    reported with the distinct rows bounded by the table's rows."""
    (N, D), B = table.shape, ids.shape[0]
    meta.report("scatter_add", cost(B, D, min(B, N)), table.dtype)
    return table


def _lib():
    lib = build.library("scatter_add")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scatter_add_launch.argtypes = [p, p, p, i, i, i, p]
    lib.scatter_add_launch.restype = i
    lib.scatter_add_error_string.argtypes = [i]
    lib.scatter_add_error_string.restype = ctypes.c_char_p
    return lib


def scatter_add_cuda_(table: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on sorted int32 ``ids``: ``table`` [N, D] fp32 is
    updated in place and returned."""
    if not table.is_cuda:
        raise ValueError(f"table must be a CUDA tensor, got {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(
            f"table must be a contiguous [N, D] float32 tensor, got {table.dtype} "
            f"{tuple(table.shape)} contiguous={table.is_contiguous()}"
        )
    N, D = table.shape
    if ids.dim() != 1 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"ids must be a contiguous 1-D int32 tensor, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    B = ids.shape[0]
    if grads.dtype != torch.float32 or tuple(grads.shape) != (B, D) or not grads.is_contiguous():
        raise ValueError(f"grads must be a contiguous float32 [{B}, {D}] tensor, got "
                         f"{grads.dtype} {tuple(grads.shape)}")
    for name, t in (("ids", ids), ("grads", grads)):
        if t.device != table.device:
            raise ValueError(f"{name} on {t.device}, table on {table.device}")
    if N >= 2**31 or B >= 2**31 or B * D >= 2**31 * 256:
        raise ValueError(f"shape too large for the kernel: N={N}, B={B}, D={D}")
    if B == 0 or D == 0:
        return table
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.scatter_add_launch(
            table.data_ptr(), ids.data_ptr(), grads.data_ptr(), N, D, B,
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"scatter_add kernel launch failed: {lib.scatter_add_error_string(err).decode()}"
        )
    scatter_add_cuda_.launches += 1
    return table


scatter_add_cuda_.launches = 0
