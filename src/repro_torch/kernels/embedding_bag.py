"""Fused embedding bag (gather + per-(example, slot) sum-pool), forward: the
CUDA kernel's wrapper (``csrc/embedding_bag.cu``, replacing the reference's
``embedding_bag_pallas``) and its plain PyTorch version.

The wrapper checks what it is given and raises on anything the kernel does
not take; it allocates the output, launches on PyTorch's current stream and
counts its launches in ``embedding_bag_cuda.launches``. The backward is
``ops.embedding_bag``'s autograd Function, through the ``scatter_add``
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MAX_TASK_BLOCKS = 65535  # grid.y of the kernel: ceil(n_slots * D / 256)


def embedding_bag_plain(table, slot_ids, slot_of, valid, n_slots: int):
    """The plain version: a flat gather of the kept nonzeros and an
    ``index_add_`` segment sum over (example, slot) buckets, in fp32 for any
    table dtype, cast once. Invalid nonzeros and slots outside
    ``[0, n_slots)`` are dropped before the gather."""
    B, nnz = slot_ids.shape
    D = table.shape[1]
    valid = valid if valid.dtype == torch.bool else valid != 0
    s = slot_of.long()
    keep = (valid & (s >= 0) & (s < n_slots)).reshape(-1).nonzero().squeeze(1)
    b_of = torch.arange(B, device=table.device).repeat_interleave(nnz)
    seg = b_of[keep] * n_slots + s.reshape(-1)[keep]
    rows = table[slot_ids.reshape(-1)[keep].long()].to(torch.float32)
    out = torch.zeros((B * n_slots, D), dtype=torch.float32, device=table.device)
    out.index_add_(0, seg, rows)
    return out.reshape(B, n_slots, D).to(table.dtype)


def _lib():
    lib = build.library("embedding_bag")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.embedding_bag_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.embedding_bag_launch.restype = i
    lib.embedding_bag_error_string.argtypes = [i]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


def embedding_bag_cuda(table: torch.Tensor, slot_ids: torch.Tensor,
                       slot_of: torch.Tensor, valid: torch.Tensor,
                       n_slots: int) -> torch.Tensor:
    """Launch the kernel: -> [B, n_slots, D] of the table's dtype."""
    n_slots = int(n_slots)
    if not table.is_cuda:
        raise ValueError(f"table must be a CUDA tensor, got {table.device}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table must be float32 or bfloat16, got {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous [N, D] tensor, got {tuple(table.shape)}")
    if slot_ids.dim() != 2:
        raise ValueError(f"slot_ids must be [B, nnz], got {tuple(slot_ids.shape)}")
    for name, t, dt in (("slot_ids", slot_ids, torch.int32),
                        ("slot_of", slot_of, torch.int32),
                        ("valid", valid, torch.bool)):
        if t.device != table.device:
            raise ValueError(f"{name} on {t.device}, table on {table.device}")
        if t.dtype != dt or t.shape != slot_ids.shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dt} tensor of shape "
                f"{tuple(slot_ids.shape)}, got {t.dtype} {tuple(t.shape)}"
            )
    if n_slots < 0:
        raise ValueError(f"n_slots must be >= 0, got {n_slots}")
    B, nnz = slot_ids.shape
    D = table.shape[1]
    if -(-n_slots * D // 256) > _MAX_TASK_BLOCKS or B >= 2**31:
        raise ValueError(f"shape too large for the kernel's grid: B={B}, n_slots*D={n_slots * D}")
    out = torch.empty((B, n_slots, D), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.embedding_bag_launch(
            table.data_ptr(), slot_ids.data_ptr(), slot_of.data_ptr(),
            valid.data_ptr(), out.data_ptr(), D, B, nnz, n_slots,
            int(table.dtype == torch.bfloat16),
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"embedding_bag kernel launch failed: "
            f"{lib.embedding_bag_error_string(err).decode()}"
        )
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
