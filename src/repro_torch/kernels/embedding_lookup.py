"""Embedding-row gather, ``out[i] = table[ids[i]]``: the CUDA kernel's
wrapper (``csrc/embedding_lookup.cu``, replacing the reference's
``embedding_lookup_pallas``) and its plain PyTorch version.

Both copy bits, so both equal ``table[ids]`` exactly. The kernel takes fp32
and bf16 tables of any width, with unit column stride and any row stride;
ids are int32 and must lie in ``[0, N)`` (not checked, not clamped).

The wrapper checks what it is given and raises on anything the kernel does
not take, allocates the output, launches on PyTorch's current stream and
counts its launches in ``embedding_lookup_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import embedding_lookup_ref

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def embedding_lookup_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain version: ``table[ids.long()]``."""
    return embedding_lookup_ref(table, ids)


def _lib():
    lib = build.library("embedding_lookup")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.embedding_lookup_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, p]
    lib.embedding_lookup_launch.restype = i
    lib.embedding_lookup_error_string.argtypes = [i]
    lib.embedding_lookup_error_string.restype = ctypes.c_char_p
    return lib


def embedding_lookup_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``table`` [N, D] fp32/bf16 (unit column stride),
    ``ids`` [B] contiguous int32 -> [B, D] contiguous, the table's dtype."""
    if not table.is_cuda:
        raise ValueError(f"table must be a CUDA tensor, got {table.device}")
    if table.dtype not in _ELEM_BYTES or table.dim() != 2:
        raise ValueError(f"table must be a [N, D] float32 or bfloat16 tensor, got "
                         f"{table.dtype} {tuple(table.shape)}")
    N, D = table.shape
    if D > 1 and table.stride(1) != 1:
        raise ValueError(f"table must have unit column stride, got strides {table.stride()}")
    if ids.dim() != 1 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"ids must be a contiguous 1-D int32 tensor, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    B = ids.shape[0]
    if B >= 2**31 or D >= 2**31:
        raise ValueError(f"shape too large for the kernel: B={B}, D={D}")
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0 or N == 0:
        if B and D:
            raise ValueError(f"ids index an empty table ({N} rows)")
        return out
    elem = _ELEM_BYTES[table.dtype]
    row_stride = table.stride(0)
    vec16 = int(all(x % 16 == 0 for x in (D * elem, row_stride * elem,
                                           table.data_ptr(), out.data_ptr())))
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.embedding_lookup_launch(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), row_stride, D, B, elem, vec16,
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"embedding_lookup kernel launch failed: "
                           f"{lib.embedding_lookup_error_string(err).decode()}")
    embedding_lookup_cuda.launches += 1
    return out


embedding_lookup_cuda.launches = 0
