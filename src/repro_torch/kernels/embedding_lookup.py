"""Embedding-row gather, ``out[i] = table[ids[i]]``: the CUDA kernels'
wrapper (``csrc/embedding_lookup.cu``, replacing the reference's
``embedding_lookup_pallas``), their launch plan and the plain PyTorch
version.

All copy bits, so all equal ``table[ids]`` exactly. The kernels take fp32
and bf16 tables of any width, with unit column stride and any row stride;
ids are int32 and must lie in ``[0, N)`` (not checked, not clamped).

The source holds two variants, and :func:`lookup_plan` fixes every number
of a launch by a rule on the shapes alone. ``"subwarp"``, on every path: a
row gets the fewest lanes (a power of two) that hold its chunks, a warp
serves the rest of its lanes' rows, every lane issues all its loads before
its stores, and small batches are cut into more tasks. ``"warp"``, by name
only, to be timed beside it: the first port's kernel, one warp a row.

The wrapper checks what it is given and raises on anything the kernels do
not take, allocates the output, launches on PyTorch's current stream and
counts its launches in ``embedding_lookup_cuda.launches`` and
``.launches_by_variant``. The raw wrapper has no backward, and raises rather
than lose a gradient (:func:`build.refuse_grad`); ``ops.embedding_lookup``
differentiates it through ``scatter_add``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ref import embedding_lookup_ref

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
VARIANTS = ("subwarp", "warp")  # in csrc/embedding_lookup.cu's numbering
UNROLL = 8  # items a lane holds in registers at most, as csrc/embedding_lookup.cu's UNROLL
# chunks a lane of one row: 8 was slower at every path width but Yi-9B's
# d-slice of 2048 (tools/lookup_timing.py plans)
CHUNKS_PER_LANE = 4
ROW_FILL = 4  # batches of rows shrink below this many tasks an SM; pieces of rows below one
WARPS_PER_BLOCK = 8  # the kernels' 256-thread blocks


class LookupPlan(NamedTuple):
    """One launch's numbers. ``unit`` bytes a chunk (16, or the element's),
    ``chunks`` C a row. ``"subwarp"``: ``lanes`` L a row, R = 32 / L rows a
    warp, tasks of ``row_batches`` rb batches of R rows by one of ``pieces``
    pieces of ``per_lane`` k chunks a lane (rb or k is 1, both powers of
    two, rb k <= ``UNROLL``), ``tasks`` of them over ``grid`` blocks of
    ``block`` threads, a task a warp. ``"warp"``: ``grid`` blocks of 8
    warps, a warp a row."""
    variant: str
    unit: int
    chunks: int
    lanes: int
    row_batches: int
    per_lane: int
    pieces: int
    tasks: int
    grid: int
    block: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def lookup_plan(B: int, D: int, elem_bytes: int, vec16: bool, n_sms: int, *,
                variant: str | None = None) -> LookupPlan:
    """The launch numbers for ``B`` rows of ``D`` elements of
    ``elem_bytes`` on ``n_sms`` SMs. ``vec16``: the row bytes, the row
    strides and both pointers are multiples of 16. By default
    ``"subwarp"``; ``variant`` names one."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"unknown embedding_lookup variant {variant!r}; one of {VARIANTS}")
    if B < 1 or D < 1:
        raise ValueError(f"no launch for B={B}, D={D}")
    unit = 16 if vec16 else elem_bytes
    C = D * elem_bytes // unit
    if variant == "warp":
        return LookupPlan("warp", unit, C, 32, 1, _cdiv(C, 32), 1, B,
                          _cdiv(B, WARPS_PER_BLOCK), 32 * WARPS_PER_BLOCK)
    L = min(32, 1 << (C - 1).bit_length())
    R = 32 // L
    whole = _cdiv(C, L)  # chunks a lane copies of a whole row
    rb, k = ((1, min(CHUNKS_PER_LANE, 1 << (whole - 1).bit_length())) if whole > 1
             else (UNROLL, 1))
    tasks = lambda rb, k: _cdiv(B, R * rb) * _cdiv(C, L * k)
    while rb > 1 and tasks(rb, k) < ROW_FILL * n_sms:  # few rows: fewer to a warp
        rb //= 2
    while k > 1 and tasks(rb, k) < n_sms:  # fewer rows than SMs: rows cut into pieces
        k //= 2
    T = tasks(rb, k)
    if T >= 2**31:
        raise ValueError(f"too many tasks for the kernel: B={B}, D={D}")
    return LookupPlan("subwarp", unit, C, L, rb, k, _cdiv(C, L * k), T,
                      _cdiv(T, WARPS_PER_BLOCK), 32 * WARPS_PER_BLOCK)


def embedding_lookup_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain version: ``table[ids.long()]``."""
    return embedding_lookup_ref(table, ids)


def cost(n_ids: int, dim: int, elem_bytes: int, distinct_rows: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: ``n_ids`` int32 ids read, each of the
    ``distinct_rows`` rows they name read once, ``n_ids`` rows of ``dim``
    elements written; no arithmetic."""
    return 0.0, float(n_ids * 4 + (distinct_rows + n_ids) * dim * elem_bytes)


def embedding_lookup_meta(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The kernel on the meta device: an empty [B, D] output, and its cost
    reported with the distinct rows bounded by the table's rows."""
    (N, D), B = table.shape, ids.shape[0]
    meta.report("embedding_lookup", cost(B, D, table.element_size(), min(B, N)), table.dtype)
    return torch.empty((B, D), dtype=table.dtype, device="meta")


def _lib():
    lib = build.library("embedding_lookup")
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.embedding_lookup_launch.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, i, i, i, i, i, i,
                                            p]
    lib.embedding_lookup_launch.restype = i
    lib.embedding_lookup_error_string.argtypes = [i]
    lib.embedding_lookup_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _checked(table: torch.Tensor, ids: torch.Tensor) -> None:
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
    if B >= 2**31 or D >= 2**31 or table.stride(0) >= 2**32:
        raise ValueError(f"shape too large for the kernel: B={B}, D={D}, row stride "
                         f"{table.stride(0)}")
    if B and D and N == 0:
        raise ValueError(f"ids index an empty table ({N} rows)")


def _vec16(table: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the row bytes, the row strides and both pointers are
    multiples of 16 (16-byte chunks)."""
    elem = _ELEM_BYTES[table.dtype]
    return all(x % 16 == 0 for x in (table.shape[1] * elem, table.stride(0) * elem,
                                     table.data_ptr(), out.data_ptr()))


def _run(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor, plan: LookupPlan,
         first_only: bool) -> None:
    """Launch ``plan`` on PyTorch's current stream, writing ``out``."""
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.embedding_lookup_launch(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), table.stride(0), table.shape[1],
            ids.shape[0], _ELEM_BYTES[table.dtype], int(_vec16(table, out)),
            VARIANTS.index(plan.variant), plan.lanes, plan.row_batches, plan.per_lane,
            plan.pieces, plan.tasks, plan.grid, plan.block, int(first_only),
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"embedding_lookup {plan.variant} kernel launch failed: "
                           f"{lib.embedding_lookup_error_string(err).decode()}")


def _launch(table: torch.Tensor, ids: torch.Tensor, variant: str | None,
            first_only: bool) -> tuple[torch.Tensor, LookupPlan | None]:
    """Allocate the output and launch the planned kernel on it; no launch
    (and no plan) for an empty output."""
    (_, D), B = table.shape, ids.shape[0]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out, None
    plan = lookup_plan(B, D, _ELEM_BYTES[table.dtype], _vec16(table, out),
                       _n_sms(table.device.index or 0), variant=variant)
    _run(table, ids, out, plan, first_only)
    return out, plan


def embedding_lookup_cuda(table: torch.Tensor, ids: torch.Tensor, *,
                          variant: str | None = None) -> torch.Tensor:
    """Launch the kernel :func:`lookup_plan` picks (or ``variant``):
    ``table`` [N, D] fp32/bf16 (unit column stride), ``ids`` [B] contiguous
    int32 -> [B, D] contiguous, the table's dtype."""
    _checked(table, ids)
    build.refuse_grad("embedding_lookup", table)
    out, plan = _launch(table, ids, variant, first_only=False)
    if plan is not None:
        embedding_lookup_cuda.launches += 1
        embedding_lookup_cuda.launches_by_variant[plan.variant] += 1
    return out


embedding_lookup_cuda.launches = 0
embedding_lookup_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def embedding_lookup_floor_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """A probe for timing, on no path and not counted: the subwarp kernel on
    its own plan's grid, copying each row's first chunk only (its id's trip
    to memory, then the row's), the rest of the output left unwritten. Its
    time is the floor two dependent trips set at small B."""
    _checked(table, ids)
    return _launch(table, ids, "subwarp", first_only=True)[0]
