"""Grouped matmul for MoE expert compute, ``out[t] = x[t] @ w[group_of(t)]``:
the CUDA kernels' wrapper (``csrc/moe_gmm.cu``, replacing the reference's
``gmm_pallas`` with its wrapper ``ops.gmm``) and its plain PyTorch version.

Rows of ``x`` [T, K] come in contiguous groups, ``group_sizes[e]`` rows for
expert ``e`` in order; ``w`` is [E, K, N]. Both versions sum in fp32 and
round once to x's dtype. Where ``group_sizes`` does not sum to T, the
groups are cut at row T and the rows past the last group are 0 (negative
sizes count as 0); the reference leaves that case undefined.

The wrapper plans the row tiles on the device with torch ops and no host
sync (:func:`gmm_tiles`): ``ceil(T / bt) + E`` tiles bound any grouping,
each inside one group. A caller that runs several products over one
grouping (a MoE layer's two or three) builds the plan once and passes it as
``tiles=``. The source holds three kernels, and :func:`gmm_variant` picks
one by an explicit rule: ``"hopper"`` (wgmma + TMA) for bf16 layouts a TMA
descriptor can describe, ``"wmma"`` (mma.sync) for other bf16 layouts,
``"f32"`` (CUDA-core FMAs) for fp32. None gives way to another, or to the
plain version: a failed build or launch raises. The wrapper checks what it
is given and raises on anything the kernels do not take (fp32 or bf16, one
dtype for x and w, unit stride over x's columns and w's last dim),
allocates the output, launches on PyTorch's current stream and counts its
launches in ``gmm_cuda.launches_by_variant``, by the caller's ``mode``
(``"forward"`` or ``"dx"``, the backward's product) in
``gmm_cuda.launches_by_mode`` and, summed, ``gmm_cuda.launches``. The raw
wrapper has no backward, and raises rather than lose a gradient
(:func:`build.refuse_grad`); ``ops.gmm`` differentiates it (dx through
this kernel again, over w transposed).
Unlike the reference it pads nothing: any T, K and N.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ref import gmm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = {torch.float32: 64, torch.bfloat16: 128}  # the kernels' row tile per dtype
VARIANTS = ("hopper", "wmma", "f32")
MODES = ("forward", "dx")


def gmm_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
              tiles: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: one fp32 product per group (``gmm_ref``). It has
    no tile plan: ``tiles`` is taken, as the kernel's wrapper takes it, and
    unused."""
    return gmm_ref(x, w, group_sizes)


def cost(rows: int, K: int, N: int, experts_hit: int, elem_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch over ``rows`` live rows: their x read and
    out written, the weights of the ``experts_hit`` experts that hold rows
    read once; 2 K N FLOPs a row."""
    return 2.0 * rows * K * N, float(elem_bytes * (rows * K + experts_hit * K * N + rows * N))


def gmm_meta(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
             tiles: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on the meta device: an empty [T, N] output, and its cost
    reported over every row of x (the static buffer: its live rows are
    data) and every expert."""
    (T, K), (E, _, N) = x.shape, w.shape
    meta.report("moe_gmm", cost(T, K, N, E, x.element_size()), x.dtype)
    return torch.empty((T, N), dtype=x.dtype, device="meta")


def gmm_tiles(group_sizes: torch.Tensor, T: int, block_t: int) -> torch.Tensor:
    """The kernels' tile plan, int32 [3, ceil(T / block_t) + E] on
    ``group_sizes``'s device: per row tile its group id, first row and end
    row. Group ``e``'s rows are cut into tiles of ``block_t`` (the last one
    ragged); group id E covers the rows past the last group (written as 0);
    the tiles past all of those have end == first row and do nothing."""
    E = group_sizes.shape[0]
    gs = group_sizes.to(torch.int64).clamp(min=0)
    ends = torch.cumsum(gs, 0).clamp(max=T)
    ends = torch.cat([ends, ends.new_full((1,), T)])  # group E: the rows past the groups
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    n_tiles = (ends - starts + block_t - 1) // block_t
    tile_end = torch.cumsum(n_tiles, 0)
    t = torch.arange(-(-T // block_t) + E, device=group_sizes.device)
    gid = torch.searchsorted(tile_end, t, right=True)  # E + 1 past the last tile
    g = gid.clamp(max=E)
    row0 = starts[g] + (t - (tile_end[g] - n_tiles[g])) * block_t
    row1 = torch.where(gid > E, row0, torch.minimum(row0 + block_t, ends[g]))
    return torch.stack([gid, row0, row1]).to(torch.int32)


def _tma_ok(t: torch.Tensor, dims: tuple[int, ...]) -> bool:
    """A TMA descriptor can describe ``t``: 16-byte aligned data, and the
    stride of each of ``dims`` that is longer than 1 a positive multiple of
    8 elements."""
    return t.data_ptr() % 16 == 0 and all(
        t.shape[d] <= 1 or (t.stride(d) > 0 and t.stride(d) % 8 == 0) for d in dims)


def gmm_variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel takes x [T, K] and w [E, K, N]: ``"f32"`` for fp32;
    for bf16 ``"hopper"`` where a TMA descriptor can describe both (K and N
    positive multiples of 8, data 16-byte aligned, x's row stride and w's
    strides over E and K multiples of 8 elements), else ``"wmma"``."""
    if x.dtype == torch.float32:
        return "f32"
    K, N = x.shape[1], w.shape[2]
    if K > 0 and N > 0 and K % 8 == 0 and N % 8 == 0 and _tma_ok(x, (0,)) \
            and _tma_ok(w, (0, 1)):
        return "hopper"
    return "wmma"


def _tma_stride(t: torch.Tensor, d: int, placeholder: int) -> int:
    """``t``'s stride over dim ``d``, or where that dim has length 1 (its
    coordinate always 0) a placeholder that a TMA descriptor takes."""
    return t.stride(d) if t.shape[d] > 1 else placeholder


def _lib():
    lib = build.library("moe_gmm")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gmm_launch.argtypes = [p, ll, p, ll, ll, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.gmm_launch.restype = i
    lib.gmm_hopper_launch.argtypes = [p, ll, p, ll, ll, p, p, i, i, i, i, i, p]
    lib.gmm_hopper_launch.restype = i
    lib.gmm_error_string.argtypes = [i]
    lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def gmm_cuda(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
             tiles: torch.Tensor | None = None, variant: str | None = None,
             mode: str = "forward") -> torch.Tensor:
    """Launch the kernel :func:`gmm_variant` picks (or ``variant``, to hold
    one kernel against another: ``"wmma"`` takes any bf16 layout,
    ``"hopper"`` only what the rule gives it): x [T, K] (unit column stride,
    any row stride), w [E, K, N] (unit stride over N), both fp32 or both
    bf16, ``group_sizes`` [E] integers (copied to x's device if elsewhere)
    -> [T, N] contiguous, x's dtype. ``tiles``: the plan
    ``gmm_tiles(group_sizes, T, TILE_ROWS[x.dtype])`` built once by the
    caller for several products, else built here. ``mode``: what the
    product is (``"dx"``: a backward's ``dy @ w^T``), counted by it."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 2 or w.dim() != 3 or x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x [T, K] and w [E, K, N] must be of one dtype, float32 or bfloat16; "
                         f"got x {x.dtype} {tuple(x.shape)}, w {w.dtype} {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    T, K = x.shape
    E, Kw, N = w.shape
    if Kw != K:
        raise ValueError(f"x has K={K} columns, w has K={Kw} rows")
    if (group_sizes.dim() != 1 or group_sizes.shape[0] != E or group_sizes.is_floating_point()
            or group_sizes.is_complex()):
        raise ValueError(f"group_sizes must be [E={E}] integers, got {group_sizes.dtype} "
                         f"{tuple(group_sizes.shape)}")
    if K > 1 and x.stride(1) != 1:
        raise ValueError(f"x must have unit column stride, got strides {x.stride()}")
    if N > 1 and w.stride(2) != 1:
        raise ValueError(f"w must have unit stride over N, got strides {w.stride()}")
    if T >= 2**30 or K >= 2**31 or N >= 2**31 or E >= 2**30:
        raise ValueError(f"shape too large for the kernel: T={T}, K={K}, N={N}, E={E}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    bt = TILE_ROWS[x.dtype]
    n_tiles = -(-T // bt) + E
    if tiles is not None and (tiles.dtype != torch.int32 or tuple(tiles.shape) != (3, n_tiles)
                              or tiles.device != x.device or not tiles.is_contiguous()):
        raise ValueError(f"tiles must be a contiguous int32 [3, {n_tiles}] plan on {x.device} "
                         f"(gmm_tiles at {bt} rows), got {tiles.dtype} {tuple(tiles.shape)} "
                         f"on {tiles.device}")
    rule = gmm_variant(x, w)
    if variant is None:
        variant = rule
    elif variant not in VARIANTS or (variant != rule and (variant, rule) != ("wmma", "hopper")):
        raise ValueError(f"moe_gmm variant {variant!r} does not take these inputs "
                         f"(the rule gives {rule!r})")
    build.refuse_grad("moe_gmm", x, w)
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    if T == 0 or N == 0:
        return out
    if E == 0:  # no group: every row lies past the groups
        return out.zero_()
    if tiles is None:
        tiles = gmm_tiles(group_sizes.to(x.device), T, bt)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if variant == "hopper":
            err = lib.gmm_hopper_launch(
                x.data_ptr(), _tma_stride(x, 0, K), w.data_ptr(), _tma_stride(w, 0, K * N),
                _tma_stride(w, 1, N), out.data_ptr(), tiles.data_ptr(), n_tiles, T, K, N, E,
                stream)
        else:
            bf16 = x.dtype == torch.bfloat16
            vec_x = int(bf16 and K % 8 == 0 and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0)
            vec_w = int(bf16 and N % 8 == 0 and w.stride(0) % 8 == 0 and w.stride(1) % 8 == 0
                        and w.data_ptr() % 16 == 0)
            vec_out = int(bf16 and N % 8 == 0)
            err = lib.gmm_launch(
                x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0), w.stride(1),
                out.data_ptr(), tiles.data_ptr(), n_tiles, bt, K, N, E, _DTYPES[x.dtype], vec_x,
                vec_w, vec_out, stream)
    if err:
        raise RuntimeError(f"gmm {variant} kernel launch failed: "
                           f"{lib.gmm_error_string(err).decode()}")
    gmm_cuda.launches_by_variant[variant] += 1
    gmm_cuda.launches_by_mode[mode] = gmm_cuda.launches_by_mode.get(mode, 0) + 1
    gmm_cuda.launches += 1
    return out


gmm_cuda.launches = 0
gmm_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
gmm_cuda.launches_by_mode = {}
