"""Top-k maximum-inner-product search: the CUDA kernels' wrapper
(``csrc/topk_mips.cu``, replacing the reference's ``topk_mips_pallas``),
their launch plan and the plain PyTorch version.

The source holds two variants, and :func:`topk_plan` picks one by a rule on
the shapes alone. ``"threshold"``: four launches — one sweep that keeps
each group's smallest key, per query the exact k-th threshold over those
minima, a second look at the rows of the k winning groups, and a sort of the
few that pass — whose candidate capacity C is proven on the host before the
launch (the argument is in the source's header). ``"stream"``: the first
port's kernel, a running top-K per block and a merge, for the shapes whose
capacity does not fit shared memory.

The wrapper checks what it is given and raises on anything the kernels do
not take; it allocates the outputs and the scratch, launches on PyTorch's
current stream and counts its launches in ``topk_mips_cuda.launches`` and
``topk_mips_cuda.launches_by_variant``. Queries and corpus are fp32
``[*, D]`` with ``D % 4 == 0``: the port pads the feature dim only to one
float4 load, not to the TPU's 128 lanes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_mips_ref

VARIANTS = ("threshold", "stream")
MAX_K = 512  # the stream variant's top-K lists (K = k rounded up) fit its 512-key buffer, BUFP
_MERGE_KEYS = 8192  # cap on splits * K: the merge sorts them in shared memory
_BLOCKS_PER_SM = 4
_MIN_ROWS_PER_SPLIT = 1024
_TQ = 8  # queries per block of the stream variant, as csrc/topk_mips.cu's TQ

# the threshold variant's sweep (mips_group_min): queries a tile and threads a
# block, as csrc/topk_mips.cu's SCAN_TQ and SCAN_THREADS (a tile chosen by
# measurement on the card; PERF.md)
THRESHOLD_TQ = 16
THRESHOLD_NT = 256
_MIN_GROUP_ROWS = 4  # splits stop doubling before a group holds fewer rows
_MAX_SPLIT_LOG2 = 15  # splits are a power of two within grid.y's 65,535
_SEL_THREADS = 1024  # mips_threshold's block: one first-level minimum a thread
SMEM_BYTES = 232_448  # shared memory one block may use on an H100


class TopkPlan(NamedTuple):
    """One launch's shapes. For ``"threshold"``: ``S`` corpus splits of
    ``rows_per_split`` rows, ``G = S * THRESHOLD_NT`` groups of at most
    ``max_group_rows`` rows, ``C`` candidates a query, ``cap`` keys for the
    threshold's compaction and ``sel_keys`` for the final sort; ``smem`` each
    launch's dynamic shared memory in bytes. For ``"stream"``: ``S`` splits of
    ``rows_per_split`` rows and ``K``; the other fields 0 or empty."""
    variant: str
    Q: int
    n: int
    k: int
    D: int
    S: int
    rows_per_split: int
    G: int
    max_group_rows: int
    C: int
    cap: int
    sel_keys: int
    K: int
    smem: dict


def topk_mips_plain(queries, corpus, k: int, n_valid: int | None = None):
    """The plain version: the full [Q, N] fp32 score matrix and a stable
    descending sort — the oracle itself."""
    return topk_mips_ref(queries, corpus, k, n_valid=n_valid)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_count(n_tiles: int, n: int, K: int, n_sms: int) -> int:
    """Corpus splits per query tile of the stream variant: enough blocks to
    fill the card, each split at least ``_MIN_ROWS_PER_SPLIT`` rows, and the
    merge's ``splits * K`` keys within its shared-memory sort."""
    S = 1
    while (
        S * n_tiles < _BLOCKS_PER_SM * n_sms
        and 2 * S * K <= _MERGE_KEYS
        and 2 * S * _MIN_ROWS_PER_SPLIT <= n
    ):
        S *= 2
    return S


def threshold_splits(n_tiles: int, n: int, n_sms: int) -> int:
    """Corpus splits per query tile of the threshold variant: the grid stays
    within ``_BLOCKS_PER_SM`` blocks per SM and every group keeps at least
    ``_MIN_GROUP_ROWS`` rows. :func:`topk_plan` moves from it where the
    buffers do not fit at this count."""
    S = 1
    while (2 * S * n_tiles <= _BLOCKS_PER_SM * n_sms
           and 2 * S * THRESHOLD_NT * _MIN_GROUP_ROWS <= n):
        S *= 2
    return S


def _threshold_plan(Q: int, n: int, k: int, D: int, S: int) -> TopkPlan:
    rps = _cdiv(n, S)
    G = S * THRESHOLD_NT
    mgr = _cdiv(rps, THRESHOLD_NT)
    C = (k - 1) * mgr + 1
    cap = _pow2_at_least((k - 1) * _cdiv(G, _SEL_THREADS) + 1)
    sel_keys = _pow2_at_least(C)
    smem = {"mips_group_min": THRESHOLD_TQ * D * 4, "mips_threshold": (_SEL_THREADS + cap) * 8,
            "mips_filter": D * 4, "mips_select": sel_keys * 8}
    return TopkPlan("threshold", Q, n, k, D, S, rps, G, mgr, C, cap, sel_keys, 0, smem)


def _fits(p: TopkPlan) -> bool:
    return p.k <= _SEL_THREADS and max(p.smem.values()) <= SMEM_BYTES


def topk_plan(Q: int, n: int, k: int, n_sms: int, *, D: int = 8,
              variant: str | None = None) -> TopkPlan:
    """The launch plan for ``Q`` queries over ``n`` live rows of width ``D``:
    ``"threshold"`` whenever its candidate buffer (C keys, rounded up to a
    power of two), its threshold compaction and the tile's queries fit one
    block's shared memory at some split count, else ``"stream"``. The split
    count is the power of two nearest :func:`threshold_splits`'s at which
    they fit: C shrinks as the splits grow, the compaction grows with them
    (k=512 over 600k rows fits at 128 splits, not 32). ``variant`` forces
    one, and raises where the threshold variant does not fit.

    The group layout is defined here once, and the kernel takes it as given:
    split ``s`` holds rows ``[s * rows_per_split, (s + 1) * rows_per_split)``
    (cut at ``n``), and thread ``t`` of it the rows ``s * rows_per_split +
    t + i * THRESHOLD_NT`` — so a group holds at most ``ceil(rows_per_split
    / THRESHOLD_NT)`` rows and ``C = (k - 1) * max_group_rows + 1`` (see
    :func:`group_ids` and the source's header)."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"unknown topk_mips variant {variant!r}; one of {VARIANTS}")
    Q, n, k, D = int(Q), int(n), int(k), int(D)
    e0 = threshold_splits(_cdiv(Q, THRESHOLD_TQ), n, n_sms).bit_length() - 1
    for e in sorted(range(_MAX_SPLIT_LOG2 + 1), key=lambda e: (abs(e - e0), -e)):
        plan = _threshold_plan(Q, n, k, D, 1 << e)
        if _fits(plan):
            break
    else:
        plan = _threshold_plan(Q, n, k, D, 1 << e0)
    if variant == "threshold" and not _fits(plan):
        raise ValueError(f"the threshold variant does not fit k={k} over {n} rows: shared "
                         f"memory {plan.smem} exceeds {SMEM_BYTES} bytes")
    if variant == "threshold" or (variant is None and _fits(plan)):
        return plan
    K = _pow2_at_least(k)
    S = split_count(_cdiv(Q, _TQ), n, K, n_sms)
    return TopkPlan("stream", Q, n, k, D, S, _cdiv(n, S), 0, 0, 0, 0, 0, K, {})


def group_ids(plan: TopkPlan) -> torch.Tensor:
    """The threshold variant's group of each live row, int64 [n]: the layout
    :func:`topk_plan` defines and ``mips_group_min`` walks."""
    r = torch.arange(plan.n, dtype=torch.int64)
    rps = plan.rows_per_split
    return (r // rps) * THRESHOLD_NT + (r % rps) % THRESHOLD_NT


def capacity_corpus(plan: TopkPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries [Q, D] and a corpus [n, D] (fp32 on the CPU, dyadic, so every
    score is exact) on which the threshold variant's candidate count is C for
    every query: the rows of k - 1 full groups all score 2, those of a k-th
    full group 1.5, and every other row below 1. The threshold is then the
    k-th group's first row, and exactly ``(k - 1) * max_group_rows + 1`` rows
    pass: the bound of the source's header is reached."""
    gid = group_ids(plan)
    full = torch.nonzero(torch.bincount(gid, minlength=plan.G) == plan.max_group_rows).flatten()
    if plan.variant != "threshold" or full.numel() < plan.k:
        raise ValueError(f"{plan.variant} plan with {full.numel()} full groups for k={plan.k}")
    r = torch.arange(plan.n)
    c = (((r[:, None] * 37 + torch.arange(plan.D) * 11) % 64 - 32) / 64.0).float()
    c[torch.isin(gid, full[: plan.k - 1]), 0] = 2.0
    c[gid == full[plan.k - 1], 0] = 1.5
    q = torch.zeros(plan.Q, plan.D)
    q[:, 0] = (1 + torch.arange(plan.Q) % 4) / 2.0
    return q, c


def _lib():
    lib = build.library("topk_mips")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_mips_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.topk_mips_launch.restype = i
    lib.topk_threshold_launch.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.topk_threshold_launch.restype = i
    lib.topk_mips_error_string.argtypes = [i]
    lib.topk_mips_error_string.restype = ctypes.c_char_p
    return lib


def topk_mips_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   n_valid: int | None = None, *, variant: str | None = None,
                   counts: torch.Tensor | None = None):
    """Launch the variant :func:`topk_plan` picks (or ``variant``): ->
    (scores f32 [Q, k], indices i32 [Q, k]).
    ``counts``, an int32 [Q] CUDA tensor, receives the threshold variant's
    candidates per query."""
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's limit of {MAX_K}")
    for name, t in (("queries", queries), ("corpus", corpus)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 2-D float32 tensor, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    if queries.device != corpus.device:
        raise ValueError(f"queries on {queries.device}, corpus on {corpus.device}")
    Q, D = queries.shape
    N = corpus.shape[0]
    if corpus.shape[1] != D or D == 0 or D % 4:
        raise ValueError(
            f"feature dims must match and be a positive multiple of 4, got "
            f"queries {tuple(queries.shape)}, corpus {tuple(corpus.shape)}"
        )
    if N >= 2**31:
        raise ValueError(f"corpus of {N} rows exceeds int32 indices")
    n = N if n_valid is None else max(0, min(int(n_valid), N))
    dev = queries.device
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return vals, idx
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = topk_plan(Q, n, k, n_sms, D=D, variant=variant)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.variant == "threshold":
        if counts is None:
            counts = torch.empty(Q, dtype=torch.int32, device=dev)
        elif counts.dtype != torch.int32 or counts.shape != (Q,) or counts.device != dev:
            raise ValueError(f"counts must be int32 [{Q}] on {dev}, got {counts.dtype} "
                             f"{tuple(counts.shape)} on {counts.device}")
        # u64 keys: gmin [Q, G], thr [Q], win [Q, k], cand [Q, C]
        scratch = torch.empty(Q * (plan.G + 1 + k + plan.C), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            err = lib.topk_threshold_launch(
                queries.data_ptr(), corpus.data_ptr(), scratch.data_ptr(), counts.data_ptr(),
                vals.data_ptr(), idx.data_ptr(), Q, n, D, k, plan.S, plan.rows_per_split,
                plan.C, plan.cap, plan.sel_keys, stream,
            )
    else:
        part = torch.empty((Q, plan.S, plan.K), dtype=torch.int64, device=dev)  # u64 keys
        with torch.cuda.device(dev):
            err = lib.topk_mips_launch(
                queries.data_ptr(), corpus.data_ptr(), part.data_ptr(),
                vals.data_ptr(), idx.data_ptr(), Q, n, D, k, plan.K, plan.S, stream,
            )
    if err:
        raise RuntimeError(f"topk_mips {plan.variant} kernel launch failed: "
                           f"{lib.topk_mips_error_string(err).decode()}")
    topk_mips_cuda.launches += 1
    topk_mips_cuda.launches_by_variant[plan.variant] += 1
    return vals, idx


topk_mips_cuda.launches = 0
topk_mips_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
