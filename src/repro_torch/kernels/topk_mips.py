"""Top-k maximum-inner-product search: the CUDA kernel's wrapper
(``csrc/topk_mips.cu``, replacing the reference's ``topk_mips_pallas``)
and its plain PyTorch version.

The wrapper checks what it is given and raises on anything the kernel does
not take; it allocates the outputs and the kernel's scratch, launches on
PyTorch's current stream and counts its launches in
``topk_mips_cuda.launches``. Queries and corpus are fp32 ``[*, D]`` with
``D % 4 == 0``: the port pads the feature dim only to one float4 load, not
to the TPU's 128 lanes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_mips_ref

MAX_K = 512  # top-K lists (K = k rounded up to a power of two) fit the 512-key buffer, BUFP
_MERGE_KEYS = 8192  # cap on splits * K: the merge sorts them in shared memory
_BLOCKS_PER_SM = 4
_MIN_ROWS_PER_SPLIT = 1024
_TQ = 8  # queries per block, as csrc/topk_mips.cu's TQ


def topk_mips_plain(queries, corpus, k: int, n_valid: int | None = None):
    """The plain version: the full [Q, N] fp32 score matrix and a stable
    descending sort — the oracle itself."""
    return topk_mips_ref(queries, corpus, k, n_valid=n_valid)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def split_count(n_tiles: int, n: int, K: int, n_sms: int) -> int:
    """Corpus splits per query tile: enough blocks to fill the card, each
    split at least ``_MIN_ROWS_PER_SPLIT`` rows, and the merge's
    ``splits * K`` keys within its shared-memory sort."""
    S = 1
    while (
        S * n_tiles < _BLOCKS_PER_SM * n_sms
        and 2 * S * K <= _MERGE_KEYS
        and 2 * S * _MIN_ROWS_PER_SPLIT <= n
    ):
        S *= 2
    return S


def _lib():
    lib = build.library("topk_mips")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_mips_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.topk_mips_launch.restype = i
    lib.topk_mips_error_string.argtypes = [i]
    lib.topk_mips_error_string.restype = ctypes.c_char_p
    return lib


def topk_mips_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   n_valid: int | None = None):
    """Launch the kernel: -> (scores f32 [Q, k], indices i32 [Q, k])."""
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
    K = _pow2_at_least(k)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    S = split_count(-(-Q // _TQ), n, K, n_sms)
    part = torch.empty((Q, S, K), dtype=torch.int64, device=dev)  # u64 keys
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.topk_mips_launch(
            queries.data_ptr(), corpus.data_ptr(), part.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), Q, n, D, k, K, S,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"topk_mips kernel launch failed: {lib.topk_mips_error_string(err).decode()}"
        )
    topk_mips_cuda.launches += 1
    return vals, idx


topk_mips_cuda.launches = 0
