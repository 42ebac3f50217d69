"""Blockwise (flash) attention with GQA and causal/sliding-window masks:
the forward's CUDA kernels' wrapper (``csrc/flash_attention.cu``, replacing
the reference's ``flash_attention_pallas``), the backward's
(``csrc/flash_attention_bwd.cu``, replacing its custom VJP ``_flash_bwd``),
and the plain PyTorch version of each.

Both keep the reference kernel's semantics: query row ``i`` sits at absolute
position ``q_offset + i``; a key is kept where it is causal-visible and
inside the window; masked scores are the finite ``NEG_INF`` and their
probabilities are zeroed, and a row that keeps no key is 0. The math is
fp32; the output has ``q``'s dtype. Unlike the reference, ``Sq`` and ``Skv``
need not be multiples of a tile. Query head ``h`` reads KV head ``(h +
head_offset) // group``: by default ``group = H / Hkv`` and ``head_offset =
0``, plain GQA; a tensor-parallel rank whose q heads start or end inside a
KV group (``models/attention.py``) passes the global group and the index of
its first head inside its group, with the KV heads its heads read.

The source holds two kernels, and :func:`flash_variant` picks one by an
explicit rule: ``"hopper"`` (wgmma + TMA) for bf16 q, k and v with a head
dim in ``HOPPER_HEAD_DIMS``, 16-byte aligned data and (b, h, s) strides that
are multiples of 8 elements; ``"simt"`` (fp32 FMA lanes) for everything
else the wrapper takes. Neither gives way to the other, or to the plain
version: a failed build or launch raises.

The wrapper checks what it is given and raises on anything neither kernel
takes (fp32 or bf16, one dtype for q, k and v, ``Dh <= 256``, unit stride
over ``Dh``), and on inputs that require grad under grad mode (the raw
wrapper has no backward; ``ops.flash_attention`` differentiates it through
the backward's wrapper), allocates the output, launches on PyTorch's current
stream and counts its launches in ``flash_attention_cuda.launches_by_variant``,
by mask mode ``(Sq, Skv, causal, window)`` in
``flash_attention_cuda.launches_by_mode`` and, summed,
``flash_attention_cuda.launches``. With ``return_lse=True`` the forward also
returns each row's log-sum-exp (fp32 [B, H, Sq]: ``log(sum_j exp(s_j))``
over the kept keys, ``s = q . k / sqrt(Dh)``; ``+inf`` for a row that keeps
no key), what the backward recomputes the probabilities from.

The backward (:func:`flash_attention_bwd_cuda`: three launches, delta, dK/dV
and dQ, no atomics) takes q, k, v, the forward's output o and lse, and the
output's gradient dO, and returns (dq, dk, dv). Its source holds three
variants: ``"hopper"`` (wgmma + TMA, warp-specialised: bf16, head dim in
``HOPPER_BWD_HEAD_DIMS``, 64 to 256, data a TMA descriptor can describe;
at 192 and 256 its dK/dV kernel gives dV to one consumer warpgroup and dK
to the other, and on a small grid two CTAs of a cluster share a key
tile), ``"mma"``
(the first tensor-core backward, mma.sync: bf16, head dim in
``MMA_BWD_HEAD_DIMS``, the same layouts; kept to be timed beside it) and
``"simt"`` (fp32 FMA lanes, anything). :func:`flash_bwd_variant` picks
``"hopper"`` where it takes the inputs, else ``"simt"``;
:func:`flash_bwd_variants` lists every variant that takes them. Its counts
are ``flash_attention_bwd_cuda.launches`` (one a backward, its three
kernels together), ``.launches_by_variant`` and ``.launches_by_mode``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, meta

NEG_INF = -1e30
MAX_HEAD_DIM = 256
HOPPER_HEAD_DIMS = (64, 96, 128, 192, 256)
HOPPER_BWD_HEAD_DIMS = HOPPER_HEAD_DIMS  # the forward's and the backward's are one set
MMA_BWD_HEAD_DIMS = (64, 128)
VARIANTS = ("hopper", "simt")
BWD_VARIANTS = ("hopper", "mma", "simt")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int, q_offset: int,
                   device) -> torch.Tensor:
    """[Sq, Skv] bool: which (query, key) pairs the kernel keeps."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def kv_groups(H: int, Hkv: int, group: int | None = None,
              head_offset: int = 0) -> tuple[int, int]:
    """(group, head_offset) of query heads that read KV head ``(h +
    head_offset) // group`` (default ``group = H / Hkv``), given as plain
    GQA's ``(H / Hkv, 0)`` wherever they map the same way. Raises where query
    head ``h`` of ``H`` would not find its KV head among ``Hkv``, or the
    offset is not inside a group."""
    if group is None:
        if Hkv < 1 or H % Hkv:
            raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
        group = H // Hkv or 1  # no query heads: any group
    if group < 1 or not 0 <= head_offset < group or (H - 1 + head_offset) // group >= Hkv:
        raise ValueError(f"{H} query heads from offset {head_offset} in groups of {group} do "
                         f"not read {Hkv} KV heads")
    if H and H % Hkv == 0 and all((h + head_offset) // group == h // (H // Hkv)
                                  for h in range(H)):
        return H // Hkv, 0
    return group, head_offset


def pad_to_groups(q: torch.Tensor, Hkv: int, group: int, head_offset: int) -> torch.Tensor:
    """q [B, H, Sq, Dh] with ``head_offset`` zero heads before it and zero
    heads after it up to ``Hkv * group``: plain GQA's layout, in which head
    ``h`` of q, now ``h + head_offset``, reads KV head ``(h + head_offset) //
    group``. A caller keeps heads ``[head_offset, head_offset + H)`` of the
    result."""
    H = q.shape[1]
    return torch.nn.functional.pad(q, (0, 0, 0, 0, head_offset, Hkv * group - H - head_offset))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, q_offset: int = 0,
                          group: int | None = None, head_offset: int = 0,
                          return_lse: bool = False):
    """The plain version: the kernel's function as one KV block, in fp32,
    with the same masks and the same ``NEG_INF`` semantics. GQA groups the
    ``H / Hkv`` query heads of a KV head instead of repeating K and V; with
    another ``group`` or a ``head_offset``, q is padded with zero heads to
    that layout (:func:`pad_to_groups`) and the padding dropped after.
    ``return_lse``: also each row's log-sum-exp, fp32 [B, H, Sq] (``+inf``
    where the row keeps no key), as the kernel returns it."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group, head_offset = kv_groups(H, Hkv, group, head_offset)
    if group * Hkv != H:
        res = flash_attention_plain(pad_to_groups(q, Hkv, group, head_offset), k, v,
                                    causal=causal, window=window, q_offset=q_offset,
                                    return_lse=return_lse)
        keep = lambda t: t[:, head_offset:head_offset + H].contiguous()
        return tuple(map(keep, res)) if return_lse else keep(res)
    rep = H // Hkv
    scale = 1.0 / (Dh**0.5)
    qf = q.float().reshape(B, Hkv, rep * Sq, Dh)
    s = torch.matmul(qf, k.float().transpose(-1, -2)).reshape(B, Hkv, rep, Sq, Skv) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.reshape(B, Hkv, rep * Sq, Skv), v.float()).reshape(B, Hkv, rep, Sq, Dh)
    out = acc / torch.where(l == 0.0, 1.0, l)  # rows that keep no key -> 0
    out = out.reshape(B, H, Sq, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, torch.inf, m + torch.log(l))
    return out, lse.reshape(B, H, Sq)


def kept_pairs(Sq: int, Skv: int, *, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the mask keeps for one (batch, head): the kernel's
    work, which skips the masked tiles."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def cost(B: int, H: int, Hkv: int, Sq: int, Skv: int, Dh: int, *, causal: bool, window: int,
         q_offset: int, elem_bytes: int, lse: bool = False) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: q, k and v read once, o (and, with
    ``lse``, the fp32 log-sum-exp) written once; two products of 2 Dh FLOPs
    for each kept (query, key) pair."""
    pairs = B * H * kept_pairs(Sq, Skv, causal=causal, window=window, q_offset=q_offset)
    return 4.0 * Dh * pairs, float(elem_bytes * (2 * B * H * Sq + 2 * B * Hkv * Skv) * Dh
                                   + (4 * B * H * Sq if lse else 0))


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0, q_offset: int = 0,
                         group: int | None = None, head_offset: int = 0,
                         return_lse: bool = False):
    """The kernel on the meta device: an empty [B, H, Sq, Dh] output (and
    [B, H, Sq] fp32 lse), and its cost reported."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_groups(H, Hkv, group, head_offset)
    meta.report("flash_attention", cost(B, H, Hkv, Sq, Skv, Dh, causal=bool(causal),
                                        window=int(window), q_offset=int(q_offset),
                                        elem_bytes=q.element_size(), lse=return_lse), q.dtype)
    out = torch.empty((B, H, Sq, Dh), dtype=q.dtype, device="meta")
    if not return_lse:
        return out
    return out, torch.empty((B, H, Sq), dtype=torch.float32, device="meta")


def flash_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel takes these inputs: ``"hopper"`` where a TMA descriptor
    can describe all three (bf16, head dim in ``HOPPER_HEAD_DIMS``, data
    16-byte aligned, every stride over (b, h, s) of a dim longer than 1 a
    positive multiple of 8 elements, and at least one key), else ``"simt"``."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in HOPPER_HEAD_DIMS or k.shape[2] == 0:
        return "simt"
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.data_ptr() % 16:
            return "simt"
        if any(n > 1 and (st % 8 or st <= 0) for n, st in zip(t.shape[:3], t.stride()[:3])):
            return "simt"
    return "hopper"


def _tma_strides(t: torch.Tensor) -> list[int]:
    """``t``'s strides over (b, h, s), a dim of length 1 given a placeholder
    that a TMA descriptor takes (its coordinate is always 0)."""
    return [st if n > 1 else 8 for n, st in zip(t.shape[:3], t.stride()[:3])]


def _lib():
    lib = build.library("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_simt_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                                ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                                ctypes.c_float, i, i, i, i, i, i, p]
    lib.flash_attention_simt_launch.restype = i
    lib.flash_attention_hopper_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                                  ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                                  ctypes.c_float, i, i, i, i, i, p]
    lib.flash_attention_hopper_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0, q_offset: int = 0,
                         group: int | None = None, head_offset: int = 0,
                         variant: str | None = None, return_lse: bool = False):
    """Launch the kernel :func:`flash_variant` picks (or ``variant``, to hold
    one kernel against the other: ``"simt"`` takes anything, ``"hopper"``
    only what the rule gives it): q [B, H, Sq, Dh], k and v [B, Hkv, Skv,
    Dh] (any strides over the first three dims, unit stride over Dh) -> o
    [B, H, Sq, Dh] contiguous, q's dtype (and, with ``return_lse``, the fp32
    [B, H, Sq] log-sum-exp: ``(o, lse)``); query head h reads KV head ``(h +
    head_offset) // group`` (default ``group = H / Hkv``)."""
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dim() != 4 or t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k, v must be 4-D tensors of one dtype, float32 or bfloat16; "
                             f"{name} is {t.dtype} {tuple(t.shape)}, q is {q.dtype}")
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride over its last dim, got {t.stride()}")
    B, H, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    if tuple(k.shape) != (B, Hkv, Skv, Dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{B}, Hkv, Skv, {Dh}]")
    group, head_offset = kv_groups(H, Hkv, group, int(head_offset))
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} outside [1, {MAX_HEAD_DIM}]")
    window, q_offset = int(window), int(q_offset)
    if (H > 65535 or B > 65535 or Skv >= 2**30 or abs(q_offset) + Sq >= 2**30
            or abs(window) >= 2**30):  # positions minus the window stay in int32
        raise ValueError(f"shape too large for the kernel: B={B}, H={H}, Sq={Sq}, Skv={Skv}, "
                         f"q_offset={q_offset}, window={window}")
    build.refuse_grad("flash_attention", q, k, v)
    out = torch.empty((B, H, Sq, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    rule = flash_variant(q, k, v)
    if variant is None:
        variant = rule
    elif variant not in VARIANTS or (variant == "hopper" and rule != "hopper"):
        raise ValueError(f"flash_attention variant {variant!r} does not take these inputs "
                         f"(the rule gives {rule!r})")
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "hopper":
            err = lib.flash_attention_hopper_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, Hkv, Sq, Skv,
                Dh, *_tma_strides(q), *_tma_strides(k), *_tma_strides(v), 1.0 / (Dh**0.5),
                int(bool(causal)), window, q_offset, group, head_offset, stream)
        else:
            err = lib.flash_attention_simt_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, Hkv, Sq, Skv,
                Dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1.0 / (Dh**0.5),
                int(bool(causal)), window, q_offset, group, head_offset, _DTYPES[q.dtype],
                stream)
    if err:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention_cuda.launches_by_variant[variant] += 1
    by_mode, mode = flash_attention_cuda.launches_by_mode, (Sq, Skv, bool(causal), window)
    by_mode[mode] = by_mode.get(mode, 0) + 1
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
flash_attention_cuda.launches_by_mode = {}


# --------------------------------------------------------------------------
# the backward
# --------------------------------------------------------------------------

BWD_BLOCK_K = 128  # the plain backward's KV block


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0, q_offset: int = 0,
                              group: int | None = None, head_offset: int = 0):
    """The plain version of the backward -> (dq, dk, dv) in q's, k's and v's
    dtypes: the kernels' explicit formulas in fp32, over KV blocks of
    ``BWD_BLOCK_K`` so that memory stays O(Sq * BWD_BLOCK_K) a head. With
    ``s = q . k / sqrt(Dh)`` and ``p = exp(s - lse)`` (0 where masked; ``lse
    = +inf`` makes a row's p 0): ``delta = sum(dO * o)``, ``dv = p^T dO``,
    ``ds = p (dO v^T - delta)``, ``dq = ds k / sqrt(Dh)``, ``dk = ds^T q /
    sqrt(Dh)``, GQA's sum over a KV head's query heads included. Another
    ``group`` or a ``head_offset`` runs padded to plain GQA's layout
    (:func:`pad_to_groups`; the padding's lse is ``+inf``, so it adds
    nothing)."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group, head_offset = kv_groups(H, Hkv, group, head_offset)
    if group * Hkv != H:
        pad = lambda t: pad_to_groups(t, Hkv, group, head_offset)
        lse_p = torch.nn.functional.pad(lse, (0, 0, head_offset, Hkv * group - H - head_offset),
                                        value=torch.inf)
        dq, dk, dv = flash_attention_bwd_plain(pad(q), k, v, pad(o), lse_p, pad(do),
                                               causal=causal, window=window,
                                               q_offset=q_offset)
        return dq[:, head_offset:head_offset + H].contiguous(), dk, dv
    rep = H // Hkv
    scale = 1.0 / (Dh**0.5)
    qf = q.float().reshape(B, Hkv, rep, Sq, Dh)
    dof = do.float().reshape(B, Hkv, rep, Sq, Dh)
    lsef = lse.float().reshape(B, Hkv, rep, Sq, 1)
    delta = (dof * o.float().reshape(B, Hkv, rep, Sq, Dh)).sum(-1, keepdim=True)
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(qf)
    dk = torch.empty((B, Hkv, Skv, Dh), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    keep = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    for k0 in range(0, Skv, BWD_BLOCK_K):
        k1 = min(k0 + BWD_BLOCK_K, Skv)
        kb, vb, mask = kf[:, :, k0:k1], vf[:, :, k0:k1], keep[:, k0:k1]
        s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kb) * scale
        p = torch.where(mask, torch.exp(s - lsef), 0.0)
        dv[:, :, k0:k1] = torch.einsum("bgrqk,bgrqd->bgkd", p, dof)
        ds = p * (torch.einsum("bgrqd,bgkd->bgrqk", dof, vb) - delta)
        dk[:, :, k0:k1] = torch.einsum("bgrqk,bgrqd->bgkd", ds, qf) * scale
        dq += torch.einsum("bgrqk,bgkd->bgrqd", ds, kb)
    return ((dq * scale).reshape(B, H, Sq, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def backward_cost(B: int, H: int, Hkv: int, Sq: int, Skv: int, Dh: int, *, causal: bool,
                  window: int, q_offset: int, elem_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one backward: q, k, v, o and dO read once, lse and
    delta (fp32) once each, dq, dk and dv written once; five products of 2
    Dh FLOPs (S, dP, dV, dK, dQ) for each kept (query, key) pair, the work
    of the function (the dQ kernel's recompute of S and dP is not counted)."""
    pairs = B * H * kept_pairs(Sq, Skv, causal=causal, window=window, q_offset=q_offset)
    return 10.0 * Dh * pairs, float(elem_bytes * (4 * B * H * Sq + 4 * B * Hkv * Skv) * Dh
                                    + 8 * B * H * Sq)


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0, q_offset: int = 0,
                             group: int | None = None, head_offset: int = 0):
    """The backward on the meta device: empty dq, dk, dv of the kernels'
    shapes and dtypes, and its cost reported as one call."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_groups(H, Hkv, group, head_offset)
    meta.report("flash_attention_backward",
                backward_cost(B, H, Hkv, Sq, Skv, Dh, causal=bool(causal), window=int(window),
                              q_offset=int(q_offset), elem_bytes=q.element_size()), q.dtype)
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    return (empty((B, H, Sq, Dh), q.dtype), empty((B, Hkv, Skv, Dh), k.dtype),
            empty((B, Hkv, Skv, Dh), v.dtype))


def flash_bwd_variants(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       do: torch.Tensor) -> tuple[str, ...]:
    """The backward kernels that take these inputs, the rule's pick first.
    ``"hopper"`` and ``"mma"`` where TMA descriptors (and ``cp.async``'s
    16-byte loads) reach every row: all five bf16, data 16-byte aligned,
    every stride over (b, h, s) of a dim longer than 1 a positive multiple
    of 8 elements, at least one key, and a head dim in
    ``HOPPER_BWD_HEAD_DIMS`` (``"hopper"``: 64, 96, 128, 192, 256) or
    ``MMA_BWD_HEAD_DIMS`` (``"mma"``: 64, 128); ``"simt"`` always."""
    Dh = q.shape[-1]
    if q.dtype != torch.bfloat16 or k.shape[2] == 0 or any(
            t.dtype != torch.bfloat16 or t.data_ptr() % 16
            or any(n > 1 and (st % 8 or st <= 0) for n, st in zip(t.shape[:3], t.stride()[:3]))
            for t in (q, k, v, o, do)):
        return ("simt",)
    return (*(["hopper"] if Dh in HOPPER_BWD_HEAD_DIMS else []),
            *(["mma"] if Dh in MMA_BWD_HEAD_DIMS else []), "simt")


def flash_bwd_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      do: torch.Tensor) -> str:
    """Which backward kernel the rule picks: ``"hopper"`` (wgmma + TMA)
    wherever it takes the inputs (:func:`flash_bwd_variants`), else
    ``"simt"``. ``"mma"`` is only ever asked for by name."""
    return flash_bwd_variants(q, k, v, o, do)[0]


def _bwd_lib():
    lib = build.library("flash_attention_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_bwd_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                               *[ll] * 15, ctypes.c_float, i, i, i, i, i, i, p]
    lib.flash_attention_bwd_launch.restype = i
    lib.flash_attention_bwd_error_string.argtypes = [i]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0, q_offset: int = 0,
                             group: int | None = None, head_offset: int = 0,
                             variant: str | None = None):
    """Launch the backward :func:`flash_bwd_variant` picks (or ``variant``,
    one of :func:`flash_bwd_variants`: ``"simt"`` takes anything, ``"hopper"``
    and ``"mma"`` only the layouts and head dims they are built for):
    q, o, dO [B, H, Sq, Dh] and k, v [B, Hkv, Skv, Dh] of one dtype (any
    strides over the first three dims, unit stride over Dh), lse fp32 [B,
    H, Sq] contiguous (the forward's ``return_lse``) -> (dq [B, H, Sq, Dh],
    dk, dv [B, Hkv, Skv, Dh]), contiguous, in that dtype. Three launches
    (delta, dK/dV, dQ) on PyTorch's current stream, counted as one."""
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dim() != 4 or t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k, v, o, do must be 4-D tensors of one dtype, float32 or "
                             f"bfloat16; {name} is {t.dtype} {tuple(t.shape)}, q is {q.dtype}")
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride over its last dim, got {t.stride()}")
    B, H, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    if tuple(k.shape) != (B, Hkv, Skv, Dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{B}, Hkv, Skv, {Dh}]")
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if (lse.device != q.device or lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [{B}, {H}, {Sq}] tensor on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    group, head_offset = kv_groups(H, Hkv, group, int(head_offset))
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} outside [1, {MAX_HEAD_DIM}]")
    window, q_offset = int(window), int(q_offset)
    if (H > 65535 or Hkv > 65535 or B > 65535 or Skv >= 2**30
            or abs(q_offset) + Sq >= 2**30 or abs(window) >= 2**30):
        raise ValueError(f"shape too large for the kernel: B={B}, H={H}, Sq={Sq}, Skv={Skv}, "
                         f"q_offset={q_offset}, window={window}")
    build.refuse_grad("flash_attention_backward", q, k, v, o, do)
    dq = torch.empty((B, H, Sq, Dh), dtype=q.dtype, device=q.device)
    if B * H * Sq == 0:  # no query: dk and dv are 0, nothing to launch
        return dq, *(torch.zeros((B, Hkv, Skv, Dh), dtype=q.dtype, device=q.device)
                     for _ in range(2))
    dk = torch.empty((B, Hkv, Skv, Dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    takes = flash_bwd_variants(q, k, v, o, do)
    if variant is None:
        variant = takes[0]
    elif variant not in takes:
        raise ValueError(f"flash_attention backward variant {variant!r} does not take these "
                         f"inputs (the variants that do: {takes})")
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            ("simt", "mma", "hopper").index(variant), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Sq, Skv, Dh, *_tma_strides(q),
            *_tma_strides(k), *_tma_strides(v), *_tma_strides(o), *_tma_strides(do),
            1.0 / (Dh**0.5), int(bool(causal)), window, q_offset, group, head_offset,
            _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention backward {variant} kernel launch failed: "
                           f"{lib.flash_attention_bwd_error_string(err).decode()}")
    flash_attention_bwd_cuda.launches_by_variant[variant] += 1
    by_mode, mode = flash_attention_bwd_cuda.launches_by_mode, (Sq, Skv, bool(causal), window)
    by_mode[mode] = by_mode.get(mode, 0) + 1
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
flash_attention_bwd_cuda.launches_by_mode = {}
