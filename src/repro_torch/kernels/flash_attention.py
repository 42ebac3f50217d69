"""Blockwise (flash) attention forward with GQA and causal/sliding-window
masks: the CUDA kernels' wrapper (``csrc/flash_attention.cu``, replacing
the reference's ``flash_attention_pallas``) and its plain PyTorch version.

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
wrapper has no backward; ``ops.flash_attention`` differentiates it by
recomputing ``ops.attention_blockwise``), allocates the output, launches on
PyTorch's current stream and counts its launches in
``flash_attention_cuda.launches_by_variant``, by mask mode ``(Sq, Skv,
causal, window)`` in ``flash_attention_cuda.launches_by_mode`` and, summed,
``flash_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, meta

NEG_INF = -1e30
MAX_HEAD_DIM = 256
HOPPER_HEAD_DIMS = (64, 96, 128, 192, 256)
VARIANTS = ("hopper", "simt")
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
                          group: int | None = None, head_offset: int = 0) -> torch.Tensor:
    """The plain version: the kernel's function as one KV block, in fp32,
    with the same masks and the same ``NEG_INF`` semantics. GQA groups the
    ``H / Hkv`` query heads of a KV head instead of repeating K and V; with
    another ``group`` or a ``head_offset``, q is padded with zero heads to
    that layout (:func:`pad_to_groups`) and the padding dropped after."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group, head_offset = kv_groups(H, Hkv, group, head_offset)
    if group * Hkv != H:
        out = flash_attention_plain(pad_to_groups(q, Hkv, group, head_offset), k, v,
                                    causal=causal, window=window, q_offset=q_offset)
        return out[:, head_offset:head_offset + H].contiguous()
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
    return out.reshape(B, H, Sq, Dh).to(q.dtype)


def kept_pairs(Sq: int, Skv: int, *, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the mask keeps for one (batch, head): the kernel's
    work, which skips the masked tiles."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def cost(B: int, H: int, Hkv: int, Sq: int, Skv: int, Dh: int, *, causal: bool, window: int,
         q_offset: int, elem_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: q, k and v read once, o written once;
    two products of 2 Dh FLOPs for each kept (query, key) pair."""
    pairs = B * H * kept_pairs(Sq, Skv, causal=causal, window=window, q_offset=q_offset)
    return 4.0 * Dh * pairs, float(elem_bytes * (2 * B * H * Sq + 2 * B * Hkv * Skv) * Dh)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0, q_offset: int = 0,
                         group: int | None = None, head_offset: int = 0) -> torch.Tensor:
    """The kernel on the meta device: an empty [B, H, Sq, Dh] output, and its
    cost reported."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv_groups(H, Hkv, group, head_offset)
    meta.report("flash_attention", cost(B, H, Hkv, Sq, Skv, Dh, causal=bool(causal),
                                        window=int(window), q_offset=int(q_offset),
                                        elem_bytes=q.element_size()), q.dtype)
    return torch.empty((B, H, Sq, Dh), dtype=q.dtype, device="meta")


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
    lib.flash_attention_simt_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                                ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                                ctypes.c_float, i, i, i, i, i, i, p]
    lib.flash_attention_simt_launch.restype = i
    lib.flash_attention_hopper_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                                  ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                                  ctypes.c_float, i, i, i, i, i, p]
    lib.flash_attention_hopper_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0, q_offset: int = 0,
                         group: int | None = None, head_offset: int = 0,
                         variant: str | None = None) -> torch.Tensor:
    """Launch the kernel :func:`flash_variant` picks (or ``variant``, to hold
    one kernel against the other: ``"simt"`` takes anything, ``"hopper"``
    only what the rule gives it): q [B, H, Sq, Dh], k and v [B, Hkv, Skv,
    Dh] (any strides over the first three dims, unit stride over Dh) -> o
    [B, H, Sq, Dh] contiguous, q's dtype; query head h reads KV head ``(h +
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
    if out.numel() == 0:
        return out
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
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Skv,
                Dh, *_tma_strides(q), *_tma_strides(k), *_tma_strides(v), 1.0 / (Dh**0.5),
                int(bool(causal)), window, q_offset, group, head_offset, stream)
        else:
            err = lib.flash_attention_simt_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Skv,
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
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
flash_attention_cuda.launches_by_mode = {}
