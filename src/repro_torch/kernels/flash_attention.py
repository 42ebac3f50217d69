"""Blockwise (flash) attention forward with GQA and causal/sliding-window
masks: the CUDA kernel's wrapper (``csrc/flash_attention.cu``, replacing
the reference's ``flash_attention_pallas``) and its plain PyTorch version.

Both keep the reference kernel's semantics: query row ``i`` sits at absolute
position ``q_offset + i``; a key is kept where it is causal-visible and
inside the window; masked scores are the finite ``NEG_INF`` and their
probabilities are zeroed, and a row that keeps no key is 0. The math is
fp32; the output has ``q``'s dtype. Unlike the reference, ``Sq`` and ``Skv``
need not be multiples of a tile.

The wrapper checks what it is given and raises on anything the kernel does
not take (fp32 or bf16, one dtype for q, k and v, ``Dh <= 256``, unit stride
over ``Dh``), allocates the output, launches on PyTorch's current stream and
counts its launches in ``flash_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """The plain version: the kernel's function as one KV block, in fp32,
    with the same masks and the same ``NEG_INF`` semantics. GQA groups the
    ``H / Hkv`` query heads of a KV head instead of repeating K and V."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
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


def _lib():
    lib = build.library("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                           ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                           ctypes.c_float, i, i, i, i, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel: q [B, H, Sq, Dh], k and v [B, Hkv, Skv, Dh] (any
    strides over the first three dims, unit stride over Dh) -> o [B, H, Sq,
    Dh] contiguous, q's dtype."""
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
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} outside [1, {MAX_HEAD_DIM}]")
    window, q_offset = int(window), int(q_offset)
    if (H > 65535 or B > 65535 or Skv >= 2**30 or abs(q_offset) + Sq >= 2**30
            or abs(window) >= 2**30):  # positions minus the window stay in int32
        raise ValueError(f"shape too large for the kernel: B={B}, H={H}, Sq={Sq}, Skv={Skv}, "
                         f"q_offset={q_offset}, window={window}")
    out = torch.empty((B, H, Sq, Dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Skv, Dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1.0 / (Dh**0.5),
            int(bool(causal)), window, q_offset, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
