"""Streaming feature extraction, raw ids -> (keys, slot_of): the CUDA
kernels' wrapper (``csrc/feature_extract.cu``, replacing the reference's
``feature_extract_pallas``), their reciprocals and the plain PyTorch
version.

Two variants: ``"recip"`` (the path) takes each modulo as a multiply by a
reciprocal that :func:`umod_magic` computes here, four positions a thread;
``"div"``, the first port's kernel with a runtime ``%``, by name only, to be
timed beside it. :func:`umod_model` is the recip kernel's modulo in Python
integers, for the tests.

Contract (the host feeder's ``data.synthetic_ctr.extract_host``, bit for
bit): ``key = splitmix64(raw ^ key_seed) % n_keys``, ``slot =
splitmix64(key ^ slot_seed) % n_slots`` over the finished key, and key 0 /
slot 0 wherever ``valid`` is false.

u64 values travel as int64 tensors holding the bit pattern: the raw ids in,
the keys out (``tensor.numpy().view(np.uint64)`` reads them back). PyTorch's
unsigned dtypes lack shifts, ``%`` and ``where``, so the plain version spells
u64 arithmetic on int64: addition, multiplication and xor wrap as u64 does,
a logical right shift masks after torch's arithmetic ``>>``, and ``%`` of a
value with the top bit set splits off that bit (``2^63 % m`` is a constant).

Domain, checked by both versions (``ValueError``): ``0 < n_keys <= 2^63``
(the reference's ``mod_pair_wide`` range), ``0 < n_slots < 2^31`` (slots
are int32; the reference would turn slots past 2^31 negative), seeds in
``[0, 2^64)``, raw int64 and valid of one shape on one device. An empty
input returns empty outputs without a launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_LOW63 = (1 << 63) - 1
_MAX_BLOCKS = 132 * 16  # grid-stride loop: a few waves of blocks on each SM
_U64 = (1 << 64) - 1
VARIANTS = ("recip", "div")


def _s64(c: int) -> int:
    """The int64 whose bit pattern is the u64 ``c``."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64_plain(z: torch.Tensor) -> torch.Tensor:
    """``core.keys.splitmix64`` on u64 bits held in int64."""
    z = z + _s64(_GOLDEN)
    z = (z ^ _lsr(z, 30)) * _s64(_MIX1)
    z = (z ^ _lsr(z, 27)) * _s64(_MIX2)
    return z ^ _lsr(z, 31)


def umod_plain(z: torch.Tensor, m: int) -> torch.Tensor:
    """``u64(z) % m`` for ``0 < m <= 2^63``, as int64 in ``[0, m)``."""
    if m & (m - 1) == 0:
        return z & (m - 1)
    r = (z & _LOW63) % m  # the low 63 bits: non-negative, exact
    t = r - (m - (1 << 63) % m)  # r + 2^63 % m - m, in (-m, m)
    return torch.where(z < 0, torch.where(t >= 0, t, t + m), r)


def umod_magic(d: int) -> tuple[int, int]:
    """The recip kernel's reciprocal of a modulus ``1 <= d < 2^64``: (m, s)
    with ``m = floor(2^64 (2^l - d) / d) + 1``, ``l = ceil(log2 d)``, ``s = l
    - 1`` (Granlund and Montgomery's round-up multiplier; ``m < 2^64``), or
    (0, 0) for a power of two, which the kernel masks."""
    if not 0 < d < 1 << 64:
        raise ValueError(f"modulus must be in [1, 2^64), got {d}")
    if d & (d - 1) == 0:
        return 0, 0
    l = (d - 1).bit_length()
    return ((1 << 64) * ((1 << l) - d)) // d + 1, l - 1


def umod_model(n: int, d: int, m: int, s: int) -> int:
    """``n % d`` for a u64 ``n`` as the recip kernel computes it from
    :func:`umod_magic`'s (m, s): ``t = umulhi(n, m)``, ``q = (t + ((n - t) >>
    1)) >> s``, ``n - q d``; a mask where m is 0."""
    if m == 0:
        return n & (d - 1)
    t = (n * m) >> 64
    q = (t + ((n - t) >> 1)) >> s
    return (n - q * d) & _U64


def check_args(raw: torch.Tensor, valid: torch.Tensor, n_keys: int, n_slots: int,
               key_seed: int, slot_seed: int) -> None:
    """Raise ``ValueError`` on anything outside the contract."""
    if not 0 < n_keys <= 1 << 63:
        raise ValueError(f"n_keys must be in (0, 2^63], got {n_keys}")
    if not 0 < n_slots < 1 << 31:
        raise ValueError(f"n_slots must be in (0, 2^31) for int32 slots, got {n_slots}")
    for name, s in (("key_seed", key_seed), ("slot_seed", slot_seed)):
        if not 0 <= s < 1 << 64:
            raise ValueError(f"{name} must be in [0, 2^64), got {s}")
    if raw.dtype != torch.int64:
        raise ValueError(f"raw must be int64 (u64 bit patterns), got {raw.dtype}")
    if valid.shape != raw.shape or valid.device != raw.device:
        raise ValueError(f"valid {tuple(valid.shape)} on {valid.device} must match raw "
                         f"{tuple(raw.shape)} on {raw.device}")


def feature_extract_plain(raw: torch.Tensor, valid: torch.Tensor, *, n_keys: int,
                          n_slots: int, key_seed: int, slot_seed: int):
    """The plain version: -> (keys int64 [u64 bits], slot_of int32)."""
    check_args(raw, valid, n_keys, n_slots, key_seed, slot_seed)
    live = valid if valid.dtype == torch.bool else valid != 0
    key = umod_plain(splitmix64_plain(raw ^ _s64(key_seed)), n_keys)
    slot = umod_plain(splitmix64_plain(key ^ _s64(slot_seed)), n_slots)
    zero = torch.zeros((), dtype=torch.int64, device=raw.device)
    return torch.where(live, key, zero), torch.where(live, slot, zero).to(torch.int32)


def _lib():
    lib = build.library("feature_extract")
    p, u64, i = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    lib.feature_extract_launch.argtypes = [p, p, p, p, ctypes.c_longlong, u64, u64, i, u64, u64,
                                           i, u64, u64, i, i, i, p]
    lib.feature_extract_launch.restype = i
    lib.feature_extract_error_string.argtypes = [i]
    lib.feature_extract_error_string.restype = ctypes.c_char_p
    return lib


def feature_extract_cuda(raw: torch.Tensor, valid: torch.Tensor, *, n_keys: int,
                         n_slots: int, key_seed: int, slot_seed: int,
                         variant: str = "recip"):
    """Launch the kernel (``variant`` "recip", the path, or "div") on
    contiguous int64 ``raw`` and bool ``valid``: -> (keys int64 [u64 bits],
    slot_of int32) of their shape."""
    if not raw.is_cuda:
        raise ValueError(f"raw must be a CUDA tensor, got {raw.device}")
    check_args(raw, valid, n_keys, n_slots, key_seed, slot_seed)
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool, got {valid.dtype}")
    if not (raw.is_contiguous() and valid.is_contiguous()):
        raise ValueError("raw and valid must be contiguous")
    if variant not in VARIANTS:
        raise ValueError(f"unknown feature_extract variant {variant!r}; one of {VARIANTS}")
    keys = torch.empty_like(raw)
    slots = torch.empty(raw.shape, dtype=torch.int32, device=raw.device)
    if raw.numel() == 0:
        return keys, slots
    (key_m, key_s), (slot_m, slot_s) = umod_magic(n_keys), umod_magic(n_slots)
    lib = _lib()
    with torch.cuda.device(raw.device):
        err = lib.feature_extract_launch(
            raw.data_ptr(), valid.data_ptr(), keys.data_ptr(), slots.data_ptr(), raw.numel(),
            n_keys, key_m, key_s, n_slots, slot_m, slot_s, key_seed, slot_seed,
            VARIANTS.index(variant), int(valid.data_ptr() % 4 == 0), _MAX_BLOCKS,
            torch.cuda.current_stream(raw.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"feature_extract {variant} kernel launch failed: "
            f"{lib.feature_extract_error_string(err).decode()}"
        )
    feature_extract_cuda.launches += 1
    feature_extract_cuda.launches_by_variant[variant] += 1
    return keys, slots


feature_extract_cuda.launches = 0
feature_extract_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
