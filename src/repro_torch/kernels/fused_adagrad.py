"""Fused row-Adagrad, ``a' = a + g*g``, ``p' = p - lr*g / (sqrt(a') + eps)``:
the CUDA kernel's wrapper (``csrc/fused_adagrad.cu``, replacing the
reference's ``adagrad_pallas``) and its plain PyTorch version.

Both return new ``(params, accum)`` and equal the reference's
``adagrad_ref`` bit for bit: fp32, every operation rounded once, sqrt and
division correctly rounded, no fused multiply-add. One flat pass over any
shape: the reference's ``[rows, 128]`` repack exists only for the TPU's
tiling.

The wrapper checks what it is given and raises on anything the kernel does
not take (contiguous fp32 tensors of one shape), allocates the outputs,
launches on PyTorch's current stream and counts its launches in
``adagrad_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import adagrad_ref

_MAX_BLOCKS = 132 * 16  # grid-stride loops: a few waves of blocks on each SM


def adagrad_plain(params, accum, grads, lr: float, eps: float = 1e-8):
    """The plain version: the oracle, one PyTorch op per rounding."""
    return adagrad_ref(params, accum, grads, lr, eps)


def _lib():
    lib = build.library("fused_adagrad")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_adagrad_launch.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_float,
                                         ctypes.c_float, i, i, p]
    lib.fused_adagrad_launch.restype = i
    lib.fused_adagrad_error_string.argtypes = [i]
    lib.fused_adagrad_error_string.restype = ctypes.c_char_p
    return lib


def adagrad_cuda(params: torch.Tensor, accum: torch.Tensor, grads: torch.Tensor,
                 lr: float, eps: float = 1e-8):
    """Launch the kernel: -> new (params, accum), fp32, of the inputs' shape."""
    if not params.is_cuda:
        raise ValueError(f"params must be a CUDA tensor, got {params.device}")
    for name, t in (("params", params), ("accum", accum), ("grads", grads)):
        if t.device != params.device:
            raise ValueError(f"{name} on {t.device}, params on {params.device}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != params.shape:
            raise ValueError(
                f"{name} must be a contiguous float32 tensor of shape {tuple(params.shape)}, "
                f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    new_params = torch.empty_like(params)
    new_accum = torch.empty_like(accum)
    n = params.numel()
    if n == 0:
        return new_params, new_accum
    ptrs = (params.data_ptr(), accum.data_ptr(), grads.data_ptr(),
            new_params.data_ptr(), new_accum.data_ptr())
    vec4 = int(all(p % 16 == 0 for p in ptrs))
    lib = _lib()
    with torch.cuda.device(params.device):
        err = lib.fused_adagrad_launch(
            *ptrs, n, float(lr), float(eps), vec4, _MAX_BLOCKS,
            torch.cuda.current_stream(params.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"fused_adagrad kernel launch failed: {lib.fused_adagrad_error_string(err).decode()}"
        )
    adagrad_cuda.launches += 1
    return new_params, new_accum


adagrad_cuda.launches = 0
