"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which ``ctypes`` loads; nothing includes
PyTorch's headers, so a build takes seconds. The libraries go to
``build/repro_torch/`` at the root of the checkout, named by a hash of their
source, and are built at first use: every missing one at once, one ``nvcc``
per source, all started together. A failed build raises with the compiler's
output; there is no fallback. :func:`refuse_grad` is the guard of the raw
wrappers whose kernels are differentiated in ``kernels.ops``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("topk_mips", "embedding_bag", "scatter_add", "fused_adagrad", "feature_extract",
           "embedding_lookup", "flash_attention", "moe_gmm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns seconds spent per compiled source (empty when all were built).
    The compiler's register/shared-memory report lands beside each library
    as ``<name>-<hash>.log``."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    secs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where autograd would need ``kernel``'s backward from its raw
    wrapper: grad mode on and a floating input that requires grad. The kernel
    writes through a raw pointer, so its output would come back without a
    ``grad_fn`` and the gradient would be lost silently. The differentiable
    entry points are in ``kernels.ops``."""
    if torch.is_grad_enabled() and any(t.is_floating_point() and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"the raw {kernel} wrapper has no backward: call the differentiable op in "
            f"repro_torch.kernels.ops, or this wrapper under torch.no_grad() or with inputs "
            f"that do not require grad")


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
