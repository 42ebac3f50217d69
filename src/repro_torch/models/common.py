"""Shared model substrate: schema-based params, norms, RoPE, the embedding
gather — the port of the reference's ``models/common.py``.

Parameters are declared as a *schema* (nested dict of :class:`ParamSpec`)
that drives initialization. The logical axis names are kept from the
reference (they name what each dim is); the sharding hooks that map them to
a device mesh belong to ``launch/`` and wait for the multi-GPU slice.

Randomness comes from an explicit ``torch.Generator``: every leaf draws
from its own stream, seeded from the generator's seed and the leaf's path,
so a leaf's values do not depend on which other leaves the schema holds.
Torch cannot reproduce ``jax.random``: to start from the reference's
weights, convert them (:func:`repro_torch.convert.lm_params_from_numpy`).
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.kernels import ops as kops

Params = Any  # nested dict of tensors


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # stddev; default 1/sqrt(shape[fan_axis])
    fan_axis: int = 0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")


def _leaf_seed(seed: int, path: tuple[str, ...]) -> int:
    digest = hashlib.sha256(f"{seed}/{'/'.join(path)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def init_params(schema: dict, generator: torch.Generator) -> Params:
    """Materialize a schema into tensors on ``generator``'s device: normal
    leaves are drawn in fp32 with their leaf's own generator, scaled, then
    cast to the spec's dtype."""
    device = generator.device
    seed = generator.initial_seed()

    def go(node, path):
        if isinstance(node, ParamSpec):
            if node.init == "zeros":
                return torch.zeros(node.shape, dtype=node.dtype, device=device)
            if node.init == "ones":
                return torch.ones(node.shape, dtype=node.dtype, device=device)
            g = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
            fan = node.shape[node.fan_axis] if node.shape else 1
            scale = node.scale if node.scale is not None else 1.0 / math.sqrt(max(1, fan))
            x = torch.randn(node.shape, generator=g, dtype=torch.float32, device=device)
            return x.mul_(scale).to(node.dtype)
        return {k: go(v, path + (k,)) for k, v in node.items()}

    return go(schema, ())


def param_count(schema: dict) -> int:
    total = 0

    def go(node):
        nonlocal total
        if isinstance(node, ParamSpec):
            total += math.prod(node.shape) if node.shape else 1
        else:
            for v in node.values():
                go(v)

    go(schema)
    return total


# --------------------------------------------------------------------------
# normalization / activations / RoPE
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


def mlp_activation(kind: str, h: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's activations, spelled op by op as ``jax.nn`` writes
    them, each op rounded to the input's dtype and each constant too (jnp's
    weak typing): in bf16 this equals the reference bit for bit, where
    torch's fused ``silu``/``gelu`` round once and differ in the last bit of
    about 40% of the values."""
    if kind == "swiglu":  # silu(gate) * h, silu(x) = x * sigmoid(x)
        if gate is None:
            raise ValueError("swiglu needs the gate projection")
        return gate * (1 / (1 + torch.exp(-gate))) * h
    if kind == "squared_relu":
        r = torch.relu(h)
        return r * r
    if kind == "gelu":  # jax.nn.gelu's default: the tanh approximation
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=h.dtype, device=h.device)
        k = torch.tensor(0.044715, dtype=h.dtype, device=h.device)
        return h * (0.5 * (1.0 + torch.tanh(c * (h + k * (h * h * h)))))
    raise ValueError(kind)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotate-half RoPE, fp32. positions: [...,] int."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exponent)
    angles = positions.float()[..., None] * freqs  # [..., half]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, S, Dh]; cos/sin: [S, Dh/2] (or broadcastable). fp32 math,
    cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    c, s = cos[None, None].float(), sin[None, None].float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1).to(x.dtype)


def embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for int ids of any shape -> [*ids.shape, D]: the
    ``embedding_lookup`` kernel on the card, its plain version on the CPU —
    bit for bit the same."""
    flat = kops.embedding_lookup(table, ids.reshape(-1))
    return flat.reshape(*ids.shape, table.shape[-1])
