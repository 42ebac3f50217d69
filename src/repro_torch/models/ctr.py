"""The paper's CTR prediction network (Figure 1), in PyTorch.

Sparse one/multi-hot features -> embedding rows (through the hierarchical
PS working table) -> per-slot sum pooling -> fully-connected tower ->
sigmoid CTR. The embedding rows are the "sparse parameters" managed by
HBM/MEM/SSD-PS; the tower is the small dense part kept on the device.

The tower is a dict of leaf tensors ``w{i}`` [in, out] and ``b{i}`` [out],
named as the reference's pytree, so ``convert.tower_from_numpy`` is a plain
copy. Inputs are padded sparse rows:
  slot_ids  int [B, nnz]  — working-slot ids (renumbered keys)
  slot_of   int [B, nnz]  — which feature slot each nonzero belongs to
  valid     bool [B, nnz]
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.ctr_models import CTRConfig
from repro_torch.kernels import ops as kops


def tower_schema(cfg: CTRConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """Leaf name -> (shape, init): weights "normal" (scaled by 1/sqrt of
    their fan-in, the first axis), biases "zeros"."""
    dims = (cfg.pooled_dim,) + tuple(cfg.mlp_hidden) + (1,)
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = ((a, b), "normal")
        out[f"b{i}"] = ((b,), "zeros")
    return out


def init_tower(cfg: CTRConfig, generator: torch.Generator, device="cpu") -> dict[str, torch.Tensor]:
    """Draw the tower from ``generator`` (a CPU generator, so one seed gives
    the same weights on any device): normal x 1/sqrt(fan_in), biases zero.
    Torch's generator cannot reproduce ``jax.random``; to start from the
    reference's weights, convert them (``convert.tower_from_numpy``)."""
    tower = {}
    for name, (shape, init) in tower_schema(cfg).items():
        if init == "zeros":
            t = torch.zeros(shape, dtype=torch.float32)
        else:
            t = torch.randn(shape, generator=generator, dtype=torch.float32)
            t = t * (1.0 / math.sqrt(max(1, shape[0])))
        tower[name] = t.to(device)
    return tower


def embed_pool(
    working_table: torch.Tensor,  # [n_working, emb_dim]
    slot_ids: torch.Tensor,  # [B, nnz]
    slot_of: torch.Tensor,  # [B, nnz]
    valid: torch.Tensor,  # [B, nnz]
    n_slots: int,
) -> torch.Tensor:
    """Sum-pool embedding rows into per-slot buckets -> [B, n_slots*emb]:
    one fused embedding-bag op, whose backward goes through ``scatter_add``."""
    B = slot_ids.shape[0]
    pooled = kops.embedding_bag(working_table, slot_ids, slot_of, valid, n_slots)
    return pooled.reshape(B, -1)


def _tower_mlp(tower: dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """The fully-connected tower: pooled features -> logits [B]."""
    n = len([k for k in tower if k.startswith("w")])
    for i in range(n):
        h = h @ tower[f"w{i}"] + tower[f"b{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return h[:, 0]


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable mean binary cross-entropy."""
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def forward(cfg: CTRConfig, tower, working_table, slot_ids, slot_of, valid) -> torch.Tensor:
    """Returns CTR logits [B]."""
    return _tower_mlp(tower, embed_pool(working_table, slot_ids, slot_of, valid, cfg.n_slots))


def loss_fn(cfg, tower, working_table, slot_ids, slot_of, valid, labels) -> torch.Tensor:
    """Mean BCE-with-logits."""
    return _bce_with_logits(forward(cfg, tower, working_table, slot_ids, slot_of, valid), labels)
