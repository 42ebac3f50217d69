"""The paper's CTR prediction network (Figure 1) + the LR baseline, in PyTorch.

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

Heterogeneous embedding widths (``CTRConfig.slot_groups``): each slot
group is backed by its own named PS table (its own working table at its
own ``emb_dim``); ``forward_grouped`` pools every group at its native
width and concatenates into the tower.
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


def init_tower(cfg: CTRConfig, generator: torch.Generator, device="cuda") -> dict[str, torch.Tensor]:
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


# --------------------------------------------------------------------------
# heterogeneous slot groups: one working table per group, own emb width
# --------------------------------------------------------------------------


def forward_grouped(cfg: CTRConfig, tower, tables: dict, inputs: dict) -> torch.Tensor:
    """Multi-table forward: ``tables[g.name]`` is that group's working
    table [n_working_g, emb_g]; ``inputs[g.name]`` holds the group's padded
    sparse triple ``{"slot_ids", "slot_of", "valid"}`` (slot_of indexes
    *within* the group). Pools each group at its native width, concatenates
    across groups, then runs the shared tower. Returns CTR logits [B]."""
    pooled = []
    for g in cfg.groups:
        inp = inputs[g.name]
        pooled.append(
            embed_pool(tables[g.name], inp["slot_ids"], inp["slot_of"], inp["valid"], g.n_slots)
        )
    return _tower_mlp(tower, torch.cat(pooled, dim=-1))


def loss_fn_grouped(cfg, tower, tables: dict, inputs: dict, labels) -> torch.Tensor:
    """Mean BCE-with-logits over the grouped forward."""
    return _bce_with_logits(forward_grouped(cfg, tower, tables, inputs), labels)


# --------------------------------------------------------------------------
# LR baseline (Tables 1-2): one weight per sparse feature, same PS machinery
# --------------------------------------------------------------------------


def lr_forward(working_table: torch.Tensor, slot_ids: torch.Tensor, valid: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """working_table: [n_working, 1] per-feature weights. Returns logits [B].

    An embedding bag with one slot of width 1: the pooled [B, 1, 1] sum of
    active feature weights is the linear score. The reference forces its
    segment-sum path here (width-1 rows are scalar DMAs on the TPU's grid);
    on the card the bag kernel takes D = 1 like any other width."""
    pooled = kops.embedding_bag(working_table, slot_ids, torch.zeros_like(slot_ids), valid, 1)
    return pooled[:, 0, 0] + bias


def lr_loss_fn(working_table, slot_ids, valid, labels, bias) -> torch.Tensor:
    return _bce_with_logits(lr_forward(working_table, slot_ids, valid, bias), labels)
