"""Mixture-of-Experts block: top-k routing with capacity-based dispatch — the
port of the reference's ``models/moe.py``.

Dispatch is scatter-based (GShard/Switch style): every (token, k) assignment
gets a position inside its expert's capacity buffer via a cumulative count;
overflow assignments are dropped (their combine weight is zero). The
capacity buffer [E, G*C, d] is grouped by expert into E contiguous groups of
G*C rows, so each expert product is one grouped matmul, ``ops.gmm`` with
``group_sizes = [G*C] * E`` (the ``moe_gmm`` kernel on the card), where the
reference writes an einsum ``ecd,edf->ecf``.

FLOP note: with capacity_factor f, compute is f * (top_k / E) of the dense
equivalent of E experts. The reference shards E over its mesh's ``model``
axis; the port runs on one card (multi-GPU is a later slice).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, mlp_activation


def moe_schema(cfg: ArchConfig, layers: int | None = None) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = cfg.n_layers if layers is None else layers
    stack = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    fan = len(stack) + 1
    schema = {
        "router": ParamSpec(stack + (d, E), lax_ + ("embed", None), fan_axis=len(stack)),
        "wi": ParamSpec(stack + (E, d, ff), lax_ + ("experts", "embed", "mlp"), fan_axis=fan),
        "wo": ParamSpec(stack + (E, ff, d), lax_ + ("experts", "mlp", "embed"), fan_axis=fan),
    }
    if cfg.mlp_act == "swiglu":
        schema["wg"] = ParamSpec(stack + (E, d, ff), lax_ + ("experts", "embed", "mlp"),
                                 fan_axis=fan)
    return schema


def expert_capacity(cfg: ArchConfig, n_tokens: int, groups: int = 1) -> int:
    cap = int(n_tokens / groups * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (cap + 7) // 8 * 8)  # the reference pads to a multiple of 8


# Dispatch groups for local-capacity routing: positions are computed within
# each of G token groups (the reference's data shards), so each group has its
# own capacity C per expert. 0 = one global group.
DISPATCH_GROUPS = 32
DISPATCH_DTYPE = torch.bfloat16


class Routing(NamedTuple):
    top_p: torch.Tensor  # [T, k] fp32 routing weights, renormalised
    top_i: torch.Tensor  # [T, k] expert of each assignment
    slot: torch.Tensor  # [T*k] row of the capacity buffer; E*G*C where dropped
    keep: torch.Tensor  # [T*k] bool: the assignment fits its expert's capacity
    aux: torch.Tensor  # scalar fp32: the Switch load-balancing loss
    groups: int  # G
    capacity: int  # C


def route(xf: torch.Tensor, router: torch.Tensor, cfg: ArchConfig, *,
          capacity: int | None = None, groups: int | None = None) -> Routing:
    """The router of :func:`moe_block` for tokens ``xf`` [T, d]: fp32 logits
    and softmax, top-k renormalised, the aux loss, and each assignment's
    group-local capacity slot, token-major."""
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    G = groups if groups is not None else (DISPATCH_GROUPS or 1)
    while T % G:
        G //= 2
    G = max(1, G)
    C = capacity if capacity is not None else expert_capacity(cfg, T, G)

    logits = xf.float() @ router.float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower expert first among equal
    # probabilities, as jax.lax.top_k does (torch.topk gives no such order)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]  # [T, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalize

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    density = F.one_hot(top_i[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(density * probs.mean(dim=0))

    # position of each (token, k) inside its expert's per-group capacity
    # slice: ranks reset at group boundaries so dispatch is group-local
    flat_e = top_i.reshape(-1)  # [T*k], token-major
    Tg = T * k // G
    onehot = F.one_hot(flat_e.reshape(G, Tg), E)  # [G, Tg, E]
    pos = torch.cumsum(onehot, dim=1) - 1  # running count per (group, expert)
    pos_of = torch.gather(pos, 2, flat_e.reshape(G, Tg, 1))[..., 0].reshape(-1)
    keep = pos_of < C
    gidx = torch.arange(G, device=xf.device).repeat_interleave(Tg)
    slot = torch.where(keep, flat_e * (G * C) + gidx * C + pos_of, E * G * C)
    return Routing(top_p, top_i, slot, keep, aux, G, C)


def moe_block(
    x: torch.Tensor,  # [B, S, d]
    p: dict,  # one layer's {router, wi[, wg], wo}
    cfg: ArchConfig,
    *,
    capacity: int | None = None,
    groups: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, d], aux_loss scalar: load-balancing loss)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, d)
    r = route(xf, p["router"], cfg, capacity=capacity, groups=groups)
    rows = E * r.groups * r.capacity

    xe = xf.repeat_interleave(k, dim=0).to(DISPATCH_DTYPE)  # [T*k, d]
    buf = torch.zeros((rows + 1, d), dtype=DISPATCH_DTYPE, device=x.device)
    buf[r.slot] = xe  # kept slots are distinct; every drop lands on the sentinel row
    buf = buf[:rows].to(xf.dtype)  # [E * G*C, d], grouped by expert

    group_sizes = torch.full((E,), r.groups * r.capacity, dtype=torch.int32, device=x.device)
    h = kops.gmm(buf, p["wi"], group_sizes)
    if cfg.mlp_act == "swiglu":
        h = mlp_activation("swiglu", h, kops.gmm(buf, p["wg"], group_sizes))
    else:
        h = mlp_activation(cfg.mlp_act, h)
    y = kops.gmm(h, p["wo"], group_sizes)  # [E * G*C, d]

    # gather back to (token, k) order and combine with routing weights
    y_flat = y.to(DISPATCH_DTYPE)
    y_tok = torch.where(r.keep[:, None], y_flat[r.slot.clamp(max=rows - 1)],
                        torch.zeros((), dtype=DISPATCH_DTYPE, device=x.device))
    y_tok = y_tok.reshape(T, k, d)
    out = torch.einsum("tkd,tk->td", y_tok.float(), r.top_p).to(x.dtype)
    return out.reshape(B, S, d), r.aux
