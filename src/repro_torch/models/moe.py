"""Mixture-of-Experts block: top-k routing with capacity-based dispatch — the
port of the reference's ``models/moe.py``.

Dispatch is scatter-based (GShard/Switch style): every (token, k) assignment
gets a position inside its expert's capacity buffer via a cumulative count;
overflow assignments are dropped (their combine weight is zero). The
reference dispatches into the whole capacity buffer [E, G*C, d] and runs an
einsum ``ecd,edf->ecf`` over it, empty rows included. The port computes the
same function on a compacted buffer: each kept assignment gets a row
(``Routing.row``) in an expert-major buffer of ``min(T*k, E*G*C)`` rows
that holds only the kept rows, in the capacity buffer's (expert, group,
position) order, ``Routing.expert_rows[e]`` rows for expert ``e``. Each
expert product is then one grouped matmul over the live rows, ``ops.gmm``
(the ``moe_gmm`` kernel on the card), with one tile plan per layer for its
two or three products. :func:`run_experts` takes either layout, so the
reference's (``Routing.slot``, ``G*C`` rows per expert) stays callable for
comparisons.

FLOP note: with capacity_factor f, compute is f * (top_k / E) of the dense
equivalent of E experts.

Tensor parallelism over ``model`` (``common.set_model_group``) places the
experts where the reference's rules do, read from ``wi``'s local shape.
Where the axis divides ``n_experts``, rank r holds experts ``[r*E/M,
(r+1)*E/M)``: its compacted buffer is the contiguous slice of the kept
rows that belong to its experts, its products run over its
``expert_rows`` only, and each token sums its local assignments. Where it
does not and divides ``d_ff``, the rules put ``model`` inside each
expert's ``mlp``: every rank holds every expert's 1/M of the columns of
``wi`` (and ``wg``) and of the rows of ``wo``, and runs the whole buffer
through them. Either way routing runs replicated (it is deterministic, so
every rank routes alike) and the ranks' partial outputs are summed over the
group. Where the axis divides neither, every expert leaf is whole and the
block runs whole on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.moe_gmm import TILE_ROWS, gmm_tiles
from repro_torch.models.common import (
    ParamSpec,
    copy_to_model,
    local_range,
    mlp_activation,
    reduce_from_model,
)


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
    row: torch.Tensor  # [T*k] int64 row of the compacted buffer; n_rows where dropped
    expert_rows: torch.Tensor  # [E] int32 kept assignments of each expert

    @property
    def n_rows(self) -> int:
        """Rows of the compacted buffer: ``min(T*k, E*G*C)``, enough for
        every kept assignment."""
        return min(self.row.shape[0], self.expert_rows.shape[0] * self.groups * self.capacity)


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

    # the compacted buffer: the capacity buffer's kept rows in its (expert,
    # group, position) order, counted on the device (no host sync)
    kept = (pos[:, -1, :] + 1).clamp(max=C)  # [G, E] kept rows per (group, expert)
    expert_rows = kept.sum(dim=0)  # [E]
    expert_start = torch.cumsum(expert_rows, 0) - expert_rows
    group_start = torch.cumsum(kept, 0) - kept  # rows of earlier groups, per expert
    n_rows = min(T * k, E * G * C)
    row = torch.where(keep, expert_start[flat_e] + group_start[gidx, flat_e] + pos_of, n_rows)
    return Routing(top_p, top_i, slot, keep, aux, G, C, row, expert_rows.to(torch.int32))


def local_rows(r: Routing, lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor, int,
                                                       torch.Tensor]:
    """The compacted buffer's part for experts [lo, hi): (each assignment's
    row in it, ``n_rows`` where dropped or another expert's; whether the
    assignment is kept here; the rows it holds room for, ``min(T*k,
    (hi-lo)*G*C)``; ``expert_rows[lo:hi]``)."""
    n_rows = min(r.row.shape[0], (hi - lo) * r.groups * r.capacity)
    start = torch.sum(r.expert_rows[:lo].to(torch.int64))  # the buffer's rows before expert lo
    flat_e = r.top_i.reshape(-1)
    here = r.keep & (flat_e >= lo) & (flat_e < hi)
    return torch.where(here, r.row - start, n_rows), here, n_rows, r.expert_rows[lo:hi]


def run_experts(xf: torch.Tensor, p: dict, cfg: ArchConfig, r: Routing, index: torch.Tensor,
                n_rows: int, group_sizes: torch.Tensor, keep: torch.Tensor | None = None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dispatch, expert products and combine for tokens ``xf`` [T, d] routed
    by ``r``: each kept assignment goes to row ``index`` of an [n_rows, d]
    buffer grouped by expert (``group_sizes[e]`` rows for expert ``e``; a
    dropped assignment's index is ``n_rows``), the layer's two or three
    ``ops.gmm`` products share one tile plan, and each token sums the rows
    of its assignments in ``keep`` (default ``r.keep``) weighted by
    ``r.top_p`` in fp32 -> [T, d] in ``dtype`` (default xf's). The port's
    layout is (``r.row``,
    ``r.n_rows``, ``r.expert_rows``), or :func:`local_rows` for a rank's
    experts; the reference's is (``r.slot``, ``E*G*C``, ``[G*C] * E``)."""
    T, d = xf.shape
    k = r.top_i.shape[1]
    keep = r.keep if keep is None else keep
    xe = xf.repeat_interleave(k, dim=0).to(DISPATCH_DTYPE)  # [T*k, d]
    buf = torch.zeros((n_rows + 1, d), dtype=DISPATCH_DTYPE, device=xf.device)
    buf[index] = xe  # kept rows are distinct; every drop lands on the sentinel row
    buf = buf[:n_rows].to(xf.dtype)  # grouped by expert

    tiles = gmm_tiles(group_sizes, n_rows, TILE_ROWS[buf.dtype]) if buf.dtype in TILE_ROWS else None
    h = kops.gmm(buf, p["wi"], group_sizes, tiles=tiles)
    if cfg.mlp_act == "swiglu":
        h = mlp_activation("swiglu", h, kops.gmm(buf, p["wg"], group_sizes, tiles=tiles))
    else:
        h = mlp_activation(cfg.mlp_act, h)
    y = kops.gmm(h, p["wo"], group_sizes, tiles=tiles)  # [n_rows, d]

    # gather back to (token, k) order and combine with routing weights
    y_flat = y.to(DISPATCH_DTYPE)
    y_tok = torch.where(keep[:, None], y_flat[index.clamp(max=n_rows - 1)],
                        torch.zeros((), dtype=DISPATCH_DTYPE, device=xf.device))
    y_tok = y_tok.reshape(T, k, d)
    return torch.einsum("tkd,tk->td", y_tok.float(), r.top_p).to(dtype or xf.dtype)


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
    xf = x.reshape(B * S, d)
    r = route(xf, p["router"], cfg, capacity=capacity, groups=groups)
    lo, hi = local_range(cfg.n_experts, p["wi"].shape[0])  # this rank's experts
    if hi - lo == cfg.n_experts and p["wi"].shape[-1] == cfg.d_ff:  # every leaf whole
        return run_experts(xf, p, cfg, r, r.row, r.n_rows, r.expert_rows).reshape(B, S, d), r.aux
    # reference :100-110, the buffers on "experts_act": the local experts'
    # rows (every expert's, where this rank holds its columns of each
    # expert's d_ff). The router's gradient sums every rank's combine term
    # through top_p's copy; the replicated aux loss reaches it once.
    index, keep, n_rows, sizes = local_rows(r, lo, hi)
    r_local = r._replace(top_p=copy_to_model(r.top_p))
    out = run_experts(copy_to_model(xf), p, cfg, r_local, index, n_rows, sizes, keep=keep,
                      dtype=torch.float32)
    return reduce_from_model(out).to(x.dtype).reshape(B, S, d), r.aux
