"""Shared model substrate: schema-based params, norms, RoPE, the embedding
gather — the port of the reference's ``models/common.py``.

Parameters are declared as a *schema* (nested dict of :class:`ParamSpec`)
that drives initialization and, through :func:`logical_specs`, the
launcher's sharding rules (``launch/sharding.py`` maps the logical axis
names to mesh axes). The sharding hooks are the reference's: the launcher
installs a gradient reduction as the ``constrain_like_params`` hook and its
row gather as the ``embed_gather`` hook; with none installed each is the
identity or today's kernel call.

Tensor parallelism over the mesh's ``model`` axis is eager SPMD: the
launcher installs the ``model`` process group (:func:`set_model_group`),
each rank holds its local shards of the weights the rules put on
``model``, and the models move activations between "sharded" and
"replicated" with four autograd operators where the reference's
``with_logical_constraint`` lets GSPMD reshard: :func:`copy_to_model`
(entering a column-parallel region), :func:`reduce_from_model` (leaving a
row-parallel one), :func:`gather_from_model` (the embedding's d-slices) and
:func:`gather_over_model` (attention's q heads where the rules cut ``wq``'s
columns inside a head, into and out of the whole heads each rank attends
with). With no group installed each is the identity.

FSDP over the mesh's ``data`` axis (the reference's ``embed`` rule): the
launcher installs the ``data`` group and each leaf's dim cut over it
(:func:`set_data_group`); each rank holds its contiguous 1/D of those
dims, and the models read every layer's (and the top level's) weights
through :func:`gather_weights`, inside each remat region, so a layer's
whole weights live only while it runs: the forward all-gathers them, the
backward reduce-scatters their gradients (summed in fp32) back onto the
shards. With no group installed it is the identity.

Randomness comes from an explicit ``torch.Generator``: every leaf draws
from its own stream, seeded from the generator's seed and the leaf's path,
so a leaf's values do not depend on which other leaves the schema holds.
Torch cannot reproduce ``jax.random``: to start from the reference's
weights, convert them (:func:`repro_torch.convert.lm_params_from_numpy`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch import collectives as coll
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


def stored_as(schema: dict, dtype: torch.dtype, keys) -> dict:
    """``schema`` with the specs under its top-level ``keys`` stored in
    ``dtype`` (a model's ``init`` and ``convert.lm_params_from_numpy`` store
    the leaves that are cast to the compute type at use this way)."""

    def go(node):
        if isinstance(node, ParamSpec):
            return dataclasses.replace(node, dtype=dtype)
        return {k: go(v) for k, v in node.items()}

    return {k: go(v) if k in keys else v for k, v in schema.items()}


def take(tree, i):
    """Entry ``i`` of every leaf of a stacked parameter (sub)tree (views)."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The ``n`` entries of every leaf of a stacked parameter (sub)tree, as
    ``n`` trees of views (``torch.unbind``): a training forward indexes its
    layers this way, so the backward stacks their gradients once instead of
    adding one stack-sized gradient per layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, and where ``enabled`` and autograd is recording, under
    ``torch.utils.checkpoint`` (non-reentrant): nothing inside is kept for
    the backward, which runs ``fn`` again — the reference's
    ``jax.checkpoint(..., policy=nothing_saveable)``. The values are the
    same either way."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def abstract_params(schema: dict) -> Params:
    """The schema's tensors on the ``meta`` device: shapes and dtypes, no
    storage (the reference's ``ShapeDtypeStruct`` tree)."""

    def go(node):
        if isinstance(node, ParamSpec):
            return torch.empty(node.shape, dtype=node.dtype, device="meta")
        return {k: go(v) for k, v in node.items()}

    return go(schema)


def logical_specs(schema: dict) -> Any:
    """Tree of logical-axis tuples matching the schema structure."""

    def go(node):
        if isinstance(node, ParamSpec):
            return node.logical
        return {k: go(v) for k, v in node.items()}

    return go(schema)


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


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each op rounded to x's dtype."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, as ``jax.nn.silu`` spells it."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, op by op; its
    constants in x's dtype."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    op by op (torch's ``F.softplus`` switches to ``x`` above a threshold and
    rounds once)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def mlp_activation(kind: str, h: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's activations, spelled op by op as ``jax.nn`` writes
    them, each op rounded to the input's dtype and each constant too (jnp's
    weak typing): in bf16 this equals the reference bit for bit, where
    torch's fused ``silu``/``gelu`` round once and differ in the last bit of
    about 40% of the values."""
    if kind == "swiglu":  # silu(gate) * h
        if gate is None:
            raise ValueError("swiglu needs the gate projection")
        return silu(gate) * h
    if kind == "squared_relu":
        r = torch.relu(h)
        return r * r
    if kind == "gelu":
        return gelu(h)
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


# --------------------------------------------------------------------------
# sharding hooks (installed by launch/sharding.py)
# --------------------------------------------------------------------------

_LOGICAL_CONSTRAINT_FN = None
_PARAM_CONSTRAINT_FN = None
_EMBED_GATHER_FN = None
_MODEL_GROUP = None
_DATA_GROUP = None
_DATA_DIMS = None


def set_logical_constraint_fn(fn) -> None:
    """Install a fn(x, logical_axes) -> x placing an activation on the mesh
    (``None`` removes it)."""
    global _LOGICAL_CONSTRAINT_FN
    _LOGICAL_CONSTRAINT_FN = fn


def with_logical_constraint(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    if _LOGICAL_CONSTRAINT_FN is None:
        return x
    return _LOGICAL_CONSTRAINT_FN(x, logical)


def set_param_constraint_fn(fn) -> None:
    """Install fn(tree) -> tree, applied by the train step to its summed
    fp32 gradient tree (``None`` removes it). The launcher's reduces the
    gradients over the data-parallel group (``launch/sharding.py``)."""
    global _PARAM_CONSTRAINT_FN
    _PARAM_CONSTRAINT_FN = fn


def constrain_like_params(grads):
    if _PARAM_CONSTRAINT_FN is None:
        return grads
    return _PARAM_CONSTRAINT_FN(grads)


def set_embed_gather_fn(fn) -> None:
    """Install the distributed HBM-PS row gather fn(table, ids) -> rows
    (``None`` restores the kernel call)."""
    global _EMBED_GATHER_FN
    _EMBED_GATHER_FN = fn


def lookup_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``embedding_lookup`` of int ids of any shape -> [*ids.shape, D]."""
    flat = kops.embedding_lookup(table, ids.reshape(-1))
    return flat.reshape(*ids.shape, table.shape[-1])


def embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for int ids of any shape -> [*ids.shape, D]: the
    installed gather, else :func:`lookup_rows` (the ``embedding_lookup``
    kernel on the card, its plain version on the CPU — bit for bit the
    same)."""
    if _EMBED_GATHER_FN is None:
        return lookup_rows(table, ids)
    return _EMBED_GATHER_FN(table, ids)


def set_model_group(group) -> None:
    """Install the ``model`` process group the tensor-parallel operators
    reduce over (``None`` removes it: every operator is the identity)."""
    global _MODEL_GROUP
    _MODEL_GROUP = group


def model_group():
    """The installed ``model`` process group, or ``None``."""
    return _MODEL_GROUP


def model_rank_and_size() -> tuple[int, int]:
    """(this rank's index in the ``model`` group, the group's size); (0, 1)
    with none installed."""
    if _MODEL_GROUP is None:
        return 0, 1
    return coll.get_rank(_MODEL_GROUP), coll.get_world_size(_MODEL_GROUP)


def _all_reduce_fp32(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ``model`` group, taken in fp32 and rounded
    once to ``x``'s dtype (every rank gets the same bits)."""
    y = x.float().contiguous() if x.dtype != torch.float32 else x.clone()
    coll.all_reduce(y, coll.ReduceOp.SUM, group=_MODEL_GROUP)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_fp32(dy)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce_fp32(x)

    @staticmethod
    def backward(ctx, dy):
        return dy


class _GatherFromModel(torch.autograd.Function):
    """The ranks' slices concatenated; the backward keeps this rank's slice
    of the gradient: right where every rank's gradient of the whole is the
    same (the embedding's d-slices, the sLSTM's gate columns, read whole by
    replicated code), not where each rank reads its own part of the whole
    (:func:`gather_over_model`)."""

    @staticmethod
    def forward(ctx, x, dim):
        r, m = model_rank_and_size()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(m)]
        coll.all_gather(parts, x, group=_MODEL_GROUP)
        ctx.dim, ctx.rank, ctx.size = dim, r, x.shape[dim]
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the ``model``
    group: a replicated activation entering a region each rank computes on
    its own shards (Megatron's f)."""
    return x if _MODEL_GROUP is None else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the ``model`` group (fp32,
    rounded once); identity backward: a row-parallel product's partial sums
    leaving as a replicated activation (Megatron's g)."""
    return x if _MODEL_GROUP is None else _ReduceFromModel.apply(x)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' slices of ``x`` concatenated along ``dim`` in rank order;
    the backward hands each rank its slice of the gradient."""
    return x if _MODEL_GROUP is None else _GatherFromModel.apply(x, dim)


def gather_over_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``x`` (one shape on every rank) concatenated along ``dim``
    in rank order; the backward reduce-scatters: every rank's gradient of
    the whole summed in fp32, rounded once, this rank's part kept. For a
    whole that each rank reads a different part of (attention's q heads
    cut inside a head, ``models/attention.py``)."""
    return x if _MODEL_GROUP is None else _GatherScatter.apply(x, dim, _MODEL_GROUP)


def set_data_group(group, dims=None) -> None:
    """Install the ``data`` process group FSDP gathers weights over and
    ``dims``, the tree beside the parameters of each leaf's dim cut over
    it, counted from the last (so it names the same dim of one layer of a
    stacked leaf), ``None`` where the leaf is whole. ``None`` removes both:
    :func:`gather_weights` is then the identity."""
    global _DATA_GROUP, _DATA_DIMS
    _DATA_GROUP, _DATA_DIMS = group, (dims if group is not None else None)


def data_group():
    """The installed ``data`` process group, or ``None``."""
    return _DATA_GROUP


def data_dims():
    """The installed tree of each leaf's dim cut over ``data``, or
    ``None``."""
    return _DATA_DIMS


class _GatherScatter(torch.autograd.Function):
    """The group's ``x`` -> the whole along ``dim`` (all-gather); the
    backward reduce-scatters the gradient back onto this rank's part,
    summed in fp32 and rounded once to its dtype. FSDP's weight gather over
    ``data`` and :func:`gather_over_model`."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = coll.get_world_size(group)
        front = x.movedim(dim, 0).contiguous()
        out = front.new_empty((n * front.shape[0],) + front.shape[1:])
        coll.all_gather_into(out, front, group=group)
        ctx.dim, ctx.n, ctx.group = dim, n, group
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        full = dy.movedim(ctx.dim, 0).float().contiguous()
        part = full.new_empty((full.shape[0] // ctx.n,) + full.shape[1:])
        coll.reduce_scatter(part, full, coll.ReduceOp.SUM, group=ctx.group)
        return part.movedim(0, ctx.dim).to(dy.dtype).contiguous(), None, None


def gather_weights(tree, *path):
    """The whole weights of ``tree``, the parameters at ``path`` (keys from
    the top of the parameter tree; one layer of a stacked subtree takes the
    stack's path): each leaf cut over ``data`` all-gathered along its dim
    (:class:`_GatherScatter`), the others as they are. The tree itself
    with no ``data`` group installed."""
    if _DATA_GROUP is None:
        return tree
    dims = _DATA_DIMS
    for key in path:
        dims = dims[key]

    def go(node, dim):
        if isinstance(node, dict):
            return {k: go(v, dim[k]) for k, v in node.items()}
        return node if dim is None else _GatherScatter.apply(node, dim, _DATA_GROUP)

    return go(tree, dims)


def block_range(full: int, rank: int, size: int) -> tuple[int, int]:
    """[floor(rank * full / size), floor((rank + 1) * full / size)): the
    contiguous 1/size of ``full`` entries where ``size`` divides it; else
    ``rank``'s share of whole entries, uneven (the q heads a rank attends
    with where the rules cut ``wq``'s columns inside a head)."""
    return rank * full // size, (rank + 1) * full // size


def local_range(full: int, local: int) -> tuple[int, int]:
    """[lo, hi) of this rank's block of a dim of ``full`` entries
    (:func:`block_range` over the ``model`` group), the whole dim where it
    holds all of it (``local == full``)."""
    if local == full:
        return 0, full
    return block_range(full, *model_rank_and_size())


def kv_heads_read(lo: int, hi: int, group: int) -> tuple[int, int, int]:
    """(the first and one past the last kv head that q heads [lo, hi) read,
    q head i reading kv head i // ``group``; the index of q head ``lo``
    inside its kv group): the run and the offset ``kops.attention`` takes.
    An empty run for no q heads."""
    if hi <= lo:
        return lo // group, lo // group, 0
    return lo // group, (hi - 1) // group + 1, lo % group
