"""Logical-axis -> mesh-axis sharding rules, and the hooks the launcher
installs.

``build_rules(cfg, mesh)`` and ``pspec`` are the reference's
(``src/repro/launch/sharding.py``), in pure Python: per logical axis name,
the mesh axes that shard it, honouring divisibility (an axis that does not
divide is replicated) and never assigning one mesh axis to two dims of one
tensor (first dim wins). A spec is the tuple the reference's
``PartitionSpec`` holds: per dim ``None``, an axis name or a tuple of
names, trailing ``None``s dropped. A mesh is anything with
``DeviceMesh``'s ``mesh_dim_names`` and ``shape``.

``install_constraints`` places both mesh axes, one process per device, as
the reference's ``NamedSharding``s place them. Data parallelism: every rank
of a ``data`` group trains its slice of the batch, and the train step's
summed gradients (the working table's included, and the loss metrics) are
averaged over the ``data`` group by the ``constrain_like_params`` hook,
where GSPMD reduces them in the reference. The embed gather is the local
kernel lookup, which is what the reference's ``shard_map`` body runs, with
zero collectives. Each leaf's shard (:func:`shard_tree`; :func:`gather_tree`
puts the shards back together) is cut on up to two dims. Over ``data``
(FSDP, the ``embed`` rule): each rank holds the contiguous 1/D of the dim
the spec puts ``data`` on; the models gather a layer's weights whole where
they read them (``common.gather_weights``, inside each remat region), the
gather's backward reduce-scatters each microbatch's gradient onto the
shards, and AdamW's state lives on them; the data-parallel mean then only
all-reduces the leaves left whole over ``data`` (norms, biases without
``embed``, dims ``data`` does not divide). Over ``model`` (tensor
parallelism): the ``model`` group is installed (``common.set_model_group``)
and each rank holds a contiguous 1/M of the dim the spec puts ``model`` on,
except where the dim is several projections side by side
(:data:`FUSED_BLOCKS`: rank r holds piece r of each) and where the rules
would cut inside each mLSTM head (:data:`HEAD_CUT`: the heads are cut
instead); the models place their activations with
``common.copy_to_model`` / ``reduce_from_model`` / ``gather_from_model`` /
``gather_over_model`` where the reference's constraints make GSPMD
reshard (``wq``'s columns cut inside a head stay on the reference's cut; the
activations go into and out of whole heads). A leaf's two cuts
are on different dims and commute. An axis of 1 cuts nothing.
:func:`check_model_parallel` refuses the ``model`` specs the port does not
place, and ``install_constraints`` calls it before it installs anything.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import collectives as coll
from repro_torch.configs import ArchConfig
from repro_torch.models.common import (
    ParamSpec,
    lookup_rows,
    set_embed_gather_fn,
    set_logical_constraint_fn,
    set_data_group,
    set_model_group,
    set_param_constraint_fn,
)
from repro_torch.train.optim import tree_map


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def build_rules(cfg: ArchConfig, mesh) -> dict[str, Any]:
    dp = data_axes(mesh)
    model = "model" if "model" in mesh.mesh_dim_names else None
    msize = _sizes(mesh).get("model", 1)
    Hkv = cfg.n_kv_heads
    kv_on_model = model and Hkv % msize == 0
    return {
        "layers": None,
        "embed": dp or None,  # FSDP dim of weight matrices
        "vocab": model,
        "vocab_rep": None,  # input-embedding rows replicated (gather local)
        "embed_tp": model if cfg.d_model % msize == 0 else None,
        "heads": model,
        "kv_heads": model if kv_on_model else None,
        "mlp": model,
        "experts": model,
        "ssm": model,
        # activations
        "batch": dp or None,
        "embed_act": None,
        "seq_act": None,
        "vocab_act": model,
        "mlp_act": model,
        "ssm_act": model,
        "experts_act": model,
        "heads_sep": model if cfg.n_heads % msize == 0 else None,
        # decode caches
        "kv_heads_cache": model if kv_on_model else None,
        "kv_seq": None if kv_on_model else model,
        "working_rows": None,  # working-table rows stay host-ordered
        "working_dim": model if cfg.d_model % msize == 0 else None,
    }


def pspec(shape: tuple[int, ...], logical: tuple[Optional[str], ...], rules: dict,
          mesh) -> tuple:
    """The spec of one tensor, honouring divisibility and no axis reuse."""
    used: set[str] = set()
    parts: list = []
    for dim, name in zip(shape, logical):
        ax = rules.get(name) if name else None
        if ax is None:
            parts.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        ax_t = tuple(a for a in ax_t if a not in used)
        if not ax_t or dim % _axes_size(mesh, ax_t) != 0:
            parts.append(None)
            continue
        used.update(ax_t)
        parts.append(ax_t if len(ax_t) > 1 else ax_t[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def schema_shardings(schema: dict, rules: dict, mesh):
    """Tree of specs matching a param schema."""

    def go(node):
        if isinstance(node, ParamSpec):
            return pspec(node.shape, node.logical, rules, mesh)
        return {k: go(v) for k, v in node.items()}

    return go(schema)


def tensor_leaves(tree):
    """The tensors of a tree of dicts, lists and tuples (NamedTuples
    included), in order; other leaves (``None``) are skipped."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


def install_constraints(mesh, rules: dict, cfg: ArchConfig) -> None:
    """Install the data-parallel gradient mean over the axes ``rules``
    shards the batch on, as the ``constrain_like_params`` hook (each tensor
    of the tree divided by the group's size, after an in-place all-reduce
    over it unless it is a parameter's gradient cut over ``data``, which
    the weights' gather summed in its backward), the local kernel lookup as
    the embed gather, for a ``model`` axis above 1 the ``model`` group the
    models' tensor-parallel operators reduce over, and for a ``data`` axis
    above 1 the ``data`` group and each leaf's dim cut over it, for the
    models' weight gathers. Raises first, installing nothing, where ``cfg``
    at this mesh is one the port does not place
    (:func:`check_model_parallel`)."""
    from repro_torch.models import get_model

    check_model_parallel(cfg, mesh)
    sizes = _sizes(mesh)
    batch_axes = rules["batch"] or ()
    if len(batch_axes) != 1:
        raise NotImplementedError(f"the batch over mesh axes {batch_axes}: the launcher reduces "
                                  f"gradients over one data axis")
    group, n = mesh.get_group(batch_axes[0]), sizes[batch_axes[0]]
    dims = data_dims(get_model(cfg).schema(cfg), rules, mesh) if n > 1 else None

    def mean_over_data(tree):
        summed = set()  # the gradients of leaves cut over data
        if dims is not None and "params" in tree:
            tree_map(lambda t, dim: dim is None or summed.add(id(t)), tree["params"], dims)
        for t in tensor_leaves(tree):
            if id(t) not in summed:
                coll.all_reduce(t, coll.ReduceOp.SUM, group=group)
            t.div_(n)
        return tree

    set_param_constraint_fn(mean_over_data)
    set_embed_gather_fn(lookup_rows)
    if sizes.get("model", 1) > 1:
        set_model_group(mesh.get_group("model"))
    if dims is not None:
        set_data_group(group, dims)


def clear_constraints() -> None:
    set_logical_constraint_fn(None)
    set_embed_gather_fn(None)
    set_param_constraint_fn(None)
    set_model_group(None)
    set_data_group(None)


# Leaves whose ``model`` dim is k projections side by side, by (parent key,
# leaf name): rank r holds piece r of each of the k blocks, in order, so its
# columns of every projection line up with its channels
FUSED_BLOCKS = {
    ("ssm", "in_proj"): 2,  # mamba [x | z]
    ("mlstm", "w_up"): 2,  # [z | gate]
    ("slstm", "w_zifo"): 4,  # [z | i | f | o]
    ("slstm", "b_zifo"): 4,
    ("slstm", "ffn_up"): 2,  # [up | gate]
}
# Leaves [..., H, dh, dh] the rules cut on dh, inside each head: the port
# cuts their heads (dim -3) instead, the same bytes a rank, so a rank's
# heads match its channels of the mLSTM's inner width
HEAD_CUT = {("mlstm", "wq"), ("mlstm", "wk"), ("mlstm", "wv")}


@dataclass(frozen=True)
class Cut:
    """Where a leaf is split. Over ``model``: at ``dim`` (``None``: whole
    over ``model``), in ``blocks`` equal blocks along it that are each split
    (1: one contiguous 1/M). Over ``data``: at ``data`` (``None``: whole
    over ``data``), one contiguous 1/D."""

    dim: Optional[int]
    blocks: int = 1
    data: Optional[int] = None


def _cut(shape, placed, key, D: int, M: int) -> Optional[Cut]:
    model = data = None
    if M > 1 and "model" in placed:
        model = Cut(len(shape) - 3) if key in HEAD_CUT else Cut(placed.index("model"),
                                                                FUSED_BLOCKS.get(key, 1))
    if D > 1 and "data" in placed:
        data = placed.index("data")
    if data is None:
        return model
    return Cut(None, data=data) if model is None else Cut(model.dim, model.blocks, data)


def check_model_parallel(cfg: ArchConfig, mesh) -> None:
    """Raise ``NotImplementedError`` for a ``model`` axis above 1 that the
    port's tensor parallelism does not place: mLSTM leaves on ``model``
    while the axis does not divide its heads (the rules then cut inside each
    head: xlstm-1.3b at 8), or while its ``wq``/``wk``/``wv`` stay whole (a
    head dim the axis does not divide); a fused leaf (:data:`FUSED_BLOCKS`)
    whose blocks the axis does not divide while it divides the whole
    (mamba's inner width, the sLSTM's ``d_model``). Everything else the
    rules place is placed: q heads cut inside a head (``models/attention.py``
    reshards into whole heads), replicated kv heads read from inside a
    group (the kernel's head offset), ``model`` inside each expert's
    ``mlp``, and blocks whose leaves all stay whole, which run whole on
    every rank."""
    from repro_torch.models import get_model

    M = _sizes(mesh).get("model", 1)
    if M == 1:
        return

    def refuse(what: str):
        raise NotImplementedError(
            f"{cfg.name}: a model axis of {M} {what}; the port cuts the mLSTM by whole heads and "
            f"fused leaves block by block, beside FSDP over data (ROADMAP §1 item 3)")

    rules = build_rules(cfg, mesh)

    def go(node, path):
        if isinstance(node, ParamSpec):
            placed = pspec(node.shape, node.logical, rules, mesh)
            k = FUSED_BLOCKS.get(path[-2:])
            if k and "model" in placed and (node.shape[placed.index("model")] // k) % M:
                refuse(f"cuts {'/'.join(path)}'s {k} fused blocks unevenly")
            return ["model" in placed] if "ssm" in node.logical and "mlstm" in path else []
        return [f for key, v in node.items() for f in go(v, path + (key,))]

    on_model = go(get_model(cfg).schema(cfg), ())
    if any(on_model) and (cfg.n_heads % M or not all(on_model)):
        H = cfg.n_heads
        dh = int(cfg.proj_factor * cfg.d_model) // H
        refuse(f"cuts the mLSTM's {H} heads of {dh} inside a head or unevenly")


def _mesh_sizes(mesh) -> tuple[int, int]:
    sizes = _sizes(mesh)
    return sizes.get("data", 1), sizes.get("model", 1)


def model_cuts(schema: dict, rules: dict, mesh):
    """Tree of each leaf's :class:`Cut` over ``model`` and ``data``
    (``None``: the leaf is whole on every rank); an axis of 1 cuts
    nothing."""
    D, M = _mesh_sizes(mesh)

    def go(node, path):
        if isinstance(node, ParamSpec):
            return _cut(node.shape, pspec(node.shape, node.logical, rules, mesh), path[-2:], D, M)
        return {k: go(v, path + (k,)) for k, v in node.items()}

    return go(schema, ())


def data_dims(schema: dict, rules: dict, mesh):
    """Tree of each leaf's dim cut over ``data``, counted from the last
    (``common.set_data_group``'s form), ``None`` where the leaf is whole
    over ``data``."""

    def go(node, cut):
        if isinstance(node, ParamSpec):
            return None if cut is None or cut.data is None else cut.data - len(node.shape)
        return {k: go(v, cut[k]) for k, v in node.items()}

    return go(schema, model_cuts(schema, rules, mesh))


def shard_leaf(t: torch.Tensor, cut: Optional[Cut], rank: int, M: int, data_rank: int = 0,
               D: int = 1) -> torch.Tensor:
    """The shard of ``t`` at ``cut`` of the rank at index ``rank`` of a
    ``model`` axis of ``M`` and ``data_rank`` of a ``data`` axis of ``D``
    (``None``: ``t`` itself, the leaf is whole): piece ``rank`` of each
    block along the ``model`` dim and the contiguous piece ``data_rank``
    along the ``data`` dim."""
    if cut is None:
        return t
    if cut.dim is not None:
        dim, k = cut.dim, cut.blocks
        n = t.shape[dim] // (k * M)
        pieces = [t.narrow(dim, (b * M + rank) * n, n) for b in range(k)]
        t = torch.cat(pieces, dim) if k > 1 else pieces[0]
    if cut.data is not None:
        n = t.shape[cut.data] // D
        t = t.narrow(cut.data, data_rank * n, n)
    return t.contiguous()


def join_shards(parts: list, cut: Cut) -> torch.Tensor:
    """The ranks' shards over ``model`` (in rank order) -> the leaf whole
    over ``model``; the inverse of :func:`shard_leaf`'s ``model`` cut."""
    blocks = [p.chunk(cut.blocks, cut.dim) for p in parts]
    return torch.cat([b[i] for i in range(cut.blocks) for b in blocks], cut.dim)


def shard_tree(tree, schema: dict, rules: dict, mesh, rank: int,
               data_rank: Optional[int] = None):
    """A whole parameter tree -> the local shards of the rank at index
    ``rank`` of the ``model`` axis and ``data_rank`` of the ``data`` axis
    (whole leaves as they are; the whole tree on a mesh of one rank).
    ``data_rank`` may be left out only where no leaf is cut over
    ``data``."""
    D, M = _mesh_sizes(mesh)
    if D == 1 and M == 1:
        return tree
    cuts = model_cuts(schema, rules, mesh)

    def leaf(t, cut):
        if cut is not None and cut.data is not None and data_rank is None:
            raise ValueError(f"shard_tree over a data axis of {D} needs the data rank")
        return shard_leaf(t, cut, rank, M, data_rank or 0, D)

    return tree_map(leaf, tree, cuts)


def gather_tree(tree, schema: dict, rules: dict, mesh, dst: Optional[int] = None):
    """This rank's local shards -> the whole tree (the tree itself on a
    mesh of one rank): each leaf gathered over ``data`` first, then over
    ``model``. With no ``dst``, on every rank (``all_gather``s). With
    ``dst``, a global rank of a mesh laid out as ``mesh.make_host_mesh``
    lays it out (rank = data index x M + model index), on ``dst``'s host
    alone, gathered one leaf at a time and moved to the host before the
    next, so no rank holds more than one whole leaf on its device; every
    rank calls it, and the others get a tree of ``None``."""
    D, M = _mesh_sizes(mesh)
    me = coll.get_rank() if dst is not None else None
    if D == 1 and M == 1:
        return tree if dst is None or me == dst else None
    row = None if dst is None else dst // M  # dst's data index

    def over(t, axis: str, n: int, cut: Cut, to: Optional[int]):
        group = mesh.get_group(axis)
        parts = [torch.empty_like(t) for _ in range(n)] if to is None or me == to else None
        if to is None:
            coll.all_gather(parts, t.contiguous(), group=group)
        else:
            coll.gather(t.contiguous(), parts, to, group=group)
        return None if parts is None else join_shards(parts, cut)

    def whole(t, cut):
        if cut is not None and cut.data is not None:  # to the member of dst's row
            t = over(t, "data", D, Cut(cut.data), None if dst is None else row * M + me % M)
        elif dst is not None and me // M != row:
            t = None
        if t is not None and cut is not None and cut.dim is not None:
            t = over(t, "model", M, cut, dst)
        if dst is None:
            return t
        return t.cpu() if me == dst else None

    return tree_map(whole, tree, model_cuts(schema, rules, mesh))


def replicated(mesh) -> tuple:
    """The spec of a tensor every rank holds whole."""
    return ()
