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

``install_constraints`` runs data parallelism, one process per device:
every rank holds the whole replicated model and trains its slice of the
batch, and the train step's summed gradients (the working table's
included, and the loss metrics) are averaged over the ``data`` group by
the ``constrain_like_params`` hook, where GSPMD reduces them in the
reference. The embed gather is the local kernel lookup, which is what the
reference's ``shard_map`` body runs, with zero collectives. Tensor
parallelism over ``model`` waits for ROADMAP §1 slice 9.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ArchConfig
from repro_torch.models.common import (
    ParamSpec,
    lookup_rows,
    set_embed_gather_fn,
    set_logical_constraint_fn,
    set_param_constraint_fn,
)


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


def install_constraints(mesh, rules: dict) -> None:
    """Install the data-parallel gradient mean over the axes ``rules``
    shards the batch on, as the ``constrain_like_params`` hook (every tensor
    of the tree all-reduced in place and divided by the group's size), and
    the local kernel lookup as the embed gather."""
    sizes = _sizes(mesh)
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"a model axis of {sizes['model']}: tensor parallelism over 'model' is ROADMAP "
            f"§1 slice 9; this launcher runs data parallelism only (model axis 1)")
    batch_axes = rules["batch"] or ()
    if len(batch_axes) != 1:
        raise NotImplementedError(f"the batch over mesh axes {batch_axes}: the launcher reduces "
                                  f"gradients over one data axis")
    group, n = mesh.get_group(batch_axes[0]), sizes[batch_axes[0]]

    def mean_over_data(tree):
        for t in tensor_leaves(tree):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            t.div_(n)
        return tree

    set_param_constraint_fn(mean_over_data)
    set_embed_gather_fn(lookup_rows)


def clear_constraints() -> None:
    set_logical_constraint_fn(None)
    set_embed_gather_fn(None)
    set_param_constraint_fn(None)


def replicated(mesh) -> tuple:
    """The spec of a tensor every rank holds whole."""
    return ()
