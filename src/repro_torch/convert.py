"""Carry parameter-server state across to the port.

The snapshot format is the reference's, byte for byte: a directory the JAX
package published opens in the port's :class:`ServingCluster`, and the
reverse. :func:`publish_arrays` builds such a directory from plain numpy
rows — for example the reference cluster's ``SSDParameterServer.iter_live()``
output, or seeded rows — by pushing them through the port's own
:class:`Cluster` and publishing one version.

:func:`tower_from_numpy` and :func:`adam_state_from_numpy` carry the dense
model across: the reference's CTR tower and its AdamW state, with their
leaves as numpy arrays, become the port's; :func:`lm_params_from_numpy`
does the same for the LM's parameter pytree. Torch's generator cannot
reproduce ``jax.random``, so this is how the two sides start from the same
weights.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.node import Cluster
from repro_torch.core.tables import TableRegistry, TableSpec
from repro_torch.serve.snapshot import SnapshotPublisher, latest_version
from repro_torch.train.optim import AdamState


def publish_arrays(
    directory: str,
    *,
    n_nodes: int,
    dim: int,
    init_cols: int | None = None,
    tables: "dict[str, tuple[TableSpec, np.ndarray, np.ndarray]]",
) -> int:
    """Publish ``tables`` as one snapshot version in ``directory``.

    ``tables`` maps each name to ``(spec, keys, rows)``: raw uint64 keys of
    that table and float32 rows at most ``dim`` wide (narrower rows are
    zero-padded to the cluster's row width), pushed in chunks no larger than
    the cluster's MEM-PS cache. A snapshot repoints files, it does not copy
    them, so each call's cluster keeps its parameter files under
    ``directory/ps_<version>``; calling again on the same directory publishes
    the next version beside the earlier ones. Returns the version id.
    """
    registry = TableRegistry()
    arrays = {}
    for name, (spec, keys, rows) in tables.items():
        keys = np.asarray(keys, dtype=np.uint64)
        rows = np.asarray(rows, dtype=np.float32)
        if spec.name != name:
            raise ValueError(f"table {name!r} carries a spec named {spec.name!r}")
        if rows.ndim != 2 or rows.shape[0] != len(keys) or rows.shape[1] > dim:
            raise ValueError(
                f"table {name!r}: rows {rows.shape} must be [len(keys)={len(keys)}, <= {dim}]"
            )
        registry.add(spec)
        arrays[name] = keys, rows
    version = (latest_version(directory) or 0) + 1
    cluster = Cluster(
        n_nodes, os.path.join(directory, f"ps_{version:08d}"), dim=dim,
        init_cols=init_cols, tables=registry,
    )
    chunk = cluster.cache_capacity
    for name, (keys, rows) in arrays.items():
        spec = registry.require(name)
        for lo in range(0, len(keys), chunk):
            hi = min(len(keys), lo + chunk)
            full = np.zeros((hi - lo, dim), dtype=np.float32)
            full[:, : rows.shape[1]] = rows[lo:hi]
            cluster.push(spec.namespace(keys[lo:hi]), full, unpin=False)
    published = SnapshotPublisher(cluster, directory).publish()
    if published != version:
        raise RuntimeError(f"published version {published}, expected {version}")
    return published


def tower_from_numpy(tree: dict, device="cuda") -> dict[str, torch.Tensor]:
    """The reference's tower pytree (``{"w0": [in, out], "b0": [out], ...}``
    with numpy leaves) as the port's tower: the same names, float32 tensors
    on ``device``."""
    return {
        name: torch.tensor(np.asarray(leaf, dtype=np.float32), device=device)
        for name, leaf in tree.items()
    }


def adam_state_from_numpy(state, device="cuda") -> AdamState:
    """The reference's AdamW state (``AdamState(step, m, v)``, or any
    ``(step, m, v)`` triple, with numpy leaves) as the port's."""
    step, m, v = state
    return AdamState(
        torch.tensor(np.asarray(step, dtype=np.int32), device=device),
        tower_from_numpy(m, device),
        tower_from_numpy(v, device),
    )


def lm_params_from_numpy(cfg: ArchConfig, tree: dict, *, device="cuda",
                         dtype: torch.dtype = torch.float32) -> dict:
    """The reference's LM parameter pytree (``transformer.init``'s nested
    dict, numpy leaves) as the port's: the same nesting and names, tensors
    on ``device``. ``dtype`` is the storage type of the layer leaves and
    ``lm_head``, as ``transformer.init`` takes it; ``final_norm`` and a dense
    ``embed`` stay fp32."""
    from repro_torch.models.transformer import schema

    want = schema(cfg)

    def go(spec, node, path, leaf_dtype):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or sorted(node) != sorted(spec):
                raise ValueError(f"{cfg.name}: {'/'.join(path) or 'params'} holds "
                                 f"{sorted(node) if isinstance(node, dict) else type(node)}, "
                                 f"want {sorted(spec)}")
            return {k: go(spec[k], node[k], path + (k,), leaf_dtype) for k in spec}
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != spec.shape:
            raise ValueError(f"{cfg.name}: {'/'.join(path)} has shape {arr.shape}, "
                             f"want {spec.shape}")
        return torch.tensor(arr, device=device).to(leaf_dtype)

    return {k: go(want[k], tree.get(k), (k,),
                  dtype if k in ("layers", "lm_head") else torch.float32) for k in want}
