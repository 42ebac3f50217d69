"""Carry parameter-server state across to the port.

The snapshot format is the reference's, byte for byte: a directory the JAX
package published opens in the port's :class:`ServingCluster`, and the
reverse. :func:`publish_arrays` builds such a directory from plain numpy
rows — for example the reference cluster's ``SSDParameterServer.iter_live()``
output, or seeded rows — by pushing them through the port's own
:class:`Cluster` and publishing one version.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.core.node import Cluster
from repro_torch.core.tables import TableRegistry, TableSpec
from repro_torch.serve.snapshot import SnapshotPublisher, latest_version


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
