"""RetrievalIndex: one snapshot version's embedding table, on the device.

The index side of the retrieval subsystem: materialize a named table's live
rows out of a published :class:`ServingVersion` into a corpus tensor the
top-k MIPS kernel can stream.

Build protocol:

1. **Manifest scan** — iterate every node view's ``iter_live()`` (the same
   corruption-safe primitive reshard/checkpoint use) and keep rows whose
   high-bit key tag matches the table; only the schema's ``emb`` field
   (the row prefix) enters the corpus — optimizer slots never ship to the
   device.
2. **Deterministic corpus order** — rows sort by raw (un-namespaced) ad
   key ascending, so corpus index ``i`` maps to one key independent of
   node count, file layout, or scan order. The kernel's tie-breaking
   (minimum corpus index) therefore has a stable meaning across rebuilds.
3. **Load-width padding** — the feature columns pad with zeros to a
   multiple of 4 floats, one 16-byte load per 4 features in the kernel.
   Nothing pads to the TPU's 128 lanes (16x the corpus bytes at emb_dim 8)
   and no rows are padded: ``n_rows`` is the corpus length.

The index pins the :class:`ServingVersion` object it was built from
(``view``) — rerank reads go through that exact view — and optionally a
set of per-node retention-ref'd file paths (``retained``) the engine takes
on the *training* cluster's SSDs so compaction can never delete a file the
bound snapshot still points at.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.keys import split_namespaced
from repro_torch.device import resolve_device

LOAD_FLOATS = 4  # the kernel reads features as float4


def padded_dim(dim: int) -> int:
    return -(-int(dim) // LOAD_FLOATS) * LOAD_FLOATS


class RetrievalIndex:
    """Corpus rows on the device for one (table, snapshot version)."""

    def __init__(
        self,
        *,
        table: str,
        version: int,
        view,
        keys: np.ndarray,
        corpus: torch.Tensor,
        n_rows: int,
        dim: int,
        retained: "dict[int, list[str]] | None" = None,
    ):
        self.table = table
        self.version = int(version)
        self.view = view  # the pinned ServingVersion (rerank reads use it)
        self.keys = keys  # uint64 [n_rows] corpus row -> raw ad key, ascending
        self.corpus = corpus  # f32 [n_rows, padded_dim(dim)] on the device
        self.n_rows = int(n_rows)
        self.dim = int(dim)
        self.retained = retained

    @property
    def device(self) -> torch.device:
        return self.corpus.device

    @classmethod
    def build(cls, source, table: str, *, view=None, device="cuda") -> "RetrievalIndex":
        """Scan ``view`` (default: ``source.acquire()``) for the table's
        live rows and materialize the corpus on ``device``. ``source`` must
        be a snapshot-backed :class:`~repro_torch.serve.snapshot.ServingCluster`
        — a live training view has no immutable version to bind."""
        dev = resolve_device(device)
        if view is None:
            view = source.acquire()
        if not hasattr(view, "ssd"):
            raise TypeError(
                "retrieval indexes bind to published snapshot versions; "
                "serve from a ServingCluster (SnapshotPublisher.publish + "
                "ServingEngine(ServingCluster(dir))), not the live cluster"
            )
        spec = view.tables.require(table)
        if spec.table_id is None:
            raise ValueError(f"table {table!r} has no assigned id")
        emb = spec.schema.emb_dim
        key_parts: list[np.ndarray] = []
        row_parts: list[np.ndarray] = []
        for ssd in view.ssd:
            for fkeys, fvals in ssd.iter_live():
                tids, raw = split_namespaced(fkeys)
                m = tids == spec.table_id
                if m.any():
                    key_parts.append(raw[m])
                    row_parts.append(np.asarray(fvals[m, :emb], dtype=np.float32))
        if key_parts:
            keys = np.concatenate(key_parts)
            rows = np.concatenate(row_parts)
            order = np.argsort(keys, kind="stable")
            keys, rows = keys[order], rows[order]
        else:
            keys = np.zeros(0, dtype=np.uint64)
            rows = np.zeros((0, emb), dtype=np.float32)
        n = len(keys)
        padded = np.zeros((n, padded_dim(emb)), dtype=np.float32)
        padded[:, :emb] = rows
        return cls(
            table=table,
            version=view.version,
            view=view,
            keys=keys,
            corpus=torch.from_numpy(padded).to(dev),
            n_rows=n,
            dim=emb,
        )
