"""RetrievalEngine: versioned top-k ad retrieval + feature-interaction
rerank over the serving tier (DESIGN.md §12).

The second production workload on the hierarchy: candidate retrieval runs
brute-force top-k MIPS (``kernels.ops.topk_mips``) over a
:class:`~repro_torch.retrieval.index.RetrievalIndex` built from the same
published snapshot versions the point-lookup :class:`ServingEngine`
serves, then an optional feature-interaction stage re-scores the top-k by
pooling each request's user-side features through the fused embedding-bag
kernel and adding ``<user_vec, candidate_emb>``. Both kernels run on the
engine's device (``device=``, default ``"cuda"``); on ``"cpu"`` their plain
PyTorch versions run instead.

Version binding mirrors the serving engine's atomicity contract:

* ``search`` reads ``self._index`` once (one atomic reference load) and
  works entirely against that object — corpus, key map and pinned
  :class:`ServingVersion` travel together, so a concurrent roll can never
  mix versions inside one request.
* ``roll_forward`` (under ``RetrievalEngine._lock``) rolls the serving
  engine, builds the **new** index completely, then swaps the reference —
  in-flight searches finish on the version they started with.
* With ``retain_cluster`` (the training cluster) the engine takes
  retention refs on every file the bound version's manifest names, so
  training-side compaction parks rather than deletes them while an index
  is bound; the refs drop when the index is replaced or ``close``d.

Counters flow through :class:`repro_torch.metrics.Counters` under the names in
``RETRIEVAL_COUNTER_NAMES`` (registered in ``metrics.KNOWN_COUNTERS``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.metrics import Counters
from repro_torch.retrieval.index import RetrievalIndex

RETRIEVAL_COUNTER_NAMES = (
    "retrieval_searches",
    "retrieval_queries",
    "retrieval_candidates",
    "retrieval_rows_scored",
    "retrieval_index_builds",
    "retrieval_index_rows",
    "retrieval_rolls",
    "retrieval_reranks",
    "retrieval_rerank_rows",
)


@dataclass
class RetrievalResult:
    """One search's candidates, sorted (score desc, corpus index asc).

    ``indices`` are corpus row ids in the bound index (-1 = padding past
    the live corpus), ``ad_keys`` the corresponding raw table keys (0 where
    invalid — check ``valid``). ``index`` pins the exact index/version the
    result was scored against; rerank reuses it."""

    scores: np.ndarray  # f32 [Q, k]
    indices: np.ndarray  # i32 [Q, k]
    ad_keys: np.ndarray  # u64 [Q, k]
    valid: np.ndarray  # bool [Q, k]
    version: int
    index: RetrievalIndex = field(repr=False)


class RetrievalEngine:
    """Top-k MIPS retrieval bound to the serving tier's snapshot versions."""

    def __init__(
        self,
        engine,
        table: str,
        *,
        counters: Counters | None = None,
        retain_cluster=None,
        device="cuda",
    ):
        from repro_torch.serve.snapshot import ServingCluster

        if not isinstance(engine.source, ServingCluster):
            raise TypeError(
                "retrieval needs a snapshot-backed ServingEngine "
                "(ServingEngine(ServingCluster(dir))); the live cluster "
                "view has no immutable version to bind an index to"
            )
        self.engine = engine
        self.table = table
        self.device = resolve_device(device)
        self.counters = counters or Counters(*RETRIEVAL_COUNTER_NAMES)
        self.retain_cluster = retain_cluster
        self._lock = threading.Lock()  # index binds/rolls; search never takes it
        self._index: RetrievalIndex | None = None
        with self._lock:
            self._bind_locked(engine.source.acquire())

    # ------------------------------------------------------ version binding
    @property
    def version(self) -> int:
        idx = self._index
        if idx is None:
            raise RuntimeError("retrieval engine is closed")
        return idx.version

    def _retained_paths(self, version: int) -> "dict[int, list[str]]":
        from repro_torch.serve.snapshot import load_version

        m = load_version(self.engine.source.dir, version)["cluster"]
        return {
            int(nid): list(nm.get("retained_paths", []))
            for nid, nm in m["nodes"].items()
        }

    def _bind_locked(self, view) -> None:
        idx = RetrievalIndex.build(
            self.engine.source, self.table, view=view, device=self.device
        )
        if self.retain_cluster is not None:
            retained = self._retained_paths(idx.version)
            for nid, paths in retained.items():
                self.retain_cluster.nodes[int(nid)].ssd.retain_files(paths)
            idx.retained = retained
        old, self._index = self._index, idx
        self.counters.inc("retrieval_index_builds")
        self.counters.inc("retrieval_index_rows", idx.n_rows)
        self._drop_refs(old)

    def _drop_refs(self, idx: "RetrievalIndex | None") -> None:
        if idx is not None and idx.retained is not None:
            self.retain_cluster.release_files(idx.retained)
            idx.retained = None

    def roll_forward(self, version: int | None = None) -> int:
        """Roll the serving engine forward (default: latest published) and
        rebuild the index on the new version. The swap is atomic: searches
        in flight finish on the index object they loaded, and no search
        ever sees a half-built corpus."""
        with self._lock:
            after = self.engine.roll_forward(version)
            if self._index is None or self._index.version != after:
                self._bind_locked(self.engine.source.acquire())
                self.counters.inc("retrieval_rolls")
            return after

    def close(self) -> None:
        """Unbind the index and drop its snapshot retention refs."""
        with self._lock:
            idx, self._index = self._index, None
            self._drop_refs(idx)

    # -------------------------------------------------------------- search
    def search(self, queries, k: int) -> RetrievalResult:
        """Top-k ads by inner product against the bound version's corpus.

        ``queries`` is [Q, emb_dim] (Q may be 0). Results follow the kernel
        contract exactly — descending score, ties by ascending corpus index,
        (-inf, -1) padding when k exceeds the live corpus — and are equal to
        ``kernels.ref.topk_mips_ref`` on the same corpus. On the card, k is
        at most ``kernels.topk_mips.MAX_K``.
        """
        idx = self._index
        if idx is None:
            raise RuntimeError("retrieval engine is closed")
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != idx.dim:
            raise ValueError(
                f"queries must be [Q, {idx.dim}] for table {idx.table!r}, "
                f"got {q.shape}"
            )
        n_q = q.shape[0]
        if n_q == 0:  # nothing to score; keep the result shape contract
            scores = np.zeros((0, k), dtype=np.float32)
            cand = np.full((0, k), -1, dtype=np.int32)
        else:
            d_pad = idx.corpus.shape[1]
            qp = torch.from_numpy(np.pad(q, ((0, 0), (0, d_pad - idx.dim))))
            vals, ind = kops.topk_mips(
                qp.to(idx.device), idx.corpus, k, n_valid=idx.n_rows
            )
            scores, cand = vals.cpu().numpy(), ind.cpu().numpy()
        valid = cand >= 0
        ad_keys = np.zeros(cand.shape, dtype=np.uint64)
        if idx.n_rows:
            ad_keys[valid] = idx.keys[cand[valid]]
        self.counters.inc("retrieval_searches")
        self.counters.inc("retrieval_queries", n_q)
        self.counters.inc("retrieval_candidates", int(valid.sum()))
        self.counters.inc("retrieval_rows_scored", n_q * idx.n_rows)
        return RetrievalResult(
            scores=scores, indices=cand, ad_keys=ad_keys, valid=valid,
            version=idx.version, index=idx,
        )

    # -------------------------------------------------------------- rerank
    def rerank(
        self,
        result: RetrievalResult,
        user_keys,  # [Q, nnz] raw keys into ``user_table``
        slot_of,  # [Q, nnz] i32 pooling bucket per nonzero
        valid,  # [Q, nnz] padding mask
        *,
        n_slots: int,
        user_table: str | None = None,
        alpha: float = 1.0,
    ) -> RetrievalResult:
        """Feature-interaction scoring stage: re-rank ``result``'s top-k.

        Each query's user-side features pool through the fused
        embedding-bag kernel on the index's device (rows pulled at the
        result's **pinned** version via ``ServingEngine.lookup_at``, so a
        concurrent roll cannot mix versions), the pooled slots sum to one
        user vector, and
        the final score is ``retrieval + alpha * <user_vec, cand_emb>``.
        Candidates re-sort by (score desc, corpus index asc) — the same
        deterministic order as retrieval itself.
        """
        idx = result.index
        uk = np.asarray(user_keys, dtype=np.uint64)
        n_q, k = result.scores.shape
        if uk.ndim != 2 or uk.shape[0] != n_q:
            raise ValueError(
                f"user_keys must be [{n_q}, nnz] to match the result, got {uk.shape}"
            )
        if n_q == 0:
            self.counters.inc("retrieval_reranks")
            return result
        uniq, inv = np.unique(uk.reshape(-1), return_inverse=True)
        rows = self.engine.lookup_at(self.table if user_table is None else user_table,
                                     uniq, view=idx.view)
        if rows.shape[1] != idx.dim:
            raise ValueError(
                f"user table emb dim {rows.shape[1]} != ad emb dim {idx.dim}"
            )
        dev = idx.device
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        pooled = kops.embedding_bag(
            to_dev(rows),
            to_dev(inv.astype(np.int32).reshape(uk.shape)),
            to_dev(np.asarray(slot_of, dtype=np.int32)),
            to_dev(np.asarray(valid)),
            int(n_slots),
        )  # [Q, n_slots, emb]
        user_vec = pooled.sum(dim=1)  # [Q, emb]
        if idx.n_rows:
            cand_emb = idx.corpus[to_dev(np.maximum(result.indices, 0).astype(np.int64))]
            cand_emb = cand_emb[..., : idx.dim]  # [Q, k, emb]
            # elementwise product + sum: fp32 on any device, no TF32 matmul
            inter = (user_vec[:, None, :] * cand_emb).sum(dim=-1).cpu().numpy()
        else:  # no live row: every candidate is padding and scores -inf below
            inter = np.zeros((n_q, k), dtype=np.float32)
        final = np.where(
            result.valid, result.scores + np.float32(alpha) * inter, -np.inf
        ).astype(np.float32)
        # deterministic re-sort: score desc, then corpus index asc, per row
        row = np.repeat(np.arange(n_q), k)
        flat = np.lexsort((result.indices.reshape(-1), -final.reshape(-1), row))
        order = flat.reshape(n_q, k) - (np.arange(n_q) * k)[:, None]
        take = lambda a: np.take_along_axis(a, order, axis=1)
        self.counters.inc("retrieval_reranks")
        self.counters.inc("retrieval_rerank_rows", int(result.valid.sum()))
        return RetrievalResult(
            scores=take(final), indices=take(result.indices),
            ad_keys=take(result.ad_keys), valid=take(result.valid),
            version=result.version, index=idx,
        )
