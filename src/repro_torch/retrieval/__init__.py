"""Embedding-based ad retrieval over versioned snapshots.

Public surface:

* :class:`RetrievalIndex` — one (table, snapshot version)'s embedding rows
  as a corpus tensor on the index's device.
* :class:`RetrievalEngine` — versioned ``search(queries, k)`` through the
  top-k MIPS kernel + feature-interaction ``rerank`` through the
  embedding-bag kernel.
* :class:`RetrievalResult` — one search's (scores, indices, ad_keys).
"""

from repro_torch.retrieval.engine import (
    RETRIEVAL_COUNTER_NAMES,
    RetrievalEngine,
    RetrievalResult,
)
from repro_torch.retrieval.index import RetrievalIndex

__all__ = [
    "RETRIEVAL_COUNTER_NAMES",
    "RetrievalEngine",
    "RetrievalIndex",
    "RetrievalResult",
]
