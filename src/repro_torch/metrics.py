"""Shared evaluation metrics and event counters."""

from __future__ import annotations

import os
import threading

import numpy as np

# Every production counter name, in one place. pscheck rule PS401 parses
# this set (via ast, without importing) and flags any ``Counters.inc`` /
# ``Counters(...)`` literal not listed here, so a typo'd name can never
# silently mint a new counter that no bench or test ever reads. Runtime
# strict mode (REPRO_SANLOCK=1 / REPRO_STRICT_COUNTERS=1) enforces the
# same contract on dynamically-built names.
KNOWN_COUNTERS = frozenset({
    # serving engine (serve/engine.py COUNTER_NAMES)
    "lookups", "coalesced_requests", "merged_pulls",
    "hot_hits", "hot_misses", "device_rows_reused", "rows_served",
    "version_rolls", "failovers", "failover_rows", "failed_lookups",
    "replica_errors",
    # SSD-PS integrity (core/ssd_ps.py)
    "ssd_files_quarantined", "ssd_rows_quarantined",
    "ssd_rows_healed", "ssd_rows_reinit", "ssd_heal_degraded",
    # node recovery (core/node.py fault_counters)
    "node_recoveries", "rows_replayed",
    # NIC wire quantization (core/node.py NetworkModel via add_from)
    "quantized_messages", "quantize_bytes_saved",
    # training wire (core/hier_ps.py WIRE_COUNTER_NAMES): push direction is
    # raw-vs-encoded bytes for the quantized gradient push; pull direction is
    # per-conflict-class rows and bytes saved (device-served rows ship no
    # bytes, forwarded rows ride the pin transfer, dedup rows collapse a
    # repeat pull inside the coalescing window to a pin message)
    "wire_push_rows", "wire_push_raw_bytes", "wire_push_enc_bytes",
    "wire_push_nonfinite_rows",
    "wire_pull_fresh_rows", "wire_pull_fresh_bytes",
    "wire_pull_device_rows", "wire_pull_device_bytes_saved",
    "wire_pull_forwarded_rows", "wire_pull_forwarded_bytes_saved",
    "wire_pull_dedup_rows", "wire_pull_dedup_bytes_saved",
    # streaming ingestion (ingest/staging.py + ingest/extract.py); times
    # are integer microseconds (counters are int-only)
    "ingest_batches", "ingest_examples", "staging_bytes",
    "ingest_wait_us", "ingest_overlap_us", "ingest_drained",
    # ad retrieval (retrieval/engine.py RETRIEVAL_COUNTER_NAMES)
    "retrieval_searches", "retrieval_queries", "retrieval_candidates",
    "retrieval_rows_scored", "retrieval_index_builds",
    "retrieval_index_rows", "retrieval_rolls", "retrieval_reranks",
    "retrieval_rerank_rows",
})


def _strict_default() -> bool:
    return bool(
        os.environ.get("REPRO_SANLOCK") or os.environ.get("REPRO_STRICT_COUNTERS")
    )


class Counters:
    """Named monotonic event counters (thread-safe).

    The serving subsystem reports through one of these (``lookups``,
    ``coalesced_requests``, ``hot_hits``, ``version_rolls``, ...) so benches
    and tests assert on counter values instead of scraping ad-hoc prints.
    Names passed to the constructor are pre-registered at 0 so a
    ``snapshot()`` always shows the full schema; ``inc`` accepts new names
    too (they appear once first incremented) — unless strict mode is on
    (``REPRO_SANLOCK``/``REPRO_STRICT_COUNTERS``, or ``strict=True``), in
    which case a name neither pre-registered nor in :data:`KNOWN_COUNTERS`
    raises instead of silently minting a counter.
    """

    def __init__(self, *names: str, strict: bool | None = None):
        self._lock = threading.Lock()
        self._c: dict[str, int] = {n: 0 for n in names}
        self._strict = _strict_default() if strict is None else bool(strict)

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            if self._strict and name not in self._c and name not in KNOWN_COUNTERS:
                raise ValueError(
                    f"unknown counter {name!r}: declare it in "
                    "repro_torch.metrics.KNOWN_COUNTERS (or the constructor)"
                )
            self._c[name] = self._c.get(name, 0) + int(n)

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def snapshot(self) -> dict:
        """A consistent copy of every counter."""
        with self._lock:
            return dict(self._c)

    def reset(self) -> None:
        with self._lock:
            self._c = {n: 0 for n in self._c}

    def add_from(self, other: "Counters | dict") -> None:
        """Accumulate another counter set (or plain dict) into this one —
        benches merge per-subsystem counters (cluster faults, serving
        engine) into one report without losing either source."""
        src = other.snapshot() if isinstance(other, Counters) else dict(other)
        with self._lock:
            for n, v in src.items():
                self._c[n] = self._c.get(n, 0) + int(v)


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney), with tie averaging."""
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
