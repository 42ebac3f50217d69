"""Redo log: the exact-recovery substrate of the PS hierarchy (DESIGN.md §9).

A killed :class:`~repro_torch.core.node.PSNode` loses its DRAM (MEM-PS cache,
including dirty rows whose updates were pushed but not yet flushed to the
SSD-PS). The redo log makes that loss exactly recoverable: every
``Cluster.push`` appends its (keys, full-width rows) to the log *before*
touching any node, and ``Cluster.flush_all`` — the durability point: after
it, every pushed row is on SSD — marks the log durable, dropping the
now-redundant prefix. Recovery of a restarted node is then

    node.restart()                 # cold MEM-PS over the intact SSD shard
    replay log suffix (owner-filtered, in order)   # last writer wins

which reconstructs bit-exact pre-kill values: rows flushed before the
durability mark are on disk, rows pushed after it are replayed, and replay
order preserves last-writer-wins for keys pushed more than once.

Cursors (``pin``) retain a suffix across durability marks for two more
consumers:

* **snapshot healing** — the publisher pins the log at publish time; a
  quarantined SSD file's rows are later healed exactly as
  ``snapshot value ⊕ redo entries since the pin`` (ssd_ps.py quarantine);
* **live reshard** — ``elastic.reshard_live`` pins *before* its bulk
  copy's flush (a push racing the gap must land in the suffix) and replays
  only the delta onto the new shards during the brief write-pause window,
  instead of requiring a quiesced cluster.

Dropping is always a *prefix* (never a pinned or newer entry), so a replay
of the retained suffix can never resurrect a stale value over a newer one.
"""

from __future__ import annotations

import threading

import numpy as np


class RedoTruncatedError(RuntimeError):
    """A consumer asked for log entries that were already compacted away."""


class RedoLog:
    """Append-only (keys, rows) log with prefix compaction and pinned cursors.

    Indices are *absolute* (monotone over the log's lifetime); compaction
    moves the base forward but never renumbers. Thread-safe: appends come
    from the pull/push stage thread while recovery/heal/reshard readers run
    elsewhere.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list[tuple[np.ndarray, np.ndarray]] = []
        self._base = 0  # absolute index of _entries[0]
        self._rows = 0  # rows currently retained
        self._pins: dict[int, int] = {}  # pin id -> absolute index
        self._next_pin = 0

    # ------------------------------------------------------------ writing
    def append(self, keys: np.ndarray, rows: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64).copy()
        rows = np.ascontiguousarray(rows, dtype=np.float32).copy()
        with self._lock:
            self._entries.append((keys, rows))
            self._rows += len(keys)

    def mark_durable(self) -> None:
        """Every previously-appended push is now on SSD: drop the prefix
        (down to the oldest pinned cursor, which heal/reshard still need)."""
        with self._lock:
            self._compact_locked(self.end)

    def _compact_locked(self, durable_upto: int) -> None:
        floor = min([durable_upto] + list(self._pins.values()))
        drop = max(0, floor - self._base)
        if drop:
            for k, _ in self._entries[:drop]:
                self._rows -= len(k)
            del self._entries[:drop]
            self._base += drop

    # ------------------------------------------------------------ cursors
    def pin(self) -> int:
        """Retain everything from the current end onward; returns a pin id."""
        with self._lock:
            pid = self._next_pin
            self._next_pin += 1
            self._pins[pid] = self.end
            return pid

    def release(self, pin_id: int) -> None:
        with self._lock:
            idx = self._pins.pop(pin_id, None)
            if idx is not None:
                # entries the pin alone was retaining become droppable at
                # the next durability mark; nothing to do eagerly
                pass

    def pin_index(self, pin_id: int) -> int:
        with self._lock:
            return self._pins[pin_id]

    # ------------------------------------------------------------ reading
    @property
    def end(self) -> int:
        return self._base + len(self._entries)

    @property
    def rows_held(self) -> int:
        with self._lock:
            return self._rows

    def covers(self, index: int) -> bool:
        """True if every entry at absolute ``index`` or later is retained."""
        with self._lock:
            return index >= self._base

    def since(self, index: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """Entries with absolute index >= ``index``, oldest first."""
        with self._lock:
            if index < self._base:
                raise RedoTruncatedError(
                    f"redo entries before {self._base} were compacted "
                    f"(requested from {index})"
                )
            return list(self._entries[index - self._base :])

    def entries(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Every retained entry, oldest first (node recovery replays all:
        replaying a pinned-but-durable prefix is an idempotent overwrite)."""
        with self._lock:
            return list(self._entries)


def apply_entries(
    entries: "list[tuple[np.ndarray, np.ndarray]]", keys: np.ndarray, rows: np.ndarray
) -> int:
    """Overwrite ``rows[i]`` with the newest logged value of ``keys[i]``
    (entries oldest-first; later entries win; duplicate keys inside one
    entry resolve to the last occurrence, matching push semantics).
    Returns the number of row overwrites applied."""
    keys = np.asarray(keys, dtype=np.uint64)
    applied = 0
    for ekeys, evals in entries:
        if not len(ekeys):
            continue
        sorter = np.argsort(ekeys, kind="stable")
        se = ekeys[sorter]
        # side="right" - 1: the LAST occurrence of a duplicated key wins
        pos = np.searchsorted(se, keys, side="right") - 1
        hit = (pos >= 0) & (se[np.clip(pos, 0, len(se) - 1)] == keys)
        if hit.any():
            rows[hit] = evals[sorter[pos[hit]]]
            applied += int(hit.sum())
    return applied


def collapse_entries(
    entries: "list[tuple[np.ndarray, np.ndarray]]",
) -> tuple[np.ndarray, np.ndarray]:
    """Flatten entries (oldest first) into one last-writer-wins batch."""
    if not entries:
        return np.empty(0, dtype=np.uint64), np.empty((0, 0), dtype=np.float32)
    all_k = np.concatenate([k for k, _ in entries])
    all_v = np.concatenate([v for _, v in entries])
    uniq, inverse = np.unique(all_k, return_inverse=True)
    last = np.empty(len(uniq), dtype=np.int64)
    last[inverse] = np.arange(len(all_k))
    return uniq, all_v[last]
