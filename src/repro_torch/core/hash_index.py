"""Batched open-addressing uint64 -> int64 hash index.

The DRAM tier of the hierarchy (MEM-PS) and the SSD-PS key->file map both
need a key index that can be probed for an entire batch of keys with numpy
ops only — no Python loop over keys. This module provides it:

* open addressing with linear probing over a power-of-two table;
* slot state tracked in an int8 array (EMPTY / FULL / TOMBstone) so any
  uint64 — including 0 and 2**64-1 — is a valid key;
* every operation (``lookup``, ``insert``, ``set``, ``delete``) probes all
  its keys simultaneously: the probe loop advances *probe distance*, not key
  index, so the expected iteration count is O(1) at bounded load factor;
* deletions leave tombstones; the table rehashes in place once tombstones
  exceed 25% of capacity, and grows 2x when live+incoming load would exceed
  75% (HugeCTR's inference PS batches its cache index the same way — see
  PAPERS.md, arXiv 2210.08804).

Keys within one ``insert``/``delete``/``set`` call must be unique (callers
dedup with ``np.unique`` first); ``lookup`` accepts duplicates.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.keys import splitmix64

_EMPTY = np.int8(0)
_FULL = np.int8(1)
_TOMB = np.int8(2)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class U64Index:
    """Vectorized uint64 -> int64 open-addressing map. -1 means "absent"."""

    __slots__ = ("cap", "_mask", "keys", "vals", "state", "n_full", "n_tomb")

    def __init__(self, expected: int):
        self._alloc(next_pow2(max(8, 2 * int(expected))))

    def _alloc(self, cap: int) -> None:
        self.cap = cap
        self._mask = np.uint64(cap - 1)
        self.keys = np.zeros(cap, dtype=np.uint64)
        self.vals = np.full(cap, -1, dtype=np.int64)
        self.state = np.zeros(cap, dtype=np.int8)
        self.n_full = 0
        self.n_tomb = 0

    def __len__(self) -> int:
        return self.n_full

    def _home(self, keys: np.ndarray) -> np.ndarray:
        return (splitmix64(keys) & self._mask).astype(np.int64)

    # ------------------------------------------------------------- probing
    def find_slots(self, keys: np.ndarray) -> np.ndarray:
        """Slot of each key, -1 if absent. Batched linear probing."""
        keys = np.asarray(keys, dtype=np.uint64)
        out = np.full(len(keys), -1, dtype=np.int64)
        if len(keys) == 0 or self.n_full == 0:
            return out
        slot = self._home(keys)
        live = np.arange(len(keys), dtype=np.int64)
        imask = self.cap - 1
        while live.size:
            s = self.state[slot]
            hit = (s == _FULL) & (self.keys[slot] == keys[live])
            out[live[hit]] = slot[hit]
            cont = (s != _EMPTY) & ~hit  # tombstone / other key: keep probing
            live = live[cont]
            slot = (slot[cont] + 1) & imask
        return out

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Value of each key, -1 if absent."""
        slots = self.find_slots(keys)
        out = np.full(len(slots), -1, dtype=np.int64)
        found = slots >= 0
        out[found] = self.vals[slots[found]]
        return out

    def contains(self, keys: np.ndarray) -> np.ndarray:
        return self.find_slots(keys) >= 0

    # ------------------------------------------------------------ mutation
    def insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Insert unique keys known to be absent from the table."""
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.int64)
        n = len(keys)
        if n == 0:
            return
        if (self.n_full + self.n_tomb + n) * 4 > self.cap * 3:
            self._rehash(max(self.cap, next_pow2(4 * (self.n_full + n))))
        slot = self._home(keys)
        live = np.arange(n, dtype=np.int64)
        imask = self.cap - 1
        while live.size:
            s = self.state[slot]
            claim = s != _FULL
            if claim.any():
                cand, cslot = live[claim], slot[claim]
                # several keys may race for one slot this round: first wins
                _, first = np.unique(cslot, return_index=True)
                winners, wslots = cand[first], cslot[first]
                self.n_tomb -= int((self.state[wslots] == _TOMB).sum())
                self.state[wslots] = _FULL
                self.keys[wslots] = keys[winners]
                self.vals[wslots] = vals[winners]
                self.n_full += len(winners)
                won = np.zeros(len(cand), dtype=bool)
                won[first] = True
                live = np.concatenate([live[~claim], cand[~won]])
                slot = np.concatenate([slot[~claim], cslot[~won]])
            else:
                pass  # every probe blocked by a FULL slot: advance all
            slot = (slot + 1) & imask

    def set(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Upsert: update present keys, insert absent ones. Keys unique."""
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.int64)
        slots = self.find_slots(keys)
        found = slots >= 0
        self.vals[slots[found]] = vals[found]
        if (~found).any():
            self.insert(keys[~found], vals[~found])

    def delete(self, keys: np.ndarray) -> None:
        """Remove unique keys; absent keys are ignored."""
        slots = self.find_slots(keys)
        slots = slots[slots >= 0]
        if slots.size:
            self.state[slots] = _TOMB
            self.n_full -= len(slots)
            self.n_tomb += len(slots)
            if self.n_tomb * 4 > self.cap:
                self._rehash(self.cap)

    # ------------------------------------------------------------ plumbing
    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """All (keys, vals) currently stored, in unspecified order."""
        full = self.state == _FULL
        return self.keys[full].copy(), self.vals[full].copy()

    def clear(self) -> None:
        self.vals.fill(-1)
        self.state.fill(_EMPTY)
        self.n_full = 0
        self.n_tomb = 0

    def _rehash(self, cap: int) -> None:
        k, v = self.items()
        self._alloc(cap)
        self.insert(k, v)
