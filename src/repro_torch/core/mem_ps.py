"""MEM-PS: per-node DRAM parameter cache (paper Section 5 / Appendix D).

Eviction policy straight from Appendix D:

* every visited parameter is placed in an **LRU** tier;
* rows evicted from the LRU tier fall into an **LFU** tier (frequency counted
  across both tiers);
* rows evicted from the LFU tier are flushed to the SSD-PS (if dirty) before
  their memory is released;
* the working parameters of in-flight batches are **pinned** — they cannot be
  evicted until their batch completes (pipeline data-integrity guarantee).

All bookkeeping is **array-backed and batch-vectorized** (DESIGN.md §2): a
batched open-addressing ``U64Index`` maps key -> arena row, and per-row state
(frequency, pin count, dirty bit, tier, recency stamp) lives in flat numpy
arrays indexed by arena row. A pull or push of N keys runs a constant number
of numpy passes — there is no Python loop over keys on the hit path, the
miss path, or the eviction path.

Batch semantics (the canonical contract pinned by tests/test_mem_ps_model.py;
a reference dict-model implements the same spec):

* ``pull``/``push`` dedup their keys; per-key stats/freq/pin counts use the
  occurrence counts, values use the last occurrence (push).
* recency stamps within a batch follow request order (first occurrence);
* hits are serviced (touched, pinned, gathered) before any allocation;
* misses/pending-hits allocate in request order, evicting in one batched
  pass: LFU victims first ordered by (freq, LFU-entry time), then LRU
  victims ordered by recency — pinned rows are never victims. If the batch
  needs more rows than free+evictable, it proceeds in rounds so an unpinned
  batch larger than the cache cycles rows through the staging buffer exactly
  like the sequential implementation did; if a round finds nothing evictable
  the documented ``MemoryError`` is raised.
* dirty evicted rows are staged in a bounded write buffer (array-backed,
  indexed by its own ``U64Index``) and written to the SSD-PS in file-sized
  batches; the buffer is consulted (batched) on misses so no update is ever
  lost or reordered.
* the LRU tier is re-shrunk at the end of every pull *and* push (the
  sequential version leaked LRU capacity on the pending-hit path).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.core.hash_index import U64Index
from repro_torch.core.ssd_ps import SSDParameterServer

_FREE = np.int8(0)
_LRU = np.int8(1)
_LFU = np.int8(2)


@dataclass
class MemStats:
    hits: int = 0
    misses: int = 0
    evict_lru_to_lfu: int = 0
    evict_lfu_to_ssd: int = 0
    flushed_rows: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.hits + self.misses)


class MemParameterServer:
    def __init__(
        self,
        ssd: SSDParameterServer,
        capacity: int,
        lru_frac: float = 0.5,
        flush_batch: int = 2048,
    ):
        self.ssd = ssd
        self.dim = ssd.dim
        self.capacity = int(capacity)
        self.lru_capacity = max(1, int(capacity * lru_frac))
        self.flush_batch = int(flush_batch)
        self.arena = np.zeros((self.capacity, self.dim), dtype=np.float32)

        # per-arena-row state (valid where tier != _FREE)
        self.key_of_row = np.zeros(self.capacity, dtype=np.uint64)
        self.freq = np.zeros(self.capacity, dtype=np.int64)
        self.pins = np.zeros(self.capacity, dtype=np.int64)
        self.dirty = np.zeros(self.capacity, dtype=bool)
        self.tier = np.full(self.capacity, _FREE, dtype=np.int8)
        self.last_used = np.zeros(self.capacity, dtype=np.int64)  # LRU recency
        self.lfu_time = np.zeros(self.capacity, dtype=np.int64)  # LFU entry order
        self._clock = 0
        self._n_lru = 0
        self._n_lfu = 0

        self.index = U64Index(self.capacity)
        self._free = np.arange(self.capacity - 1, -1, -1, dtype=np.int64)
        self._free_n = self.capacity

        # staging buffer for evicted-but-dirty rows awaiting a batched SSD
        # write; sized so one eviction pass can never overflow it
        pcap = self.flush_batch + self.capacity
        self._pend_vals = np.zeros((pcap, self.dim), dtype=np.float32)
        self._pend_index = U64Index(pcap)
        self._pend_free = np.arange(pcap - 1, -1, -1, dtype=np.int64)
        self._pend_free_n = pcap

        self.stats = MemStats()
        self._lock = threading.RLock()

    # ------------------------------------------------------------ internals
    def _take_free(self, n: int) -> np.ndarray:
        rows = self._free[self._free_n - n : self._free_n].copy()
        self._free_n -= n
        return rows

    def _give_free(self, rows: np.ndarray) -> None:
        self._free[self._free_n : self._free_n + len(rows)] = rows
        self._free_n += len(rows)

    def _evictable_count(self) -> int:
        return int(((self.tier != _FREE) & (self.pins == 0)).sum())

    def _evict_rows(self, need: int) -> None:
        """Free ``need`` arena rows in one batched pass (caller checked
        feasibility): LFU victims by (freq, LFU-entry time), then LRU
        victims by recency. Dirty victims are staged for the SSD."""
        evictable = (self.tier != _FREE) & (self.pins == 0)
        lfu_rows = np.nonzero(evictable & (self.tier == _LFU))[0]
        order = np.lexsort((self.lfu_time[lfu_rows], self.freq[lfu_rows]))
        n_lfu = min(need, len(lfu_rows))
        victims = lfu_rows[order[:n_lfu]]
        self.stats.evict_lfu_to_ssd += n_lfu
        self._n_lfu -= n_lfu
        if n_lfu < need:
            lru_rows = np.nonzero(evictable & (self.tier == _LRU))[0]
            order = np.argsort(self.last_used[lru_rows], kind="stable")
            lru_victims = lru_rows[order[: need - n_lfu]]
            self._n_lru -= len(lru_victims)
            victims = np.concatenate([victims, lru_victims])
        d = victims[self.dirty[victims]]
        if d.size:
            self._pend_add(self.key_of_row[d], self.arena[d])
        self.index.delete(self.key_of_row[victims])
        self.tier[victims] = _FREE
        self.dirty[victims] = False
        self._give_free(victims)
        if len(self._pend_index) >= self.flush_batch:
            self._flush_pending()

    def _shrink_lru(self) -> None:
        """Demote the coldest unpinned LRU rows into LFU until the LRU tier
        fits (all in one pass; if everything is pinned the tier may grow)."""
        excess = self._n_lru - self.lru_capacity
        if excess <= 0:
            return
        lru_rows = np.nonzero((self.tier == _LRU) & (self.pins == 0))[0]
        k = min(excess, len(lru_rows))
        if k <= 0:
            return
        order = np.argsort(self.last_used[lru_rows], kind="stable")
        demoted = lru_rows[order[:k]]
        self.tier[demoted] = _LFU
        self.lfu_time[demoted] = self._clock + np.arange(k)
        self._clock += k
        self._n_lru -= k
        self._n_lfu += k
        self.stats.evict_lru_to_lfu += k

    # ------------------------------------------------- pending write buffer
    def _pend_add(self, keys: np.ndarray, vals: np.ndarray) -> None:
        slots = self._pend_free[self._pend_free_n - len(keys) : self._pend_free_n].copy()
        self._pend_free_n -= len(keys)
        self._pend_vals[slots] = vals
        self._pend_index.insert(keys, slots)

    def _pend_release(self, keys: np.ndarray, slots: np.ndarray) -> None:
        self._pend_index.delete(keys)
        self._pend_free[self._pend_free_n : self._pend_free_n + len(slots)] = slots
        self._pend_free_n += len(slots)

    def _flush_pending(self) -> None:
        keys, slots = self._pend_index.items()
        if len(keys) == 0:
            return
        self.ssd.write_batch(keys, self._pend_vals[slots])
        self.stats.flushed_rows += len(keys)
        self._pend_index.clear()
        pcap = len(self._pend_free)
        self._pend_free[:] = np.arange(pcap - 1, -1, -1, dtype=np.int64)
        self._pend_free_n = pcap

    # ------------------------------------------------------------ interface
    def _dedup(self, keys: np.ndarray):
        """(uniq, first_idx, inverse, counts); inverse/counts are None when
        the input is already strictly increasing (identity dedup, all-ones
        counts). The hierarchy's callers — HierarchicalPS after its
        ``np.unique`` and the owner-sorted cluster segments — always pass
        sorted unique keys, so the hot path skips the O(n log n) dedup."""
        if len(keys) < 2 or bool((keys[1:] > keys[:-1]).all()):
            return keys, np.arange(len(keys), dtype=np.int64), None, None
        uniq, first_idx, inverse, counts = np.unique(
            keys, return_index=True, return_inverse=True, return_counts=True
        )
        return uniq, first_idx.astype(np.int64), inverse, counts

    def pull(self, keys: np.ndarray, pin: bool = True) -> np.ndarray:
        """Gather rows for ``keys``; misses read from the SSD-PS."""
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        if keys.size == 0:
            return np.empty((0, self.dim), dtype=np.float32)
        with self._lock:
            uniq, first_idx, inverse, counts = self._dedup(keys)
            # advance the clock up front so recency stamps stay globally
            # unique even if pin pressure aborts the batch midway
            base = self._clock
            self._clock += len(keys)
            rows = self.index.lookup(uniq)
            hit = rows >= 0
            n_hit = int(hit.sum())
            all_hit = n_hit == len(uniq)
            hrows = rows if all_hit else rows[hit]
            if n_hit:
                c_hit = None if counts is None else counts[hit]
                self.stats.hits += n_hit if c_hit is None else int(c_hit.sum())
                self.freq[hrows] += 1 if c_hit is None else c_hit
                if self._n_lfu:
                    promoted = hrows[self.tier[hrows] == _LFU]
                    self.tier[promoted] = _LRU
                    self._n_lru += len(promoted)
                    self._n_lfu -= len(promoted)
                self.last_used[hrows] = base + (first_idx if all_hit else first_idx[hit])
                if pin:
                    self.pins[hrows] += 1 if c_hit is None else c_hit
            if all_hit:
                out_u = self.arena[hrows]  # the one gather on the hit path
                self._shrink_lru()
                return out_u if inverse is None else out_u[inverse]
            out_u = np.empty((len(uniq), self.dim), dtype=np.float32)
            if n_hit:
                out_u[hit] = self.arena[hrows]
            absent = np.nonzero(~hit)[0]
            # allocate in request order; rounds let an unpinned over-capacity
            # batch cycle rows through the staging buffer
            absent = absent[np.argsort(first_idx[absent], kind="stable")]
            while absent.size:
                avail = self._free_n + self._evictable_count()
                if avail == 0:
                    raise MemoryError(
                        "MEM-PS cache exhausted with all rows pinned; increase "
                        "capacity or reduce the prefetch-queue depth"
                    )
                chunk, absent = absent[:avail], absent[avail:]
                n = len(chunk)
                if n > self._free_n:
                    self._evict_rows(n - self._free_n)
                new_rows = self._take_free(n)
                a_keys = uniq[chunk]
                c_chunk = np.ones(n, dtype=np.int64) if counts is None else counts[chunk]
                pend_slots = self._pend_index.lookup(a_keys)
                from_pend = pend_slots >= 0
                self.stats.hits += int(c_chunk[from_pend].sum())
                self.stats.misses += int(c_chunk[~from_pend].sum())
                vals = np.empty((n, self.dim), dtype=np.float32)
                if from_pend.any():
                    psl = pend_slots[from_pend]
                    vals[from_pend] = self._pend_vals[psl]
                    self._pend_release(a_keys[from_pend], psl)
                if (~from_pend).any():
                    vals[~from_pend] = self.ssd.read_batch(a_keys[~from_pend])
                self.arena[new_rows] = vals
                self.key_of_row[new_rows] = a_keys
                self.freq[new_rows] = c_chunk
                self.pins[new_rows] = c_chunk if pin else 0
                self.dirty[new_rows] = from_pend  # still newer than SSD copy
                self.tier[new_rows] = _LRU
                self.last_used[new_rows] = base + first_idx[chunk]
                self._n_lru += n
                self.index.insert(a_keys, new_rows)
                out_u[chunk] = vals
            self._shrink_lru()
            return out_u if inverse is None else out_u[inverse]

    def push(self, keys: np.ndarray, values: np.ndarray, unpin: bool = True) -> None:
        """Apply updated rows (paper: updates land in the pinned cache rows)."""
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        if keys.size == 0:
            return
        values = np.asarray(values, dtype=np.float32).reshape(len(keys), -1)
        with self._lock:
            uniq, first_idx, inverse, counts = self._dedup(keys)
            base = self._clock
            self._clock += len(keys)
            if inverse is None:
                vals_u = values
            else:
                last_idx = np.empty(len(uniq), dtype=np.int64)
                last_idx[inverse] = np.arange(len(keys))  # last occurrence wins
                vals_u = values[last_idx]
            rows = self.index.lookup(uniq)
            hit = rows >= 0
            n_hit = int(hit.sum())
            all_hit = n_hit == len(uniq)
            hrows = rows if all_hit else rows[hit]
            if n_hit:
                self.arena[hrows] = vals_u if all_hit else vals_u[hit]
                self.dirty[hrows] = True
                if unpin:
                    c_hit = 1 if counts is None else counts[hit]
                    self.pins[hrows] = np.maximum(self.pins[hrows] - c_hit, 0)
            if all_hit:
                self._shrink_lru()
                return
            absent = np.nonzero(~hit)[0]
            absent = absent[np.argsort(first_idx[absent], kind="stable")]
            while absent.size:  # not pulled first: treat as fresh rows
                avail = self._free_n + self._evictable_count()
                if avail == 0:
                    raise MemoryError(
                        "MEM-PS cache exhausted with all rows pinned; increase "
                        "capacity or reduce the prefetch-queue depth"
                    )
                chunk, absent = absent[:avail], absent[avail:]
                n = len(chunk)
                a_keys = uniq[chunk]
                pend_slots = self._pend_index.lookup(a_keys)
                from_pend = pend_slots >= 0
                if from_pend.any():  # pushed value supersedes the staged one
                    self._pend_release(a_keys[from_pend], pend_slots[from_pend])
                if n > self._free_n:
                    self._evict_rows(n - self._free_n)
                new_rows = self._take_free(n)
                self.arena[new_rows] = vals_u[chunk]
                self.key_of_row[new_rows] = a_keys
                self.freq[new_rows] = 1
                self.pins[new_rows] = 0
                self.dirty[new_rows] = True
                self.tier[new_rows] = _LRU
                self.last_used[new_rows] = base + first_idx[chunk]
                self._n_lru += n
                self.index.insert(a_keys, new_rows)
            self._shrink_lru()

    def pin(self, keys: np.ndarray) -> None:
        """Add a pin to already-cached rows (per-key occurrence counts).

        Used by the pipeline's version forwarding: a successor batch takes
        over a predecessor's rows without re-pulling them, so it must take
        over the eviction pin too. Keys not currently cached are ignored —
        their value safety is guaranteed by the dirty-row staging buffer."""
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        if keys.size == 0:
            return
        with self._lock:
            uniq, counts = np.unique(keys, return_counts=True)
            rows = self.index.lookup(uniq)
            hit = rows >= 0
            self.pins[rows[hit]] += counts[hit]

    def unpin(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        if keys.size == 0:
            return
        with self._lock:
            uniq, counts = np.unique(keys, return_counts=True)
            rows = self.index.lookup(uniq)
            hit = rows >= 0
            hrows = rows[hit]
            self.pins[hrows] = np.maximum(self.pins[hrows] - counts[hit], 0)

    @property
    def total_pins(self) -> int:
        """Sum of live pin counts (pin-leak regression checks)."""
        with self._lock:
            return int(self.pins[self.tier != _FREE].sum())

    def flush_all(self) -> None:
        """Write every dirty row to the SSD-PS (checkpoint/shutdown path)."""
        with self._lock:
            d = np.nonzero((self.tier != _FREE) & self.dirty)[0]
            if d.size:
                self.ssd.write_batch(self.key_of_row[d], self.arena[d])
                self.stats.flushed_rows += len(d)
                self.dirty[d] = False
            self._flush_pending()

    @property
    def n_cached(self) -> int:
        return self.capacity - self._free_n

    # ------------------------------------------------------------- testing
    def debug_snapshot(self) -> tuple[dict, dict]:
        """(cached, pending) visible state for the model-parity tests.

        ``cached``: key -> (freq, pins, dirty, tier, value tuple);
        ``pending``: key -> value tuple. Test-only (per-key Python loop).
        """
        tiers = {int(_LRU): "lru", int(_LFU): "lfu"}
        cached = {}
        for r in np.nonzero(self.tier != _FREE)[0]:
            cached[int(self.key_of_row[r])] = (
                int(self.freq[r]),
                int(self.pins[r]),
                bool(self.dirty[r]),
                tiers[int(self.tier[r])],
                tuple(float(x) for x in self.arena[r]),
            )
        pk, ps = self._pend_index.items()
        pending = {
            int(k): tuple(float(x) for x in self._pend_vals[s])
            for k, s in zip(pk.tolist(), ps.tolist())
        }
        return cached, pending
