"""Request-coalescing serving engine + serving-side hot-row cache (§7).

The serving read path, top to bottom:

    request streams ---\
    request streams ----+--> ServingEngine.lookup(table, keys)
    request streams ---/          |  leader/follower coalescing: concurrent
                                  |  requests merge into ONE deduped pull,
                                  v  results scatter back per request
                          HotRowCache (DRAM)     version-keyed, pin-free
                                  |  misses only
                                  v
                  ServingCluster.pull / live Cluster.pull(pin=False)
                     (remote segments: int8 wire when opted in)

plus a device tier for decode loops: :meth:`ServingEngine.lookup_device`
keeps the hottest rows resident on the engine's torch device (``device=``,
default ``"cuda"``) across steps via
:class:`~repro_torch.core.hbm_ps.DeviceHotSet` and transfers only the delta.

Everything is **version-keyed**: a merged batch acquires one
:class:`~repro_torch.serve.snapshot.ServingVersion` and serves every request in
it from that version alone; cache rows remember the version they were
filled at and rows from a retired version read as misses. Hot hits are
bit-identical to a cold pull because a version's rows are immutable (the
cache stores exactly the bytes the cold pull returned, quantized wire
included — the encode is deterministic).

Counters (``lookups``, ``coalesced_requests``, ``hot_hits``, ``hot_misses``,
``version_rolls``, ...) are :class:`repro_torch.metrics.Counters` — benches and
tests assert on them instead of scraping prints.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.hash_index import U64Index
from repro_torch.core.hbm_ps import DeviceHotSet
from repro_torch.core.node import Cluster
from repro_torch.core.tables import TableRegistry, TableSpec
from repro_torch.device import resolve_device
from repro_torch.metrics import Counters

COUNTER_NAMES = (
    "lookups",
    "coalesced_requests",
    "merged_pulls",
    "hot_hits",
    "hot_misses",
    "device_rows_reused",
    "rows_served",
    "version_rolls",
    "failovers",
    "failover_rows",
    "failed_lookups",
    "replica_errors",
)


class HotRowCache:
    """Pin-free, version-keyed read-through row cache (the serving DRAM tier).

    ``U64Index``-backed and array-backed like the MEM-PS arena, with none of
    its dirty/staging/pin machinery: serving rows are immutable within a
    version, so there is nothing to write back and nothing to pin. Staleness
    is impossible by construction — every row remembers the version it was
    filled at, and a lookup only hits rows whose version matches the
    request's; rows from retired versions read as misses and get overwritten
    in place or evicted.

    Eviction is one vectorized pass: stale-version rows first, then coldest
    by (freq, recency). All operations are batched numpy over unique keys —
    no per-key Python on hit or miss paths.
    """

    def __init__(self, capacity: int, dim: int):
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.arena = np.zeros((self.capacity, self.dim), dtype=np.float32)
        self.key_of_row = np.zeros(self.capacity, dtype=np.uint64)
        self.version_of = np.full(self.capacity, -1, dtype=np.int64)
        self.freq = np.zeros(self.capacity, dtype=np.int64)
        self.last_used = np.zeros(self.capacity, dtype=np.int64)
        self.used = np.zeros(self.capacity, dtype=bool)
        self.index = U64Index(self.capacity)
        self._free = np.arange(self.capacity - 1, -1, -1, dtype=np.int64)
        self._free_n = self.capacity
        self._clock = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return self.capacity - self._free_n

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.hits + self.misses)

    def lookup(self, keys: np.ndarray, version: int) -> tuple[np.ndarray, np.ndarray]:
        """keys: unique uint64. Returns (hit_mask, rows[n_hit]) — a hit
        requires both key presence AND a matching fill version."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = self.index.lookup(keys)
        m = rows >= 0
        hrows = rows[m]
        ok = self.version_of[hrows] == version
        hrows = hrows[ok]
        mask = np.zeros(len(keys), dtype=bool)
        mask[np.nonzero(m)[0][ok]] = True
        n_hit = len(hrows)
        self.hits += n_hit
        self.misses += len(keys) - n_hit
        if n_hit:
            self.freq[hrows] += 1
            self.last_used[hrows] = self._clock + np.arange(n_hit)
            self._clock += n_hit
        return mask, self.arena[hrows]

    def insert(self, keys: np.ndarray, rows: np.ndarray, version: int) -> None:
        """keys: unique uint64; rows: [n, dim]. Existing entries (stale
        versions included) are overwritten in place; new entries evict the
        stale-then-coldest rows when full."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = np.asarray(rows, dtype=np.float32)
        if len(keys) > self.capacity:  # keep the head; callers pass request
            keys, rows = keys[: self.capacity], rows[: self.capacity]  # order
        slots = self.index.lookup(keys)
        have = slots >= 0
        if have.any():
            hs = slots[have]
            self.arena[hs] = rows[have]
            self.version_of[hs] = version
            self.freq[hs] += 1
            self.last_used[hs] = self._clock + np.arange(len(hs))
            self._clock += len(hs)
        need = np.nonzero(~have)[0]
        n = len(need)
        if n == 0:
            return
        if n > self._free_n:
            self._evict(n - self._free_n, version)
        new_rows = self._free[self._free_n - n : self._free_n].copy()
        self._free_n -= n
        self.arena[new_rows] = rows[need]
        self.key_of_row[new_rows] = keys[need]
        self.version_of[new_rows] = version
        self.freq[new_rows] = 1
        self.last_used[new_rows] = self._clock + np.arange(n)
        self._clock += n
        self.used[new_rows] = True
        self.index.insert(keys[need], new_rows)

    def _evict(self, n: int, version: int) -> None:
        cand = np.nonzero(self.used)[0]
        # stale-version rows first (they can never hit again), then coldest
        stale = self.version_of[cand] != version
        order = np.lexsort((self.last_used[cand], self.freq[cand], ~stale))
        victims = cand[order[:n]]
        self.index.delete(self.key_of_row[victims])
        self.used[victims] = False
        self.version_of[victims] = -1
        self._free[self._free_n : self._free_n + len(victims)] = victims
        self._free_n += len(victims)


class LiveClusterView:
    """Serve directly off the live training cluster — no snapshot handoff.

    Reads are pin-free (``Cluster.pull(pin=False)``) and see whatever the
    trainer last pushed, so there is no cross-request version guarantee; the
    ``version`` here is a manual epoch for the engine's caches — call
    :meth:`roll_forward` after the trainer mutates rows to invalidate them.
    Use :class:`~repro_torch.serve.snapshot.ServingCluster` for real versioned
    serving.
    """

    def __init__(self, cluster: Cluster, node_id: int = 0):
        if cluster.tables is None or len(cluster.tables) == 0:
            raise ValueError("live serving needs a cluster with registered tables")
        self.cluster = cluster
        self.node_id = int(node_id)
        self._version = 0

    @dataclass(frozen=True)
    class _Epoch:
        version: int

    @property
    def version(self) -> int:
        return self._version

    @property
    def registry(self) -> TableRegistry:
        return self.cluster.tables

    @property
    def dim(self) -> int:
        return self.cluster.dim

    @property
    def network(self):
        return self.cluster.network

    def acquire(self) -> "_Epoch":
        return LiveClusterView._Epoch(self._version)

    def pull(self, keys: np.ndarray, view=None) -> np.ndarray:
        return self.cluster.pull(keys, requester=self.node_id, pin=False)

    def roll_forward(self, version: int | None = None) -> int:
        self._version = self._version + 1 if version is None else int(version)
        return self._version


@dataclass
class _Request:
    """One stream's enqueued lookup, filled by the flush that serves it."""

    spec: TableSpec
    shape: tuple
    keys: np.ndarray  # flat, namespaced
    event: threading.Event = field(default_factory=threading.Event)
    out: np.ndarray | None = None
    err: BaseException | None = None
    promoted: bool = False  # woken to take over leadership, not served yet


class ServingEngine:
    """The serving API: coalesced, cached, versioned lookups on named tables.

    ``source`` is a :class:`~repro_torch.serve.snapshot.ServingCluster` (versioned
    snapshots) or a :class:`LiveClusterView`. Concurrent ``lookup`` calls
    coalesce leader/follower style: the first request in becomes the leader,
    optionally sleeps ``coalesce_window_s`` to let followers enqueue, then
    merges everything pending — dedup across requests, ONE cluster pull for
    the union's misses — and scatters rows back per request before waking
    the followers. ``lookup_many`` runs the same merge for a list of
    requests in one call (deterministic coalescing for closed-loop callers
    and tests). ``lookup_device`` is the decode-loop path: slots + a dense
    device table, with a :class:`DeviceHotSet` keeping hot rows resident.
    The device tables live on ``device`` (default ``"cuda"``; a CUDA device
    without a card raises here).
    """

    def __init__(
        self,
        source,
        *,
        cache_rows: int = 65536,
        device_hot_rows: int = 0,
        coalesce_window_s: float = 0.0,
        counters: Counters | None = None,
        fallbacks: "list | tuple" = (),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.source = source
        # surviving replicas to serve from when the primary source fails
        # mid-lookup (DESIGN.md §9): tried in order, each on its own active
        # version — degraded serving, so failover rows are never cached
        # under the primary's version key
        self.fallbacks = list(fallbacks)
        self.counters = counters or Counters(*COUNTER_NAMES)
        self.cache = HotRowCache(cache_rows, source.dim) if cache_rows else None
        self.coalesce_window_s = float(coalesce_window_s)
        self._mu = threading.Lock()  # pending queue + leader election
        self._cache_mu = threading.Lock()  # hot-row cache state
        self._dev_mu = threading.Lock()  # device hot sets (plan/admit pairs)
        self._pending: list[_Request] = []
        self._flushing = False
        self._dev: dict[str, DeviceHotSet] = {}
        self._device_hot_rows = int(device_hot_rows)

    # ------------------------------------------------------------- plumbing
    @property
    def registry(self) -> TableRegistry:
        return self.source.registry

    @property
    def version(self) -> int:
        return self.source.version

    def roll_forward(self, version: int | None = None) -> int:
        """Advance to a newer published version (default: latest) without
        dropping in-flight lookups; they finish on the version they
        acquired. Stale cache/device-resident rows become misses."""
        before = self.source.version
        after = self.source.roll_forward(version)
        for fb in self.fallbacks:
            fb.roll_forward(after)  # replicas track the primary's version
        if after != before:
            self.counters.inc("version_rolls")
        return after

    def _make_req(self, table: str, keys) -> _Request:
        spec = self.registry.require(table)
        arr = np.asarray(keys, dtype=np.uint64)
        return _Request(spec, np.shape(arr), spec.namespace(arr).reshape(-1))

    # ------------------------------------------------------------- failover
    def _pull_source(self, view, keys: np.ndarray) -> "tuple[np.ndarray, bool]":
        """Pull ``keys`` from the primary source, failing over to surviving
        fallback replicas when it raises (replica loss rides through as a
        served request, not an error). Returns ``(rows, cacheable)`` —
        failover rows come from the fallback's own active version, so they
        must NOT be cached under the primary view's version key (a later
        hot hit would have to be bit-identical to a primary cold pull).
        Only when every replica fails does the original error surface."""
        try:
            return self.source.pull(keys, view=view), True
        except Exception as primary_err:
            for fb in self.fallbacks:
                try:
                    rows = fb.pull(keys, view=fb.acquire())
                except Exception:
                    # this replica is gone too; try the next — but count the
                    # skip so replica loss is never silent (pscheck PS301)
                    self.counters.inc("replica_errors")
                    continue
                self.counters.inc("failovers")
                self.counters.inc("failover_rows", len(keys))
                return rows, False
            self.counters.inc("failed_lookups")
            raise primary_err

    # ------------------------------------------------------------ hot cache
    def _rows_for(self, view, uniq: np.ndarray) -> np.ndarray:
        """Full-width rows for unique cluster keys, read through the
        version-keyed hot cache.

        The cluster pull runs OUTSIDE the cache lock: a cold pull pays SSD
        reads plus (possibly slept) NIC time, and holding the lock across
        it would serialize every concurrent path — including pure cache
        hits — behind one flush's misses. Two threads may then pull the
        same row concurrently; that is safe, not just tolerable, because a
        version's rows are immutable (both pulls return identical bytes and
        the second insert overwrites in place)."""
        version = view.version
        if self.cache is None:
            self.counters.inc("hot_misses", len(uniq))
            rows, _ = self._pull_source(view, uniq)
            return rows
        with self._cache_mu:
            mask, hit_rows = self.cache.lookup(uniq, version)
        n_hit = int(mask.sum())
        self.counters.inc("hot_hits", n_hit)
        if n_hit == len(uniq):
            return hit_rows
        out = np.empty((len(uniq), self.source.dim), dtype=np.float32)
        out[mask] = hit_rows
        miss = ~mask
        self.counters.inc("hot_misses", int(miss.sum()))
        pulled, cacheable = self._pull_source(view, uniq[miss])
        out[miss] = pulled
        if cacheable:
            with self._cache_mu:
                self.cache.insert(uniq[miss], pulled, version)
        return out

    # ------------------------------------------------------------- lookups
    def _serve_batch(self, batch: list[_Request]) -> None:
        """Merge, pull once, scatter back. Never raises — failures land on
        each request's ``err`` so follower threads re-raise locally."""
        try:
            view = self.source.acquire()  # ONE version for the whole merge
            all_keys = np.concatenate([r.keys for r in batch])
            uniq, inverse = np.unique(all_keys, return_inverse=True)
            self.counters.inc("merged_pulls")
            if len(batch) > 1:
                self.counters.inc("coalesced_requests", len(batch))
            rows = self._rows_for(view, uniq)
            self.counters.inc("rows_served", len(all_keys))
            off = 0
            for r in batch:
                n = len(r.keys)
                emb = r.spec.schema.emb_dim
                sel = inverse[off : off + n]
                off += n
                r.out = rows[sel][:, :emb].reshape(r.shape + (emb,))
        except BaseException as e:
            for r in batch:
                r.err = e
        finally:
            for r in batch:
                r.event.set()

    def _lead_one_flush(self) -> None:
        """Serve ONE merged batch (everything pending right now — which
        includes the calling thread's own request), then hand leadership to
        the oldest newly-arrived follower instead of draining the queue:
        under sustained load a drain-to-empty leader would keep serving
        other streams' requests long after its own was filled, unbounding
        that request's latency. ``_flushing`` stays True across the
        handoff, so arrivals keep enqueueing as followers."""
        with self._mu:
            batch, self._pending = self._pending, []
            if not batch:
                self._flushing = False
                return
        self._serve_batch(batch)
        with self._mu:
            if not self._pending:
                self._flushing = False
                return
            nxt = self._pending[0]
            nxt.promoted = True
        nxt.event.set()  # wakes as the next leader, not as served

    def lookup(self, table: str, keys) -> np.ndarray:
        """Rows of ``table``'s ``emb`` field for ``keys`` (any shape);
        returns ``keys.shape + (emb_dim,)``. Thread-safe; concurrent calls
        coalesce into shared pulls."""
        req = self._make_req(table, keys)
        self.counters.inc("lookups")
        with self._mu:
            self._pending.append(req)
            lead = not self._flushing
            if lead:
                self._flushing = True
        if lead:
            if self.coalesce_window_s > 0:
                time.sleep(self.coalesce_window_s)
            self._lead_one_flush()
        else:
            req.event.wait()
            if req.promoted:  # take over leadership; our request is still
                req.event.clear()  # pending and gets served in our flush
                self._lead_one_flush()
        if req.err is not None:
            raise req.err
        return req.out

    def lookup_at(self, table: str, keys, *, view=None) -> np.ndarray:
        """Version-pinned lookup: like :meth:`lookup` but served entirely
        from ``view`` (an acquired source version; default: the active one)
        and without coalescing. The retrieval rerank path reads user-side
        rows at the exact version its index was built on, so a concurrent
        ``roll_forward`` can never mix versions inside one scored request.
        Rows still read through the version-keyed hot cache."""
        req = self._make_req(table, keys)
        self.counters.inc("lookups")
        if view is None:
            view = self.source.acquire()
        uniq, inverse = np.unique(req.keys, return_inverse=True)
        rows = self._rows_for(view, uniq)
        self.counters.inc("rows_served", len(req.keys))
        emb = req.spec.schema.emb_dim
        return rows[inverse][:, :emb].reshape(req.shape + (emb,))

    def lookup_many(self, requests: "list[tuple[str, np.ndarray]]") -> list[np.ndarray]:
        """Serve N streams' lookups as one merged batch (deterministic
        coalescing: one deduped pull for the union of all keys)."""
        batch = [self._make_req(t, k) for t, k in requests]
        self.counters.inc("lookups", len(batch))
        self._serve_batch(batch)
        for r in batch:
            if r.err is not None:
                raise r.err
        return [r.out for r in batch]

    # ---------------------------------------------------------- device path
    def lookup_device(self, table: str, keys):
        """Decode-loop path: ``(slots, device_table)`` where ``slots`` maps
        each key position to a row of the dense [n_working, emb_dim] torch
        table on the engine's device. With ``device_hot_rows`` > 0 the
        hottest rows stay device-resident across steps (per table) and only
        the delta is transferred from host."""
        req = self._make_req(table, keys)
        self.counters.inc("lookups")
        emb = req.spec.schema.emb_dim
        uniq, inverse = np.unique(req.keys, return_inverse=True)
        slots = inverse.astype(np.int32).reshape(req.shape)
        view = self.source.acquire()
        self.counters.inc("rows_served", len(req.keys))
        if self._device_hot_rows <= 0:
            rows = self._rows_for(view, uniq)[:, :emb]
            return slots, torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        # An admit() swapping the resident table between another thread's
        # plan() and assemble() would gather rows by stale indices — wrong
        # rows, or an index error where the resident table shrank. But the
        # host pull blocks on SSD/NIC work, so it must NOT run under
        # _dev_mu (pscheck PS202): instead plan under the lock, pull outside
        # it, and re-check the hot set's generation before assembling — a
        # concurrent mutation just replans (the second pass usually reuses
        # the first pull's rows from the hot cache, so the retry is cheap).
        while True:
            with self._dev_mu:
                dev = self._dev.get(table)
                if dev is None:
                    dev = self._dev[table] = DeviceHotSet(self._device_hot_rows, emb * 4)
                plan = dev.plan(uniq, view.version)
                gen = dev.generation
            if len(plan.fresh_dst):
                host = self._rows_for(view, uniq[plan.fresh_dst])[:, :emb]
            else:
                host = np.empty((0, emb), dtype=np.float32)
            with self._dev_mu:
                if dev.generation != gen:
                    continue  # raced with another lookup's admit: replan
                self.counters.inc("device_rows_reused", plan.n_reused)
                fresh = torch.from_numpy(np.ascontiguousarray(host)).to(self.device)
                table_dev = dev.assemble_and_admit(fresh, plan)
            return slots, table_dev

    def device_hot_stats(self, table: str):
        dev = self._dev.get(table)
        return None if dev is None else dev.stats
