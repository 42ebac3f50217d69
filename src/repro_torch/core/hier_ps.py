"""Hierarchical parameter server orchestrator — Algorithm 1 of the paper.

Per training batch:

  1. identify the union of referenced sparse keys (dedup);
  2. pull their rows from the cluster (local MEM-PS/SSD-PS + remote MEM-PS),
     pinning them for the duration of the batch;
  3. renumber keys to contiguous *working slots* and hand a dense working
     table (+ per-row optimizer state) to the device step;
  4. after the device finishes its mini-batches, push the updated rows back
     to their owner nodes and unpin.

Row layout is described by a :class:`~repro_torch.core.tables.RowSchema`: the SSD
row packs ``[emb | optimizer slots...]`` in one fixed-size value so a key's
full training state moves through MEM-PS/SSD-PS as one row (the paper's
fixed-size-value design). A table narrower than the cluster row uses a
prefix; the tail is kept zero. One engine serves exactly one table — the
multi-table façade (:class:`repro_torch.core.client.PSClient`) runs one engine
per named table over the shared cluster, which keeps every guarantee below
*per table* (namespaced keys cannot conflict across tables).

Lossless pipeline overlap (paper §3-4: the 4-stage pipeline must not change
the learned model) is implemented with an **in-flight registry**: every
prepared batch is registered until its push lands on the cluster. When
``prepare_batch(i+1)`` runs concurrently with the training of batch ``i``,
its keys are partitioned into

* **fresh** keys — held by no in-flight batch; pulled from the cluster
  immediately (this is the work that overlaps device compute), and
* **conflicting** keys — held by a still-in-flight batch; these are NOT
  pulled (the cluster copy is stale until that batch pushes). Instead the
  prepare waits, per conflicting predecessor, for its training results and
  **forwards the pushed rows directly** into the new working set (per-key
  version forwarding), transferring the MEM-PS pin in the same step.

The push itself is deferred: the train stage only deposits its results
(:meth:`finish_batch`); the next ``prepare_batch`` call — which the trainer
runs on the pull/push stage thread — applies all completed pushes in batch
order before pulling, so SSD/MEM-PS traffic stays off the device stage and
overlaps the next batch's compute. ``drain()`` applies whatever is left at
end of stream. The result is bitwise equality with serial execution while
pull, push and train all overlap.

Completion tokens stay bounded via the registry's floor watermark: once
every batch up to seq ``s`` has left the in-flight window, the engine
collapses their tokens into ``DependencyRegistry.set_floor`` — derived
from the *actual* in-flight window, not a hardcoded token-discard distance.
"""

from __future__ import annotations

import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.compression import (
    KeyedRowStore,
    WireConfig,
    encode_push,
    raw_push_row_bytes,
)
from repro_torch.core.keys import member_sorted
from repro_torch.core.node import Cluster
from repro_torch.core.pipeline import DependencyRegistry
from repro_torch.core.tables import RowSchema, TableSpec
from repro_torch.metrics import Counters

# training-wire byte accounting (DESIGN.md §13), one Counters set per engine.
# Push direction: raw key+f32 bytes the exact wire would move vs the encoded
# packet bytes actually metered. Pull direction: per-conflict-class rows and
# the row bytes each class kept off the wire.
WIRE_COUNTER_NAMES = (
    "wire_push_rows", "wire_push_raw_bytes", "wire_push_enc_bytes",
    "wire_push_nonfinite_rows",
    "wire_pull_fresh_rows", "wire_pull_fresh_bytes",
    "wire_pull_device_rows", "wire_pull_device_bytes_saved",
    "wire_pull_forwarded_rows", "wire_pull_forwarded_bytes_saved",
    "wire_pull_dedup_rows", "wire_pull_dedup_bytes_saved",
)


@dataclass
class WorkingSet:
    """The device-ready working parameters of one batch."""

    keys: np.ndarray  # uint64 [n_working] — unique referenced keys
    params: np.ndarray  # float32 [n_working, emb_dim]
    opt_state: np.ndarray  # float32 [n_working, opt_dim]
    slots: np.ndarray  # int32, same shape as the batch's key tensor
    batch_id: int

    @property
    def n_working(self) -> int:
        return len(self.keys)


@dataclass
class PSStats:
    """Counters for the conflict-aware pull path."""

    batches_prepared: int = 0
    rows_pulled: int = 0  # fresh rows actually pulled from the cluster
    rows_forwarded: int = 0  # conflict rows served by host version forwarding
    rows_device_served: int = 0  # conflict rows served by the HBM-PS copy
    rows_dedup_served: int = 0  # repeat-key pulls served by the push window
    pull_bytes_saved: int = 0  # row bytes NOT pulled thanks to all paths
    dedup_reuses: int = 0  # prepare_batch calls answered by the registry
    deferred_pushes: int = 0  # pushes applied off the train stage

    @property
    def conflict_rows(self) -> int:
        return self.rows_forwarded + self.rows_device_served


@dataclass
class _InFlight:
    """One prepared batch, tracked until its push lands on the cluster."""

    seq: int
    ws: WorkingSet
    requester: int
    ext_id: int | None  # caller-supplied batch id (speculation dedup)
    pinned: list = field(default_factory=list)  # key arrays we hold pins on
    new_params: np.ndarray | None = None  # trained results (finish_batch)
    new_opt: np.ndarray | None = None
    trained: bool = False
    device_mask: np.ndarray | None = None  # rows served by the HBM-PS copy
    packet: object | None = None  # encoded PushPacket (wire metering)


class HierarchicalPS:
    """Host-side orchestrator of ONE table over a PS cluster.

    ``spec`` describes the table (schema + key-namespace id); the legacy
    two-int signature ``HierarchicalPS(cluster, emb_dim, opt_dim)`` still
    works and builds an anonymous full-width ``[emb | opt]`` spec with
    table id 0 (whose key tagging is the identity) — the exact pre-
    multi-table behaviour. Keys passed to this engine are already in
    cluster key space; namespacing raw per-table keys is the session
    layer's job (:class:`repro_torch.core.client.BatchSession`).
    """

    def __init__(
        self,
        cluster: Cluster,
        emb_dim: int | None = None,
        opt_dim: int = 0,
        deps: DependencyRegistry | None = None,
        spec: TableSpec | None = None,
        wire: WireConfig | None = None,
    ):
        self.cluster = cluster
        if spec is None:
            assert emb_dim is not None, "pass emb_dim/opt_dim or spec"
            assert cluster.dim == emb_dim + opt_dim, (
                f"cluster value dim {cluster.dim} != emb {emb_dim} + opt {opt_dim}"
            )
            schema = (
                RowSchema.embedding(emb_dim)
                if opt_dim == 0
                else RowSchema.with_slots(emb_dim, opt=opt_dim)
            )
            spec = TableSpec("default", schema, table_id=0)
        self.spec = spec
        self.schema = spec.schema
        self.emb_dim = self.schema.emb_dim
        self.opt_dim = self.schema.opt_dim
        self.width = self.schema.width
        assert cluster.dim >= self.width, (
            f"cluster row width {cluster.dim} < table schema width {self.width}"
        )
        self.deps = deps or DependencyRegistry()
        # one token family per table: engines sharing a DependencyRegistry
        # (PSClient) must not collide on their per-batch sequence numbers
        self._token_family = ("trained", self.spec.table_id)
        self.stats = PSStats()
        self._batch_counter = 0
        self._lock = threading.RLock()  # registry state
        self._push_lock = threading.Lock()  # serializes deferred pushes
        self._inflight: "OrderedDict[int, _InFlight]" = OrderedDict()
        self._ext_to_seq: dict[int, int] = {}
        # seqs allocated by a prepare that has not registered yet — they
        # hold the token floor back so a successor can never see their
        # token as "already done" before they trained
        self._preparing: set[int] = set()
        # keys of the last fully-prepared *device-resident* batch (the set
        # the caller keeps on device when device_resident_prev is passed).
        # Any unflagged prepare (eval-style), an abort of that batch, or
        # drain() invalidates it — device-serving against a batch whose
        # rows never reached the device would train zeros.
        self._last_prepared_keys: np.ndarray | None = None
        self._last_prepared_seq: int = -1
        # ---- training wire (DESIGN.md §13) ----------------------------
        self.wire = wire or WireConfig()
        self.wire_counters = Counters(*WIRE_COUNTER_NAMES)
        # per-key quantization residual, carried into the key's next push
        # (unbounded: a residual is at most one quantization step per field)
        self._ef = KeyedRowStore(self.width) if self.wire.quantize_push else None
        # rows pushed within the coalescing window: delta base for
        # device-served rows (window 1 suffices — the base is always the
        # immediately-previous batch) and the dedup source for repeat-key
        # pulls. Written at deposit time under ``_lock``.
        cache_window = max(
            1 if self.wire.quantize_push else 0, self.wire.dedup_window
        )
        self._pushed = (
            KeyedRowStore(self.width, window=cache_window) if cache_window else None
        )
        # degraded SSD heals re-initialize rows behind our back; the cached
        # copies then no longer match the cluster, so drop them wholesale
        fc = cluster.fault_counters
        self._heal_seen = fc["ssd_rows_reinit"] + fc["ssd_heal_degraded"]

    # ------------------------------------------------------------- tokens
    def _trained_token(self, seq: int):
        return (self._token_family, seq)

    def _floor_bound_locked(self) -> int:
        """Largest seq known to have left the in-flight window (all tokens
        at or below it are collapsible). Derived from the registry's actual
        window: the oldest in-flight or still-preparing batch holds it."""
        cands = []
        if self._inflight:
            cands.append(min(self._inflight))
        if self._preparing:
            cands.append(min(self._preparing))
        return (min(cands) if cands else self._batch_counter) - 1

    # ----------------------------------------------------------- pull side
    def prepare_batch(
        self,
        batch_keys: np.ndarray,
        requester: int = 0,
        batch_id: int | None = None,
        device_resident_prev: bool = False,
    ) -> WorkingSet:
        """batch_keys: any-shape uint64 tensor of referenced keys (padded
        entries may use key 0 — slot 0 then maps to key 0's row, which is
        fine: its update contribution is masked out by the model).

        ``batch_id`` (the caller's external batch identifier) dedups
        re-execution: a straggler-speculation or retry re-running the
        pull/push stage for a batch already in flight gets the existing
        working set back instead of double-pinning every key.

        ``device_resident_prev``: the caller keeps the previous batch's
        final rows device-resident (DeviceWorkingSet) and will remap shared
        keys on device. Conflicts held by the *immediately preceding* batch
        then need no host value at all — the paper's "served from the
        HBM-PS copy" case — so this prepare does not wait for that batch's
        training; only conflicts with older in-flight batches still use
        host version forwarding. The returned working set's rows for those
        keys are zero and must not be transferred (the device remap covers
        exactly these keys: they are, by construction, in the previous
        batch's key set)."""
        # apply any completed-but-unpushed predecessors first: this runs on
        # the pull/push stage thread, keeping SSD/MEM-PS write traffic off
        # the train stage and overlapped with device compute
        self.apply_ready_pushes()

        flat = np.asarray(batch_keys, dtype=np.uint64).reshape(-1)
        uniq, inverse = np.unique(flat, return_inverse=True)
        n = len(uniq)

        with self._lock:
            if batch_id is not None and batch_id in self._ext_to_seq:
                entry = self._inflight.get(self._ext_to_seq[batch_id])
                if entry is not None:
                    self.stats.dedup_reuses += 1
                    return entry.ws
            seq = self._batch_counter
            self._batch_counter += 1
            # conflict detection: latest in-flight holder per key (scan the
            # few in-flight batches newest-first; both key sets are sorted)
            holder_seq = np.full(n, -1, dtype=np.int64)
            holder_pos = np.zeros(n, dtype=np.int64)
            entries = {s: e for s, e in self._inflight.items()}
            for s in sorted(entries, reverse=True):
                open_mask = holder_seq < 0
                if not open_mask.any():
                    break
                m, pos = member_sorted(entries[s].ws.keys, uniq)
                m &= open_mask
                holder_seq[m] = s
                holder_pos[m] = pos[m]
            last_keys = self._last_prepared_keys
            # last statement under the lock, immediately before the guarded
            # region: nothing between add and the except can leak the seq
            # (a leaked seq would hold the token floor back forever)
            self._preparing.add(seq)

        pinned_fresh = None  # keys pinned by the pull, until entry owns them
        try:
            # keys of the previous prepared batch are served from the
            # device-resident HBM-PS copy: no host value, no waiting — the
            # device remap is inherently ordered after that batch's train
            # step, and its final device rows are bitwise what its push wrote
            # (so this holds whether or not that push has landed yet). Push
            # ordering guarantees no OLDER in-flight batch still holds such
            # a key.
            if device_resident_prev and last_keys is not None:
                device_served, _ = member_sorted(last_keys, uniq)
            else:
                device_served = np.zeros(n, dtype=bool)
            fresh = (holder_seq < 0) & ~device_served
            # pull dedup (DESIGN.md §13): a fresh key whose push landed
            # within the coalescing window is served from the retained copy
            # — bitwise what the cluster holds (single writer per table, and
            # no-holder means the writing batch's push already applied) —
            # for the cost of a pin message instead of a row transfer
            dedup = np.zeros(n, dtype=bool)
            dedup_rows = None
            if self._pushed is not None and self.wire.dedup_window > 0:
                self._check_heal_coherence()
                with self._lock:
                    if len(self._pushed):
                        dedup = fresh & self._pushed.contains(uniq)
                        if dedup.any():
                            dedup_rows, _ = self._pushed.get(uniq[dedup])
                        fresh = fresh & ~dedup
            n_fresh = int(fresh.sum())
            if n_fresh == n:
                # conflict-free (every serial batch after its predecessor's
                # push landed): the pulled buffer is freshly allocated per
                # batch, so the working set views straight into it
                rows = self.cluster.pull(uniq, requester=requester, pin=True)
                pinned_fresh = uniq[fresh]
            else:
                rows = np.zeros((n, self.cluster.dim), dtype=np.float32)
                if dedup_rows is not None:
                    rows[dedup, : self.width] = dedup_rows
                if n_fresh:
                    # the overlap win: fresh rows pull while predecessors train
                    rows[fresh] = self.cluster.pull(
                        uniq[fresh], requester=requester, pin=True
                    )
                    pinned_fresh = uniq[fresh]
            ws = WorkingSet(
                keys=uniq,
                params=rows[:, : self.emb_dim],
                opt_state=rows[:, self.emb_dim : self.width],
                slots=inverse.astype(np.int32).reshape(np.shape(batch_keys)),
                batch_id=seq,
            )
            entry = _InFlight(
                seq=seq, ws=ws, requester=requester, ext_id=batch_id,
                device_mask=device_served if device_served.any() else None,
            )
            if pinned_fresh is not None:
                entry.pinned.append(pinned_fresh)
        except BaseException:
            # pscheck PS101: the pull takes pins before the in-flight entry
            # exists to own them — release here or they leak forever
            with self._lock:
                self._preparing.discard(seq)
            if pinned_fresh is not None:
                self.cluster.unpin(pinned_fresh)
            raise
        with self._lock:
            self._inflight[seq] = entry
            self._preparing.discard(seq)
            if batch_id is not None:
                self._ext_to_seq[batch_id] = seq
        self.stats.batches_prepared += 1
        self.stats.rows_pulled += n_fresh
        row_bytes = self.cluster.dim * 4
        if n_fresh:
            self.wire_counters.inc("wire_pull_fresh_rows", n_fresh)
            self.wire_counters.inc("wire_pull_fresh_bytes", n_fresh * row_bytes)

        n_dd = int(dedup.sum())
        if n_dd:
            try:
                # the dedup-served rows still need eviction pins for the
                # batch's lifetime; the pin message is all that hits the wire
                dd_keys = uniq[dedup]
                self.cluster.pin(dd_keys, requester=requester)
                entry.pinned.append(dd_keys)
            except BaseException:
                self._forget(entry, unpin=True)
                raise
            self.stats.rows_dedup_served += n_dd
            self.stats.pull_bytes_saved += n_dd * row_bytes
            self.wire_counters.inc("wire_pull_dedup_rows", n_dd)
            self.wire_counters.inc("wire_pull_dedup_bytes_saved", n_dd * row_bytes)
        n_dev = int(device_served.sum())
        if n_dev:
            try:
                # pin transfer happens now, while the predecessor still holds
                # its own pin (its deferred push releases that one later)
                dev_keys = uniq[device_served]
                self.cluster.pin(dev_keys, requester=requester)
                entry.pinned.append(dev_keys)
            except BaseException:
                self._forget(entry, unpin=True)
                raise
            self.stats.rows_device_served += n_dev
            self.stats.pull_bytes_saved += n_dev * row_bytes
            self.wire_counters.inc("wire_pull_device_rows", n_dev)
            self.wire_counters.inc("wire_pull_device_bytes_saved", n_dev * row_bytes)
        if n_fresh + n_dd + n_dev < n:
            holder_seq = np.where(device_served, -1, holder_seq)
            try:
                self._resolve_conflicts(entry, uniq, holder_seq, holder_pos, entries)
            except BaseException:
                self._forget(entry, unpin=True)
                raise
        with self._lock:
            if device_resident_prev:
                self._last_prepared_keys = uniq
                self._last_prepared_seq = seq
            else:
                # a foreign (eval-style) prepare breaks the previous-batch
                # relationship the device remap relies on
                self._last_prepared_keys = None
                self._last_prepared_seq = -1
        return ws

    def _resolve_conflicts(  # pscheck: ok PS101 caller wraps with _forget(unpin=True)
        self,
        entry: _InFlight,
        uniq: np.ndarray,
        holder_seq: np.ndarray,
        holder_pos: np.ndarray,
        entries: dict[int, _InFlight],
    ) -> None:
        """Per-key version forwarding: for each conflicting predecessor (in
        batch order) wait for its training results, copy its pushed rows for
        the shared keys straight into this working set, and take over the
        MEM-PS pin on those keys. No whole-batch blocking: only the batches
        that actually share keys are awaited, and their non-shared work
        (fresh pull above, device train below) already overlapped."""
        ws = entry.ws
        # worklist of (holder seq, ws row indices), resolved oldest-first; a
        # holder aborted mid-wait re-queues its keys against the next-older
        # in-flight holder (which may still carry an unpushed update) and
        # only keys with no holder at all fall back to a cluster pull
        work = [
            (s, np.nonzero(holder_seq == s)[0], holder_pos[holder_seq == s])
            for s in sorted(set(holder_seq[holder_seq >= 0].tolist()))
        ]
        while work:
            s, idx, pos = work.pop(0)
            src = entries[s]
            self.deps.wait(self._trained_token(s))
            if src.new_params is None:
                # aborted without training (token signalled by abort/drain):
                # an older in-flight batch may still hold a pending update
                sub_keys = uniq[idx]
                with self._lock:
                    entries.update(
                        {s2: e for s2, e in self._inflight.items() if s2 < s}
                    )
                h2 = np.full(len(sub_keys), -1, dtype=np.int64)
                p2 = np.zeros(len(sub_keys), dtype=np.int64)
                for s2 in sorted((x for x in entries if x < s), reverse=True):
                    open_m = h2 < 0
                    if not open_m.any():
                        break
                    m2, pp = member_sorted(entries[s2].ws.keys, sub_keys)
                    m2 &= open_m
                    h2[m2] = s2
                    p2[m2] = pp[m2]
                for s2 in sorted(set(h2[h2 >= 0].tolist())):
                    sel = h2 == s2
                    work.append((s2, idx[sel], p2[sel]))
                work.sort(key=lambda w: w[0])
                unheld = idx[h2 < 0]
                if unheld.size:
                    pulled = self.cluster.pull(
                        uniq[unheld], requester=entry.requester, pin=True
                    )
                    ws.params[unheld] = pulled[:, : self.emb_dim]
                    if self.opt_dim:
                        ws.opt_state[unheld] = pulled[:, self.emb_dim : self.width]
                    entry.pinned.append(uniq[unheld])
                    self.stats.rows_pulled += len(unheld)
                    self.wire_counters.inc("wire_pull_fresh_rows", len(unheld))
                    self.wire_counters.inc(
                        "wire_pull_fresh_bytes", len(unheld) * self.cluster.dim * 4
                    )
                continue
            ws.params[idx] = src.new_params[pos]
            if self.opt_dim:
                ws.opt_state[idx] = (
                    src.new_opt[pos] if src.new_opt is not None else src.ws.opt_state[pos]
                )
            # pin transfer: we now hold these rows in place of (alongside)
            # the predecessor, whose deferred push will unpin its own count
            self.cluster.pin(uniq[idx], requester=entry.requester)
            entry.pinned.append(uniq[idx])
            n_fwd = len(idx)
            self.stats.rows_forwarded += n_fwd
            self.stats.pull_bytes_saved += n_fwd * self.cluster.dim * 4
            self.wire_counters.inc("wire_pull_forwarded_rows", n_fwd)
            self.wire_counters.inc(
                "wire_pull_forwarded_bytes_saved", n_fwd * self.cluster.dim * 4
            )

    # ----------------------------------------------------------- push side
    def finish_batch(
        self,
        ws: WorkingSet,
        new_params: np.ndarray,
        new_opt_state: np.ndarray | None = None,
    ) -> None:
        """Deposit a batch's trained rows without touching the cluster.

        The actual push is deferred to the pull/push stage thread (the next
        ``prepare_batch`` / ``apply_ready_pushes`` / ``drain`` call), and the
        results become the forwarding source for conflicting successors.

        With the training wire on (``wire.quantize_push``) the quantize →
        dequantize round trip happens HERE, at deposit time: the entry then
        holds the *applied* (dequantized) rows, so version forwarding, the
        deferred push, the redo log and recovery replay all see bitwise the
        rows the wire's receiver reconstructs — lossy serial and lossy
        pipelined runs stay bitwise equal (modulo device-resident reuse,
        which keeps pre-quantization rows on device by design)."""
        with self._lock:
            entry = self._inflight.get(ws.batch_id)
            if entry is None:
                raise KeyError(f"batch {ws.batch_id} is not in flight")
            new_params = np.asarray(new_params, dtype=np.float32)
            new_opt = (
                None if new_opt_state is None else np.asarray(new_opt_state, dtype=np.float32)
            )
            if self.wire.enabled:
                new_params, new_opt = self._encode_deposit(entry, new_params, new_opt)
            entry.new_params = new_params
            entry.new_opt = new_opt
            entry.trained = True
        self.deps.signal(self._trained_token(ws.batch_id))

    def _encode_deposit(
        self,
        entry: _InFlight,
        new_params: np.ndarray,
        new_opt: np.ndarray | None,
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """Wire-side processing of one deposit (called under ``_lock``).

        Quantizes the push as a delta against each row's base — the batch's
        starting rows, which by push ordering are exactly what the receiver
        holds when this push applies; device-served rows (zero in the
        working set) take their base from the pushed-row window instead,
        falling back to absolute encoding on a cache miss. Stores the
        error-feedback residual per key, retains the applied rows in the
        pushed-row window, and returns the applied (dequantized) rows."""
        ws = entry.ws
        n = ws.n_working
        if self.opt_dim:
            opt_src = new_opt if new_opt is not None else ws.opt_state
            new_rows = np.concatenate(
                [new_params, np.asarray(opt_src, dtype=np.float32)], axis=1
            )
        else:
            new_rows = new_params
        if self.wire.quantize_push:
            base = (
                np.concatenate([ws.params, ws.opt_state], axis=1)
                if self.opt_dim
                else np.array(ws.params, dtype=np.float32)
            )
            has_base = np.ones(n, dtype=bool)
            if entry.device_mask is not None:
                m = entry.device_mask
                cached, found = (
                    self._pushed.get(ws.keys[m])
                    if self._pushed is not None
                    else (np.zeros((int(m.sum()), self.width), np.float32),
                          np.zeros(int(m.sum()), bool))
                )
                base[m] = cached
                has_base[m] = found
            residual, _ = self._ef.get(ws.keys)
            pkt, applied, new_res, n_bad = encode_push(
                new_rows, base, residual, self.emb_dim,
                has_base=has_base, nonfinite=self.wire.nonfinite,
            )
            self._ef.put(ws.keys, new_res, seq=entry.seq)
            entry.packet = pkt
            self.wire_counters.inc("wire_push_rows", n)
            self.wire_counters.inc(
                "wire_push_raw_bytes", n * raw_push_row_bytes(self.cluster.dim)
            )
            self.wire_counters.inc("wire_push_enc_bytes", pkt.nbytes)
            if n_bad:
                self.wire_counters.inc("wire_push_nonfinite_rows", n_bad)
            new_rows = applied
        if self._pushed is not None:
            self._pushed.put(ws.keys, new_rows, seq=entry.seq)
        if self.opt_dim:
            return new_rows[:, : self.emb_dim], new_rows[:, self.emb_dim :]
        return new_rows, new_opt

    def _check_heal_coherence(self) -> None:
        """Drop the pushed-row window if any degraded SSD heal happened
        since we last looked: re-initialized rows no longer match the
        retained copies, so neither dedup nor delta bases may use them."""
        fc = self.cluster.fault_counters
        h = fc["ssd_rows_reinit"] + fc["ssd_heal_degraded"]
        if h != self._heal_seen:
            self._heal_seen = h
            with self._lock:
                if self._pushed is not None:
                    self._pushed.clear()

    # ------------------------------------------------- wire state lifecycle
    def wire_state(self) -> "dict[str, np.ndarray] | None":
        """Checkpointable error-feedback state (``None`` when the lossy
        wire is off). The pushed-row window is deliberately NOT part of it:
        it re-warms from live traffic and must not survive a restore onto a
        cluster whose rows it never observed."""
        if self._ef is None:
            return None
        with self._lock:
            st = self._ef.state()
        return {"keys": st["keys"], "rows": st["rows"]}

    def load_wire_state(self, state: "dict[str, np.ndarray]") -> None:
        if self._ef is None:
            return
        with self._lock:
            self._ef.clear()
            keys = np.asarray(state["keys"], dtype=np.uint64)
            if len(keys):
                self._ef.put(keys, np.asarray(state["rows"], dtype=np.float32))
            if self._pushed is not None:
                self._pushed.clear()

    def apply_ready_pushes(self) -> int:
        """Apply the deferred pushes of every trained in-flight batch, oldest
        first, stopping at the first still-training one (pushes must land in
        batch order so later batches' rows supersede earlier ones)."""
        applied = 0
        with self._push_lock:
            while True:
                with self._lock:
                    entry = next(iter(self._inflight.values()), None)
                    if entry is None or not entry.trained:
                        return applied
                self._push_entry(entry)
                with self._lock:
                    self._inflight.pop(entry.seq, None)
                    if entry.ext_id is not None:
                        self._ext_to_seq.pop(entry.ext_id, None)
                    # collapse the departed batches' tokens into the floor
                    # watermark (bounded token set, no hardcoded window)
                    self.deps.set_floor(self._token_family, self._floor_bound_locked())
                applied += 1
                self.stats.deferred_pushes += 1

    def _push_entry(self, entry: _InFlight) -> None:
        ws = entry.ws
        full = self.width == self.cluster.dim
        rows = (np.empty if full else np.zeros)(
            (ws.n_working, self.cluster.dim), dtype=np.float32
        )
        rows[:, : self.emb_dim] = entry.new_params
        rows[:, self.emb_dim : self.width] = (
            entry.new_opt if entry.new_opt is not None else ws.opt_state
        )
        # entry.packet (set at deposit when the lossy wire is on) makes the
        # cluster meter the encoded bytes; the values pushed are the exact
        # dequantized rows either way
        self.cluster.push(
            ws.keys, rows, requester=entry.requester, unpin=True, packet=entry.packet
        )

    def complete_batch(
        self,
        ws: WorkingSet,
        new_params: np.ndarray,
        new_opt_state: np.ndarray | None = None,
        requester: int = 0,
    ) -> None:
        """Synchronous finish+push (serial callers: examples, LM trainer).

        Pushes land in batch order, so the push is immediate only when every
        earlier in-flight batch already finished (always true for the serial
        prepare->train->complete loop). The push is attributed to the
        requester recorded at prepare time; ``requester`` here is kept for
        signature compatibility."""
        del requester
        self.finish_batch(ws, new_params, new_opt_state)
        self.apply_ready_pushes()

    def drain(self, strict: bool = True) -> None:
        """End of stream / failure: push every trained batch, unpin the rest.

        ``strict`` (the success path) propagates a push failure — the tail
        batches' updates landing is part of the run's contract. Pass
        ``strict=False`` on the failure path, where a push that cannot land
        (e.g. its owner node died) must not mask the original pipeline
        error; the remaining batches' pins are still released."""
        try:
            self.apply_ready_pushes()
        except Exception:
            if strict:
                raise
        finally:
            with self._lock:
                remaining = list(self._inflight.values())
                self._inflight.clear()
                self._ext_to_seq.clear()
                self._last_prepared_keys = None  # residency ends with the run
                self._last_prepared_seq = -1
                if self._pushed is not None and any(e.trained for e in remaining):
                    # a trained batch whose push never landed has deposited
                    # rows in the window that the cluster never saw
                    self._pushed.clear()
            # pscheck PS101: one entry's unpin failing must not leak the
            # rest — attempt every release, then surface the first error
            # only if it would not mask an already-propagating exception
            unpin_errs: list[BaseException] = []
            for entry in remaining:
                self.deps.signal(self._trained_token(entry.seq))  # wake waiters
                for keys in entry.pinned:
                    try:
                        self.cluster.unpin(keys)
                    except Exception as err:
                        unpin_errs.append(err)
            with self._lock:
                self.deps.set_floor(self._token_family, self._floor_bound_locked())
            if unpin_errs and sys.exc_info()[0] is None:
                raise unpin_errs[0]

    def abort_batch(self, ws: WorkingSet) -> None:
        """Unpin without applying (failure path)."""
        with self._lock:
            entry = self._inflight.pop(ws.batch_id, None)
            if entry is not None and entry.ext_id is not None:
                self._ext_to_seq.pop(entry.ext_id, None)
            if ws.batch_id == self._last_prepared_seq:
                self._last_prepared_keys = None  # its rows never trained
                self._last_prepared_seq = -1
            if self._pushed is not None and entry is not None and entry.trained:
                self._pushed.clear()  # its deposited rows never landed
        # wake any prepare blocked on this batch's keys; it will see the
        # missing results and fall back to pulling the (current) cluster copy
        self.deps.signal(self._trained_token(ws.batch_id))
        with self._lock:
            self.deps.set_floor(self._token_family, self._floor_bound_locked())
        pinned = entry.pinned if entry is not None else [ws.keys]
        unpin_errs: list[BaseException] = []
        for keys in pinned:  # release every group even if one owner is down
            try:
                self.cluster.unpin(keys)
            except Exception as err:
                unpin_errs.append(err)
        if unpin_errs:
            raise unpin_errs[0]

    def _forget(self, entry: _InFlight, unpin: bool) -> None:
        with self._lock:
            self._inflight.pop(entry.seq, None)
            if entry.ext_id is not None:
                self._ext_to_seq.pop(entry.ext_id, None)
            if entry.seq == self._last_prepared_seq:
                self._last_prepared_keys = None
                self._last_prepared_seq = -1
        self.deps.signal(self._trained_token(entry.seq))
        with self._lock:
            self.deps.set_floor(self._token_family, self._floor_bound_locked())
        if unpin:
            for keys in entry.pinned:
                self.cluster.unpin(keys)

    # ------------------------------------------------------------- testing
    def n_inflight(self) -> int:
        with self._lock:
            return len(self._inflight)
