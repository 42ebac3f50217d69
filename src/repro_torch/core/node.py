"""Logical multi-node PS cluster with a simulated network (paper Section 5).

Each node owns one shard of the key space (modulo partition) with its own
MEM-PS + SSD-PS stack. A requesting node pulls local keys from its own
MEM-PS/SSD-PS and remote keys from peer MEM-PS "through the network"; remote
updates are NOT pushed back (paper: the remote node's own GPUs hold the
synchronized copy and its MEM-PS pulls from them) — in our adaptation the
synchronized updates are applied on the *owner* node by the orchestrator
after the device all-reduce, which preserves exactly the same semantics.

The container has one host, so nodes are in-process objects; the NIC is a
latency+bandwidth model whose virtual time is recorded (and optionally slept)
so Fig-4b/5b style benchmarks are meaningful. All protocols (partitioned
pull, failure, reshard) are real code paths.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.compression import sparse_decode, sparse_encode
from repro_torch.core.keys import key_to_node, partition_by_owner
from repro_torch.core.mem_ps import MemParameterServer
from repro_torch.core.recovery import RedoLog, apply_entries
from repro_torch.core.ssd_ps import SSDParameterServer
from repro_torch.core.tables import TableRegistry
from repro_torch.metrics import Counters


@dataclass
class NetworkModel:
    """Simulated NIC: per-message latency + bandwidth (default ~100Gb RDMA).

    ``wire_quantize=True`` opts remote *serving-style* reads (``pull`` with
    ``pin=False``) into the int8 row-sparse wire format of
    :mod:`repro_torch.core.compression`; bytes-on-wire then count the encoded
    packet, and ``quantize_bytes_saved`` feeds the Fig-4b accounting.
    Pinned training pulls stay exact. Training *pushes* may cross encoded
    when the engine's training wire is on (``Cluster.push(packet=...)``):
    the values applied are the exact dequantized rows, but the NIC meters
    the encoded packet — latency, ``bytes_moved`` and NIC_STALL faults all
    see the bytes actually moved, and ``push_bytes_saved`` records the win.
    """

    latency_s: float = 5e-6
    bandwidth_gbps: float = 100.0
    real_sleep: bool = False
    time_scale: float = 1.0  # scale factor applied when sleeping
    wire_quantize: bool = False  # int8 wire format for serving reads

    virtual_time: float = 0.0
    bytes_moved: int = 0
    messages: int = 0
    quantized_messages: int = 0
    quantize_bytes_saved: int = 0  # raw f32 bytes minus encoded packet bytes
    push_enc_messages: int = 0  # training pushes that crossed encoded
    push_bytes_saved: int = 0  # raw push bytes minus encoded packet bytes
    stalls: int = 0  # NIC_STALL faults absorbed (DESIGN.md §9)
    stall_time: float = 0.0  # extra virtual seconds those stalls added
    faults: object = field(default=None, compare=False, repr=False)

    def transfer(self, nbytes: int) -> float:
        dt = self.latency_s + nbytes * 8.0 / (self.bandwidth_gbps * 1e9)
        if self.faults is not None:
            extra = self.faults.on_transfer(self)
            if extra > 0.0:
                dt += extra
                self.stalls += 1
                self.stall_time += extra
        self.virtual_time += dt
        self.bytes_moved += nbytes
        self.messages += 1
        if self.real_sleep:
            time.sleep(dt * self.time_scale)
        return dt

    def reply(self, keys: np.ndarray, vals: np.ndarray, serving: bool) -> np.ndarray:
        """Account one remote reply and return the rows as the requester
        sees them: with ``wire_quantize`` on and a *serving-style* read
        (``serving=True``), the reply crosses the wire int8 row-sparse and
        the requester gets the decoded (lossy) rows; training replies stay
        exact f32. One implementation serves both the training cluster's
        pull and the snapshot ServingCluster's — the Fig-4b byte accounting
        cannot diverge between them."""
        if self.wire_quantize and serving:
            pkt = sparse_encode(keys, vals, quantize=True)
            # the reply resends values only — the keys crossed the wire in
            # the request message the caller already metered; charging
            # pkt.nbytes here double-counted 8 B/row of key traffic
            self.transfer(pkt.payload_nbytes)
            self.quantized_messages += 1
            self.quantize_bytes_saved += max(0, vals.nbytes - pkt.payload_nbytes)
            return sparse_decode(pkt)[1]
        self.transfer(vals.nbytes)
        return vals

    def fresh(self) -> "NetworkModel":
        """Same link parameters, zeroed counters (reshard target NIC).
        ``replace`` copies every field by construction — a future parameter
        can't silently revert to its default here."""
        return dataclasses.replace(
            self, virtual_time=0.0, bytes_moved=0, messages=0,
            quantized_messages=0, quantize_bytes_saved=0,
            push_enc_messages=0, push_bytes_saved=0,
            stalls=0, stall_time=0.0,
        )


class NodeDownError(RuntimeError):
    pass


class PSNode:
    """One node: MEM-PS cache over an SSD-PS shard."""

    def __init__(
        self,
        node_id: int,
        base_dir: str,
        dim: int,
        cache_capacity: int = 100_000,
        file_capacity: int = 4096,
        init_scale: float = 0.01,
        init_cols: int | None = None,
    ):
        self.node_id = node_id
        self.dir = os.path.join(base_dir, f"node_{node_id:03d}")
        self.ssd = SSDParameterServer(
            self.dir, dim, file_capacity=file_capacity, init_scale=init_scale,
            init_cols=init_cols,
        )
        self.mem = MemParameterServer(self.ssd, capacity=cache_capacity)
        self.alive = True
        self.faults = None  # armed FaultInjector observing this node's ops

    def pull(self, keys: np.ndarray, pin: bool = True) -> np.ndarray:
        if self.faults is not None:
            self.faults.on_node_op(self, "pull")
        if not self.alive:
            raise NodeDownError(f"node {self.node_id} is down")
        return self.mem.pull(keys, pin=pin)

    def push(self, keys: np.ndarray, values: np.ndarray, unpin: bool = True) -> None:
        if self.faults is not None:
            self.faults.on_node_op(self, "push")
        if not self.alive:
            raise NodeDownError(f"node {self.node_id} is down")
        self.mem.push(keys, values, unpin=unpin)

    def pin(self, keys: np.ndarray) -> None:  # pscheck: ok PS101 RPC shim: pin ownership stays with the Cluster caller
        if self.faults is not None:
            self.faults.on_node_op(self, "pin")
        if not self.alive:
            raise NodeDownError(f"node {self.node_id} is down")
        self.mem.pin(keys)

    def kill(self) -> None:
        """Simulate a node failure: in-memory state is lost."""
        self.alive = False

    def restart(self) -> None:
        """Restart after failure: DRAM cache is cold, SSD manifest rebuilt
        from the checkpointed manifest by the caller (Cluster.restore)."""
        self.mem = MemParameterServer(self.ssd, capacity=self.mem.capacity)
        self.alive = True


class Cluster:
    """N logical PS nodes + the partitioned pull/push protocol."""

    def __init__(
        self,
        n_nodes: int,
        base_dir: str,
        dim: int,
        cache_capacity: int = 100_000,
        file_capacity: int = 4096,
        network: NetworkModel | None = None,
        init_scale: float = 0.01,
        init_cols: int | None = None,
        tables: TableRegistry | None = None,
        redo_rows: int = 0,
        auto_recover: bool = False,
        recover_attempts: int = 3,
        recover_backoff_s: float = 0.005,
    ):
        self.n_nodes = n_nodes
        self.base_dir = base_dir
        self.dim = dim
        # remember construction parameters so restore() can rebuild an
        # identically-configured cluster (resume must not silently revert
        # cache/file capacities or the network model to defaults)
        self.cache_capacity = cache_capacity
        self.file_capacity = file_capacity
        self.init_scale = init_scale
        self.init_cols = init_cols
        self.network = network or NetworkModel()
        self.tables: TableRegistry | None = None
        # ---- fault model state (DESIGN.md §9) -------------------------
        # redo_rows > 0 enables the push redo log (exact node recovery,
        # snapshot healing, live reshard) with auto-flush past that many
        # retained rows; auto_recover turns a dead-owner segment into
        # bounded retry-with-backoff around recover_node() instead of
        # surfacing NodeDownError to the caller
        self.redo: RedoLog | None = RedoLog() if redo_rows else None
        self.redo_rows = int(redo_rows)
        self.auto_recover = bool(auto_recover)
        self.recover_attempts = int(recover_attempts)
        self.recover_backoff_s = float(recover_backoff_s)
        self.fault_counters = Counters(
            "node_recoveries", "rows_replayed",
            "ssd_files_quarantined", "ssd_rows_quarantined",
            "ssd_rows_healed", "ssd_rows_reinit",
        )
        self.recovery_time_s = 0.0
        self._heal_src: "tuple[str, int, int] | None" = None  # (dir, version, redo idx)
        self._heal_pin: int | None = None
        self._heal_view = None  # cached ServingVersion for _heal_src
        # a cluster whose SSD shards started empty can heal exactly from
        # initializer + full redo even before any snapshot is published;
        # restore()/reshard clears this (pre-existing rows aren't derivable)
        self._heal_from_init_ok = True
        self._write_gate = threading.Event()
        self._write_gate.set()
        self.nodes = [
            PSNode(i, base_dir, dim, cache_capacity, file_capacity, init_scale, init_cols)
            for i in range(n_nodes)
        ]
        for node in self.nodes:
            self._wire_node(node)
        if tables is not None:
            self.register_tables(tables)
        self.pull_local_time = 0.0
        self.pull_remote_time = 0.0
        # the SanLock sanitizer (REPRO_SANLOCK=1) asserts total_pins()==0 at
        # test teardown for every cluster; registration is a weakref append
        from repro_torch.analysis import sanlock
        sanlock.register_cluster(self)

    def _wire_node(self, node: PSNode) -> None:
        """Attach the cluster's fault-model plumbing to one node's SSD:
        shared quarantine counters and the exact-heal callback (called on
        restore() too — a rebuilt SSD instance starts unwired)."""
        node.ssd.counters = self.fault_counters
        node.ssd.heal_fn = lambda lost, _node=node: self._heal_rows(_node, lost)

    def register_tables(self, tables: TableRegistry) -> None:
        """Host a set of named tables: installs the registry's schema-aware
        missing-row initializer on every node's SSD-PS (each table's ``emb``
        field gets its own deterministic init; the row tail beyond the
        table's schema width stays zero)."""
        if tables.width > self.dim:
            raise ValueError(
                f"cluster row width {self.dim} < widest table schema {tables.width}"
            )
        self.tables = tables
        init = tables.initializer(self.dim, self.init_scale, self.init_cols)
        for node in self.nodes:
            node.ssd.initializer = init

    # ------------------------------------------------------------ protocol
    def owner_of(self, keys: np.ndarray) -> np.ndarray:
        return key_to_node(keys, self.n_nodes)

    def _partition(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Owner-sort once: (order, bounds) with one contiguous segment per
        node — no per-node boolean-mask scans over the full key set."""
        owners = self.owner_of(keys)
        order, splits = partition_by_owner(keys, owners, self.n_nodes)
        bounds = np.concatenate([[0], splits, [len(keys)]])
        return order, bounds

    def _with_recovery(self, node_id: int, op):
        """Run one per-node segment op. A dead owner raises
        :class:`NodeDownError` — never a silent skip returning
        uninitialized rows. With ``auto_recover`` the segment instead gets
        bounded retry-with-backoff around :meth:`recover_node`; the error
        still surfaces once the attempts are spent or recovery itself is
        impossible (no redo log)."""
        attempt = 0
        while True:
            try:
                return op()
            except NodeDownError:
                if not self.auto_recover or attempt >= self.recover_attempts:
                    raise
                time.sleep(self.recover_backoff_s * (2.0 ** attempt))
                attempt += 1
                self.recover_node(node_id)

    def pull(self, keys: np.ndarray, requester: int = 0, pin: bool = True) -> np.ndarray:
        """Partitioned pull: local shard from local MEM-PS/SSD-PS, remote
        shards from peer MEM-PS over the (simulated) network.

        Pin-transactional: if a node fails partway (NodeDownError, MEM-PS
        pin pressure), pins taken by the already-served segments — including
        rows a failing MEM-PS allocated before raising — are rolled back, so
        a retried or abandoned pull never strands pinned rows."""
        keys = np.asarray(keys, dtype=np.uint64)
        order, bounds = self._partition(keys)
        sorted_keys = keys[order]
        sorted_out = np.empty((len(keys), self.dim), dtype=np.float32)
        for node_id in range(self.n_nodes):
            lo, hi = int(bounds[node_id]), int(bounds[node_id + 1])
            if lo == hi:
                continue
            t0 = time.perf_counter()
            try:
                vals = self._with_recovery(
                    node_id,
                    lambda n=node_id: self.nodes[n].pull(sorted_keys[lo:hi], pin=pin),
                )
            except BaseException:
                if pin:  # roll back this + every prior segment's pins
                    for nid in range(node_id + 1):
                        l, h = int(bounds[nid]), int(bounds[nid + 1])
                        if l < h and self.nodes[nid].alive:
                            self.nodes[nid].mem.unpin(sorted_keys[l:h])
                raise
            elapsed = time.perf_counter() - t0
            if node_id == requester:
                self.pull_local_time += elapsed
            else:
                # request keys out + rows back over the NIC; unpinned reads
                # are serving-style and may ride the int8 wire (pinned
                # training pulls stay exact)
                self.network.transfer((hi - lo) * 8)
                vals = self.network.reply(sorted_keys[lo:hi], vals, serving=not pin)
                self.pull_remote_time += elapsed
            sorted_out[lo:hi] = vals
        out = np.empty_like(sorted_out)
        out[order] = sorted_out  # one scatter back into request order
        return out

    def push(
        self,
        keys: np.ndarray,
        values: np.ndarray,
        requester: int = 0,
        unpin: bool = True,
        packet=None,
    ) -> None:
        """Partitioned push. ``values`` are always the exact f32 rows to
        apply (with the training wire on, the engine already quantized and
        *dequantized* them, so nodes, the redo log, and recovery replay all
        see precisely the rows the receiver reconstructs). ``packet`` — a
        :class:`repro_torch.core.compression.PushPacket` covering these rows — is
        metering-only: remote segments then charge the NIC the encoded
        segment bytes instead of raw key+f32."""
        if not self._write_gate.wait(timeout=120.0):
            raise RuntimeError("cluster write gate held >120s (pause_writes leak?)")
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.float32)
        if self.redo is not None:
            # logged before any node is touched: a node killed mid-push is
            # recovered by replaying the log, so a partially-applied push
            # still converges to fully-applied after recover_node()
            self.redo.append(keys, values)
        order, bounds = self._partition(keys)
        sorted_keys = keys[order]
        sorted_vals = values[order]
        for node_id in range(self.n_nodes):
            lo, hi = int(bounds[node_id]), int(bounds[node_id + 1])
            if lo == hi:
                continue
            if node_id != requester:
                raw = (hi - lo) * (8 + 4 * self.dim)
                if packet is not None:
                    enc = packet.segment_nbytes(hi - lo)
                    self.network.transfer(enc)
                    self.network.push_enc_messages += 1
                    self.network.push_bytes_saved += max(0, raw - enc)
                else:
                    self.network.transfer(raw)
            self._with_recovery(
                node_id,
                lambda n=node_id, l=lo, h=hi: self.nodes[n].push(
                    sorted_keys[l:h], sorted_vals[l:h], unpin=unpin
                ),
            )
        if (
            self.redo is not None
            and self.redo_rows
            and self.redo.rows_held > self.redo_rows
            and all(n.alive for n in self.nodes)
        ):
            self.flush_all()  # durability point: log prefix becomes droppable

    def pin(self, keys: np.ndarray, requester: int = 0) -> None:
        """Partitioned pin (version-forwarding pin transfer): a successor
        batch takes over eviction pins on rows it received without a pull.
        Remote pins cost one key-sized control message, far below the row
        pull they replace. Pin-transactional like ``pull``: a node failure
        mid-way rolls back the segments already pinned."""
        keys = np.asarray(keys, dtype=np.uint64)
        order, bounds = self._partition(keys)
        sorted_keys = keys[order]
        for node_id in range(self.n_nodes):
            lo, hi = int(bounds[node_id]), int(bounds[node_id + 1])
            if lo == hi:
                continue
            try:
                self._with_recovery(
                    node_id,
                    lambda n=node_id: self.nodes[n].pin(sorted_keys[lo:hi]),
                )
            except BaseException:
                for nid in range(node_id):
                    l, h = int(bounds[nid]), int(bounds[nid + 1])
                    if l < h and self.nodes[nid].alive:
                        self.nodes[nid].mem.unpin(sorted_keys[l:h])
                raise
            if node_id != requester:
                self.network.transfer((hi - lo) * 8)

    def unpin(self, keys: np.ndarray) -> None:
        """Partitioned unpin without a push (abort/drain path)."""
        keys = np.asarray(keys, dtype=np.uint64)
        order, bounds = self._partition(keys)
        sorted_keys = keys[order]
        for node_id in range(self.n_nodes):
            lo, hi = int(bounds[node_id]), int(bounds[node_id + 1])
            if lo < hi and self.nodes[node_id].alive:
                self.nodes[node_id].mem.unpin(sorted_keys[lo:hi])

    def total_pins(self) -> int:
        """Live pin count across nodes (pin-leak regression checks)."""
        return sum(n.mem.total_pins for n in self.nodes if n.alive)

    def ctor_kwargs(self) -> dict:
        """ALL non-positional construction parameters, for restore() and
        elastic.reshard() — rebuilding from a hand-picked subset silently
        reverts any parameter the subset misses to its default."""
        return {
            "cache_capacity": self.cache_capacity,
            "file_capacity": self.file_capacity,
            "network": self.network,
            "init_scale": self.init_scale,
            "init_cols": self.init_cols,
            "tables": self.tables,
            "redo_rows": self.redo_rows,
            "auto_recover": self.auto_recover,
            "recover_attempts": self.recover_attempts,
            "recover_backoff_s": self.recover_backoff_s,
        }

    # ------------------------------------------------------------ lifecycle
    def flush_all(self) -> None:
        all_alive = True
        for n in self.nodes:
            if n.alive:
                n.mem.flush_all()
            else:
                all_alive = False
        if self.redo is not None and all_alive:
            # durability point — but only if every shard actually flushed; a
            # dead node's entries must survive in the log until it recovers
            self.redo.mark_durable()

    def kill_node(self, node_id: int) -> None:
        self.nodes[node_id].kill()

    def alive_nodes(self) -> list[int]:
        return [n.node_id for n in self.nodes if n.alive]

    # ------------------------------------------------- recovery (DESIGN §9)
    def enable_redo(self, max_rows: int = 262_144) -> None:
        """Turn on the push redo log post-construction (the trainer does
        this for ride-through runs). ``max_rows`` bounds retained rows via
        auto-flush; call before the first push for full coverage."""
        if self.redo is None:
            self.redo = RedoLog()
        self.redo_rows = int(max_rows)

    def recover_node(self, node_id: int) -> bool:
        """Exact recovery of a killed node: restart over the intact SSD
        shard, then replay the redo log's owner-filtered suffix in order
        (last writer wins), reconstructing every DRAM-resident update the
        kill destroyed. Raises :class:`NodeDownError` when the redo log is
        disabled — a bare ``restart()`` would silently revert the shard to
        its last flush, which is exactly the corruption this PR removes."""
        node = self.nodes[node_id]
        if node.alive:
            return False
        if self.redo is None:
            raise NodeDownError(
                f"node {node_id} is down and the redo log is disabled; exact "
                "recovery is impossible (enable_redo(), or restore from a "
                "checkpoint)"
            )
        t0 = time.perf_counter()
        node.restart()
        replayed = 0
        for ekeys, evals in self.redo.entries():
            mask = self.owner_of(ekeys) == node_id
            if mask.any():
                seg_k, seg_v = ekeys[mask], evals[mask]
                # replayed rows cross the NIC from the requester's log
                self.network.transfer(len(seg_k) * (8 + 4 * self.dim))
                node.push(seg_k, seg_v, unpin=False)
                replayed += len(seg_k)
        self.fault_counters.inc("node_recoveries")
        self.fault_counters.inc("rows_replayed", replayed)
        self.recovery_time_s += time.perf_counter() - t0
        return True

    def recover_dead_nodes(self) -> list[int]:
        """Recover every dead node; returns the recovered ids."""
        return [
            n.node_id for n in self.nodes if not n.alive and self.recover_node(n.node_id)
        ]

    def pause_writes(self) -> None:
        """Close the write gate: pushes block (reads keep flowing). Used by
        elastic.reshard_live for its delta-replay cutover window."""
        self._write_gate.clear()

    def resume_writes(self) -> None:
        self._write_gate.set()

    def pin_redo(self) -> int | None:
        """Pin the redo log at its current end (heal/reshard cursor)."""
        return self.redo.pin() if self.redo is not None else None

    def release_redo(self, pin_id: int | None) -> None:
        if self.redo is not None and pin_id is not None:
            self.redo.release(pin_id)

    def set_heal_source(self, directory: str, version: int, redo_pin: int | None) -> None:
        """Register a published snapshot as the exact-heal base for SSD
        quarantines: ``snapshot(version) + redo[pin:] == current values``.
        The publisher takes the pin *before* publishing (so the retained
        suffix covers everything after the snapshot's flush) and hands it
        over here; the previous heal source's pin is released."""
        if self.redo is None or redo_pin is None:
            return
        idx = self.redo.pin_index(redo_pin)
        old_pin = self._heal_pin
        self._heal_src = (directory, int(version), int(idx))
        self._heal_pin = redo_pin
        self._heal_view = None
        if old_pin is not None:
            self.redo.release(old_pin)

    def _heal_rows(self, node: PSNode, keys: np.ndarray):
        """Exact current values for rows lost to an SSD quarantine, or
        ``None`` when only degraded re-initialization is possible.

        Base rows come from the registered heal snapshot (or, for a
        cluster whose shards started empty, the deterministic initializer
        with the log covering from index 0); the redo suffix is then
        replayed over them, oldest first, so the result equals the newest
        pushed value — bit-exact, which is what keeps training loss
        trajectories identical through an injected file drop."""
        if self.redo is None:
            return None
        keys = np.asarray(keys, dtype=np.uint64)
        if self._heal_src is not None:
            directory, version, idx = self._heal_src
            if not self.redo.covers(idx):
                return None  # pin bookkeeping failed us; degrade, don't lie
            view = self._heal_view
            if view is None or view.version != version:
                from repro_torch.serve.snapshot import ServingVersion  # circular import

                view = ServingVersion(directory, version)
                self._heal_view = view
            rows = np.empty((len(keys), self.dim), dtype=np.float32)
            owners = key_to_node(keys, view.n_nodes)
            for nid in range(view.n_nodes):
                m = owners == nid
                if m.any():
                    rows[m] = view.read(nid, keys[m])
            entries = self.redo.since(idx)
        elif self._heal_from_init_ok and self.redo.covers(0):
            rows = node.ssd.init_rows(keys)
            entries = self.redo.since(0)
        else:
            return None
        apply_entries(entries, keys, rows)
        return rows

    def manifest(self) -> dict:
        self.flush_all()
        out = {
            "n_nodes": self.n_nodes,
            "dim": self.dim,
            "nodes": {n.node_id: n.ssd.manifest() for n in self.nodes},
        }
        if self.tables is not None:
            # checkpoints record the hosted table specs, so a restore (or a
            # reshard from a manifest) reconstructs the same named tables
            out["tables"] = self.tables.to_manifest()
        return out

    def publish_manifest(self) -> dict:
        """Snapshot-publishing manifest (DESIGN.md §7): like :meth:`manifest`
        but every node's SSD-PS atomically *retains* the files the manifest
        references (compaction parks instead of deleting them), and the
        missing-row init parameters ride along so a read-only serving view
        initializes unseen keys bit-identically to this cluster."""
        self.flush_all()
        out = {
            "n_nodes": self.n_nodes,
            "dim": self.dim,
            "init_scale": self.init_scale,
            "init_cols": self.init_cols,
            "nodes": {n.node_id: n.ssd.publish_manifest() for n in self.nodes},
        }
        if self.tables is not None:
            out["tables"] = self.tables.to_manifest()
        return out

    def release_files(self, per_node: "dict[int, list[str]]") -> None:
        """Retire one published version's retention references."""
        for nid, paths in per_node.items():
            self.nodes[int(nid)].ssd.release_files(paths)

    @classmethod
    def restore(cls, manifest: dict, base_dir: str, **kw) -> "Cluster":
        if kw.get("tables") is None and manifest.get("tables"):
            kw["tables"] = TableRegistry.from_manifest(manifest["tables"])
        c = cls(manifest["n_nodes"], base_dir, manifest["dim"], **kw)
        nodes = manifest["nodes"]
        for node in c.nodes:
            m = nodes.get(node.node_id, nodes.get(str(node.node_id)))  # JSON strs
            node.ssd = SSDParameterServer.from_manifest(node.dir, m)
            node.mem = MemParameterServer(node.ssd, capacity=node.mem.capacity)
            c._wire_node(node)  # rebuilt SSDs need counters + heal_fn again
        # restored shards hold pre-existing rows the redo log never saw, so
        # initializer+full-replay healing would fabricate values; exact
        # healing resumes once a snapshot is published on this cluster
        c._heal_from_init_ok = False
        if c.tables is not None:
            c.register_tables(c.tables)  # re-install on the restored SSDs
        return c

    def destroy(self) -> None:
        shutil.rmtree(self.base_dir, ignore_errors=True)
