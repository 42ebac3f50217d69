"""Deterministic fault injection across the PS hierarchy (DESIGN.md §9).

A :class:`FaultInjector` is armed onto a :class:`~repro_torch.core.node.Cluster`
and fires a fixed schedule of faults at deterministic *operation counts*
(not wall-clock times — the same schedule hits the same op index on every
run). Three hook points cover the hierarchy's failure surface:

* ``on_node_op``   — counted at every ``PSNode.pull/push/pin``; a
  ``NODE_KILL`` event kills the target node *mid-pipeline* (DRAM lost,
  SSD shard intact), which the next touch of that node surfaces as
  :class:`~repro_torch.core.node.NodeDownError`.
* ``on_file_read`` — counted at every SSD-PS parameter-file read; an
  ``SSD_DROP`` deletes the file about to be read, ``SSD_TRUNCATE`` cuts it
  in half. Both are *detected* by the CRC32 file checksum and quarantined
  (ssd_ps.py), never served as garbage.
* ``on_transfer``  — counted at every simulated NIC message; a
  ``NIC_STALL`` adds a burst of extra latency (virtual time, plus a real
  sleep when the network model sleeps), modeling a congested/flapping link.

Schedules are either explicit (a list of :class:`FaultSpec`) or generated
from a seed (``FaultInjector.from_seed``), so a chaos benchmark can say
"1 node kill + 1 SSD file drop + 1 NIC stall, seed 7" and get the same
fault sequence on every run. Every fired fault is appended to
``injector.fired`` for assertions and bench reporting.

The injector is simulation machinery: hooks are no-ops (one attribute
check) when no injector is armed, and nothing in the recovery paths ever
consults it — recovery sees only the faults' *effects*.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

import numpy as np

NODE_KILL = "node_kill"
SSD_DROP = "ssd_drop"
SSD_TRUNCATE = "ssd_truncate"
NIC_STALL = "nic_stall"

_KINDS = (NODE_KILL, SSD_DROP, SSD_TRUNCATE, NIC_STALL)
# which op counter each fault kind fires on
_COUNTER_OF = {
    NODE_KILL: "node_op",
    SSD_DROP: "file_read",
    SSD_TRUNCATE: "file_read",
    NIC_STALL: "transfer",
}


@dataclass
class FaultSpec:
    """One scheduled fault: fires once when its op counter reaches ``at_op``."""

    kind: str
    at_op: int
    node_id: int = 0  # NODE_KILL target
    stall_s: float = 0.02  # NIC_STALL extra seconds (virtual)
    fired: bool = field(default=False, compare=False)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Seed- or schedule-driven fault source for the PS hierarchy."""

    def __init__(self, schedule: "list[FaultSpec]"):
        self.schedule = list(schedule)
        self.fired: list[dict] = []
        self._lock = threading.Lock()
        self._ops = {"node_op": 0, "file_read": 0, "transfer": 0}
        self._cluster = None

    @classmethod
    def from_seed(
        cls,
        seed: int,
        n_nodes: int,
        kills: int = 1,
        drops: int = 1,
        stalls: int = 1,
        truncates: int = 0,
        horizon: int = 200,
    ) -> "FaultInjector":
        """A reproducible random schedule: op indices, kill targets, and
        stall lengths all come from one seeded generator."""
        rng = np.random.default_rng(seed)
        schedule: list[FaultSpec] = []
        for _ in range(kills):
            schedule.append(
                FaultSpec(
                    NODE_KILL,
                    at_op=int(rng.integers(1, max(2, horizon))),
                    node_id=int(rng.integers(0, max(1, n_nodes))),
                )
            )
        for kind, n in ((SSD_DROP, drops), (SSD_TRUNCATE, truncates)):
            for _ in range(n):
                schedule.append(
                    FaultSpec(kind, at_op=int(rng.integers(1, max(2, horizon))))
                )
        for _ in range(stalls):
            schedule.append(
                FaultSpec(
                    NIC_STALL,
                    at_op=int(rng.integers(1, max(2, horizon))),
                    stall_s=float(rng.uniform(0.005, 0.05)),
                )
            )
        return cls(schedule)

    # ------------------------------------------------------------- arming
    def arm(self, cluster) -> "FaultInjector":
        """Wire the hooks into every node (ops + SSD reads) and the NIC."""
        self._cluster = cluster
        for node in cluster.nodes:
            node.faults = self
            node.ssd.faults = self
        cluster.network.faults = self
        return self

    def disarm(self) -> None:
        if self._cluster is not None:
            for node in self._cluster.nodes:
                node.faults = None
                node.ssd.faults = None
            self._cluster.network.faults = None
            self._cluster = None

    # -------------------------------------------------------------- hooks
    def _due(self, counter: str) -> "list[FaultSpec]":
        """Advance ``counter`` and return the specs due at this op. A spec
        stays due (``at_op <= count``, not ``==``) until its handler marks
        it fired — so a fault scheduled between two observed ops fires at
        the next one, and a handler that declines a target (e.g. a
        snapshot-retained file) retries at the next op."""
        count = self._ops[counter] = self._ops[counter] + 1
        return [
            spec
            for spec in self.schedule
            if not spec.fired
            and _COUNTER_OF[spec.kind] == counter
            and spec.at_op <= count
        ]

    def _log(self, spec: FaultSpec, **detail) -> None:
        self.fired.append(
            {"kind": spec.kind, "at_op": self._ops[_COUNTER_OF[spec.kind]], **detail}
        )

    def on_node_op(self, node, op: str) -> None:
        """Called at the top of PSNode.pull/push/pin. May kill any node in
        the armed cluster (including the one being touched — the caller's
        alive check then raises NodeDownError, i.e. a kill mid-request)."""
        with self._lock:
            for spec in self._due("node_op"):
                if spec.kind == NODE_KILL and self._cluster is not None:
                    spec.fired = True
                    target = self._cluster.nodes[spec.node_id % len(self._cluster.nodes)]
                    target.kill()
                    self._log(spec, node_id=target.node_id, during=op)

    def on_file_read(self, ssd, meta) -> None:
        """Called before SSD-PS opens ``meta.path``. Drops or truncates the
        file about to be read so the corruption is observed immediately.

        Snapshot-retained files are skipped (the fault defers to the next
        read of a local-only file): published snapshots model replicas on
        durable remote storage — see DESIGN.md §9 — and dropping the local
        path would, in this single-host simulation, also destroy the heal
        base that real deployments keep elsewhere."""
        with self._lock:
            for spec in self._due("file_read"):
                if spec.kind not in (SSD_DROP, SSD_TRUNCATE):
                    continue
                if ssd.is_retained(meta.path):
                    continue  # stays due; fires on the next local-only read
                spec.fired = True
                if spec.kind == SSD_DROP:
                    try:
                        os.remove(meta.path)
                    except FileNotFoundError:
                        pass
                else:
                    try:
                        size = os.path.getsize(meta.path)
                        with open(meta.path, "r+b") as f:
                            f.truncate(max(1, size // 2))
                    except FileNotFoundError:
                        pass
                self._log(spec, path=meta.path)

    def on_transfer(self, network) -> float:
        """Called per NIC message; returns extra stall seconds (0 normally)."""
        extra = 0.0
        with self._lock:
            for spec in self._due("transfer"):
                if spec.kind == NIC_STALL:
                    spec.fired = True
                    extra += spec.stall_s
                    self._log(spec, stall_s=spec.stall_s)
        return extra

    # ------------------------------------------------------------- report
    def ops_seen(self) -> dict:
        with self._lock:
            return dict(self._ops)

    def all_fired(self) -> bool:
        return all(s.fired for s in self.schedule)
