"""Elastic scaling: reshard a PS cluster from N to M nodes.

At 1000+ node scale, node counts change (failures, preemption, scale-up).
Key ownership is ``hash(key) % n_nodes``, so a change of n_nodes remaps
roughly (1 - 1/max(N, M)) of keys. Resharding streams each node's live rows
file-by-file (sequential reads), repartitions them by the new owner map, and
writes them into fresh SSD-PS shards — the same file-granularity sequential
I/O discipline the paper uses for updates.

Two entry points (DESIGN.md §9):

* :func:`reshard` — offline: flush, bulk-copy, done. Dead nodes are
  recovered first (``Cluster.recover_node``: restart + redo replay); if
  recovery is impossible the reshard *raises* with the lost-row count
  instead of silently dropping the dead shard's rows.
* :func:`reshard_live` — under traffic: bulk-copy while pulls/pushes keep
  flowing, then a brief write-gate pause replays only the redo-log delta
  onto the new shards. The measured pause is the write availability gap
  (reads never stop); it scales with the delta, not the table.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.keys import key_to_node
from repro_torch.core.node import Cluster, NodeDownError
from repro_torch.core.recovery import collapse_entries


def _recover_or_raise(cluster: Cluster, action: str) -> None:
    """Bring every dead node back (restart + redo replay) before moving
    rows. Without the redo log a dead shard's DRAM-resident updates are
    unrecoverable — surface that with the at-risk row count rather than
    producing a new cluster that silently lost them."""
    dead = [n for n in cluster.nodes if not n.alive]
    if not dead:
        return
    try:
        cluster.recover_dead_nodes()
    except NodeDownError as e:
        at_risk = sum(n.ssd.n_live_rows for n in dead)
        raise NodeDownError(
            f"{action} with dead node(s) {[n.node_id for n in dead]} would lose "
            f"updates to >= {at_risk} rows (SSD-resident; DRAM-resident updates "
            "uncounted): recovery failed"
        ) from e


def _bulk_copy(cluster: Cluster, new: Cluster, new_n_nodes: int) -> int:
    """Stream every live row into the new shards; returns rows moved."""
    # stage rows per new owner so each write is one (or few) sequential files
    staged_keys: list[list[np.ndarray]] = [[] for _ in range(new_n_nodes)]
    staged_vals: list[list[np.ndarray]] = [[] for _ in range(new_n_nodes)]
    moved = 0
    for node in cluster.nodes:
        for keys, vals in node.ssd.iter_live():
            owners = key_to_node(keys, new_n_nodes)
            for dst in range(new_n_nodes):
                mask = owners == dst
                if mask.any():
                    staged_keys[dst].append(keys[mask])
                    staged_vals[dst].append(vals[mask])
                    if dst != node.node_id:  # data actually moves
                        new.network.transfer(int(mask.sum()) * (8 + 4 * cluster.dim))
    for dst in range(new_n_nodes):
        if staged_keys[dst]:
            k = np.concatenate(staged_keys[dst])
            v = np.concatenate(staged_vals[dst])
            new.nodes[dst].ssd.write_batch(k, v)
            moved += len(k)
    return moved


def _make_target(cluster: Cluster, new_n_nodes: int, new_base_dir: str) -> Cluster:
    kw = cluster.ctor_kwargs()
    kw["network"] = cluster.network.fresh()
    new = Cluster(new_n_nodes, new_base_dir, cluster.dim, **kw)
    # the new shards receive rows via direct SSD writes below, which the
    # new cluster's own (empty) redo log never saw — initializer+replay
    # healing would fabricate values, so disable it until its first publish
    new._heal_from_init_ok = False
    return new


def reshard(cluster: Cluster, new_n_nodes: int, new_base_dir: str) -> Cluster:
    """Build a new cluster with ``new_n_nodes`` holding the same live rows.

    The new cluster is rebuilt from ``cluster.ctor_kwargs()`` — the full
    construction-parameter set — rather than a hand-picked subset, so no
    kwarg (file/cache capacities, init scheme, hosted table specs, future
    additions) silently reverts to its default across a reshard; only the
    NIC is replaced by a fresh same-parameter instance so the transfer
    counters below measure this reshard's own traffic. Hosted table specs
    ride along via ``tables``, keeping every named table's key namespacing
    and missing-row initializer intact on the new shards.

    Dead nodes are recovered (never silently skipped) — see
    :func:`_recover_or_raise`."""
    _recover_or_raise(cluster, "reshard")
    cluster.flush_all()
    new = _make_target(cluster, new_n_nodes, new_base_dir)
    _bulk_copy(cluster, new, new_n_nodes)
    return new


def reshard_live(
    cluster: Cluster, new_n_nodes: int, new_base_dir: str
) -> "tuple[Cluster, dict]":
    """Reshard under sustained traffic with a bounded write-availability gap.

    Phase 1 (traffic flows): flush, pin the redo log, bulk-copy every live
    row — concurrent pushes keep landing on the old cluster *and* in the
    pinned redo suffix. Phase 2 (write gate closed, reads still served):
    collapse the redo delta last-writer-wins and write it onto the new
    shards, so the new cluster ends bit-identical to the old one's final
    state. Returns ``(new_cluster, info)`` where ``info['gap_s']`` is the
    measured wall-clock write gap and ``info['delta_rows']`` the rows that
    crossed during it.

    Requires the redo log (``Cluster.enable_redo``): without delta
    tracking, traffic during the bulk copy would be silently lost."""
    if cluster.redo is None:
        raise ValueError(
            "reshard_live needs the redo log to track the live delta "
            "(Cluster.enable_redo() / redo_rows=...)"
        )
    _recover_or_raise(cluster, "reshard_live")
    # ---- phase 1: bulk copy, writes still flowing ----------------------
    # pin BEFORE flushing: a push racing into the gap between the two would
    # otherwise be neither SSD-resident for the bulk copy nor inside the
    # pinned suffix for the delta replay — i.e. silently lost
    pin = cluster.pin_redo()
    cluster.flush_all()  # everything appended before the pin is now on SSD
    new = _make_target(cluster, new_n_nodes, new_base_dir)
    moved = _bulk_copy(cluster, new, new_n_nodes)
    # ---- phase 2: gate writes, replay the delta, cut over --------------
    t0 = time.perf_counter()
    cluster.pause_writes()
    try:
        # pushes that raced the bulk copy live in MEM (dirty) *and* in the
        # pinned redo suffix; the suffix alone reconstructs their newest
        # values, no extra flush of the old cluster needed
        dk, dv = collapse_entries(cluster.redo.since(cluster.redo.pin_index(pin)))
        if len(dk):
            owners = key_to_node(dk, new_n_nodes)
            for dst in range(new_n_nodes):
                mask = owners == dst
                if mask.any():
                    new.network.transfer(int(mask.sum()) * (8 + 4 * cluster.dim))
                    new.nodes[dst].ssd.write_batch(dk[mask], dv[mask])
        gap_s = time.perf_counter() - t0
    finally:
        cluster.resume_writes()
        cluster.release_redo(pin)
    return new, {"gap_s": gap_s, "delta_rows": int(len(dk)), "moved_rows": int(moved)}
