"""HBM-PS: device residency of working rows across batches and requests.

The port's counterpart of the reference's ``core/hbm_ps.py``:
:class:`WorkingTable` (the single-device working table's
``get``/``accumulate``/``insert`` through the ``embedding_lookup`` and
``scatter_add`` kernels); :class:`ShardedWorkingTable` (the table
partitioned over a mesh axis, slot ``s`` on shard ``s % S`` at local row ``s
// S``, with the ``psum`` and two-``all_to_all`` exchanges of paper §4) and
its host helpers :func:`shard_layout`, :func:`to_sharded_rows`,
:func:`from_sharded_rows` and :func:`plan_a2a` (the reference's numpy);
:func:`assemble_rows`;
for training,
:class:`ReusePlan`, :class:`ReuseStats` and :class:`DeviceWorkingSet`
(rows shared with the previous batch stay on the device); for serving,
:class:`HotPlan`, :class:`HotSetStats` and :class:`DeviceHotSet` (the
hottest rows stay on the device). The plan logic is the reference's numpy;
only the device tables and their gathers and scatters are torch. Because
serving rows are immutable within a snapshot version, any device-resident
copy equals the host copy bit-for-bit — residency is keyed by version and
resets on a roll-forward.

Torch raises on an out-of-bounds gather where ``jnp`` clamps, so a stale
plan would fail loudly here instead of serving wrong rows; the engine's
replan-on-generation check (``ServingEngine.lookup_device``) still keeps
plans fresh.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.keys import member_sorted
from repro_torch.kernels import ops as kops


class WorkingTable:
    """Dense device working table with hash-table semantics: the MEM-PS
    renumbers a batch's unique keys to contiguous slots, so ``get`` is a row
    gather and ``accumulate`` a scatter-add. Functional, as the reference's:
    each returns a new tensor."""

    @staticmethod
    def get(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
        return kops.embedding_lookup(table, slots)

    @staticmethod
    def accumulate(
        table: torch.Tensor, slots: torch.Tensor, values: torch.Tensor,
        *, assume_sorted: bool = False,
    ) -> torch.Tensor:
        return kops.scatter_add(table, slots, values, assume_sorted=assume_sorted)

    @staticmethod
    def insert(table: torch.Tensor, slots: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        out = table.clone()
        out[slots.long()] = values.to(table.dtype)
        return out


# --------------------------------------------------------------------------
# sharded working table over the `model` mesh axis
# --------------------------------------------------------------------------


def shard_layout(n_working: int, n_shards: int) -> int:
    """Rows per shard after padding (slot s -> shard s % S, row s // S)."""
    return (n_working + n_shards - 1) // n_shards


def to_sharded_rows(values: np.ndarray, n_shards: int) -> np.ndarray:
    """Host-side: [n_working, d] -> [S * rows_per_shard, d] padded, where the
    shard-major layout matches the device partition (shard = slot % S)."""
    n, d = values.shape
    rps = shard_layout(n, n_shards)
    out = np.zeros((n_shards * rps, d), dtype=values.dtype)
    for s in range(n_shards):
        rows = values[s::n_shards]
        out[s * rps : s * rps + len(rows)] = rows
    return out


def from_sharded_rows(sharded: np.ndarray, n_working: int, n_shards: int) -> np.ndarray:
    n, d = n_working, sharded.shape[1]
    rps = shard_layout(n, n_shards)
    out = np.zeros((n, d), dtype=sharded.dtype)
    for s in range(n_shards):
        take = len(out[s::n_shards])
        out[s::n_shards] = sharded[s * rps : s * rps + take]
    return out


def psum_body(local: torch.Tensor, slots: torch.Tensor, rank: int, n_shards: int) -> torch.Tensor:
    """Shard ``rank``'s part of :meth:`ShardedWorkingTable.get_psum`: the
    rows of the slots it owns (``slot % S == rank``, local row ``slot //
    S``) through ``embedding_lookup``, zero for the others. The S parts sum
    to ``WorkingTable.get`` of the whole table."""
    owned = (slots % n_shards) == rank
    local_row = torch.where(owned, slots // n_shards, 0)
    rows = kops.embedding_lookup(local, local_row)
    return rows.masked_fill(~owned[:, None], 0.0)


def accumulate_body(local: torch.Tensor, slots: torch.Tensor, grads: torch.Tensor, rank: int,
                    n_shards: int, *, assume_sorted: bool = False) -> torch.Tensor:
    """Shard ``rank``'s :meth:`ShardedWorkingTable.accumulate`: the gradients
    of the slots it does not own zeroed, then ``scatter_add`` at ``slot //
    S`` -> its new local shard. The zeros land in valid rows, so ascending
    slots stay ascending local rows (``assume_sorted``)."""
    owned = (slots % n_shards) == rank
    g = grads.masked_fill(~owned[:, None], 0.0)
    return kops.scatter_add(local, slots // n_shards, g, assume_sorted=assume_sorted)


def a2a_serve_body(local: torch.Tensor, requested: torch.Tensor, n_shards: int) -> torch.Tensor:
    """An owner's side of :meth:`ShardedWorkingTable.get_a2a`: the rows of
    the ``[S * m]`` slots the requesters sent it (all its own) -> ``[S * m,
    d]``, through ``embedding_lookup``."""
    return kops.embedding_lookup(local, requested // n_shards)


def a2a_restore_body(received: torch.Tensor, restore_r: torch.Tensor) -> torch.Tensor:
    """A requester's side of :meth:`ShardedWorkingTable.get_a2a`: its batch
    positions' rows out of the ``[S * m, d]`` rows the owners sent back,
    through ``embedding_lookup``."""
    return kops.embedding_lookup(received, restore_r)


class ShardedWorkingTable:
    """Working table sharded over a mesh axis with explicit collectives: the
    reference's ``ShardedWorkingTable`` (paper §4's per-GPU modulo
    partition), run eagerly over ``mesh.get_group(axis)``, one process per
    device. Each rank passes its own ``[rows_per_shard, d]`` shard
    (``to_sharded_rows``' block ``rank``) where the reference passes one
    global array sharded over the axis. Each op is a per-shard body (a plain
    function of the local shard, the slots, the rank and S, which a single
    process can run for every shard) plus its collectives."""

    def __init__(self, mesh, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.rank = mesh.get_local_rank(axis)
        self.n_shards = mesh.size(mesh.mesh_dim_names.index(axis))

    def get_psum(self, local: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
        """slots: [B] (the same on every shard) -> [B, d] on every shard:
        each shard's owned rows, summed by one ``all_reduce``."""
        rows = psum_body(local, slots, self.rank, self.n_shards)
        dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=self.group)
        return rows

    def accumulate(self, local: torch.Tensor, slots: torch.Tensor, grads: torch.Tensor, *,
                   assume_sorted: bool = False) -> torch.Tensor:
        """grads: [B, d] for all B slots (already summed over the data axis)
        -> this shard's new local rows; each shard applies the rows it
        owns. No collective."""
        return accumulate_body(local, slots, grads, self.rank, self.n_shards,
                               assume_sorted=assume_sorted)

    def get_a2a(self, local: torch.Tensor, req_r: torch.Tensor,
                restore_r: torch.Tensor) -> torch.Tensor:
        """The paper's p2p ``get`` as two ``all_to_all_single``: ``req_r``
        ([S, m], :func:`plan_a2a`'s ``req[rank]``) goes to the owners, which
        gather their rows and send them back; ``restore_r`` (``restore[rank]``)
        picks this requester's ``B / S`` rows out of them -> [B / S, d]."""
        requested = torch.empty(req_r.numel(), dtype=req_r.dtype, device=req_r.device)
        dist.all_to_all_single(requested, req_r.reshape(-1).contiguous(), group=self.group)
        rows = a2a_serve_body(local, requested, self.n_shards)
        received = torch.empty_like(rows)
        dist.all_to_all_single(received, rows, group=self.group)
        return a2a_restore_body(received, restore_r)


def plan_a2a(slots: np.ndarray, n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side routing plan for :meth:`ShardedWorkingTable.get_a2a`.

    Splits the batch into one contiguous chunk per requester shard and
    groups each chunk's slots by owner shard, padding every (requester,
    owner) request list to the same length m (pad entries request slot
    ``o`` — owner o's local row 0 — and are dropped by ``restore``).

    Returns (req [S, S, m] int32, restore [S, B//S] int32) with
    ``restore[r, j]`` indexing into the [S*m] rows shard r receives.
    """
    slots = np.asarray(slots, dtype=np.int64)
    S = n_shards
    B = len(slots)
    assert B % S == 0, f"batch {B} must pad to a multiple of {S} requesters"
    chunk = B // S
    # group by (requester, owner) in a few vectorized passes: a stable
    # argsort on the pair id keeps each group's request order, cumsum gives
    # group starts, and positions within a group follow by subtraction
    owners = slots % S
    pair = np.repeat(np.arange(S, dtype=np.int64), chunk) * S + owners
    order = np.argsort(pair, kind="stable")
    counts = np.bincount(pair, minlength=S * S)
    m = max(1, int(counts.max()))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(B, dtype=np.int64) - np.repeat(starts, counts)
    req = np.tile(np.arange(S, dtype=np.int32), (S, 1))[:, :, None].repeat(m, axis=2)
    req.reshape(S * S, m)[pair[order], rank] = slots[order]
    restore = np.empty(B, dtype=np.int32)
    restore[order] = owners[order] * m + rank
    return req, restore.reshape(S, chunk)


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


def assemble_rows(
    prev_table: torch.Tensor | None,
    fresh_rows: torch.Tensor,
    reuse_src: np.ndarray,
    reuse_dst: np.ndarray,
    fresh_dst: np.ndarray,
    n_working: int,
) -> torch.Tensor:
    """Build a [n_working, d] device table from already-resident rows plus
    the freshly-transferred delta: gather of ``prev_table[reuse_src]`` into
    ``reuse_dst`` + scatter of ``fresh_rows`` into ``fresh_dst``. Pure data
    movement — bitwise. Shared by the training :class:`DeviceWorkingSet`
    (previous-batch residency) and the serving :class:`DeviceHotSet`
    (frequency-ranked residency)."""
    if len(reuse_src) == 0:
        return fresh_rows  # fresh_dst is the identity permutation
    dev = fresh_rows.device
    out = torch.zeros((n_working, fresh_rows.shape[-1]), dtype=fresh_rows.dtype, device=dev)
    out[_index(reuse_dst, dev)] = prev_table[_index(reuse_src, dev)]
    out[_index(fresh_dst, dev)] = fresh_rows
    return out


@dataclass
class ReusePlan:
    """How to assemble one batch's device table from the previous one."""

    n_working: int
    seq: int  # device-table generation this plan expects to remap from
    reuse_src: np.ndarray  # int32 — row in the PREVIOUS device table
    reuse_dst: np.ndarray  # int32 — row in the new table (same key)
    fresh_dst: np.ndarray  # int32 — new-table rows transferred from host

    @property
    def n_reused(self) -> int:
        return len(self.reuse_src)


@dataclass
class ReuseStats:
    batches: int = 0
    rows_reused: int = 0
    rows_transferred: int = 0
    bytes_saved: int = 0  # host->device bytes avoided by on-device remap
    bytes_transferred: int = 0


class DeviceWorkingSet:
    """Keeps consecutive batches' shared rows device-resident.

    The MEM-PS renumbers each batch's keys to fresh contiguous slots, so a
    key shared by batches i and i+1 lands at a *different* slot — but its
    post-train value already lives in batch i's final device table. ``plan``
    matches the new batch's (sorted, unique) keys against the previous
    batch's and emits a slot remap; ``assemble`` builds the new table on
    device from the remapped rows plus only the freshly-transferred delta.
    Values are bitwise-identical to a full host pull because the final
    device rows are exactly what the host push wrote back.
    """

    def __init__(self, row_bytes: int):
        self.row_bytes = int(row_bytes)
        self.stats = ReuseStats()
        self._prev_keys: np.ndarray | None = None
        self._seq = 0
        self._last_ext_id: int | None = None
        self._last_plan: ReusePlan | None = None

    def reset(self) -> None:
        """Invalidate residency (resume/restore or an aborted pipeline)."""
        self._prev_keys = None
        self._last_ext_id = None
        self._last_plan = None

    def plan(self, keys: np.ndarray, batch_id: int | None = None) -> ReusePlan:
        """keys: sorted unique uint64 of the new batch. Updates state.

        ``batch_id`` dedups a retried transfer stage: re-planning the same
        batch would diff its keys against themselves (and skew the device
        generation), so an immediate re-plan returns the original plan."""
        if batch_id is not None and batch_id == self._last_ext_id:
            return self._last_plan
        n = len(keys)
        prev = self._prev_keys
        self._prev_keys = keys
        self._seq += 1
        self._last_ext_id = batch_id
        self.stats.batches += 1
        if prev is None or len(prev) == 0:
            fresh = np.arange(n, dtype=np.int32)
            empty = np.empty(0, dtype=np.int32)
            self.stats.rows_transferred += n
            self.stats.bytes_transferred += n * self.row_bytes
            self._last_plan = ReusePlan(n, self._seq, empty, empty, fresh)
            return self._last_plan
        hit, pos_c = member_sorted(prev, keys)
        reuse_dst = np.nonzero(hit)[0].astype(np.int32)
        reuse_src = pos_c[hit].astype(np.int32)
        fresh_dst = np.nonzero(~hit)[0].astype(np.int32)
        self.stats.rows_reused += len(reuse_dst)
        self.stats.rows_transferred += len(fresh_dst)
        self.stats.bytes_saved += len(reuse_dst) * self.row_bytes
        self.stats.bytes_transferred += len(fresh_dst) * self.row_bytes
        self._last_plan = ReusePlan(n, self._seq, reuse_src, reuse_dst, fresh_dst)
        return self._last_plan

    @staticmethod
    def assemble(prev_table: torch.Tensor | None, fresh_rows: torch.Tensor, plan: ReusePlan) -> torch.Tensor:
        """Build the [n_working, d] table: device gather of reused rows +
        scatter of the transferred delta. Pure data movement — bitwise."""
        return assemble_rows(
            prev_table, fresh_rows,
            plan.reuse_src, plan.reuse_dst, plan.fresh_dst, plan.n_working,
        )


@dataclass
class HotPlan:
    """How to assemble one lookup's device table from the hot resident set."""

    n_working: int
    version: int
    keys: np.ndarray  # uint64 — the lookup's sorted unique keys
    reuse_src: np.ndarray  # int32 — row in the RESIDENT device table
    reuse_dst: np.ndarray  # int32 — row in the lookup's table (same key)
    fresh_dst: np.ndarray  # int32 — lookup rows transferred from host

    @property
    def n_reused(self) -> int:
        return len(self.reuse_src)


@dataclass
class HotSetStats:
    steps: int = 0
    rows_reused: int = 0
    rows_transferred: int = 0
    bytes_saved: int = 0  # host->device bytes avoided by residency
    bytes_transferred: int = 0

    @property
    def device_hit_rate(self) -> float:
        return self.rows_reused / max(1, self.rows_reused + self.rows_transferred)


class DeviceHotSet:
    """Keeps the hottest serving rows device-resident across decode steps.

    The training working set exploits *adjacency* (training batch i+1
    shares keys with batch i); serving streams instead revisit a skewed hot
    set over many steps, so this class ranks keys by visit frequency and
    keeps the top ``capacity`` resident. Per lookup:

      1. ``plan``      — match the lookup's unique keys against the resident
                         set (one ``member_sorted`` pass); only the misses
                         need a host row.
      2. ``assemble``  — build the lookup's dense [n_working, d] table on
                         device: gather of resident rows + scatter of the
                         transferred delta (same primitive as training).
      3. ``admit``     — fold the lookup's keys into the frequency ranking
                         and refresh the resident table, sourcing rows from
                         the just-built lookup table and the old resident
                         table (both bitwise-correct: a version's rows are
                         immutable, so every copy of a key's row is equal).

    Residency is **version-keyed**: ``plan`` with a different snapshot
    version resets the set, so a roll-forward can never serve a stale row.
    """

    def __init__(self, capacity: int, row_bytes: int):
        self.capacity = int(capacity)
        self.row_bytes = int(row_bytes)
        self.stats = HotSetStats()
        self.generation = 0  # bumped on every resident-set mutation; lets
        # callers release their lock across the host pull and detect a
        # concurrent admit/reset before assembling against a stale plan
        self._version: int | None = None
        self._keys: np.ndarray | None = None  # sorted unique resident keys
        self._freq: np.ndarray | None = None  # int64, aligned with _keys
        self._table: torch.Tensor | None = None  # [len(_keys), d] resident rows

    @property
    def n_resident(self) -> int:
        return 0 if self._keys is None else len(self._keys)

    def reset(self) -> None:
        self.generation += 1
        self._version = None
        self._keys = None
        self._freq = None
        self._table = None

    def plan(self, keys: np.ndarray, version: int) -> HotPlan:
        """keys: sorted unique uint64 of one lookup; version: the snapshot
        version the caller's rows come from."""
        if version != self._version:
            self.reset()
            self._version = version
        n = len(keys)
        self.stats.steps += 1
        if self._keys is None or len(self._keys) == 0:
            fresh = np.arange(n, dtype=np.int32)
            empty = np.empty(0, dtype=np.int32)
            self.stats.rows_transferred += n
            self.stats.bytes_transferred += n * self.row_bytes
            return HotPlan(n, version, keys, empty, empty, fresh)
        hit, pos = member_sorted(self._keys, keys)
        reuse_dst = np.nonzero(hit)[0].astype(np.int32)
        reuse_src = pos[hit].astype(np.int32)
        fresh_dst = np.nonzero(~hit)[0].astype(np.int32)
        self.stats.rows_reused += len(reuse_dst)
        self.stats.rows_transferred += len(fresh_dst)
        self.stats.bytes_saved += len(reuse_dst) * self.row_bytes
        self.stats.bytes_transferred += len(fresh_dst) * self.row_bytes
        return HotPlan(n, version, keys, reuse_src, reuse_dst, fresh_dst)

    def assemble(self, fresh_rows: torch.Tensor, plan: HotPlan) -> torch.Tensor:
        """Lookup table from resident rows + transferred delta (device-side
        data movement only)."""
        return assemble_rows(
            self._table, fresh_rows,
            plan.reuse_src, plan.reuse_dst, plan.fresh_dst, plan.n_working,
        )

    def admit(self, batch_table: torch.Tensor, plan: HotPlan) -> None:
        """Update the frequency ranking with this lookup and refresh the
        resident set to the top-``capacity`` keys."""
        if plan.version != self._version:
            return  # raced with a reset; next plan() rebuilds
        keys = plan.keys
        if self._keys is None or len(self._keys) == 0:
            cand, freq = keys, np.ones(len(keys), dtype=np.int64)
        else:
            cand = np.union1d(self._keys, keys)  # sorted unique
            m_old, p_old = member_sorted(self._keys, cand)
            freq = np.where(m_old, self._freq[np.minimum(p_old, len(self._freq) - 1)], 0)
            m_new, _ = member_sorted(keys, cand)
            freq = freq + m_new
        if len(cand) > self.capacity:
            keep = np.zeros(len(cand), dtype=bool)
            keep[np.argsort(-freq, kind="stable")[: self.capacity]] = True
            cand, freq = cand[keep], freq[keep]  # mask keeps the sort order
        in_batch, pos_b = member_sorted(keys, cand)
        dev = batch_table.device
        tbl = torch.zeros((len(cand), batch_table.shape[-1]), dtype=batch_table.dtype, device=dev)
        b_idx = np.nonzero(in_batch)[0]
        if b_idx.size:
            tbl[_index(b_idx, dev)] = batch_table[_index(pos_b[in_batch], dev)]
        if self._keys is not None and len(self._keys):
            rest = ~in_batch
            if rest.any():
                m_old, p_old = member_sorted(self._keys, cand[rest])
                # every kept non-batch key came from the old resident set
                r_idx = np.nonzero(rest)[0]
                tbl[_index(r_idx, dev)] = self._table[_index(p_old, dev)]
        self._keys, self._freq, self._table = cand, freq, tbl
        self.generation += 1

    def assemble_and_admit(self, fresh_rows: torch.Tensor, plan: HotPlan) -> torch.Tensor:
        table = self.assemble(fresh_rows, plan)
        self.admit(table, plan)
        return table
