"""HBM-PS: device residency of working rows across batches and requests.

The port's counterpart of the reference's ``core/hbm_ps.py`` for the
serving, training and LM serving slices: :class:`WorkingTable` (the
single-device working table's ``get``/``accumulate``/``insert`` through the
``embedding_lookup`` and ``scatter_add`` kernels); :func:`assemble_rows`;
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
