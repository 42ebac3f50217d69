"""Named embedding tables over one shared PS cluster (DESIGN.md §6).

The paper's production system serves many heterogeneous sparse feature
families (query, ad, user-portrait slots) out of one HBM/MEM/SSD hierarchy.
This module provides the vocabulary for that:

* :class:`RowSchema` — the named fields of one table's row (an ``emb``
  field first, then optimizer slots of any width). It replaces the
  ``emb_dim``/``opt_dim`` slicing previously hardcoded through
  ``hier_ps.py``: a row's layout is data, not convention.
* :class:`TableSpec` — a named table binding a schema to a table id. Keys
  are namespaced into the shared cluster key space by high-bit tagging
  (``keys.namespace_keys``), so tables can never collide while the
  hash-partitioned owner map still spreads every table across all nodes.
* :class:`TableRegistry` — the set of tables hosted by one cluster. The
  cluster row width is the *maximum* schema width across tables; narrower
  tables use a prefix of the fixed-size row — the paper's fixed-size-value
  design survives multi-tenancy. The registry also builds the per-key
  missing-row initializer (each table's ``emb`` field gets the
  deterministic per-key init at its own width/scale; optimizer slots and
  the unused tail are zero) and serializes to/from checkpoint manifests.

Sessions over these tables live in :mod:`repro_torch.core.client`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.keys import (
    MAX_TABLES,
    deterministic_init,
    namespace_keys,
    split_namespaced,
)


@dataclass(frozen=True)
class RowSchema:
    """Named fields of one table row: ``((name, width), ...)``.

    The first field is the embedding (randomly initialized for unseen
    keys); every later field is optimizer state of arbitrary width
    (zero-initialized). The concatenation, in order, is the fixed-size
    value that moves through MEM-PS/SSD-PS as one float32 row.
    """

    fields: tuple[tuple[str, int], ...]

    def __post_init__(self):
        if not self.fields:
            raise ValueError("RowSchema needs at least one field")
        names = [n for n, _ in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in {names}")
        for n, w in self.fields:
            if int(w) <= 0:
                raise ValueError(f"field {n!r} has non-positive width {w}")

    # ------------------------------------------------------------- layout
    @property
    def width(self) -> int:
        return sum(w for _, w in self.fields)

    @property
    def emb_dim(self) -> int:
        return self.fields[0][1]

    @property
    def opt_dim(self) -> int:
        return self.width - self.emb_dim

    def offset_of(self, name: str) -> int:
        off = 0
        for n, w in self.fields:
            if n == name:
                return off
            off += w
        raise KeyError(f"no field {name!r} in {self.fields}")

    def slice_of(self, name: str) -> slice:
        off = self.offset_of(name)
        return slice(off, off + dict(self.fields)[name])

    # ------------------------------------------------------- constructors
    @classmethod
    def embedding(cls, dim: int) -> "RowSchema":
        """Inference/serving rows: just the embedding."""
        return cls((("emb", int(dim)),))

    @classmethod
    def with_adagrad(cls, dim: int) -> "RowSchema":
        """The paper's training row: ``[emb | adagrad accumulator]``."""
        return cls((("emb", int(dim)), ("adagrad", int(dim))))

    @classmethod
    def with_slots(cls, dim: int, **slots: int) -> "RowSchema":
        """Embedding plus arbitrary named optimizer slots, e.g.
        ``RowSchema.with_slots(8, m=8, v=8, step=1)`` for row-Adam."""
        return cls((("emb", int(dim)),) + tuple((n, int(w)) for n, w in slots.items()))

    # ------------------------------------------------------- serialization
    def to_manifest(self) -> list:
        return [[n, int(w)] for n, w in self.fields]

    @classmethod
    def from_manifest(cls, m: list) -> "RowSchema":
        return cls(tuple((str(n), int(w)) for n, w in m))


@dataclass(frozen=True)
class TableSpec:
    """One named table: schema + id (the key-namespace tag) + init scale.

    ``table_id=None`` (the default) asks the registry to assign the next
    free id at registration; an explicit id is honored exactly or rejected
    if taken — never silently remapped, since the id IS the key namespace
    and a remap would point the table at different rows. ``init_scale=None``
    defers to the hosting cluster's ``init_scale`` so a single-table client
    initializes bit-identically to the pre-multi-table code path.
    """

    name: str
    schema: RowSchema
    table_id: int | None = None
    init_scale: float | None = None

    def __post_init__(self):
        if self.table_id is not None and not 0 <= self.table_id < MAX_TABLES:
            raise ValueError(f"table_id {self.table_id} out of [0, {MAX_TABLES})")

    def _assigned_id(self) -> int:
        if self.table_id is None:
            raise ValueError(
                f"table {self.name!r} has no table_id yet — register it first"
            )
        return self.table_id

    def namespace(self, keys: np.ndarray) -> np.ndarray:
        """Raw per-table keys -> shared cluster key space."""
        return namespace_keys(keys, self._assigned_id())

    def raw(self, keys: np.ndarray) -> np.ndarray:
        """Cluster keys -> this table's raw keys (drops the tag)."""
        return split_namespaced(keys)[1]

    def to_manifest(self) -> dict:
        return {
            "name": self.name,
            "table_id": None if self.table_id is None else int(self.table_id),
            "schema": self.schema.to_manifest(),
            "init_scale": self.init_scale,
        }

    @classmethod
    def from_manifest(cls, m: dict) -> "TableSpec":
        return cls(
            name=str(m["name"]),
            schema=RowSchema.from_manifest(m["schema"]),
            table_id=None if m.get("table_id") is None else int(m["table_id"]),
            init_scale=None if m.get("init_scale") is None else float(m["init_scale"]),
        )


class TableRegistry:
    """The named tables hosted by one cluster (id- and name-addressable)."""

    def __init__(self, specs: "list[TableSpec] | None" = None):
        self._by_name: dict[str, TableSpec] = {}
        self._by_id: dict[int, TableSpec] = {}
        for spec in specs or []:
            self.add(spec)

    def add(self, spec: TableSpec) -> TableSpec:
        """Register a spec. ``table_id=None`` gets the next free id; an
        explicit id is honored exactly or rejected if taken (the id is the
        key namespace — silently remapping it would point the table at
        different rows). Re-adding an identical spec is a no-op."""
        prev = self._by_name.get(spec.name)
        if prev is not None:
            if prev == spec or (spec.table_id is None and replace(spec, table_id=prev.table_id) == prev):
                return prev
            raise ValueError(f"table {spec.name!r} already registered with a different spec")
        if spec.table_id is None:
            spec = replace(spec, table_id=self._next_free_id())
        elif spec.table_id in self._by_id:
            raise ValueError(f"table_id {spec.table_id} already taken")
        self._by_name[spec.name] = spec
        self._by_id[spec.table_id] = spec
        return spec

    def _next_free_id(self) -> int:
        tid = 0
        while tid in self._by_id:
            tid += 1
        if tid >= MAX_TABLES:
            raise ValueError(f"registry full ({MAX_TABLES} tables)")
        return tid

    def __len__(self) -> int:
        return len(self._by_name)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self):
        return iter(self._by_name.values())

    def get(self, name: str) -> TableSpec:
        return self._by_name[name]

    def require(self, name: str) -> TableSpec:
        """`get` with an error that names the tables that DO exist — the
        lookup surfaces (sessions, serving engines) route through this so a
        typo'd table name fails with the menu, not a bare KeyError."""
        spec = self._by_name.get(name)
        if spec is None:
            raise KeyError(
                f"no table {name!r}; registered tables: {self.names or '(none)'}"
            )
        return spec

    def by_id(self, table_id: int) -> TableSpec:
        return self._by_id[table_id]

    @property
    def names(self) -> list[str]:
        return list(self._by_name)

    @property
    def width(self) -> int:
        """Cluster row width: the max schema width across tables (narrower
        tables use a row prefix — the fixed-size-value design survives)."""
        return max((s.schema.width for s in self), default=0)

    # --------------------------------------------------------- initializer
    def initializer(self, dim: int, default_scale: float, default_init_cols: int | None = None):
        """Vectorized missing-row initializer for the hosting SSD-PS.

        Groups the requested keys by table tag and fills each group's
        ``emb`` field with the table's deterministic per-key init (at the
        table's own width and scale); optimizer slots and the unused row
        tail stay zero. Keys with an unregistered tag fall back to the
        cluster's legacy init (``default_init_cols`` random columns at
        ``default_scale``) so raw cluster access keeps working alongside
        registered tables.
        """
        fallback_cols = dim if default_init_cols is None else int(default_init_cols)

        def init(keys: np.ndarray) -> np.ndarray:
            keys = np.asarray(keys, dtype=np.uint64)
            out = np.zeros((len(keys), dim), dtype=np.float32)
            tids, _ = split_namespaced(keys)
            for tid in np.unique(tids):
                sel = tids == tid
                spec = self._by_id.get(int(tid))
                if spec is None:
                    out[sel, :fallback_cols] = deterministic_init(
                        keys[sel], fallback_cols, default_scale
                    )
                    continue
                scale = default_scale if spec.init_scale is None else spec.init_scale
                emb = spec.schema.emb_dim
                out[sel, :emb] = deterministic_init(keys[sel], emb, scale)
            return out

        return init

    # ------------------------------------------------------- serialization
    def to_manifest(self) -> list:
        return [s.to_manifest() for s in self]

    @classmethod
    def from_manifest(cls, m: list) -> "TableRegistry":
        return cls([TableSpec.from_manifest(s) for s in m])
