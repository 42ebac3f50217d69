"""The paper's own CTR prediction models A-E (Table 3), plus scaled variants.

Paper Table 3:
  model  #nnz/example  #sparse      #dense   size    MPI nodes
  A      100           8e9          7e5      300 GB  100
  B      100           2e10         2e4      600 GB  80
  C      500           6e10         2e6      2 TB    75
  D      500           1e11         4e6      6 TB    150
  E      500           2e11         7e6      10 TB   128

The ``paper`` configs carry those numbers for roofline math; the ``scaled``
configs shrink the key space so the full hierarchical-PS workflow (SSD files,
cache, compaction) runs on this container while keeping the *structure*
(nnz/example ratios, dense-net shapes, zipfian key popularity) identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.tables import RowSchema, TableSpec


@dataclass(frozen=True)
class SlotGroup:
    """A set of feature slots sharing one embedding table.

    Production CTR models give different feature families (query, ad,
    user-portrait slots) different embedding widths; each group becomes a
    named table with its own :class:`RowSchema` on the shared cluster.
    """

    name: str  # table name on the PS cluster
    n_slots: int  # feature slots pooled within this group
    emb_dim: int  # embedding width of this group's table

    @property
    def pooled_dim(self) -> int:
        return self.n_slots * self.emb_dim


@dataclass(frozen=True)
class CTRConfig:
    name: str
    n_sparse_keys: int  # size of the sparse key space (rows that exist)
    nnz_per_example: int  # non-zero features per example
    emb_dim: int  # embedding width per sparse feature
    n_slots: int  # feature slots; nnz are spread across slots & sum-pooled
    mlp_hidden: tuple[int, ...]  # fully-connected tower
    batch_size: int  # examples per training batch ("HDFS batch")
    minibatches_per_batch: int  # GPU mini-batches per pulled working set
    zipf_a: float = 1.05  # key popularity skew (cache-ability)
    # heterogeneous embedding widths: slots partitioned into named groups,
    # each backed by its own PS table. None => one uniform group ("ctr")
    # of (n_slots, emb_dim) — the single-table layout.
    slot_groups: tuple[SlotGroup, ...] | None = None

    @property
    def groups(self) -> tuple[SlotGroup, ...]:
        if self.slot_groups is not None:
            return self.slot_groups
        return (SlotGroup("ctr", self.n_slots, self.emb_dim),)

    @property
    def pooled_dim(self) -> int:
        """Tower input width: per-slot sum-pools concatenated across groups."""
        return sum(g.pooled_dim for g in self.groups)

    @property
    def dense_params(self) -> int:
        dims = (self.pooled_dim,) + self.mlp_hidden + (1,)
        return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))

    @property
    def sparse_params(self) -> int:
        # each slot group draws from its own n_sparse_keys-sized key space
        return sum(self.n_sparse_keys * g.emb_dim for g in self.groups)


def table_specs(cfg: CTRConfig) -> list[TableSpec]:
    """One named training table per slot group: ``[emb | adagrad]`` rows.

    The hosting cluster's row width must be ``>= 2 * max(emb_dim)`` across
    groups; narrower groups use a row prefix (fixed-size-value design)."""
    return [TableSpec(g.name, RowSchema.with_adagrad(g.emb_dim)) for g in cfg.groups]


def _scale(name: str, keys: int, nnz: int, hidden: tuple[int, ...], batch: int) -> CTRConfig:
    return CTRConfig(
        name=name,
        n_sparse_keys=keys,
        nnz_per_example=nnz,
        emb_dim=8,
        n_slots=max(8, nnz // 4),
        mlp_hidden=hidden,
        batch_size=batch,
        minibatches_per_batch=4,
    )


# --- paper-spec configs (used for analytic/roofline math; never allocated) ---
PAPER = {
    "A": CTRConfig("ctr-A", 8 * 10**9, 100, 8, 32, (511, 255, 127), 4_000_000, 1000),
    "B": CTRConfig("ctr-B", 2 * 10**10, 100, 8, 32, (96, 64, 32), 4_000_000, 1000),
    "C": CTRConfig("ctr-C", 6 * 10**10, 500, 8, 128, (859, 430, 215), 4_000_000, 1000),
    "D": CTRConfig("ctr-D", 1 * 10**11, 500, 8, 128, (1330, 660, 330), 4_000_000, 1000),
    "E": CTRConfig("ctr-E", 2 * 10**11, 500, 8, 128, (1840, 920, 460), 4_000_000, 1000),
}

# --- container-scale configs (run the real workflow end-to-end) ---
SCALED = {
    "A": _scale("ctr-A-scaled", 80_000, 100, (64, 32), 4096),
    "B": _scale("ctr-B-scaled", 200_000, 100, (32, 16), 4096),
    "C": _scale("ctr-C-scaled", 600_000, 500, (96, 48), 2048),
    "D": _scale("ctr-D-scaled", 1_000_000, 500, (128, 64), 2048),
    "E": _scale("ctr-E-scaled", 2_000_000, 500, (160, 80), 2048),
}

# storage-bound bench config: the paper's operating point. The key space is
# far larger than the MEM-PS cache, so every batch's pull/push does real
# SSD-PS work — the regime the 4-stage pipeline exists to hide. (The SCALED
# configs' working sets cover most of their key space, so after warm-up they
# are DRAM-resident and train-bound.)
STORAGE_BENCH = CTRConfig(
    name="ctr-storage",
    n_sparse_keys=8_000_000,
    nnz_per_example=64,
    emb_dim=8,
    n_slots=16,
    mlp_hidden=(64, 32),
    batch_size=1024,
    minibatches_per_batch=8,
)

# heterogeneous per-slot embedding widths: "query"-style slots at width 4,
# "ad"-style slots at width 8, each group a named table on one cluster
# (cluster row width = 2 * max emb = 16; the width-8 rows use a prefix)
TINY_HETERO = CTRConfig(
    name="ctr-tiny-hetero",
    n_sparse_keys=1_000,
    nnz_per_example=16,
    emb_dim=8,  # max width (used for cluster sizing helpers)
    n_slots=8,
    mlp_hidden=(16, 8),
    batch_size=64,
    minibatches_per_batch=2,
    slot_groups=(SlotGroup("query", 4, 4), SlotGroup("ad", 4, 8)),
)

# a tiny config for unit tests
TINY = CTRConfig(
    name="ctr-tiny",
    n_sparse_keys=1_000,
    nnz_per_example=16,
    emb_dim=4,
    n_slots=8,
    mlp_hidden=(16, 8),
    batch_size=64,
    minibatches_per_batch=2,
)
