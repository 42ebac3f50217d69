"""Multi-table PS client: named tables + batch sessions (DESIGN.md §6).

:class:`PSClient` is the user-facing surface of the hierarchical parameter
server. It hosts any number of named tables (``TableSpec``/``RowSchema``,
see :mod:`repro_torch.core.tables`) over ONE shared HBM/MEM/SSD cluster and
replaces the loose ``prepare_batch`` / ``finish_batch`` / ``complete_batch``
/ ``abort_batch`` quartet with a :class:`BatchSession` handle carrying
explicit commit/abort semantics::

    client = PSClient(cluster, [TableSpec("ctr", RowSchema.with_adagrad(8))])
    with client.session("ctr", batch.keys) as s:
        new_emb, new_acc = device_step(s.params, s.opt_state, s.slots, ...)
        s.commit(new_emb, new_acc)            # push + unpin
    # exiting without commit aborts (unpin, no update)

Each table gets its own :class:`~repro_torch.core.hier_ps.HierarchicalPS` engine
over the shared cluster; the engines share one
:class:`~repro_torch.core.pipeline.DependencyRegistry` (token families are
namespaced per table id). Because session keys are namespaced by high-bit
tagging before they reach the engine, cross-batch conflicts — and therefore
the in-flight registry, version forwarding and deferred pushes behind the
bitwise serial-parity guarantee — are strictly per-table.

Session flavours:

* **training** (default) — pulls with MEM-PS pins through the in-flight
  registry; ``commit(new_params, new_opt)`` pushes + unpins (pass
  ``defer=True`` from a pipeline's train stage to deposit only, letting
  the pull/push stage thread apply the push); ``abort()`` unpins without
  updating. Exiting a ``with`` block without committing aborts.
* **read-only** (``read_only=True``) — ad-hoc single-shot reads: pulls
  *without* pins and never touches the in-flight registry, so decode loops
  cannot accumulate pin pressure; ``commit`` is an error. With
  ``NetworkModel(wire_quantize=True)`` these reads travel the int8 wire
  format. The first-class serving path is :meth:`PSClient.serving_view`
  (DESIGN.md §7): a request-coalescing
  :class:`~repro_torch.serve.engine.ServingEngine` with a version-keyed hot-row
  cache over published snapshots.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.compression import WireConfig
from repro_torch.core.hier_ps import HierarchicalPS, WorkingSet
from repro_torch.core.node import Cluster
from repro_torch.core.pipeline import DependencyRegistry
from repro_torch.core.tables import RowSchema, TableRegistry, TableSpec
from repro_torch.metrics import Counters


class SessionStateError(RuntimeError):
    """Commit/abort called on a session that already left the open state."""


class BatchSession:
    """One batch's working rows on one named table.

    Construct via :meth:`PSClient.session`. Usable as a context manager
    (exit without commit = abort) or as a plain handle passed between
    pipeline stages (the trainer prepares on the pull/push thread and
    commits from the train stage with ``defer=True``).
    """

    def __init__(
        self,
        engine: HierarchicalPS,
        spec: TableSpec,
        batch_keys: np.ndarray,
        *,
        batch_id: int | None = None,
        device_resident_prev: bool = False,
        read_only: bool = False,
        requester: int = 0,
    ):
        self.spec = spec
        self.read_only = read_only
        self._engine = engine
        self._state = "open"
        tagged = spec.namespace(batch_keys)
        if read_only:
            # serving path: no pins, no in-flight registry — stale-by-one
            # reads are acceptable for inference, pin pressure is not
            flat = np.asarray(tagged, dtype=np.uint64).reshape(-1)
            uniq, inverse = np.unique(flat, return_inverse=True)
            rows = engine.cluster.pull(uniq, requester=requester, pin=False)
            self.ws = WorkingSet(
                keys=uniq,
                params=rows[:, : engine.emb_dim],
                opt_state=rows[:, engine.emb_dim : engine.width],
                slots=inverse.astype(np.int32).reshape(np.shape(tagged)),
                batch_id=-1,
            )
        else:
            self.ws = engine.prepare_batch(
                tagged,
                requester=requester,
                batch_id=batch_id,
                device_resident_prev=device_resident_prev,
            )

    # ----------------------------------------------------------- the rows
    @property
    def keys(self) -> np.ndarray:
        """Unique referenced keys in *cluster* key space (tagged)."""
        return self.ws.keys

    @property
    def raw_keys(self) -> np.ndarray:
        """Unique referenced keys in this table's raw key space."""
        return self.spec.raw(self.ws.keys)

    @property
    def params(self) -> np.ndarray:
        return self.ws.params

    @property
    def opt_state(self) -> np.ndarray:
        return self.ws.opt_state

    @property
    def slots(self) -> np.ndarray:
        return self.ws.slots

    @property
    def n_working(self) -> int:
        return self.ws.n_working

    @property
    def batch_id(self) -> int:
        return self.ws.batch_id

    @property
    def state(self) -> str:
        return self._state

    def field(self, name: str) -> np.ndarray:
        """View of one named schema field of the working rows."""
        sl = self.spec.schema.slice_of(name)
        if sl.start < self._engine.emb_dim:
            return self.ws.params[:, sl]
        off = self._engine.emb_dim
        return self.ws.opt_state[:, sl.start - off : sl.stop - off]

    # ------------------------------------------------------- commit/abort
    def commit(
        self,
        new_params: np.ndarray,
        new_opt_state: np.ndarray | None = None,
        *,
        defer: bool = False,
    ) -> None:
        """Publish the trained rows and release the session.

        ``defer=True`` only deposits the results (the push runs on the next
        ``prepare``/``apply_ready_pushes``/``drain`` on the pull/push stage
        thread, and the rows become the forwarding source for conflicting
        successor batches); the default pushes synchronously."""
        if self.read_only:
            raise SessionStateError("read-only session cannot commit")
        if self._state != "open":
            raise SessionStateError(f"commit on a {self._state} session")
        self._engine.finish_batch(self.ws, new_params, new_opt_state)
        self._state = "committed"
        if not defer:
            self._engine.apply_ready_pushes()

    def abort(self) -> None:
        """Release the session without publishing (unpins pulled rows)."""
        if self._state != "open":
            raise SessionStateError(f"abort on a {self._state} session")
        if not self.read_only:
            self._engine.abort_batch(self.ws)
        self._state = "aborted"

    # ----------------------------------------------------- context manager
    def __enter__(self) -> "BatchSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._state == "open":
            self.abort()
        return False


class PSClient:
    """Named tables + sessions over one shared PS cluster.

    ``tables`` seeds the cluster's :class:`TableRegistry` (specs, or
    ``(name, RowSchema)`` pairs — ids are auto-assigned in order). A client
    over a cluster that already hosts tables (restored from a checkpoint
    manifest, or shared with another client) picks those up automatically.
    """

    def __init__(
        self,
        cluster: Cluster,
        tables: "list[TableSpec | tuple[str, RowSchema]] | None" = None,
        deps: DependencyRegistry | None = None,
        wire: WireConfig | None = None,
    ):
        self.cluster = cluster
        self.deps = deps or DependencyRegistry()
        # the training-wire config (quantized push + dedup window, DESIGN.md
        # §13) applies uniformly to every table engine this client builds
        self.wire = wire or WireConfig()
        registry = cluster.tables if cluster.tables is not None else TableRegistry()
        for t in tables or []:
            spec = t if isinstance(t, TableSpec) else TableSpec(name=t[0], schema=t[1])
            registry.add(spec)
        self.registry = registry
        if len(registry):
            cluster.register_tables(registry)
        self._engines: dict[str, HierarchicalPS] = {}
        for spec in registry:
            self._engines[spec.name] = HierarchicalPS(
                cluster, deps=self.deps, spec=spec, wire=self.wire
            )

    # ------------------------------------------------------------- tables
    def create_table(
        self,
        name: str,
        schema: RowSchema,
        *,
        table_id: int | None = None,
        init_scale: float | None = None,
    ) -> TableSpec:
        """Register a table after construction (id auto-assigned unless
        given explicitly)."""
        spec = self.registry.add(
            TableSpec(name, schema, table_id=table_id, init_scale=init_scale)
        )
        self.cluster.register_tables(self.registry)
        self._engines[spec.name] = HierarchicalPS(
            self.cluster, deps=self.deps, spec=spec, wire=self.wire
        )
        return spec

    @property
    def table_names(self) -> list[str]:
        return self.registry.names

    def table(self, name: str) -> TableSpec:
        return self.registry.get(name)

    def engine(self, name: str) -> HierarchicalPS:
        """The per-table orchestration engine (in-flight registry, stats)."""
        return self._engines[name]

    def stats(self, name: str):
        return self._engines[name].stats

    # --------------------------------------------------------- training wire
    def wire_counters(self) -> dict:
        """Per-class bytes-on-wire counters summed across every table."""
        acc = Counters()
        for e in self._engines.values():
            acc.add_from(e.wire_counters)
        return acc.snapshot()

    def wire_state(self) -> dict:
        """Checkpointable error-feedback residual state, keyed by table
        name (tables with the lossy wire off are omitted)."""
        out = {}
        for name, e in self._engines.items():
            st = e.wire_state()
            if st is not None:
                out[name] = st
        return out

    def load_wire_state(self, state: dict) -> None:
        """Restore per-table error-feedback residuals saved by
        :meth:`wire_state` (unknown tables are ignored)."""
        for name, st in (state or {}).items():
            if name in self._engines:
                self._engines[name].load_wire_state(st)

    # ------------------------------------------------------------ sessions
    def session(
        self,
        table: str,
        batch_keys: np.ndarray,
        *,
        batch_id: int | None = None,
        device_resident_prev: bool = False,
        read_only: bool = False,
        requester: int = 0,
    ) -> BatchSession:
        """Open a batch session on ``table`` for the given raw keys."""
        spec = self.registry.require(table)
        return BatchSession(
            self._engines[table],
            spec,
            batch_keys,
            batch_id=batch_id,
            device_resident_prev=device_resident_prev,
            read_only=read_only,
            requester=requester,
        )

    # ------------------------------------------------------------- serving
    def serving_view(
        self,
        version: int | None = None,
        *,
        snapshots=None,
        network=None,
        **engine_kw,
    ) -> "ServingEngine":
        """The serving entry point (DESIGN.md §7): a request-coalescing
        :class:`~repro_torch.serve.engine.ServingEngine` over this client's tables.

        With ``snapshots`` (a :class:`~repro_torch.serve.snapshot.SnapshotPublisher`
        or a snapshot directory) the engine opens the published ``version``
        (default: latest) **read-only** — the production train->serve
        handoff, isolated from ongoing training and atomically
        roll-forwardable. Without it the engine serves pin-free straight off
        the live cluster (demos, tests). ``network`` configures the
        serving-side NIC model (e.g. ``NetworkModel(wire_quantize=True)``
        for int8 remote reads); remaining kwargs reach the engine
        (``cache_rows``, ``device_hot_rows``, ``coalesce_window_s``).
        """
        from repro_torch.serve.engine import LiveClusterView, ServingEngine
        from repro_torch.serve.snapshot import ServingCluster

        if snapshots is not None:
            directory = getattr(snapshots, "dir", snapshots)
            source = ServingCluster(directory, version=version, network=network)
        else:
            if version is not None:
                raise ValueError(
                    "pinning a published version needs `snapshots=`; the live "
                    "cluster view is unversioned"
                )
            if network is not None:
                raise ValueError(
                    "the live view reads over the cluster's own NetworkModel; "
                    "`network=` only configures a snapshot ServingCluster"
                )
            source = LiveClusterView(self.cluster)
        return ServingEngine(source, **engine_kw)

    # ----------------------------------------------------------- lifecycle
    def apply_ready_pushes(self) -> int:
        """Apply every table's completed deferred pushes (pull/push stage)."""
        return sum(e.apply_ready_pushes() for e in self._engines.values())

    def drain(self, strict: bool = True) -> None:
        """Push every trained batch and unpin the rest, on every table."""
        errs = []
        for e in self._engines.values():
            try:
                e.drain(strict=strict)
            except Exception as err:  # keep draining the other tables
                errs.append(err)
        if errs and strict:
            raise errs[0]

    def n_inflight(self) -> int:
        return sum(e.n_inflight() for e in self._engines.values())

    def manifest(self) -> dict:
        """Cluster manifest (flushes dirty rows); records the table specs."""
        return self.cluster.manifest()
