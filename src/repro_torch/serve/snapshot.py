"""Versioned snapshot publishing: the train -> serve handoff (DESIGN.md §7).

The training cluster's SSD-PS is log-structured — parameter files are
immutable and updates always land in *new* files (``ssd_ps.py``). Publishing
a serving snapshot is therefore **repointing, not copying**:

    trainer ----publish----> v_00000007.json            (manifest only)
        |                       |  key->file map, table specs, init params
        |                       |  + retention refs on every named file
        '--- keeps training --->|  (new files; compaction parks, never
                                |   deletes, a retained path)
    ServingCluster --open------>'  read-only views over the SAME files

:class:`SnapshotPublisher` captures the cluster's ``publish_manifest()``
(which atomically takes per-file retention references so compaction can
never delete a file a live version points to), writes one immutable JSON
manifest per version, and flips a ``LATEST`` pointer last — the same
temp-file + ``os.replace`` discipline as ``checkpoint.py``, whose helpers it
shares. Publishing N versions after training M batches costs N small JSON
files, not N copies of the table.

:class:`ServingCluster` is the inference-side counterpart: it opens a named
version **read-only** (per-node SSD views built from the manifest; no
MEM-PS, no pins, no write path) and can :meth:`~ServingCluster.roll_forward`
to a newer version without dropping requests — the active
:class:`ServingVersion` is swapped atomically and in-flight lookups keep
reading the version object they acquired, whose files stay on disk until
the publisher releases them. Remote shard reads travel the simulated NIC
and, with ``NetworkModel(wire_quantize=True)``, the int8 row-sparse wire
format (serving reads tolerate quantization; see ``compression.py``).
"""

from __future__ import annotations

import os
import re
import threading

import numpy as np

from repro_torch.core.keys import key_to_node, partition_by_owner
from repro_torch.core.node import Cluster, NetworkModel, NodeDownError
from repro_torch.core.ssd_ps import SSDParameterServer
from repro_torch.core.tables import TableRegistry
from repro_torch.train.checkpoint import atomic_write_json, flip_pointer

_VERSION_RE = re.compile(r"^v_(\d{8})\.json$")


def _version_path(directory: str, version: int) -> str:
    return os.path.join(directory, f"v_{version:08d}.json")


def list_versions(directory: str) -> list[int]:
    """All published version ids in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _VERSION_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_version(directory: str) -> int | None:
    """The LATEST pointer's target (fallback: newest manifest on disk)."""
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        m = _VERSION_RE.match(name)
        if m:
            return int(m.group(1))
    versions = list_versions(directory)
    return versions[-1] if versions else None


def load_version(directory: str, version: int) -> dict:
    import json

    with open(_version_path(directory, version)) as f:
        return json.load(f)


class SnapshotPublisher:
    """Training-side: atomically publish immutable table versions.

    ``keep`` > 0 auto-releases versions this publisher created beyond the
    newest ``keep`` (their retained files become deletable); ``keep=0``
    (default) never auto-releases — the operator (or a test) calls
    :meth:`release` once no serving cluster reads the version anymore.
    Releasing a version a live ServingCluster still serves is an operator
    error, exactly like deleting a checkpoint mid-restore.
    """

    def __init__(self, cluster: Cluster, directory: str, keep: int = 0):
        os.makedirs(directory, exist_ok=True)
        self.cluster = cluster
        self.dir = directory
        self.keep = int(keep)
        self._lock = threading.Lock()
        # version -> per-node retained path lists (for release)
        self._live: dict[int, dict[int, list[str]]] = {}
        self._released: set[int] = set()  # release() is idempotent per id
        last = latest_version(directory)
        self._next = (last or 0) + 1

    def publish(self) -> int:
        """Publish the cluster's current (flushed) state as a new version.

        Returns the version id. The manifest is written to a temp file and
        ``os.replace``d, then LATEST is flipped — a reader never observes a
        half-written version, and a crash mid-publish leaves the previous
        LATEST intact.
        """
        with self._lock:
            version = self._next
            self._next += 1
            # pin the redo log *before* the manifest's flush: the retained
            # suffix then covers every push after this snapshot's state, so
            # the cluster can heal a quarantined SSD file bit-exactly as
            # snapshot(version) + redo replay (DESIGN.md §9)
            redo_pin = self.cluster.pin_redo()
            m = self.cluster.publish_manifest()  # flush + atomic retention
            retained = {
                int(nid): list(nm.get("retained_paths", []))
                for nid, nm in m["nodes"].items()
            }
            atomic_write_json(
                _version_path(self.dir, version),
                {"version": version, "cluster": m},
            )
            flip_pointer(
                os.path.join(self.dir, "LATEST"),
                os.path.basename(_version_path(self.dir, version)),
            )
            self._live[version] = retained
            self.cluster.set_heal_source(self.dir, version, redo_pin)
            if self.keep > 0:
                for v in sorted(self._live)[: -self.keep]:
                    self._release_locked(v)
            return version

    def _release_locked(self, version: int) -> None:
        if version in self._released:
            return  # double release would over-decrement refs that other
            # versions still hold on shared paths
        retained = self._live.pop(version, None)
        if retained is None:
            # a version published by a previous publisher instance over the
            # same directory (restart): its retained paths are recorded in
            # the on-disk manifest, so the release still reaches the SSDs
            try:
                m = load_version(self.dir, version)["cluster"]
            except FileNotFoundError:
                return
            retained = {
                int(nid): list(nm.get("retained_paths", []))
                for nid, nm in m["nodes"].items()
            }
        self._released.add(version)
        self.cluster.release_files(retained)

    def rebind(self, cluster: Cluster) -> None:
        """Re-attach to a restored/resharded cluster (CTRTrainer.resume).

        Retention references live inside the SSD-PS instances, so a
        ``Cluster.restore`` starts with zero — without re-taking them,
        compaction on the restored cluster would delete files that live
        published versions still reference. Re-takes every live version's
        references on the new instances."""
        with self._lock:
            self.cluster = cluster
            for retained in self._live.values():
                for nid, paths in retained.items():
                    cluster.nodes[int(nid)].ssd.retain_files(paths)

    def release(self, version: int) -> None:
        """Retire a version: its manifest stays but its retention refs drop
        (files already superseded by compaction get deleted)."""
        with self._lock:
            self._release_locked(version)

    def versions(self) -> list[int]:
        return list_versions(self.dir)

    def latest(self) -> int | None:
        return latest_version(self.dir)


class ServingVersion:
    """One immutable published version, opened read-only.

    Holds per-node SSD views over the *training* cluster's parameter files
    (paths come from the manifest; nothing is copied) with the table
    registry's schema-aware missing-row initializer installed, so unseen
    keys serve the same deterministic init rows the training cluster would.
    The object is immutable after construction — a lookup that acquired it
    keeps a consistent view across a concurrent roll-forward.
    """

    def __init__(self, directory: str, version: int):
        snap = load_version(directory, version)
        m = snap["cluster"]
        self.version = int(snap["version"])
        self.n_nodes = int(m["n_nodes"])
        self.dim = int(m["dim"])
        init_scale = float(m.get("init_scale", 0.01))
        init_cols = m.get("init_cols")
        self.tables = (
            TableRegistry.from_manifest(m["tables"]) if m.get("tables") else TableRegistry()
        )
        nodes = m["nodes"]
        self.ssd: list[SSDParameterServer] = []
        for nid in range(self.n_nodes):
            nm = nodes.get(nid, nodes.get(str(nid)))  # JSON string keys
            view = SSDParameterServer.from_manifest(
                directory, nm, init_scale=init_scale, init_cols=init_cols,
                auto_compact=False,
            )
            if len(self.tables):
                view.initializer = self.tables.initializer(
                    self.dim, init_scale, init_cols
                )
            self.ssd.append(view)

    def read(self, node_id: int, keys: np.ndarray) -> np.ndarray:
        return self.ssd[node_id].read_batch(keys)


class ServingCluster:
    """Read-only serving side over published versions.

    The partitioned pull mirrors :meth:`Cluster.pull`'s owner-sorted
    protocol (local shard from the local view, remote shards over the NIC
    model, int8 wire when ``network.wire_quantize``) but with no MEM-PS, no
    pins and no write path — the serving-side DRAM tier is the engine's
    version-keyed :class:`~repro_torch.serve.engine.HotRowCache` instead.
    """

    def __init__(
        self,
        directory: str,
        version: int | None = None,
        network: NetworkModel | None = None,
        node_id: int = 0,
    ):
        self.dir = directory
        self.network = network or NetworkModel()
        self.node_id = int(node_id)
        self._lock = threading.Lock()
        if version is None:
            version = latest_version(directory)
            if version is None:
                raise FileNotFoundError(f"no published versions in {directory}")
        self._active = ServingVersion(directory, version)
        self.alive = True

    # ---------------------------------------------------------- fault model
    def kill(self) -> None:
        """Simulate losing this serving replica: subsequent pulls raise
        :class:`~repro_torch.core.node.NodeDownError` (the engine fails over to
        surviving replicas, DESIGN.md §9) until a roll_forward revives it —
        modeling a replacement replica coming up on the published version."""
        self.alive = False

    # ------------------------------------------------------------ versions
    @property
    def version(self) -> int:
        return self._active.version

    @property
    def registry(self) -> TableRegistry:
        return self._active.tables

    @property
    def dim(self) -> int:
        return self._active.dim

    def acquire(self) -> ServingVersion:
        """The active version, atomically. A request works entirely against
        the object it acquired — rolling forward mid-request cannot mix
        versions within one lookup."""
        return self._active

    def roll_forward(self, version: int | None = None) -> int:
        """Swap to ``version`` (default: LATEST). The new version is opened
        fully *before* the swap, so concurrent lookups see either the old
        or the new version, never a partial one. Returns the active id."""
        with self._lock:
            target = latest_version(self.dir) if version is None else int(version)
            if target is None or target == self._active.version:
                self.alive = True  # replacement replica on the same version
                return self._active.version
            self._active = ServingVersion(self.dir, target)
            self.alive = True
            return self._active.version

    # ---------------------------------------------------------------- pull
    def pull(self, keys: np.ndarray, view: ServingVersion | None = None) -> np.ndarray:
        """Owner-partitioned read of ``keys`` (cluster key space) against
        one version. Remote segments cross the simulated NIC; serving reads
        ride the int8 wire when the network opts in."""
        if not self.alive:
            raise NodeDownError("serving replica is down")
        view = view or self.acquire()
        keys = np.asarray(keys, dtype=np.uint64)
        owners = key_to_node(keys, view.n_nodes)
        order, splits = partition_by_owner(keys, owners, view.n_nodes)
        bounds = np.concatenate([[0], splits, [len(keys)]])
        sorted_keys = keys[order]
        sorted_out = np.empty((len(keys), view.dim), dtype=np.float32)
        for node_id in range(view.n_nodes):
            lo, hi = int(bounds[node_id]), int(bounds[node_id + 1])
            if lo == hi:
                continue
            vals = view.read(node_id, sorted_keys[lo:hi])
            if node_id != self.node_id:
                self.network.transfer((hi - lo) * 8)  # request keys out
                vals = self.network.reply(sorted_keys[lo:hi], vals, serving=True)
            sorted_out[lo:hi] = vals
        out = np.empty_like(sorted_out)
        out[order] = sorted_out
        return out
