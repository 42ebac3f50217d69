"""SSD-PS: log-structured, file-granularity parameter store (paper Section 6).

Design points taken directly from the paper / Appendix E:

* Parameters are grouped into immutable **parameter files**; a file is the
  SSD I/O unit. Reading any requested key reads its whole file (bandwidth
  over random access; file size is tunable).
* Updates are **never in-place**: updated rows are chunked and written
  sequentially as *new* files; the in-memory parameter->file mapping is then
  repointed and the old copies become stale.
* Each file keeps a **stale counter** (maintained on mapping updates, no file
  reads needed). A background/regular **compaction** merges files whose stale
  fraction exceeds 50%, which bounds total disk usage at <= 2x live bytes
  (1/0.5), plus one in-flight write batch.
* The same never-in-place property makes **snapshot publishing repointing,
  not copying** (DESIGN.md §7): :meth:`publish_manifest` captures the
  key->file map and takes a per-file *retention reference* on every file it
  mentions. Compaction still merges retained files, but parks their paths in
  an orphan set instead of deleting them; :meth:`release_files` drops the
  references and removes any orphan that reached zero. A published version
  therefore stays readable for as long as someone holds it, at zero write
  cost to the trainer.
* The key->file map lives in memory (a descriptor is a few bytes/key; a node
  only holds its key shard). It is a batched open-addressing ``U64Index``
  (DESIGN.md §5) storing ``file_id * file_capacity + row_in_file`` packed in
  one int64, so read/write/compaction probe and repoint whole batches with
  numpy ops — the only Python loops left iterate over *files* (the I/O
  unit), never over keys.

Values are float32 rows of fixed width ``dim`` (embedding row [+ optimizer
slots] — exactly the paper's fixed-size-value observation that lets the
serialized bucket fit SSD blocks with no I/O amplification).

File layout (little-endian): header  <u32 magic, u32 n_rows, u32 dim,
u32 crc32(payload)> followed by the payload: n_rows u64 keys then
n_rows*dim f32 values. The CRC makes a dropped, truncated, or bit-flipped
parameter file *detectable* (DESIGN.md §9): a failed read raises
:class:`SSDCorruptionError` and the file is **quarantined** — its index
entries are purged and its live rows are either healed exactly from a
published snapshot + the cluster redo log (``heal_fn``, installed by
``Cluster``) or degraded to the deterministic missing-row initializer.
Garbage is never served.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.hash_index import U64Index
from repro_torch.core.keys import deterministic_init
from repro_torch.metrics import Counters

_MAGIC = 0x55D9A5
_HEADER = struct.Struct("<IIII")


class SSDCorruptionError(RuntimeError):
    """A parameter file failed its integrity check (missing / truncated /
    checksum mismatch). Carries the file id so the reader can quarantine."""

    def __init__(self, file_id: int, path: str, reason: str):
        super().__init__(f"corrupt parameter file {path}: {reason}")
        self.file_id = file_id
        self.path = path
        self.reason = reason


@dataclass
class FileMeta:
    file_id: int
    path: str
    n_rows: int
    n_stale: int = 0

    @property
    def stale_frac(self) -> float:
        return self.n_stale / max(1, self.n_rows)


@dataclass
class SSDStats:
    bytes_written: int = 0
    bytes_read: int = 0
    rows_read: int = 0
    rows_requested: int = 0
    files_written: int = 0
    files_read: int = 0
    compactions: int = 0
    compaction_time: float = 0.0
    read_time: float = 0.0
    write_time: float = 0.0

    @property
    def read_amplification(self) -> float:
        """rows read from disk / rows actually requested (paper's I/O amp)."""
        return self.rows_read / max(1, self.rows_requested)


class SSDParameterServer:
    """One node's materialized parameter shard on local SSD."""

    def __init__(
        self,
        directory: str,
        dim: int,
        file_capacity: int = 4096,
        compact_stale_frac: float = 0.5,
        init_scale: float = 0.01,
        init_cols: int | None = None,
        auto_compact: bool = True,
        lock: bool = True,
        initializer=None,
        counters: Counters | None = None,
    ):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.dim = dim
        self.file_capacity = int(file_capacity)
        self.compact_stale_frac = float(compact_stale_frac)
        self.init_scale = init_scale
        # rows for unseen keys: random-init the first init_cols columns
        # (embedding), zero the rest (optimizer slots ride along in the row)
        self.init_cols = dim if init_cols is None else int(init_cols)
        # optional schema-aware override: a callable (keys) -> [n, dim] rows
        # (installed by the cluster's TableRegistry for multi-table hosting)
        self.initializer = initializer
        self.auto_compact = auto_compact
        self._next_file_id = 0
        self.files: dict[int, FileMeta] = {}
        # key -> file_id * file_capacity + row_in_file (packed int64)
        self.index = U64Index(4 * self.file_capacity)
        # snapshot retention: path -> live reference count, plus the paths
        # compaction already dropped from `files` but must keep on disk
        self._file_refs: dict[str, int] = {}
        self._orphaned: set[str] = set()
        self.stats = SSDStats()
        # fault-model wiring (DESIGN.md §9): quarantine/heal event counters
        # (a Cluster passes its shared fault counters in), the exact-heal
        # callback (keys -> rows or None) installed by the owning cluster,
        # and an optional armed FaultInjector observing file reads
        self.counters = counters if counters is not None else Counters(
            "ssd_files_quarantined", "ssd_rows_quarantined",
            "ssd_rows_healed", "ssd_rows_reinit",
        )
        self.heal_fn = None
        self.faults = None
        self._in_compact = False
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ io
    def _file_path(self, file_id: int) -> str:
        return os.path.join(self.dir, f"params_{file_id:08d}.bin")

    def _write_file(self, keys: np.ndarray, values: np.ndarray) -> int:
        fid = self._next_file_id
        self._next_file_id += 1
        path = self._file_path(fid)
        t0 = time.perf_counter()
        kb = np.ascontiguousarray(keys, dtype=np.uint64).tobytes()
        vb = np.ascontiguousarray(values, dtype=np.float32).tobytes()
        crc = zlib.crc32(vb, zlib.crc32(kb)) & 0xFFFFFFFF
        with open(path, "wb") as f:
            f.write(_HEADER.pack(_MAGIC, len(keys), self.dim, crc))
            f.write(kb)
            f.write(vb)
        self.stats.write_time += time.perf_counter() - t0
        nbytes = _HEADER.size + keys.nbytes + values.nbytes
        self.stats.bytes_written += nbytes
        self.stats.files_written += 1
        self.files[fid] = FileMeta(fid, path, len(keys))
        return fid

    def _read_file(self, fid: int) -> tuple[np.ndarray, np.ndarray]:
        """Whole-file read with integrity verification. Any failure —
        missing file (dropped), short read (truncated), header or CRC
        mismatch (bit rot) — raises :class:`SSDCorruptionError`; the file
        is never partially served."""
        meta = self.files[fid]
        if self.faults is not None:
            self.faults.on_file_read(self, meta)
        t0 = time.perf_counter()
        try:
            with open(meta.path, "rb") as f:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    raise SSDCorruptionError(fid, meta.path, "truncated header")
                magic, n_rows, dim, crc = _HEADER.unpack(head)
                if magic != _MAGIC:
                    raise SSDCorruptionError(fid, meta.path, "bad magic")
                if dim != self.dim or n_rows != meta.n_rows:
                    raise SSDCorruptionError(
                        fid, meta.path,
                        f"header mismatch (dim={dim}, n_rows={n_rows})",
                    )
                payload = f.read(n_rows * (8 + 4 * dim))
        except OSError as e:  # FileNotFoundError, EIO, ...
            raise SSDCorruptionError(fid, meta.path, f"unreadable: {e}") from e
        if len(payload) != n_rows * (8 + 4 * dim):
            raise SSDCorruptionError(fid, meta.path, "truncated payload")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise SSDCorruptionError(fid, meta.path, "checksum mismatch")
        keys = np.frombuffer(payload[: 8 * n_rows], dtype=np.uint64)
        values = np.frombuffer(payload[8 * n_rows :], dtype=np.float32)
        self.stats.read_time += time.perf_counter() - t0
        self.stats.bytes_read += _HEADER.size + keys.nbytes + values.nbytes
        self.stats.files_read += 1
        self.stats.rows_read += n_rows
        return keys, values.reshape(n_rows, dim)

    # ------------------------------------------------------------ interface
    def write_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Dump updated rows as new sequential files (paper: never in-place)."""
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.float32)
        assert values.shape == (len(keys), self.dim)
        if len(keys) == 0:
            return
        with self._lock:
            for start in range(0, len(keys), self.file_capacity):
                sl = slice(start, start + self.file_capacity)
                k, v = keys[sl], values[sl]
                fid = self._write_file(k, v)
                # repoint mapping (batched); old copies become stale
                uniq, first, inverse, cnt = np.unique(
                    k, return_index=True, return_inverse=True, return_counts=True
                )
                old = self.index.lookup(uniq)
                had = old >= 0
                if had.any():
                    for f, c in zip(*np.unique(old[had] // self.file_capacity, return_counts=True)):
                        self.files[int(f)].n_stale += int(c)
                # duplicate keys within one file: all but the last row stale
                self.files[fid].n_stale += int((cnt - 1).sum())
                last = np.empty(len(uniq), dtype=np.int64)
                last[inverse] = np.arange(len(k))
                self.index.set(uniq, fid * self.file_capacity + last)
            if self.auto_compact and not self._in_compact:
                # quarantine healing writes from inside a compaction read
                # path; re-entering compact there would recurse
                self.compact()

    def read_batch(self, keys: np.ndarray) -> np.ndarray:
        """Gather rows for ``keys``; whole-file reads; missing keys get the
        deterministic per-key initialization (fresh parameters).

        A file that fails its integrity check mid-gather is quarantined
        (index purged, live rows healed exactly via ``heal_fn`` or left to
        re-initialize) and the gather retries — each quarantine removes one
        file, so the loop terminates. The caller never sees garbage rows
        and never sees the corruption as an exception."""
        keys = np.asarray(keys, dtype=np.uint64)
        with self._lock:
            self.stats.rows_requested += len(keys)
            while True:
                try:
                    return self._gather_locked(keys)
                except SSDCorruptionError as e:
                    self._quarantine_locked(e.file_id)

    def _gather_locked(self, keys: np.ndarray) -> np.ndarray:
        out = np.empty((len(keys), self.dim), dtype=np.float32)
        locs = self.index.lookup(keys)
        found = np.nonzero(locs >= 0)[0]
        if found.size:
            floc = locs[found]
            order = np.argsort(floc, kind="stable")  # groups by file id
            floc, found = floc[order], found[order]
            fids = floc // self.file_capacity
            starts = np.concatenate([[0], np.nonzero(np.diff(fids))[0] + 1, [len(fids)]])
            for s, e in zip(starts[:-1], starts[1:]):
                _, vals = self._read_file(int(fids[s]))  # file = I/O unit
                out[found[s:e]] = vals[floc[s:e] % self.file_capacity]
        missing = locs < 0
        if missing.any():
            out[missing] = self.init_rows(keys[missing])
        return out

    def init_rows(self, keys: np.ndarray) -> np.ndarray:
        """Deterministic fresh-parameter rows for never-seen keys (also the
        degraded-serving fallback for unhealable quarantined rows)."""
        keys = np.asarray(keys, dtype=np.uint64)
        if self.initializer is not None:
            return np.asarray(self.initializer(keys), dtype=np.float32)
        fresh = np.zeros((len(keys), self.dim), dtype=np.float32)
        fresh[:, : self.init_cols] = deterministic_init(
            keys, self.init_cols, self.init_scale
        )
        return fresh

    # ---------------------------------------------------------- quarantine
    def quarantine_file(self, file_id: int) -> int:
        """Public entry (tests/operators): quarantine one parameter file.
        Returns the number of live rows that were lost from the file."""
        with self._lock:
            return self._quarantine_locked(file_id)

    def _quarantine_locked(self, file_id: int) -> int:
        """Pull a corrupt file out of service: purge its index entries,
        delete it from disk, then restore its live rows — exactly, via
        ``heal_fn`` (published snapshot + redo-log replay, wired by the
        Cluster), or degraded, by leaving them to the missing-row
        initializer. Counter names follow the DESIGN.md §9 fault model."""
        meta = self.files.pop(file_id, None)
        if meta is None:
            return 0
        all_keys, all_locs = self.index.items()
        lost = all_keys[all_locs // self.file_capacity == file_id]
        if lost.size:
            self.index.delete(lost)
        self.counters.inc("ssd_files_quarantined")
        self.counters.inc("ssd_rows_quarantined", int(lost.size))
        self._orphaned.discard(meta.path)
        self._file_refs.pop(meta.path, None)  # corrupt: no version can use it
        try:
            os.remove(meta.path)
        except OSError:
            pass
        if not lost.size:
            return 0
        healed = None
        if self.heal_fn is not None:
            try:
                healed = self.heal_fn(lost)
            except SSDCorruptionError:
                raise  # a snapshot view hit corruption too: let reader retry
            except Exception:
                # heal source unavailable -> degraded (deterministic reinit)
                # serving; counted so the degradation is never silent
                healed = None
                self.counters.inc("ssd_heal_degraded")
        if healed is not None:
            self.write_batch(lost, np.asarray(healed, dtype=np.float32))
            self.counters.inc("ssd_rows_healed", int(lost.size))
        else:
            # rows fall back to the deterministic initializer on next read
            self.counters.inc("ssd_rows_reinit", int(lost.size))
        return int(lost.size)

    def contains(self, key: int) -> bool:
        return bool(self.index.contains(np.asarray([key], dtype=np.uint64))[0])

    # ---------------------------------------------------------- compaction
    def compact(self, force: bool = False) -> int:
        """Merge files whose stale fraction exceeds the threshold.

        Returns number of files merged. Only >50%-stale files are eligible
        (paper threshold), bounding disk usage at <=2x live rows.
        """
        with self._lock:
            victims = [
                m
                for m in self.files.values()
                if m.n_rows > 0 and (force or m.stale_frac > self.compact_stale_frac) and m.n_stale > 0
            ]
            if not victims:
                return 0
            t0 = time.perf_counter()
            self._in_compact = True
            try:
                live_keys: list[np.ndarray] = []
                live_vals: list[np.ndarray] = []
                for meta in victims:
                    try:
                        fkeys, fvals = self._read_file(meta.file_id)
                    except SSDCorruptionError:
                        # victim turned out corrupt: quarantine it (heals or
                        # degrades its live rows) instead of aborting the
                        # whole compaction
                        self._quarantine_locked(meta.file_id)
                        continue
                    current = meta.file_id * self.file_capacity + np.arange(len(fkeys))
                    mask = self.index.lookup(fkeys) == current
                    if mask.any():
                        live_keys.append(fkeys[mask])
                        live_vals.append(fvals[mask])
                # write survivors as fresh files and erase victims
                if live_keys:
                    all_k = np.concatenate(live_keys)
                    all_v = np.concatenate(live_vals)
                    for start in range(0, len(all_k), self.file_capacity):
                        sl = slice(start, start + self.file_capacity)
                        k, v = all_k[sl], all_v[sl]
                        fid = self._write_file(k, v)
                        self.index.set(k, fid * self.file_capacity + np.arange(len(k)))
                for meta in victims:
                    if meta.file_id not in self.files:
                        continue  # quarantined above: already gone
                    if self._file_refs.get(meta.path, 0) > 0:
                        # a published snapshot still points here: park the path
                        # until every referencing version is released
                        self._orphaned.add(meta.path)
                    else:
                        try:
                            os.remove(meta.path)
                        except FileNotFoundError:
                            pass
                    del self.files[meta.file_id]
            finally:
                self._in_compact = False
            self.stats.compactions += 1
            self.stats.compaction_time += time.perf_counter() - t0
            return len(victims)

    # -------------------------------------------------------------- info
    @property
    def n_live_rows(self) -> int:
        return len(self.index)

    @property
    def n_disk_rows(self) -> int:
        return sum(m.n_rows for m in self.files.values())

    @property
    def disk_bytes(self) -> int:
        return sum(_HEADER.size + m.n_rows * (8 + 4 * self.dim) for m in self.files.values())

    def space_amplification(self) -> float:
        return self.n_disk_rows / max(1, self.n_live_rows)

    # --------------------------------------------------- snapshot retention
    def publish_manifest(self) -> dict:
        """Manifest + atomic retention of every file it references.

        Capturing the map and taking the references under one lock hold is
        what makes publishing safe against a concurrent ``write_batch`` ->
        auto-``compact`` deleting a just-referenced file. The returned dict
        adds ``retained_paths`` — the caller (SnapshotPublisher) passes it
        back to :meth:`release_files` when the version is retired.
        """
        with self._lock:
            m = self.manifest()
            paths = [meta.path for meta in self.files.values()]
            for p in paths:
                self._file_refs[p] = self._file_refs.get(p, 0) + 1
            m["retained_paths"] = paths
            return m

    def retain_files(self, paths: "list[str]") -> None:
        """Re-take retention references on ``paths`` (publisher re-attach
        after Cluster.restore — refs live in SSD instances, so a restored
        instance starts with zero and would let compaction delete files a
        published version still references). Paths the restored manifest no
        longer lists as active files are parked as orphans so a later
        release still reclaims them."""
        with self._lock:
            active = {m.path for m in self.files.values()}
            for p in paths:
                self._file_refs[p] = self._file_refs.get(p, 0) + 1
                if p not in active and os.path.exists(p):
                    self._orphaned.add(p)

    def release_files(self, paths: "list[str]") -> None:
        """Drop one retention reference per path; orphans at zero are
        deleted from disk (files still live in ``self.files`` just lose
        the reference and stay)."""
        with self._lock:
            for p in paths:
                n = self._file_refs.get(p, 0) - 1
                if n > 0:
                    self._file_refs[p] = n
                else:
                    self._file_refs.pop(p, None)
                    if p in self._orphaned:
                        self._orphaned.discard(p)
                        try:
                            os.remove(p)
                        except FileNotFoundError:
                            pass

    def is_retained(self, path: str) -> bool:
        """True if a published snapshot holds a retention ref on ``path``."""
        with self._lock:
            return self._file_refs.get(path, 0) > 0

    @property
    def n_retained_orphans(self) -> int:
        """Stale-but-retained files currently parked on disk."""
        with self._lock:
            return len(self._orphaned)

    # ------------------------------------------------------- checkpointing
    def manifest(self) -> dict:
        keys, locs = self.index.items()
        return {
            "dim": self.dim,
            "file_capacity": self.file_capacity,
            "next_file_id": self._next_file_id,
            "files": {fid: (m.path, m.n_rows, m.n_stale) for fid, m in self.files.items()},
            "key_to_file": {
                int(k): (int(l) // self.file_capacity, int(l) % self.file_capacity)
                for k, l in zip(keys.tolist(), locs.tolist())
            },
        }

    @classmethod
    def from_manifest(cls, directory: str, manifest: dict, **kw) -> "SSDParameterServer":
        ps = cls(directory, manifest["dim"], manifest["file_capacity"], **kw)
        ps._next_file_id = manifest["next_file_id"]
        ps.files = {
            int(fid): FileMeta(int(fid), path, n_rows, n_stale)
            for fid, (path, n_rows, n_stale) in manifest["files"].items()
        }
        k2f = manifest["key_to_file"]
        keys = np.fromiter((int(k) for k in k2f), dtype=np.uint64, count=len(k2f))
        locs = np.fromiter(
            (int(f) * ps.file_capacity + int(r) for f, r in k2f.values()),
            dtype=np.int64,
            count=len(k2f),
        )
        ps.index.insert(keys, locs)
        return ps

    def iter_live(self, chunk: int = 65536):
        """Yield (keys, values) over all live rows (for reshard/checkpoint).

        Corruption-safe: a corrupt file is quarantined in place and, if it
        healed, its rows land in a *new* file — so iteration re-scans for
        unvisited file ids each round instead of snapshotting the file list
        up front (a snapshot would silently skip the healed rows)."""
        with self._lock:
            visited: set[int] = set()
            while True:
                pending = [fid for fid in self.files if fid not in visited]
                if not pending:
                    return
                for fid in pending:
                    visited.add(fid)
                    if fid not in self.files:
                        continue  # merged away by a heal-triggered compaction
                    try:
                        fkeys, fvals = self._read_file(fid)
                    except SSDCorruptionError:
                        self._quarantine_locked(fid)
                        continue
                    current = fid * self.file_capacity + np.arange(len(fkeys))
                    mask = self.index.lookup(fkeys) == current
                    if mask.any():
                        yield fkeys[mask], fvals[mask]
