"""The port's declared lock-order table and blocking-call model (pscheck).

Every ``threading.Lock``/``RLock`` that ``src/repro_torch`` allocates has a
:class:`LockSpec` here. Levels are the permitted acquisition order: a
thread holding a lock at level L may only take locks at a *strictly
greater* level (same-instance re-acquisition of a reentrant RLock is
exempt). ``blocking_ok`` declares whether holding the lock across blocking
work (SSD file I/O, cluster pull/push, NIC transfer, a compiler run,
sleep/join) is part of the design.

A class the reference also declares keeps the reference's level,
``blocking_ok`` and ``reentrant`` (``repro.analysis.locks.LOCK_ORDER``; the
port's copies of the host hierarchy take their locks in the same order).
A module-level lock is keyed by its module's path under the package
(``kernels/build.py``), and the rules resolve a bare ``with <name>:`` in
that module to it.

The runtime sanitizer (``sanlock``) checks the *instance-level* graph for
cycles and does not use the levels.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class LockSpec:
    cls: str  # class whose instances own the lock, or the module's path for a module lock
    attr: str  # attribute (``with self.<attr>:``) or module global (``with <attr>:``)
    level: int  # strictly increasing along any nesting chain
    blocking_ok: bool  # may blocking work run while it is held?
    reentrant: bool = False  # RLock: same-instance nesting is fine
    why: str = ""


LOCK_ORDER: tuple[LockSpec, ...] = (
    LockSpec(
        "ServingEngine", "_mu", 10, False,
        why="request coalescing map; leaders pull OUTSIDE it",
    ),
    LockSpec(
        "HierarchicalPS", "_push_lock", 10, True,
        why="serializes deferred cluster pushes by design (push stage)",
    ),
    LockSpec(
        "StagingRing", "_lock", 11, False,
        why="slot sequence/occupancy bookkeeping only; deps.wait, NIC "
        "transfer and the host-to-device copy all run outside it",
    ),
    LockSpec(
        "RetrievalEngine", "_lock", 11, True,
        why="index binds/rolls only (manifest scan + corpus upload under "
        "it by design); searches read the bound index without locking",
    ),
    LockSpec(
        "SnapshotPublisher", "_lock", 12, True,
        why="publish = flush_all + manifest write; serialized by design",
    ),
    LockSpec(
        "ServingCluster", "_lock", 12, True,
        why="roll_forward opens manifests under it; version flips are rare",
    ),
    LockSpec(
        "HierarchicalPS", "_lock", 20, False, reentrant=True,
        why="in-flight registry bookkeeping only; pulls happen outside",
    ),
    LockSpec(
        "ServingEngine", "_dev_mu", 20, False,
        why="DeviceHotSet plan/admit; host pulls must happen between, "
        "with a generation re-check",
    ),
    LockSpec(
        "ServingEngine", "_cache_mu", 30, False,
        why="HotRowCache probe/insert; leader pulls run outside it",
    ),
    LockSpec(
        "MemParameterServer", "_lock", 40, True, reentrant=True,
        why="cache lock intentionally covers SSD miss-fill and evict-flush",
    ),
    LockSpec(
        "SSDParameterServer", "_lock", 50, True, reentrant=True,
        why="file I/O IS the protected resource (read/write/compact/heal)",
    ),
    LockSpec(
        "RedoLog", "_lock", 60, False,
        why="memory-only append/snapshot; readers copy out under it",
    ),
    LockSpec(
        "FaultInjector", "_lock", 70, True,
        why="fires SSD drop/truncate at read time by design (test support)",
    ),
    LockSpec(
        "Counters", "_lock", 100, False,
        why="leaf: plain dict bump, nothing may nest inside",
    ),
    LockSpec(
        "kernels/build.py", "_lock", 100, True,
        why="leaf: the kernels' first-use build; nvcc runs under it by design "
        "(one build for every thread), and it takes no other lock",
    ),
)

LOCKS: dict[tuple[str, str], LockSpec] = {(s.cls, s.attr): s for s in LOCK_ORDER}

BY_ATTR: dict[str, list[LockSpec]] = {}
for _s in LOCK_ORDER:
    BY_ATTR.setdefault(_s.attr, []).append(_s)

# Attribute names that look like locks: _mu, _lock, _cache_mu, _push_lock...
LOCK_ATTR_RE = re.compile(r"^_(?:[a-z0-9]+_)*(?:mu|lock)$")

# Method names that block regardless of receiver (PS hierarchy verbs +
# thread/time waits). str.join / "sep".join is excluded by the Constant-
# receiver check in rules.py.
BLOCKING_ATTRS = frozenset({
    "pull", "push", "transfer", "flush_all", "publish_manifest",
    "read_batch", "write_batch", "recover_node", "roll_forward",
    "acquire_version", "publish", "sleep", "join", "wait",
})

# os./shutil. file-system calls (only flagged with that receiver, so
# str.replace / list.remove stay clean).
FS_BLOCKING_ATTRS = frozenset({
    "remove", "replace", "rename", "makedirs", "rmtree", "unlink",
    "getsize", "listdir", "fsync",
})
FS_RECEIVERS = frozenset({"os", "shutil", "path"})

# Bare-name calls that block.
BLOCKING_NAMES = frozenset({"open"})
