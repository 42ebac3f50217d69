"""SanLock for the port: runtime lock-order + pin-leak sanitizer
(``REPRO_TORCH_SANLOCK=1``).

The static rules (PS201/PS202) see only syntactic nesting; this module
records what the threads actually did. :func:`install` replaces
``threading.Lock``/``threading.RLock`` with factories that wrap locks
*allocated from inside* ``src/repro_torch`` (the caller's frame decides;
``analysis/`` itself and pytest/queue/Condition internals keep raw locks).
Every wrapped acquisition while other wrapped locks are held adds
held->acquired edges to a global, instance-level acquisition graph;
:func:`find_cycle` detects potential-deadlock cycles, which the pytest
plugin (``repro_torch.analysis.pytest_plugin``) turns into test failures.

Instance-level matters: the SSD heal path legitimately takes a snapshot
view's ``SSDParameterServer._lock`` while holding the training shard's —
same allocation site, different instances, not a self-cycle. Nodes hold
strong references to the wrappers so ``id()`` reuse cannot alias edges;
names are allocation sites (``ssd_ps.py:155``) for readable reports, and
:func:`wrapped` counts the wrapped locks by owner (``ServingEngine._mu``,
``kernels/build.py:_lock``).

The pin half: ``Cluster.__init__`` calls :func:`register_cluster`, and
the plugin asserts ``total_pins() == 0`` on every registered cluster at
test teardown (mark a test ``pscheck_allow_pins`` to opt out).

``install`` only affects locks created *after* it runs — a module-level
lock (``kernels/build.py``'s) is allocated when its module is imported, so
install before anything imports the port's modules.
"""

from __future__ import annotations

import linecache
import os
import re
import sys
import threading
import weakref

ENV = "REPRO_TORCH_SANLOCK"

_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

_installed = False
_graph_guard = _ORIG_LOCK()
# (id(held), id(acquired)) -> [held_wrapper, acquired_wrapper, count]
_edges: dict[tuple[int, int], list] = {}
_tls = threading.local()
_clusters: list = []  # weakrefs to every Cluster ever constructed
_wrapped: dict[str, int] = {}  # owner -> wrapped locks allocated
_SEP = os.sep
_PORT_DIR = f"{_SEP}repro_torch{_SEP}"
_ANALYSIS_DIR = f"{_SEP}repro_torch{_SEP}analysis{_SEP}"
_TARGET_RE = re.compile(r"(?:self\.)?(\w+)\s*(?::[^=]*)?=\s*threading\.R?Lock\(")


def enabled() -> bool:
    return _installed


class _SanLockBase:
    """Wraps a real lock; context-manager + acquire/release compatible."""

    _reentrant = False

    def __init__(self, raw, name: str):
        self._raw = raw
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._raw.acquire(blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    def release(self):
        self._raw.release()
        _note_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._raw.locked()

    def __repr__(self):
        return f"<SanLock {self.name} at {id(self):#x}>"


class _SanLock(_SanLockBase):
    pass


class _SanRLock(_SanLockBase):
    _reentrant = True

    def locked(self):  # RLocks grew .locked() only in 3.12
        m = getattr(self._raw, "locked", None)
        return m() if m is not None else False


def _note_acquire(lock) -> None:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    if any(held is lock for held in stack):
        # reentrant re-acquisition: the thread already owns it, so this
        # acquire can never block and constrains no ordering — adding
        # edges here would paint callback re-entry (SSD read -> fault
        # injector -> ssd.is_retained) as a false faults->ssd->faults cycle
        stack.append(lock)
        return
    for held in stack:
        key = (id(held), id(lock))
        with _graph_guard:
            cell = _edges.get(key)
            if cell is None:
                _edges[key] = [held, lock, 1]
            else:
                cell[2] += 1
    stack.append(lock)


def _note_release(lock) -> None:
    stack = getattr(_tls, "stack", None)
    if stack:
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                break


def _from_port(frame) -> bool:
    fname = frame.f_code.co_filename
    return _PORT_DIR in fname and _ANALYSIS_DIR not in fname


def _site(frame) -> str:
    return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"


def _owner(frame) -> str:
    """``Class.attr`` for ``self.attr = threading.Lock()`` in a method, else
    ``<module path under repro_torch>:<name>``."""
    fname = frame.f_code.co_filename
    m = _TARGET_RE.search(linecache.getline(fname, frame.f_lineno))
    attr = m.group(1) if m else "?"
    me = frame.f_locals.get("self")
    if me is not None:
        return f"{type(me).__name__}.{attr}"
    return f"{fname.split(_PORT_DIR, 1)[-1].replace(_SEP, '/')}:{attr}"


def _wrap(cls, raw, frame):
    owner = _owner(frame)
    with _graph_guard:
        _wrapped[owner] = _wrapped.get(owner, 0) + 1
    return cls(raw, _site(frame))


def _lock_factory():
    f = sys._getframe(1)
    raw = _ORIG_LOCK()
    return _wrap(_SanLock, raw, f) if _from_port(f) else raw


def _rlock_factory():
    f = sys._getframe(1)
    raw = _ORIG_RLOCK()
    return _wrap(_SanRLock, raw, f) if _from_port(f) else raw


def install() -> None:
    """Patch the threading lock factories (idempotent)."""
    global _installed
    if _installed:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True


def install_from_env() -> bool:
    """:func:`install` when ``REPRO_TORCH_SANLOCK`` is set; -> installed?"""
    if os.environ.get(ENV):
        install()
    return _installed


def wrapped() -> dict[str, int]:
    """Wrapped locks allocated since install, counted by owner."""
    with _graph_guard:
        return dict(_wrapped)


def reset_graph() -> None:
    with _graph_guard:
        _edges.clear()


def edges() -> list[tuple[str, str, int]]:
    with _graph_guard:
        return [(h.name, a.name, n) for h, a, n in _edges.values()]


def find_cycle() -> list[str] | None:
    """DFS over the instance-level graph; returns the cycle's allocation
    sites (closed walk) or None if acyclic."""
    with _graph_guard:
        adj: dict[int, set[int]] = {}
        names: dict[int, str] = {}
        for h, a, _n in _edges.values():
            adj.setdefault(id(h), set()).add(id(a))
            adj.setdefault(id(a), set())
            names[id(h)] = h.name
            names[id(a)] = a.name
    WHITE, GREY, BLACK = 0, 1, 2
    color = {v: WHITE for v in adj}
    path: list[int] = []

    def dfs(v) -> list[int] | None:
        color[v] = GREY
        path.append(v)
        for w in adj[v]:
            if color[w] == GREY:
                return path[path.index(w):] + [w]
            if color[w] == WHITE:
                cyc = dfs(w)
                if cyc is not None:
                    return cyc
        path.pop()
        color[v] = BLACK
        return None

    for v in list(adj):
        if color[v] == WHITE:
            cyc = dfs(v)
            if cyc is not None:
                return [names[x] for x in cyc]
    return None


# ------------------------------------------------------------------- pins
def register_cluster(cluster) -> None:
    """Called by Cluster.__init__ (cheap; weakref only)."""
    _clusters.append(weakref.ref(cluster))


def cluster_mark() -> int:
    """Snapshot of the registry length; pass to pin_leaks to scope the
    check to clusters created after the mark (per-test attribution)."""
    return len(_clusters)


def pin_leaks(mark: int = 0) -> list[tuple[str, int]]:
    """(repr, residual pin count) for live clusters registered at or after
    ``mark`` whose ``total_pins()`` is nonzero."""
    leaks = []
    for ref in _clusters[mark:]:
        c = ref()
        if c is None:
            continue
        try:
            pins = int(c.total_pins())
        except Exception as err:  # cluster mid-teardown: report, don't mask
            leaks.append((f"{c!r} (total_pins raised {err!r})", -1))
            continue
        if pins:
            leaks.append((repr(c), pins))
    return leaks


def prune_dead_clusters() -> None:
    _clusters[:] = [r for r in _clusters if r() is not None]
