"""The 4-stage prefetch pipeline (paper Section 3 + Appendix B).

Stages map to independent hardware resources —

    read (network/HDFS)  ->  pull/push (CPU+SSD)  ->  transfer (PCIe/ICI)
        ->  train (accelerator)

Each stage is a worker thread feeding a bounded prefetch queue; a worker
stalls when the next stage's queue is full (the paper's back-pressure rule:
"the worker thread stalls when the prefetch queue of the next stage is
full"). Overall batch latency is then max(stage) instead of sum(stage).

Extras for 1000+-node operation:

* per-stage timing stats (drives the Fig-3c reproduction);
* straggler mitigation: a job whose stage exceeds ``timeout`` is
  speculatively re-executed on a backup worker; first completion wins.
  Speculation is only legal for stages marked ``idempotent`` — re-running a
  stage with side effects (e.g. the pull/push stage, which pins MEM-PS rows)
  would double-apply them, so non-idempotent stages never get a backup;
* failure handling: a stage exception is retried ``max_retries`` times,
  then the pipeline drains and surfaces the error;
* inter-stage dependencies: a :class:`DependencyRegistry` lets one stage
  publish completion tokens (e.g. "batch i trained") that another stage
  awaits (e.g. "pull of batch i+1 forwards batch i's pushed rows") — the
  mechanism behind the lossless overlap of pull(i+1) with train(i);
* clean shutdown: every queue put/get is stop-aware, so abandoning the
  ``run`` iterator early (or a downstream error) cannot leave a worker
  blocked forever on a full queue with its batch's rows still pinned.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Iterable, Iterator


_SENTINEL = object()
_STOPPED = object()  # returned by stop-aware get when the pipeline is halting
_POLL_S = 0.05  # granularity at which blocked puts/gets observe _stop


class DependencyAborted(RuntimeError):
    """Raised to a waiter when the pipeline shuts down before its token."""


class DependencyRegistry:
    """Completion tokens signalled by one stage and awaited by another.

    Tokens are arbitrary hashable values (e.g. ``("trained", batch_id)``).
    ``wait`` blocks until the token is signalled; ``abort`` wakes every
    waiter with :class:`DependencyAborted` so a dying pipeline never leaves
    a stage blocked on an event that will no longer happen.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._done: set[Hashable] = set()
        self._floors: dict[Hashable, int] = {}
        self._aborted = False

    def signal(self, token: Hashable) -> None:
        with self._cond:
            self._done.add(token)
            self._cond.notify_all()

    def discard(self, token: Hashable) -> None:
        """Drop a token no waiter can reference anymore (keeps the done-set
        bounded over long runs); waiting on a discarded token hangs."""
        with self._cond:
            self._done.discard(token)

    def set_floor(self, family: Hashable, upto: int) -> None:
        """Collapse every token ``(family, seq)`` with ``seq <= upto`` into
        one permanently-signalled watermark: they count as done forever and
        are dropped from the done-set. This is how a producer of monotone
        sequence tokens keeps the set bounded *without* the hang risk of
        ``discard`` — a late waiter on a collapsed token returns
        immediately instead of blocking on a token that will never
        reappear. Floors only move forward."""
        with self._cond:
            if self._floors.get(family, upto - 1) >= upto:
                return
            self._floors[family] = upto
            self._done = {t for t in self._done if not self._under_floor(t)}
            self._cond.notify_all()

    def _under_floor(self, token: Hashable) -> bool:
        if not (isinstance(token, tuple) and len(token) == 2):
            return False
        floor = self._floors.get(token[0])
        return floor is not None and isinstance(token[1], int) and token[1] <= floor

    def is_done(self, token: Hashable) -> bool:
        with self._cond:
            return token in self._done or self._under_floor(token)

    def wait(self, token: Hashable, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while token not in self._done and not self._under_floor(token):
                if self._aborted:
                    raise DependencyAborted(f"pipeline stopped before {token!r}")
                remaining = _POLL_S if deadline is None else min(
                    _POLL_S, deadline - time.monotonic()
                )
                if remaining <= 0:
                    raise TimeoutError(f"dependency {token!r} not signalled")
                self._cond.wait(remaining)

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()

    def reset(self) -> None:
        """Clear a previous abort AND all signalled tokens/floors (a fresh
        pipeline run reuses the registry; stale tokens would satisfy a new
        run's waits instantly). Call only with no waiter in flight —
        Pipeline.run does so before starting its workers."""
        with self._cond:
            self._aborted = False
            self._done.clear()
            self._floors.clear()


@dataclass
class StageStats:
    name: str
    jobs: int = 0
    busy_time: float = 0.0
    stall_time: float = 0.0  # blocked pushing downstream (back-pressure)
    wait_time: float = 0.0  # blocked waiting upstream
    retries: int = 0
    speculative_wins: int = 0

    @property
    def mean_time(self) -> float:
        return self.busy_time / max(1, self.jobs)


@dataclass
class Stage:
    name: str
    fn: Callable[[Any], Any]
    capacity: int = 2  # prefetch-queue depth feeding the NEXT stage
    timeout: float | None = None  # straggler threshold (seconds)
    max_retries: int = 2
    idempotent: bool = True  # False => never speculatively re-executed
    # called at shutdown for each item this stage produced but the next
    # stage never consumed — stages whose outputs own resources (e.g. a
    # staging-ring slot, pinned rows) release them here so an abort/drain
    # cannot strand ownership inside a dead queue
    on_drain: Callable[[Any], None] | None = None


class PipelineError(RuntimeError):
    pass


class Pipeline:
    """Chain of stages, each on its own worker thread."""

    def __init__(self, stages: list[Stage], deps: DependencyRegistry | None = None):
        self.stages = stages
        self.stats = [StageStats(s.name) for s in stages]
        self.deps = deps
        self._error: Exception | None = None
        self.error_stage: str | None = None  # stage whose job raised first
        self.drained_items = 0  # in-flight batches discarded at shutdown
        self.drain_errors: list[Exception] = []  # on_drain hook failures
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # --------------------------------------------------- stop-aware queue ops
    def _put(self, q: queue.Queue, item: Any) -> bool:
        """Blocking put that observes ``_stop``; returns False if halted."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: queue.Queue) -> Any:
        """Blocking get that observes ``_stop``; returns _STOPPED if halted."""
        while not self._stop.is_set():
            try:
                return q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return _STOPPED

    def _drain(self, q: queue.Queue, on_drain: Callable | None = None) -> int:
        n = 0
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                return n
            if item is _SENTINEL or item is _STOPPED:
                continue
            n += 1
            if on_drain is not None:
                try:
                    on_drain(item)
                except Exception as e:
                    # a failing release hook must not mask the primary
                    # pipeline error; collected for callers/tests to check
                    self.drain_errors.append(e)

    # ------------------------------------------------------------- running
    def run(self, source: Iterable[Any]) -> Iterator[Any]:
        """Stream ``source`` items through all stages, yielding results in
        order. Timing of each stage is recorded in ``self.stats``."""
        if self.deps is not None:
            self.deps.reset()
        self._stop.clear()
        self._error = None
        queues = [queue.Queue(maxsize=max(1, s.capacity)) for s in self.stages]
        out_q: queue.Queue = queue.Queue(maxsize=max(1, self.stages[-1].capacity))
        all_queues = queues + [out_q]

        def feeder():
            try:
                for item in source:
                    if not self._put(queues[0], item):
                        return
            except Exception as e:  # propagate source errors
                self._error = e
                self._stop.set()
            finally:
                self._put(queues[0], _SENTINEL)

        def worker(idx: int):
            stage, stats = self.stages[idx], self.stats[idx]
            in_q = queues[idx]
            nxt = queues[idx + 1] if idx + 1 < len(self.stages) else out_q
            while True:
                t0 = time.perf_counter()
                item = self._get(in_q)
                stats.wait_time += time.perf_counter() - t0
                if item is _STOPPED:
                    return
                if item is _SENTINEL:
                    self._put(nxt, _SENTINEL)
                    return
                try:
                    result = self._run_job(stage, stats, item)
                except Exception as e:
                    if self._error is None:  # keep the root cause: secondary
                        self._error = e  # failures (DependencyAborted in a
                        self.error_stage = stage.name  # stage the abort
                    self._stop.set()  # released) don't mask it
                    if self.deps is not None:
                        self.deps.abort()
                    return
                t0 = time.perf_counter()
                if not self._put(nxt, result):
                    # the pipeline halted while this output waited for queue
                    # space: it will never be consumed OR drained from a
                    # queue, so release its resources here
                    if stage.on_drain is not None:
                        try:
                            stage.on_drain(result)
                        except Exception as e:
                            self.drain_errors.append(e)
                    return
                stats.stall_time += time.perf_counter() - t0

        self._threads = [threading.Thread(target=feeder, daemon=True)]
        for i in range(len(self.stages)):
            self._threads.append(threading.Thread(target=worker, args=(i,), daemon=True))
        for t in self._threads:
            t.start()

        # speculative duplicates never reach the sink: the stage returns the
        # first completion and drops the loser, so results stay exactly-once.
        try:
            while True:
                item = self._get(out_q)
                if item is _STOPPED or item is _SENTINEL:
                    break
                yield item
        finally:
            self._shutdown(all_queues)
        if self._error is not None:
            where = f" at stage {self.error_stage!r}" if self.error_stage else ""
            raise PipelineError(
                f"pipeline failed{where}: {self._error!r}"
            ) from self._error

    def _shutdown(self, all_queues: list[queue.Queue]) -> None:
        """Halt workers and release every blocked thread: stop flag first
        (puts/gets poll it), then abort dependency waiters, then drain the
        queues so no batch stays enqueued with its rows pinned."""
        self._stop.set()
        if self.deps is not None:
            self.deps.abort()
        deadline = time.monotonic() + 5.0
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        # drained items are batches that entered the pipeline but never
        # reached the sink — fault-recovery code (CTRTrainer._ride_through)
        # replays them from its own buffer; the count is diagnostic.
        # queues[0] holds raw source items (no producer stage); queue i+1
        # and out_q hold stage i's outputs, released via its on_drain hook
        producers = [None] + list(self.stages)
        self.drained_items += sum(
            self._drain(q, s.on_drain if s is not None else None)
            for q, s in zip(all_queues, producers)
        )

    # ------------------------------------------------- one job, one stage
    def _run_job(self, stage: Stage, stats: StageStats, item: Any) -> Any:
        attempts = 0
        while True:
            t0 = time.perf_counter()
            try:
                if stage.timeout is None or not stage.idempotent:
                    result = stage.fn(item)
                else:
                    result = self._run_speculative(stage, stats, item)
                stats.jobs += 1
                stats.busy_time += time.perf_counter() - t0
                return result
            except DependencyAborted:
                raise  # the pipeline is dying; re-running cannot succeed
            except Exception:
                attempts += 1
                stats.retries += 1
                if attempts > stage.max_retries:
                    raise

    def _run_speculative(self, stage: Stage, stats: StageStats, item: Any) -> Any:
        """Run fn; if it exceeds the straggler timeout, launch a backup and
        take whichever finishes first. Only called for idempotent stages —
        the backup may re-execute a job whose primary later also completes."""
        result_q: queue.Queue = queue.Queue()

        def attempt(tag: str):
            try:
                result_q.put((tag, stage.fn(item), None))
            except Exception as e:  # pragma: no cover - surfaced by caller
                result_q.put((tag, None, e))

        primary = threading.Thread(target=attempt, args=("primary",), daemon=True)
        primary.start()
        try:
            tag, res, err = result_q.get(timeout=stage.timeout)
        except queue.Empty:
            backup = threading.Thread(target=attempt, args=("backup",), daemon=True)
            backup.start()
            tag, res, err = result_q.get()  # first of the two
            if tag == "backup" and err is None:
                stats.speculative_wins += 1
        if err is not None:
            raise err
        return res

    # ---------------------------------------------------------------- info
    def report(self) -> dict[str, dict]:
        return {
            s.name: {
                "jobs": s.jobs,
                "mean_s": s.mean_time,
                "busy_s": s.busy_time,
                "stall_s": s.stall_time,
                "wait_s": s.wait_time,
                "retries": s.retries,
                "speculative_wins": s.speculative_wins,
            }
            for s in self.stats
        }

    def bottleneck(self) -> str:
        return max(self.stats, key=lambda s: s.busy_time).name
