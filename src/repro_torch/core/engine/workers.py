"""MaintenanceWorkerPool: overlap maintenance compute with the foreground.

The segment API (``SegmentedScheduler.run_segment``) made every flush and
merge a WAL-logged, replay-deterministic unit -- but each unit still runs
*inline* on the submitting thread, so a merge slice's sort/dedup compute
lands squarely in the foreground stall histogram. This pool moves the
compute off-thread without giving up one bit of determinism, using a
**prepare/apply split**:

  * **prepare** (worker threads): the compute-heavy, side-effect-free part
    of a maintenance unit -- ``backend.merge_runs`` over the immutable
    key/value arrays of the SSTables a merge will read, or
    ``backend.bloom_build`` over a new table's keys -- runs speculatively
    against a snapshot. Prepares mutate NOTHING: no manifest edits, no
    level lists, no Disk accounting, no WAL records.
  * **apply** (foreground thread): the maintenance step executes exactly
    where it always did, inside its logged segment. At its compute point
    it calls ``take(key, fn)``: if a worker finished the same computation
    (identified by ``key`` -- the sst_ids of the inputs, which name
    immutable content), the prepared result is consumed; otherwise ``fn``
    runs inline. Both paths return *identical arrays*, because the
    computation is a pure function of inputs the key pins down. Every
    side effect then commits on the foreground path at the same
    deterministic segment boundaries as before.

Determinism contract: store state, query results and WAL contents are
bit-identical for any worker count (including 0) and any worker
completion order -- workers only change *when wall-clock time is spent*,
which the ``bg_segments`` / ``bg_overlap_us`` IOStats report. Replay
during recovery recomputes inline (the pool is never consulted with a
stale key, and a missed key is just an inline compute), so recovery is
bit-identical with workers on.

On a CUDA device the prepares launch K1 (``merge_runs``) and K2
(``bloom_build``) from the worker threads while the foreground launches
K1 (``ingest_run``) and K5; ``TorchBackend`` keeps one staging buffer per
thread and launches every kernel on the device's default stream (see
``core/engine/torch_backend.py``). A prepare that raises is a ``take``
miss, and the inline recompute runs the same kernel on the foreground.

``workers=0`` (the default) keeps the pool fully inert: no threads are
created and ``take`` simply calls ``fn`` -- byte-for-byte today's inline
behavior.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

__all__ = ["MaintenanceWorkerPool"]


class _Job:
    __slots__ = ("fn", "result", "err", "dur_s", "done")

    def __init__(self, fn):
        self.fn = fn
        self.result = None
        self.err = None
        self.dur_s = 0.0
        self.done = False


class MaintenanceWorkerPool:
    """Bounded thread pool running speculative maintenance prepares.

    ``submit(key, fn)`` schedules ``fn`` (a pure thunk) under ``key``;
    ``take(key, fn)`` consumes the prepared result or computes inline.
    Threads start lazily on the first submit and are daemons -- an
    unclosed pool never blocks interpreter exit. ``stats`` (an
    ``IOStats``) receives ``bg_segments`` / ``bg_overlap_us`` for every
    consumed prepare.
    """

    def __init__(self, workers: int, *, stats=None, max_prepared: int = 64):
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        self.workers = int(workers)
        self.stats = stats
        self.max_prepared = int(max_prepared)
        self._cv = threading.Condition()
        self._queue: OrderedDict = OrderedDict()    # key -> _Job, not started
        self._running: dict = {}                    # key -> _Job, on a worker
        self._done: OrderedDict = OrderedDict()     # key -> _Job, unconsumed
        self._threads: list[threading.Thread] = []
        self._closed = False
        # observability (all monotonic; never part of replayed state)
        self.submitted = 0      # prepares accepted
        self.prepared = 0       # prepares completed on a worker
        self.hits = 0           # take() served from a prepared result
        self.misses = 0         # take() computed inline (never prepared,
                                # not started yet, or the prepare errored)
        self.wasted = 0         # prepared results evicted unconsumed

    @property
    def enabled(self) -> bool:
        return self.workers > 0 and not self._closed

    # -- worker side -----------------------------------------------------------
    def _spawn(self) -> None:
        while len(self._threads) < self.workers:
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"maint-worker-{len(self._threads)}")
            self._threads.append(t)
            t.start()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                key, job = self._queue.popitem(last=False)
                self._running[key] = job
            t0 = time.perf_counter()
            try:
                job.result = job.fn()
            except BaseException as e:      # surfaces as a take() miss;
                job.err = e                 # the inline recompute re-raises
            job.dur_s = time.perf_counter() - t0
            with self._cv:
                del self._running[key]
                job.done = True
                job.fn = None               # drop the closure (holds arrays)
                self._done[key] = job
                self.prepared += 1
                while len(self._done) > self.max_prepared:
                    self._done.popitem(last=False)
                    self.wasted += 1
                self._cv.notify_all()

    # -- foreground side -------------------------------------------------------
    def submit(self, key, fn) -> bool:
        """Schedule a speculative prepare. Deduplicates by key; returns
        True iff the job was accepted. A no-op on a disabled pool."""
        if not self.enabled:
            return False
        with self._cv:
            if key in self._queue or key in self._running \
                    or key in self._done:
                return False
            self._spawn()
            self._queue[key] = _Job(fn)
            self.submitted += 1
            self._cv.notify()
        return True

    def take(self, key, fn):
        """Consume the prepared result for ``key``, or compute ``fn()``
        inline. The two are interchangeable by construction: ``fn`` is a
        pure function of inputs ``key`` identifies, so the returned value
        is bit-identical either way."""
        if not self.enabled:
            return fn()
        with self._cv:
            job = self._done.pop(key, None)
            if job is None:
                # Not finished: compute inline, whether the job is still
                # queued (cancel it) or mid-compute on a worker (let it
                # finish into _done -- a later take may still consume it,
                # else it counts wasted). Blocking on a running worker
                # would put scheduler latency on the foreground stall
                # path, which costs more than the duplicated pure compute.
                self._queue.pop(key, None)
        if job is not None and job.err is None:
            self.hits += 1
            if self.stats is not None:
                self.stats.bg_segments += 1
                self.stats.bg_overlap_us += job.dur_s * 1e6
            return job.result
        self.misses += 1
        return fn()

    # -- lifecycle -------------------------------------------------------------
    def drain(self) -> None:
        """Wait until no prepare is queued or running (tests)."""
        with self._cv:
            while self._queue or self._running:
                self._cv.wait()

    def close(self) -> None:
        """Stop the workers (idempotent). Unconsumed prepares are counted
        wasted; a closed pool computes everything inline."""
        with self._cv:
            self._closed = True
            self.wasted += len(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        with self._cv:
            self.wasted += len(self._done)
            self._done.clear()
