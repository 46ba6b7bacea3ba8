"""Bounded double-buffered host-staging pipeline (counterpart of
``quiver_tpu/pipeline.py``).

A training loop over the tiered store stages each batch's feature rows
(``Feature.__getitem__``: the hot-tier gather and the host-tier reads
of ``gather_rows``) and samples the next batch while the card runs the
current step. This module gives that staging an executor:

- **one** worker thread per pipeline, so results complete in submission
  order;
- a **bounded** queue (``depth``, default 2: the double buffer):
  ``submit`` blocks at ``depth`` queued items instead of queueing an
  unbounded backlog ahead of the card;
- **clean shutdown**: an idempotent ``close()`` (cancels queued work,
  stops the worker), context-manager support, and a ``weakref.finalize``
  safety net so a dropped pipeline leaks no thread;
- **failure**: a stage that raises surfaces the exception through
  ``Future.result()`` (and through ``map`` and ``pipelined``, which
  cancel the work still queued first); the pipeline stays serviceable.
  The worker fires the ``"pipeline.worker"`` fault site (``faults.py``)
  before each queue pop, and a dead worker is restarted by the next
  ``submit`` or ``ensure_worker``;
- **telemetry**: ``stats()`` (``metrics.StepStats.watch_pipeline`` folds
  it) and, with ``tracing`` on, ``pipeline.queue_wait`` and
  ``pipeline.execute`` spans.

``future_type`` (a ``concurrent.futures.Future`` subclass) is the class
of the futures ``submit`` returns: ``Feature.prefetch`` uses one whose
``result()`` orders the reading CUDA stream after the worker's. A
training loop can also drive the pipeline directly::

    from quiver_tpu_torch.pipeline import pipelined
    for x in pipelined(lambda ids: feature[ids], id_batches):
        state, loss = step_fn(state, x, ...)   # batch i+1 stages meanwhile
"""

from __future__ import annotations

import collections
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Callable, Iterable, Iterator, Optional

from . import faults, tracing

_STOP = object()


def _worker(q: "queue.Queue", stats: dict, lock: "threading.Lock",
            name: str = "pipeline"):
    while True:
        # the injectable worker-death site sits BEFORE the queue pop:
        # a killed worker strands no claimed item, so the watchdog
        # restart (``_ensure_worker``) resumes the queue with every
        # future intact
        faults.fire("pipeline.worker")
        item = q.get()
        if item is _STOP:
            return
        fut, fn, args, kwargs, t_enq = item
        if not fut.set_running_or_notify_cancel():
            with lock:
                stats["cancelled"] += 1
            continue                     # cancelled while queued
        t_run = time.perf_counter()
        wait = t_run - t_enq
        # span hooks ride the stats plumbing's own clock reads: when
        # tracing is off this adds one bool check per item, nothing else
        traced = tracing.enabled()
        if traced:
            tracing.record("pipeline.queue_wait", t_enq, wait,
                           args={"pipeline": name})
        try:
            fut.set_result(fn(*args, **kwargs))
            ok = True
        except BaseException as e:       # surfaces via fut.result()
            fut.set_exception(e)
            ok = False
        if traced:
            tracing.record("pipeline.execute", t_run,
                           time.perf_counter() - t_run,
                           args={"pipeline": name, "ok": ok})
        with lock:
            stats["completed" if ok else "failed"] += 1
            stats["total_wait_s"] += wait
            stats["max_wait_s"] = max(stats["max_wait_s"], wait)


def _drain_cancel(q: "queue.Queue", stats=None, lock=None):
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            return
        if item is not _STOP and item[0].cancel() and stats is not None:
            with lock:
                stats["cancelled"] += 1


def _finalize_shutdown(q: "queue.Queue", box: dict, stats: dict,
                       lock: "threading.Lock"):
    """GC safety net (must not reference the Pipeline itself): cancel
    queued work and stop the worker so a dropped pipeline leaks no
    thread. No join — this can run from the GC."""
    _drain_cancel(q, stats, lock)
    t = box.get("thread")
    if t is not None and t.is_alive():
        q.put(_STOP)


class Pipeline:
    """Single-worker, depth-bounded staging executor (see module doc).

    ``submit(fn, *args, **kwargs)`` returns a ``future_type`` future and
    blocks once ``depth`` items are queued (backpressure).
    ``map(fn, items)`` yields ``fn(item)`` results in order with at
    most ``depth`` stages in flight.
    """

    def __init__(self, depth: int = 2, name: str = "quiver-pipeline",
                 future_type: type = Future):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._depth = depth
        self._name = name
        self._future_type = future_type
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._box: dict = {"thread": None}
        self._closed = False
        self._lock = threading.Lock()
        # telemetry (read via stats()): queue-wait seconds measure how
        # long staged batches sat behind the worker — the number that
        # says whether the pipeline depth or the stage itself is the
        # bottleneck (metrics.StepStats.watch_pipeline consumes this)
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "cancelled": 0, "dropped": 0, "max_depth": 0,
                       "worker_restarts": 0,
                       "total_wait_s": 0.0, "max_wait_s": 0.0}
        self._stats_lock = threading.Lock()
        self._finalizer = weakref.finalize(self, _finalize_shutdown,
                                           self._q, self._box,
                                           self._stats, self._stats_lock)

    # -- core ---------------------------------------------------------------
    def _ensure_worker(self):
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self._name}: pipeline is closed")
            cur = self._box["thread"]
            if cur is not None and not cur.is_alive():
                # worker-death watchdog: the loop only exits cleanly on
                # _STOP (sent by close), so a dead thread on an OPEN
                # pipeline is an unexpected death (an injected
                # ``pipeline.worker`` fault, a BaseException escaping
                # the loop) — restart it; the queue and every queued
                # future survive intact, and the restart is counted
                self._box["thread"] = None
                cur = None
                with self._stats_lock:
                    self._stats["worker_restarts"] += 1
            if cur is None:
                t = threading.Thread(target=_worker,
                                     args=(self._q, self._stats,
                                           self._stats_lock, self._name),
                                     name=self._name, daemon=True)
                t.start()
                self._box["thread"] = t

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        self._ensure_worker()
        fut: Future = self._future_type()
        # count the submission BEFORE the (possibly blocking) put: a
        # concurrent stats() read must never see completed > submitted
        with self._stats_lock:
            self._stats["submitted"] += 1
        self._q.put((fut, fn, args, kwargs,
                     time.perf_counter()))       # blocks at depth
        with self._stats_lock:
            self._stats["max_depth"] = max(self._stats["max_depth"],
                                           self._q.qsize())
        if self._closed:
            # close() raced our enqueue (its drain may have run before
            # our put landed, stranding the item behind _STOP with no
            # worker): reclaim it so the Future can never hang. If the
            # worker already picked it up, cancel() fails and the item
            # completes normally.
            if fut.cancel():
                raise RuntimeError(f"{self._name}: pipeline is closed")
        return fut

    def ensure_worker(self) -> bool:
        """Revive a dead worker WITHOUT submitting (the watchdog's
        second trigger): a consumer about to BLOCK on an
        already-queued future must be able to restart the thread that
        will resolve it — waiting for the next ``submit`` to notice
        would deadlock a caller that only submits after the wait.
        Returns False (a no-op) when the pipeline is closed."""
        if self._closed:
            return False
        try:
            self._ensure_worker()
        except RuntimeError:
            return False                 # close() raced us
        return True

    def try_submit(self, fn: Callable, *args, **kwargs) -> Optional[Future]:
        """Non-blocking :meth:`submit`: returns the ``Future``, or
        ``None`` when the queue is already at ``depth`` — the item is
        DROPPED, not queued (counted in ``stats()['dropped']``): for a
        producer that must shed work rather than wait, as the JAX
        package's cold-tier prefetcher publishes frontiers."""
        self._ensure_worker()
        fut: Future = self._future_type()
        with self._stats_lock:
            self._stats["submitted"] += 1
        try:
            self._q.put_nowait((fut, fn, args, kwargs,
                                time.perf_counter()))
        except queue.Full:
            with self._stats_lock:
                self._stats["submitted"] -= 1
                self._stats["dropped"] += 1
            return None
        with self._stats_lock:
            self._stats["max_depth"] = max(self._stats["max_depth"],
                                           self._q.qsize())
        if self._closed:
            # same close() race as submit(): reclaim a stranded item
            if fut.cancel():
                return None
        return fut

    def map(self, fn: Callable, items: Iterable) -> Iterator:
        """Yield ``fn(item)`` for each item, in order, keeping up to
        ``depth`` stages in flight. An exception from any stage
        propagates at its yield point after cancelling the not-yet-
        running remainder (the running stage finishes; its result is
        dropped)."""
        pending: collections.deque = collections.deque()
        it = iter(items)
        exhausted = False
        try:
            while pending or not exhausted:
                while not exhausted and len(pending) < self._depth:
                    try:
                        x = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(self.submit(fn, x))
                if pending:
                    yield pending.popleft().result()
        finally:
            while pending:
                pending.popleft().cancel()

    # -- lifecycle ----------------------------------------------------------
    def close(self, wait: bool = True):
        """Cancel queued work and stop the worker. Idempotent; safe to
        call from any thread; also runs (joinless) via the GC
        finalizer."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t = self._box["thread"]
            self._box["thread"] = None
        self._finalizer.detach()
        _drain_cancel(self._q, self._stats, self._stats_lock)
        if t is not None:
            self._q.put(_STOP)
            # a stage fn / Future done-callback may close the pipeline
            # from the worker itself — joining the current thread would
            # raise, so skip the join there (the worker exits on _STOP)
            if wait and t is not threading.current_thread():
                t.join()

    def stats(self) -> dict:
        """Queue telemetry snapshot: submitted/completed/failed/
        cancelled counts, peak queued depth, and worker-side wait
        totals (``mean_wait_s`` derived). Cheap; safe from any
        thread."""
        with self._stats_lock:
            s = dict(self._stats)
        done = s["completed"] + s["failed"]
        s["mean_wait_s"] = s["total_wait_s"] / done if done else 0.0
        s["depth"] = self._q.qsize()
        return s

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        state = "closed" if self._closed else "open"
        return f"Pipeline({self._name!r}, depth={self._depth}, {state})"


def pipelined(fn: Callable, items: Iterable, depth: int = 2,
              name: str = "quiver-pipelined") -> Iterator:
    """Run ``fn`` over ``items`` on a fresh background pipeline,
    yielding results in order with up to ``depth`` stages in flight.
    The pipeline is closed when the generator finishes — normally, on a
    stage exception, or when the consumer abandons it."""
    p = Pipeline(depth=depth, name=name)
    try:
        yield from p.map(fn, items)
    finally:
        p.close()
