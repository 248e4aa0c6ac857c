"""Cross-request query coalescing for the serving path, after the JAX
package's ``server/coalescer.py``.

Concurrent ``POST /index/{i}/query`` requests are collected into one
executor batch, so independent single-query clients share the batch
path (``Executor.execute_batch_begin``): one flush, one ``mega_interpret``
launch per shard-count cohort.

- A request thread enqueues its query and blocks on its item's event.
- One dispatcher thread collects the items that arrive within a short
  window (default 1.5 ms), flushing early when the batch reaches
  ``max_batch``, when a write arrives, or when the previous batch was
  still running as they arrived (they have waited already).
- A batch of one runs the exact direct path (``execute_full``). A
  larger batch runs ``execute_batch_begin`` and
  ``execute_batch_shaped_finish`` with per-request errors: one bad query
  fails only itself.
- Identical reads in a write-free flush run once and share the answer.
- Pipelined dispatch: a read-only batch's begin runs on the dispatcher,
  its finish (the host syncs and the JSON shaping) on a finalizer
  thread, so batch K+1 stages and launches while batch K drains. Depth
  one: the dispatcher waits for the finalizer's slot before handing it
  the next batch. A batch with a write, or of one item, first waits for
  the in-flight batch to finish and then runs serially.
- Admission control: past ``max_queue`` pending items ``submit`` raises
  ``CoalescerOverload`` (HTTP 429 with Retry-After). With ``deadline_s``
  a request still queued at its deadline is ejected and fails with
  ``DeadlineExceeded`` (HTTP 408); a claimed request always finishes.

The JAX package's stats, tracing, workload-recorder and timeline hooks
are not ported; ``counters`` holds the counts the serving checks read.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from pilosa_tpu_torch.server.api import ApiError
from pilosa_tpu_torch.utils.fingerprint import request_key

# Item lifecycle: PENDING (queued, still ejectable) -> CLAIMED (taken by
# the dispatcher; result imminent) or EJECTED (deadline passed while
# queued; the dispatcher skips it).
_PENDING, _CLAIMED, _EJECTED = 0, 1, 2


class CoalescerStopped(RuntimeError):
    """Raised by submit() when the coalescer is stopped or its dispatcher
    died: the ONLY condition the API may answer by re-running the query
    on the direct path."""


class CoalescerOverload(ApiError):
    """Pending queue at capacity: HTTP 429 with a Retry-After hint."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg, 429)
        self.retry_after = retry_after
        self.headers = {"Retry-After": str(max(1, int(retry_after)))}


class DeadlineExceeded(ApiError):
    """The request expired while queued; it was never dispatched."""

    def __init__(self, msg: str):
        super().__init__(msg, 408)


class _Item:
    __slots__ = ("index", "query", "shards", "is_write", "deadline",
                 "state", "event", "result")

    def __init__(self, index: str, query: Any,
                 shards: Optional[Sequence[int]], is_write: bool,
                 deadline: Optional[float]):
        self.index = index
        self.query = query
        self.shards = shards
        self.is_write = is_write
        self.deadline = deadline
        self.state = _PENDING
        self.event = threading.Event()
        self.result: Any = None


class QueryCoalescer:
    """Collects concurrent single-query requests into executor batches.

    ``submit()`` is the entry for request threads; ``start()`` and
    ``stop()`` bracket the dispatcher's life. ``stop()`` drains: what is
    queued still runs before the dispatcher exits."""

    def __init__(self, executor: Any, window_s: float = 0.0015,
                 max_batch: int = 64, max_queue: int = 256,
                 deadline_s: float = 0.0):
        self.executor = executor
        self.window_s = max(0.0, float(window_s))
        self.max_batch = max(1, int(max_batch))
        self.max_queue = max(1, int(max_queue))
        self.deadline_s = max(0.0, float(deadline_s))
        self._queue: List[_Item] = []
        # Items claimed for the batch being built or run, so a dying
        # dispatcher can resolve them too.
        self._inflight: List[_Item] = []
        self._cond = threading.Condition()
        self._flush_now: Optional[str] = None  # early-flush reason
        self._stop = False
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # True while the dispatcher runs a batch: arrivals meanwhile have
        # waited already and flush without a new window.
        self._busy = False
        # The finalizer's depth-one slot and its lifecycle.
        self._pl_cond = threading.Condition()
        self._pl_pending: Optional[tuple] = None
        self._pl_stop = False
        self._pl_thread: Optional[threading.Thread] = None
        self._counts_lock = threading.Lock()
        # admitted, rejected, deadline_ejected, deduped, batches (flushes
        # of more than one item), batched_requests, pipelined,
        # flush.<reason>.
        self.counters: Dict[str, int] = {}

    def _count(self, name: str, n: int = 1) -> None:
        with self._counts_lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # ------------------------------------------------------------ lifecycle

    @property
    def running(self) -> bool:
        return self._running

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def start(self) -> None:
        if self._running or (self._thread is not None
                             and self._thread.is_alive()):
            # A stop() whose drain timed out leaves the old dispatcher
            # running: never start a second one over the same queue.
            return
        with self._cond:
            self._stop = False
            self._running = True
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="query-coalescer")
        self._thread.start()
        if self._pl_thread is None or not self._pl_thread.is_alive():
            with self._pl_cond:
                self._pl_stop = False
            self._pl_thread = threading.Thread(
                target=self._finalize_loop, daemon=True,
                name="query-coalescer-finalize")
            self._pl_thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop admitting, run everything queued, join the threads. Safe
        to call twice. A dispatcher still inside a batch after
        ``timeout`` keeps its handle, and start() will not double it."""
        with self._cond:
            if not self._running and self._thread is None:
                return
            self._running = False  # submit() now raises CoalescerStopped
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                return
            with self._cond:
                self._thread = None
        # The dispatcher waited for its in-flight batch before exiting,
        # so the finalizer is idle.
        with self._pl_cond:
            self._pl_stop = True
            self._pl_cond.notify_all()
        ft = self._pl_thread
        if ft is not None:
            ft.join(timeout=timeout)
            if not ft.is_alive():
                self._pl_thread = None

    # --------------------------------------------------------------- submit

    def submit(self, index: str, query: Any,
               shards: Optional[Sequence[int]] = None) -> Dict[str, Any]:
        """Queue one query and block until its batch resolves. Returns
        the shaped response; raises the request's own exception,
        ``CoalescerOverload``, ``DeadlineExceeded``, or
        ``CoalescerStopped`` when the coalescer is not running."""
        from pilosa_tpu_torch.executor.executor import query_is_write
        deadline = (time.monotonic() + self.deadline_s
                    if self.deadline_s > 0 else None)
        is_write = query_is_write(query)
        item = _Item(index, query, shards, is_write, deadline)
        with self._cond:
            if not self._running:
                raise CoalescerStopped("coalescer stopped")
            if len(self._queue) >= self.max_queue:
                self._count("rejected")
                raise CoalescerOverload(
                    f"query queue at capacity ({self.max_queue} pending)",
                    retry_after=max(1.0, self.window_s * 2))
            self._queue.append(item)
            self._count("admitted")
            if is_write and self._flush_now is None:
                # A write must not sit in a window.
                self._flush_now = "write"
            elif len(self._queue) >= self.max_batch and \
                    self._flush_now is None:
                self._flush_now = "size"
            self._cond.notify_all()
        return self._await(item)

    def _await(self, item: _Item) -> Dict[str, Any]:
        if item.deadline is not None:
            if not item.event.wait(max(0.0, item.deadline
                                       - time.monotonic())):
                with self._cond:
                    if item.state == _PENDING:
                        # Still queued: eject it so it never dispatches.
                        item.state = _EJECTED
                        try:
                            self._queue.remove(item)
                        except ValueError:
                            pass
                        self._count("deadline_ejected")
                        raise DeadlineExceeded(
                            f"deadline exceeded after "
                            f"{self.deadline_s * 1e3:.0f} ms in queue")
                # Claimed in the race: the deadline bounds queue time,
                # not execution, so deliver the result.
                item.event.wait()
        else:
            item.event.wait()
        if isinstance(item.result, Exception):
            raise item.result
        return item.result

    # ----------------------------------------------------------- dispatcher

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._queue and not self._stop:
                        self._busy = False
                        self._cond.wait()
                    if not self._queue and self._stop:
                        break
                    reason = self._collect_window()
                    batch = self._claim_batch()
                    busy_next = bool(self._queue)
                if batch:
                    if self._can_pipeline(batch):
                        self._execute_pipelined(batch, reason)
                    else:
                        # A write (or the direct path of a lone request)
                        # runs after the in-flight batch has drained.
                        self._pipeline_barrier()
                        self._execute(batch, reason)
                self._inflight = []
                with self._cond:
                    self._busy = busy_next or bool(self._queue)
            self._pipeline_barrier()
        except BaseException as e:  # dispatcher died: strand nobody
            with self._cond:
                self._running = False
                pending, self._queue = self._queue, []
            for item in pending + self._inflight:
                if not item.event.is_set():
                    item.result = CoalescerStopped(
                        f"coalescer dispatcher died: {e!r}")
                    item.event.set()
            raise

    def _collect_window(self) -> str:
        """Hold the window open for more arrivals (lock held); returns
        the flush reason."""
        if self._stop:
            return "shutdown"
        if self._busy:
            return "drain"
        if self.window_s <= 0:
            return "idle"
        deadline = time.monotonic() + self.window_s
        while (self._flush_now is None and not self._stop
               and len(self._queue) < self.max_batch):
            left = deadline - time.monotonic()
            if left <= 0:
                return "window"
            self._cond.wait(left)
        if self._stop:
            return "shutdown"
        return self._flush_now or "window"

    def _claim_batch(self) -> List[_Item]:
        """Claim up to max_batch pending items (lock held), failing the
        expired ones with DeadlineExceeded."""
        self._flush_now = None
        now = time.monotonic()
        batch = self._inflight = []
        while self._queue and len(batch) < self.max_batch:
            item = self._queue.pop(0)
            if item.state != _PENDING:
                continue
            if item.deadline is not None and now >= item.deadline:
                item.state = _EJECTED
                item.result = DeadlineExceeded(
                    f"deadline exceeded after "
                    f"{self.deadline_s * 1e3:.0f} ms in queue")
                self._count("deadline_ejected")
                item.event.set()
                continue
            item.state = _CLAIMED
            batch.append(item)
        return batch

    def _note_flush(self, batch: List[_Item], reason: str) -> None:
        self._count(f"flush.{reason}")
        if len(batch) > 1:
            self._count("batches")
            self._count("batched_requests", len(batch))

    def _execute(self, batch: List[_Item], reason: str) -> None:
        self._note_flush(batch, reason)
        try:
            if len(batch) == 1:
                self._execute_direct(batch[0])
            else:
                reqs, owner = self._dedup(batch)
                self._resolve(owner, self.executor.execute_batch_shaped(reqs))
        except Exception as e:  # the dispatcher must never die
            for item in batch:
                if not item.event.is_set():
                    item.result = e
                    item.event.set()

    def _execute_direct(self, item: _Item) -> None:
        """A batch of one runs the exact direct path."""
        try:
            item.result = self.executor.execute_full(
                item.index, item.query, shards=item.shards)
        except Exception as e:
            item.result = e
        item.event.set()

    def _dedup(self, batch: List[_Item]) -> Tuple[
            List[Tuple[str, Any, Optional[Sequence[int]]]],
            List[List[_Item]]]:
        """Collapse identical read-only queries when the flush carries no
        write (a write orders against its batchmates, so reads around it
        each run in place)."""
        dedup_ok = not any(it.is_write for it in batch)
        first: Dict[tuple, int] = {}
        reqs: List[Tuple[str, Any, Optional[Sequence[int]]]] = []
        owner: List[List[_Item]] = []
        for item in batch:
            key = None
            if dedup_ok and isinstance(item.query, str):
                key = request_key(item.index, item.query, item.shards)
                if key in first:
                    owner[first[key]].append(item)
                    continue
                first[key] = len(reqs)
            reqs.append((item.index, item.query, item.shards))
            owner.append([item])
        if len(reqs) < len(batch):
            self._count("deduped", len(batch) - len(reqs))
        return reqs, owner

    @staticmethod
    def _resolve(owner: List[List[_Item]], shaped: List[Any]) -> None:
        for res, items in zip(shaped, owner):
            for item in items:
                item.result = res
                item.event.set()

    # ------------------------------------------------------- pipelined path

    def _can_pipeline(self, batch: List[_Item]) -> bool:
        """Read-only batches of more than one item pipeline while the
        finalizer runs."""
        return (not self._pl_stop and self._pl_thread is not None
                and self._pl_thread.is_alive() and len(batch) > 1
                and not any(it.is_write for it in batch))

    def _pipeline_barrier(self) -> None:
        """Wait until no batch is in flight on the finalizer."""
        if self._pl_thread is None:
            return
        with self._pl_cond:
            while self._pl_pending is not None:
                self._pl_cond.wait()

    def _execute_pipelined(self, batch: List[_Item], reason: str) -> None:
        """The begin half here (parse, stage, flush, launch), then hand
        the in-flight batch to the finalizer and go back to collecting."""
        self._note_flush(batch, reason)
        try:
            reqs, owner = self._dedup(batch)
            flight = self.executor.execute_batch_begin(reqs)
        except Exception as e:  # the begin failed: resolve everyone now
            for item in batch:
                if not item.event.is_set():
                    item.result = e
                    item.event.set()
            return
        self._count("pipelined")
        with self._pl_cond:
            # Depth one: wait for the previous batch's slot. The wait
            # comes after this batch launched, so its device work
            # already overlaps the previous drain.
            while self._pl_pending is not None:
                self._pl_cond.wait()
            if not self._pl_stop:
                self._pl_pending = (batch, owner, flight)
                self._pl_cond.notify_all()
                return
        # The finalizer ended while this batch began: drain it here.
        try:
            self._finish(batch, owner, flight)
        except Exception:
            pass  # resolved to the batch's requesters

    def _finish(self, batch: List[_Item], owner: List[List[_Item]],
                flight: Any) -> None:
        """Drain one in-flight batch and resolve its requesters; on a
        failure resolve them with it (an interrupt or exit as
        CoalescerStopped), then raise it."""
        try:
            self._resolve(owner,
                          self.executor.execute_batch_shaped_finish(flight))
        except BaseException as e:
            for item in batch:
                if not item.event.is_set():
                    item.result = (e if isinstance(e, Exception)
                                   else CoalescerStopped(repr(e)))
                    item.event.set()
            raise

    def _finalize_loop(self) -> None:
        """Drain in-flight batches. A failed drain resolves that batch's
        requesters with its error and the loop goes on; an interrupt or
        exit ends the loop, and later batches drain on the dispatcher."""
        while True:
            with self._pl_cond:
                while self._pl_pending is None and not self._pl_stop:
                    self._pl_cond.wait()
                if self._pl_pending is None:
                    return
                work = self._pl_pending
            try:
                self._finish(*work)
            except Exception:
                pass  # resolved to the batch's requesters
            except BaseException:
                with self._pl_cond:
                    self._pl_stop = True
                raise
            finally:
                with self._pl_cond:
                    self._pl_pending = None
                    self._pl_cond.notify_all()
