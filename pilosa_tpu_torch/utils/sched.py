"""Deterministic cooperative scheduler: the runtime of the interleaving
explorer, after the JAX package's ``utils/sched.py``.

A scenario's threads are real ``threading.Thread``s, but only ONE runs
at a time: every other worker waits on a gate event of its own, and
control goes back to the scheduler at every lock acquire and release,
condition wait and notify, and explicit :func:`checkpoint` (for shared
state read without a lock). The scheduler picks who runs at each such
point, so a run is fixed by its *schedule* (the choices in order):

- :func:`explore_dfs` walks the tree of schedules breadth-first under
  a budget of schedules, exhaustive for small scenarios;
- :func:`rng_decider` takes a seeded random walk (``default_rng([seed,
  index])`` rebuilds the schedule);
- :func:`schedule_decider` replays a pinned schedule.

While a :class:`Scheduler` is active (its ``with`` body),
``make_lock`` / ``make_rlock`` / ``make_condition`` of
:mod:`pilosa_tpu_torch.utils.locks` return :class:`SchedLock` /
:class:`SchedRLock` / :class:`SchedCondition`, so scenario code runs
the port's own modules (``ResultCache``, ``LayoutManager``,
``Cluster``) unchanged.

Lock state is plain Python data (owner, count, waiters): with one
runner at a time nothing races on it, and it gives the wait-for graph
of a deadlock (no runnable worker while blocked ones remain; the
report names who waits on what and who holds it). Threads the
scheduler does not manage (the scenario's setup on the controlling
thread) take and release locks without yielding.

A timed condition wait times out only when nothing else can run, which
keeps timeout-guarded loops live without a branch for every spurious
wakeup.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "DeadlockError",
    "Outcome",
    "SchedCondition",
    "SchedLock",
    "SchedRLock",
    "Scheduler",
    "active_scheduler",
    "checkpoint",
    "explore_dfs",
    "rng_decider",
    "schedule_decider",
]

# decide(step_index, runnable_worker_idxs) -> position in that list.
# The runnable list is sorted by spawn index, so a decider can
# implement priority policies (the sequential oracle) as well as
# positional replay (schedule_decider).
Decider = Callable[[int, Sequence[int]], int]

_CONTROLLER = object()  # owner marker for unmanaged-thread acquisitions

# Steps a run may take: a scenario spinning without blocking (livelock)
# ends with a diagnosis instead of hanging the explorer.
MAX_STEPS = 20_000


class DeadlockError(RuntimeError):
    """No runnable worker while blocked workers remain; the message is
    the wait-for graph."""


class _Abort(BaseException):
    """Injected into parked workers to unwind them after the run is
    over (deadlock, failure, or budget stop). BaseException so scenario
    ``except Exception`` blocks cannot swallow it."""


class _Worker:
    def __init__(self, idx: int, name: str,
                 fn: Callable[[], None]) -> None:
        self.idx = idx
        self.name = name
        self.fn = fn
        self.gate = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.done = False
        self.exc: Optional[BaseException] = None
        # What this worker is parked on: a lock (waiting for release),
        # a condition (waiting for notify), or None (runnable).
        self.blocked_on: Optional[Union["SchedLock", "SchedCondition"]] = None
        self.waiting_in: Optional["SchedCondition"] = None
        self.timed = False       # the current cond wait has a timeout
        self.timed_out = False   # scheduler fired that timeout

    def __repr__(self) -> str:
        return f"<worker {self.name!r}>"


class Outcome:
    """One run's result: the schedule actually taken (``(choice,
    n_runnable)`` per step — replayable via the choices alone), worker
    errors, and the deadlock report if one was detected."""

    def __init__(self) -> None:
        self.trace: List[Tuple[int, int]] = []
        self.errors: List[str] = []
        self.deadlock: Optional[str] = None
        self.steps = 0

    @property
    def schedule(self) -> List[int]:
        return [c for c, _ in self.trace]

    @property
    def failed(self) -> bool:
        return bool(self.errors) or self.deadlock is not None

    def __repr__(self) -> str:
        return (f"<Outcome steps={self.steps} errors={len(self.errors)} "
                f"deadlock={self.deadlock is not None}>")


_ACTIVE: Optional["Scheduler"] = None


def active_scheduler() -> Optional["Scheduler"]:
    """The scheduler the ``make_*`` lock factories should instrument
    for, or None (normal operation)."""
    return _ACTIVE


def checkpoint() -> None:
    """Explicit yield point for UNLOCKED shared access: scenario code
    calls this between a racy read and its dependent use so the
    explorer can interleave there. No-op outside a scheduler run (and
    for threads the scheduler does not manage)."""
    sch = _ACTIVE
    if sch is None:
        return
    w = sch._worker_for_current()
    if w is not None:
        sch._switch_from(w)


class Scheduler:
    """One exploration run: activate (``with``), build scenario state
    (its ``make_*`` locks become Sched* wrappers), :meth:`spawn` the
    workers, :meth:`run`, read :attr:`outcome`."""

    def __init__(self, decide: Decider,
                 max_steps: int = MAX_STEPS) -> None:
        self._decide = decide
        self._max_steps = max_steps
        self._workers: List[_Worker] = []
        self._by_ident: Dict[int, _Worker] = {}
        self._main_gate = threading.Event()
        self._aborting = False
        self.outcome = Outcome()

    # ------------------------------------------------------ activation

    def __enter__(self) -> "Scheduler":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a Scheduler is already active")
        _ACTIVE = self
        return self

    def __exit__(self, *exc: object) -> None:
        global _ACTIVE
        _ACTIVE = None

    # --------------------------------------------------------- workers

    def spawn(self, name: str, fn: Callable[[], None]) -> None:
        if self._by_ident:
            raise RuntimeError("spawn() after run()")
        self._workers.append(_Worker(len(self._workers), name, fn))

    def _worker_main(self, w: _Worker) -> None:
        self._by_ident[threading.get_ident()] = w
        w.gate.wait()
        w.gate.clear()
        try:
            if not self._aborting:
                w.fn()
        except _Abort:
            pass
        except BaseException as e:  # noqa: BLE001 — reported, not lost
            w.exc = e
        finally:
            w.done = True
            self._main_gate.set()

    def _worker_for_current(self) -> Optional[_Worker]:
        return self._by_ident.get(threading.get_ident())

    # --------------------------------------------- worker-side switches

    def _switch_from(self, w: _Worker) -> None:
        """Hand the run token back to the scheduler; returns when this
        worker is next scheduled. Called on the WORKER's thread."""
        if self._aborting:
            # The run is over; do not wait for a schedule slot that
            # will never come (an aborting worker unwinds through
            # lock releases, which yield).
            raise _Abort()
        self._main_gate.set()
        w.gate.wait()
        w.gate.clear()
        if self._aborting:
            raise _Abort()

    def _park(self, w: _Worker,
              on: Union["SchedLock", "SchedCondition"]) -> None:
        """Block this worker on a lock/condition until another worker
        makes it runnable again (release / notify / timeout)."""
        w.blocked_on = on
        self._switch_from(w)

    # ------------------------------------------------------------- run

    def run(self) -> Outcome:
        out = self.outcome
        for w in self._workers:
            w.thread = threading.Thread(
                target=self._worker_main, args=(w,),
                name=w.name, daemon=True)
            w.thread.start()
        while True:
            live = [w for w in self._workers if not w.done]
            if any(w.exc is not None for w in self._workers):
                break  # a worker failed: the run's verdict is known
            if not live:
                break
            runnable = [w for w in live if w.blocked_on is None]
            if not runnable:
                timed = [w for w in live if w.timed]
                if not timed:
                    out.deadlock = self._wait_for_report(live)
                    break
                # "Eventually": fire a timeout only at quiescence.
                runnable = timed
            if out.steps >= self._max_steps:
                out.errors.append(
                    f"step budget exceeded ({self._max_steps}): "
                    "livelock or runaway scenario")
                break
            k = self._decide(out.steps, [w.idx for w in runnable])
            if not 0 <= k < len(runnable):
                k %= len(runnable)
            out.trace.append((k, len(runnable)))
            out.steps += 1
            w = runnable[k]
            if w.timed and w.blocked_on is not None:
                self._fire_timeout(w)
            w.gate.set()
            self._main_gate.wait()
            self._main_gate.clear()
        self._abort_rest()
        for w in self._workers:
            if w.exc is not None:
                out.errors.append(
                    f"{w.name}: {type(w.exc).__name__}: {w.exc}")
        return out

    def _fire_timeout(self, w: _Worker) -> None:
        cond = w.waiting_in
        if cond is not None and w in cond._waiting:
            cond._waiting.remove(w)
        w.timed_out = True
        w.blocked_on = None

    def _abort_rest(self) -> None:
        self._aborting = True
        for w in self._workers:
            if not w.done:
                w.gate.set()
        for w in self._workers:
            if w.thread is not None:
                w.thread.join(timeout=5.0)

    def _wait_for_report(self, blocked: List[_Worker]) -> str:
        parts = []
        for w in blocked:
            on = w.blocked_on
            if isinstance(on, SchedCondition):
                parts.append(f"{w.name} waits on condition "
                             f"{on.name!r} (no notifier can run)")
            elif isinstance(on, SchedLock):
                owner = on._owner
                holder = (owner.name if isinstance(owner, _Worker)
                          else "controller")
                parts.append(f"{w.name} waits on lock {on.name!r} "
                             f"held by {holder}")
            else:
                parts.append(f"{w.name} blocked")
        return "deadlock: " + "; ".join(parts)


# -------------------------------------------------------------- locks


class SchedLock:
    """Scheduler-instrumented mutex. State is plain data — only one
    worker runs at a time. Non-reentrant: a worker re-acquiring parks
    on itself and the wait-for graph reports the self-deadlock."""

    _reentrant = False

    def __init__(self, name: str, sch: Scheduler) -> None:
        self.name = name
        self._sch = sch
        self._owner: Optional[object] = None  # _Worker | _CONTROLLER
        self._count = 0
        self._waiters: List[_Worker] = []

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        w = self._sch._worker_for_current()
        if w is None:
            if self._owner is None:
                self._owner = _CONTROLLER
                self._count = 1
            elif self._owner is _CONTROLLER and self._reentrant:
                self._count += 1
            else:
                raise RuntimeError(
                    f"controller thread acquiring contended lock "
                    f"{self.name!r} (scenario setup must not race "
                    f"workers)")
            return True
        self._sch._switch_from(w)  # preemption point before acquire
        while not (self._owner is None
                   or (self._reentrant and self._owner is w)):
            self._waiters.append(w)
            self._sch._park(w, self)
        self._owner = w
        self._count += 1
        return True

    def release(self) -> None:
        w = self._sch._worker_for_current()
        expected: object = w if w is not None else _CONTROLLER
        if self._owner is not expected:
            raise RuntimeError(f"release of {self.name!r} by "
                               f"non-owner")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            for ww in self._waiters:
                ww.blocked_on = None
            self._waiters.clear()
        if w is not None:
            self._sch._switch_from(w)  # others may grab it first

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class SchedRLock(SchedLock):
    _reentrant = True


class SchedCondition:
    """Scheduler-instrumented condition over a :class:`SchedRLock`."""

    def __init__(self, name: str, sch: Scheduler) -> None:
        self.name = name
        self._sch = sch
        self._lock = SchedRLock(name, sch)
        self._waiting: List[_Worker] = []

    # lock protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "SchedCondition":
        self._lock.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self._lock.release()

    # condition protocol
    def _check_owned(self, w: Optional[_Worker]) -> None:
        expected: object = w if w is not None else _CONTROLLER
        if self._lock._owner is not expected:
            raise RuntimeError(
                f"condition {self.name!r} used without owning its lock")

    def wait(self, timeout: Optional[float] = None) -> bool:
        w = self._sch._worker_for_current()
        if w is None:
            raise RuntimeError("controller thread cannot wait() under "
                               "the scheduler")
        self._check_owned(w)
        saved = self._lock._count
        # Full release (RLock semantics), waking lock waiters.
        self._lock._count = 0
        self._lock._owner = None
        for ww in self._lock._waiters:
            ww.blocked_on = None
        self._lock._waiters.clear()
        self._waiting.append(w)
        w.waiting_in = self
        w.timed = timeout is not None
        self._sch._park(w, self)
        timed_out = w.timed_out
        w.timed = False
        w.timed_out = False
        w.waiting_in = None
        # Re-acquire, restoring the recursion count.
        while self._lock._owner is not None and self._lock._owner is not w:
            self._lock._waiters.append(w)
            self._sch._park(w, self._lock)
        self._lock._owner = w
        self._lock._count += saved
        return not timed_out

    def wait_for(self, predicate: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        while not predicate():
            if not self.wait(timeout):
                return predicate()
        return True

    def notify(self, n: int = 1) -> None:
        w = self._sch._worker_for_current()
        self._check_owned(w)
        woken = self._waiting[:n]
        del self._waiting[:len(woken)]
        for ww in woken:
            ww.blocked_on = None
        if w is not None:
            self._sch._switch_from(w)

    def notify_all(self) -> None:
        self.notify(len(self._waiting) or 1)

    def __repr__(self) -> str:
        return f"<SchedCondition {self.name!r}>"


# -------------------------------------------------------- exploration


def schedule_decider(schedule: Sequence[int]) -> Decider:
    """Replay a pinned schedule; past its end, KEEP RUNNING the worker
    the last choice landed on (falling back to the lowest index when
    it blocks or finishes). Sticky continuation means one divergence
    choice expresses "preempt here and let the other thread run to
    completion" — so the breadth-first sweep covers every
    single-preemption interleaving at divergence depth 1, where most
    check-then-act races live."""
    state: Dict[str, Optional[int]] = {"last": None}

    def decide(step: int, runnable: Sequence[int]) -> int:
        if step < len(schedule):
            k = min(schedule[step], len(runnable) - 1)
        else:
            last = state["last"]
            k = runnable.index(last) if last in runnable else 0
        state["last"] = runnable[k]
        return k

    return decide


def rng_decider(rng: "object") -> Decider:
    """Random walk driven by a numpy Generator (``default_rng([seed,
    index])`` — the (seed, index) reproducer contract)."""

    def decide(step: int, runnable: Sequence[int]) -> int:
        n = len(runnable)
        return int(rng.integers(0, n))  # type: ignore[attr-defined]

    return decide


def explore_dfs(run_with: Callable[[Decider], Outcome],
                max_schedules: int
                ) -> List[Tuple[List[int], Outcome]]:
    """Systematic exploration of the schedule tree: run a prefix
    (choices beyond it default to 0), then enqueue every untaken
    branch along its trace — breadth-first, so schedules diverging at
    EARLY steps (single preemptions — where most atomicity races live)
    are covered first, and deeper divergences later (the CHESS
    preemption-bounding insight). Each schedule runs exactly once:
    children only branch at positions at or past their parent's pinned
    prefix. Exhaustive when the tree fits in ``max_schedules``; a
    truncated sweep is still deterministic (same order every time)."""
    results: List[Tuple[List[int], Outcome]] = []
    queue: List[List[int]] = [[]]
    head = 0
    while head < len(queue) and len(results) < max_schedules:
        prefix = queue[head]
        head += 1
        outcome = run_with(schedule_decider(prefix))
        results.append((outcome.schedule, outcome))
        trace = outcome.trace
        for i in range(len(prefix), len(trace)):
            chosen, n = trace[i]
            stem = [c for c, _ in trace[:i]]
            for c in range(n):
                if c != chosen:
                    queue.append(stem + [c])
    return results
