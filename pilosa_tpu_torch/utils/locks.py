"""Named lock construction and the runtime lock-order checker, after the
JAX package's ``utils/locks.py``.

Every lock of the measurement plane (``utils/{stats,tracing,timeline,
profile,roofline}.py``) is made through ``make_lock`` / ``make_rlock`` /
``make_condition``. In normal runs the factories return the plain
``threading`` primitives, with no overhead. With
``PILOSA_TPU_LOCK_CHECK=1`` in the environment (read when the lock is
made) they return Debug* wrappers that record every acquisition into a
process-global *order graph* keyed by lock NAME (``"Profiler._lock"``):
acquiring B while holding A adds the edge A -> B, and an insertion that
closes a cycle raises ``LockOrderError`` at the acquisition site.

Granularity notes:

- Nodes are lock *names*, not instances: the checker enforces a
  class-level ordering. Same-name edges (holding one recorder's lock
  while taking another's) are deliberately not recorded.
- ``DebugCondition.wait`` pops the condition from the held stack for
  the duration of the wait (the underlying lock really is released),
  and ``notify`` records the waiter's re-acquire as an edge from every
  lock the notifier holds. A lock held ACROSS the wait that the notify
  path also needs is the lost-wakeup deadlock shape, reported directly.
- Violations both raise at the offending acquire AND accumulate in
  ``lock_order_violations()``, so a test can assert emptiness even when
  application code swallows the raise.

Third factory mode: while a ``pilosa_tpu_torch.utils.sched.Scheduler``
is active, the factories return its Sched* wrappers instead, so every
acquire, release, wait and notify is a yield point of the interleaving
explorer (``tests/test_torch_interleave.py``) over the port's modules,
unchanged.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

from pilosa_tpu_torch.utils import sched as _sched

def _enabled() -> bool:
    return os.environ.get("PILOSA_TPU_LOCK_CHECK", "") == "1"


class LockOrderError(AssertionError):
    """Acquiring this lock would close a cycle in the observed
    acquisition-order graph (potential deadlock)."""


class _OrderGraph:
    """Process-global observed-order graph. Tiny (a few dozen nodes);
    guarded by its own plain mutex which is never held while user code
    runs."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}
        # (held, acquiring) -> provenance string, for reports.
        self._seen: Dict[Tuple[str, str], str] = {}
        # cond name -> lock names some waiter held ACROSS a wait on it.
        self._wait_retained: Dict[str, Set[str]] = {}
        self.violations: List[str] = []

    def before_acquire(self, held: List[str], name: str) -> None:
        new = [h for h in held if h != name]
        if not new:
            return
        with self._mu:
            for h in new:
                self._edges.setdefault(h, set()).add(name)
                self._seen.setdefault((h, name),
                                      f"{h} held while acquiring {name}")
            cycle = self._find_cycle(name, set(new))
            if cycle is not None:
                msg = ("lock-order cycle: "
                       + " -> ".join(cycle)
                       + f" (thread {threading.current_thread().name} "
                       + f"holds {new!r}, acquiring {name!r})")
                self.violations.append(msg)
                raise LockOrderError(msg)

    def _find_cycle(self, start: str,
                    targets: Set[str]) -> Optional[List[str]]:
        """A path start ->* t for some held t proves t -> start -> t."""
        stack = [(start, [start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt in targets:
                    return path + [nxt, start]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_wait(self, cond: str, retained: List[str]) -> None:
        """A waiter is about to drop `cond` while still holding
        `retained` — remembered so a later notify can detect the
        lost-wakeup shape (notify path needs a lock a waiter keeps)."""
        if not retained:
            return
        with self._mu:
            self._wait_retained.setdefault(cond, set()).update(retained)

    def on_notify(self, cond: str, notifier_held: List[str]) -> None:
        """The waiter's ``wait()`` re-acquire of `cond`, recorded as an
        acquisition edge from the notify side: the re-acquire is
        enabled while the notifier's other locks are held, so each
        held -> cond edge participates in cycle detection exactly like
        a direct acquisition. Also flags the lost-wakeup deadlock: a
        lock some waiter retained across its wait that this notify
        path is holding."""
        held = [h for h in notifier_held if h != cond]
        msgs: List[str] = []
        with self._mu:
            stuck = self._wait_retained.get(cond, set()) & set(held)
            for r in sorted(stuck):
                msgs.append(
                    f"condition {cond!r}: notify path holds {r!r}, "
                    f"which a waiter retains across its wait "
                    f"(lost-wakeup deadlock)")
            for h in held:
                self._edges.setdefault(h, set()).add(cond)
                self._seen.setdefault(
                    (h, cond),
                    f"{h} held while notifying {cond} (waiter "
                    f"re-acquire edge)")
            if not msgs:
                cycle = self._find_cycle(cond, set(held))
                if cycle is not None:
                    msgs.append(
                        "lock-order cycle through condition: "
                        + " -> ".join(cycle)
                        + f" (thread {threading.current_thread().name}"
                        + f" notifies {cond!r} holding {held!r})")
            self.violations.extend(msgs)
        if msgs:
            raise LockOrderError(msgs[0])

    def edges(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._seen.clear()
            self._wait_retained.clear()
            self.violations.clear()


_GRAPH = _OrderGraph()
_TLS = threading.local()


def _held() -> List[str]:
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


def lock_order_edges() -> Dict[str, Set[str]]:
    """Observed (held -> acquired) order edges so far."""
    return _GRAPH.edges()


def lock_order_violations() -> List[str]:
    return list(_GRAPH.violations)


def reset_lock_order() -> None:
    """Clear the global graph (test isolation)."""
    _GRAPH.reset()


class DebugLock:
    """threading.Lock with named order tracking."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()
        self._owner: Optional[int] = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._inner.acquire()  # reentrant fast path: no new edge
            self._count += 1
            return True
        _GRAPH.before_acquire(_held(), self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._count += 1
            _held().append(self.name)
        return ok

    def release(self) -> None:
        self._count -= 1
        if self._count == 0:
            self._owner = None
            held = _held()
            # Remove the INNERMOST matching entry (locks may be
            # released out of LIFO order).
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class DebugRLock(DebugLock):
    _reentrant = True

    def __init__(self, name: str):
        super().__init__(name)
        self._inner = threading.RLock()

    def locked(self) -> bool:
        # _thread.RLock has no locked() before Python 3.14; held-ness
        # is tracked by our own owner bookkeeping.
        return self._owner is not None


class DebugCondition:
    """threading.Condition over a DebugRLock, with wait() keeping the
    held-stack honest while the lock is dropped."""

    def __init__(self, name: str):
        self.name = name
        self._dlock = DebugRLock(name)
        self._cond = threading.Condition(lock=_CondShim(self._dlock))

    # Lock protocol -----------------------------------------------------
    def acquire(self, *a, **kw) -> bool:
        return self._cond.acquire(*a, **kw)

    def release(self) -> None:
        self._cond.release()

    def __enter__(self) -> "DebugCondition":
        self._cond.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._cond.__exit__(*exc)

    # Condition protocol ------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        # Locks retained across the wait feed the notify-side
        # lost-wakeup check; the re-acquire itself routes through
        # _CondShim._acquire_restore -> DebugLock.acquire, so its
        # held -> cond edges are recorded like any acquisition.
        _GRAPH.note_wait(self.name,
                         [h for h in _held() if h != self.name])
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _GRAPH.note_wait(self.name,
                         [h for h in _held() if h != self.name])
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        _GRAPH.on_notify(self.name, list(_held()))
        self._cond.notify(n)

    def notify_all(self) -> None:
        _GRAPH.on_notify(self.name, list(_held()))
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"<DebugCondition {self.name!r}>"


class _CondShim:
    """Adapter handing a DebugRLock to threading.Condition. Condition
    calls _release_save/_acquire_restore around wait(); routing them
    through the debug lock's release/acquire keeps the per-thread held
    stack exact across the wait window."""

    def __init__(self, dlock: DebugRLock):
        self._dlock = dlock

    def acquire(self, *a, **kw):
        return self._dlock.acquire(*a, **kw)

    def release(self):
        self._dlock.release()

    def __enter__(self):
        return self._dlock.__enter__()

    def __exit__(self, *exc):
        return self._dlock.__exit__(*exc)

    def _release_save(self):
        # Fully drop a possibly multiply-held RLock: unwind our own
        # count so the held stack and owner reset, remembering depth.
        count = self._dlock._count
        for _ in range(count):
            self._dlock.release()
        return count

    def _acquire_restore(self, count):
        for _ in range(count):
            self._dlock.acquire()

    def _is_owned(self):
        return self._dlock._owner == threading.get_ident()


def make_lock(name: str):
    """A mutex named for diagnostics: plain threading.Lock normally,
    order-checked DebugLock under PILOSA_TPU_LOCK_CHECK=1, and a
    SchedLock while an interleaving explorer's Scheduler is active."""
    sch = _sched.active_scheduler()
    if sch is not None:
        return _sched.SchedLock(name, sch)
    return DebugLock(name) if _enabled() else threading.Lock()


def make_rlock(name: str):
    sch = _sched.active_scheduler()
    if sch is not None:
        return _sched.SchedRLock(name, sch)
    return DebugRLock(name) if _enabled() else threading.RLock()


def make_condition(name: str):
    sch = _sched.active_scheduler()
    if sch is not None:
        return _sched.SchedCondition(name, sch)
    return DebugCondition(name) if _enabled() else threading.Condition()
