"""The port's named locks and lock-order checker
(``pilosa_tpu_torch/utils/locks.py``): plain primitives by default, and
under ``PILOSA_TPU_LOCK_CHECK=1`` an order graph that refuses the
acquisition closing a cycle, records the notify side of a condition, and
reports a lock kept across a wait that the notify path needs."""

import threading

import pytest

from pilosa_tpu_torch.utils import locks


@pytest.fixture
def checked(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_LOCK_CHECK", "1")
    locks.reset_lock_order()
    yield
    locks.reset_lock_order()


def test_plain_primitives_without_the_check(monkeypatch):
    monkeypatch.delenv("PILOSA_TPU_LOCK_CHECK", raising=False)
    assert type(locks.make_lock("x")) is type(threading.Lock())
    assert type(locks.make_rlock("x")) is type(threading.RLock())
    assert isinstance(locks.make_condition("x"), threading.Condition)


def test_cycle_is_refused_and_recorded(checked):
    a, b = locks.make_lock("A"), locks.make_lock("B")
    with a:
        with b:
            pass
    assert locks.lock_order_edges() == {"A": {"B"}}
    with b:
        with pytest.raises(locks.LockOrderError, match="A -> B"):
            with a:
                pass
    assert locks.lock_order_violations()
    assert not a.locked()


def test_reentrant_lock_and_same_name_edges(checked):
    r = locks.make_rlock("R")
    with r:
        with r:
            assert r.locked()
    assert not r.locked()
    one, two = locks.make_lock("Frag"), locks.make_lock("Frag")
    with one:
        with two:
            pass
    assert locks.lock_order_edges() == {}


def test_condition_wait_and_notify_edges(checked):
    cond, other = locks.make_condition("C"), locks.make_lock("L")
    ready = []

    def waiter():
        with cond:
            cond.wait_for(lambda: ready, timeout=5)

    t = threading.Thread(target=waiter)
    t.start()
    with other:
        with cond:
            ready.append(1)
            cond.notify_all()
    t.join(5)
    assert "C" in locks.lock_order_edges()["L"]
    assert not locks.lock_order_violations()
