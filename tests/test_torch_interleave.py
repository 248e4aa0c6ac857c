"""The interleaving explorer over the port: ``pilosa_tpu_torch/utils/
sched.py`` and the scheduler mode of the port's lock factories, held
against the JAX package's ``utils/sched.py``, and the sweep of the JAX
package's scenario corpus (``tools/interleave.py``) rebuilt over the
port's own modules.

- the scheduler: the factories hand out its wrappers while it is active,
  a lost update is reachable without a lock and not with one, an AB/BA
  deadlock is named by the wait-for graph, a timed wait fires only at
  quiescence, and the JAX scheduler and the port's take the same
  schedules to the same outcomes on the same scenario;
- the sweep (the harness of ``tools/interleave.py``, breadth-first over
  schedules under DEFAULT_BUDGET, each run judged for exceptions,
  deadlocks, the scenario's invariant and sequential equivalence): every
  good scenario sweeps clean, and every re-introduced bad one is found
  within the budget.

Scenario by scenario, the port's counterpart:

- ``coalescer_double_buffer``: the JAX scenario is a model of the
  coalescer's depth-1 pipelined hand-off; the port's coalescer has the
  same hand-off (``_pl_pending``/``_pl_cond``), so the model stands
  for both;
- ``result_cache_stamp`` and ``bad_cache_stamp_then_read``: the port's
  real ``ResultCache``;
- ``layout_demote_promote``: the port's real ``LayoutManager`` (its
  locks come from the factory);
- ``bank_cache_miss_race`` and ``bad_bank_cache_unlocked_evict``: models
  of the JAX executor's LRU bank cache with its ledger. The port has no
  counterpart in that form: its ``Executor._empty_bank`` is an unbounded
  memo of all-zero banks by shard count, with no eviction and no ledger,
  where either of two racing inserts holds the same zeros. The models
  run as the JAX package runs them;
- ``cluster_route_adopt`` and ``bad_resize_two_step_route``: the port's
  real ``Cluster``;
- ``bad_lock_order_abba``: two factory locks.
"""

import itertools
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pytest

from pilosa_tpu.utils import sched as jsched
from pilosa_tpu_torch.utils import sched
from pilosa_tpu_torch.utils.locks import make_condition, make_lock, \
    make_rlock

DEFAULT_BUDGET = 400


# ------------------------------------------------------- scheduler basics


def test_factories_return_sched_wrappers_under_scheduler():
    with sched.Scheduler(sched.schedule_decider([])):
        assert isinstance(make_lock("x"), sched.SchedLock)
        assert isinstance(make_rlock("x"), sched.SchedRLock)
        assert isinstance(make_condition("x"), sched.SchedCondition)
    assert not isinstance(make_lock("x"), sched.SchedLock)
    with pytest.raises(RuntimeError, match="already active"):
        with sched.Scheduler(sched.schedule_decider([])):
            with sched.Scheduler(sched.schedule_decider([])):
                pass


def _increment_run(mod, factory, use_lock):
    """run_with(decide) of two workers incrementing a shared count
    (under a factory lock or not), over scheduler module ``mod``; the
    finals land in the returned set."""
    finals = set()

    def run_with(decide):
        with mod.Scheduler(decide) as s:
            lock = factory("L")
            state = {"n": 0}

            def inc():
                if use_lock:
                    with lock:
                        v = state["n"]
                        mod.checkpoint()
                        state["n"] = v + 1
                else:
                    v = state["n"]
                    mod.checkpoint()
                    state["n"] = v + 1

            s.spawn("t1", inc)
            s.spawn("t2", inc)
            out = s.run()
        assert not out.failed
        finals.add(state["n"])
        return out

    return run_with, finals


def test_unlocked_increment_races_locked_does_not():
    run_with, finals = _increment_run(sched, make_lock, False)
    sched.explore_dfs(run_with, 100)
    assert finals == {1, 2}
    run_with, finals = _increment_run(sched, make_lock, True)
    sched.explore_dfs(run_with, 200)
    assert finals == {2}


@pytest.mark.parametrize("use_lock", [False, True])
def test_schedules_match_jax(use_lock):
    """The JAX scheduler and the port's enumerate the same schedules in
    the same order, each to the same trace and final count."""
    from pilosa_tpu.utils.locks import make_lock as jax_make_lock
    got = []
    for mod, factory in ((jsched, jax_make_lock), (sched, make_lock)):
        runs = []
        run_with, _ = _increment_run(mod, factory, use_lock)

        def keep(decide, run_with=run_with, runs=runs):
            out = run_with(decide)
            runs.append((out.trace, out.steps))
            return out

        sched_list = [s for s, _ in mod.explore_dfs(keep, 150)]
        got.append((sched_list, runs))
    assert got[0] == got[1]
    assert len(got[1][0]) == len({tuple(s) for s in got[1][0]})


def test_deadlock_abba_minimal():
    def run_with(decide):
        with sched.Scheduler(decide) as s:
            a, b = make_lock("A"), make_lock("B")

            def t1():
                with a:
                    with b:
                        pass

            def t2():
                with b:
                    with a:
                        pass

            s.spawn("t1", t1)
            s.spawn("t2", t2)
            return s.run()

    deadlocks = [o.deadlock for _, o in sched.explore_dfs(run_with, 500)
                 if o.deadlock is not None]
    assert deadlocks, "AB/BA deadlock not found"
    assert "t1" in deadlocks[0] and "t2" in deadlocks[0]
    assert "'A'" in deadlocks[0] and "'B'" in deadlocks[0]


def test_timed_wait_fires_only_at_quiescence():
    log = []
    with sched.Scheduler(sched.schedule_decider([])) as s:
        cond = make_condition("C")

        def waiter():
            with cond:
                log.append(cond.wait(timeout=0.01))

        s.spawn("w", waiter)
        out = s.run()
    assert not out.failed and log == [False]


def test_untimed_wait_without_notifier_is_deadlock():
    with sched.Scheduler(sched.schedule_decider([])) as s:
        cond = make_condition("C")

        def waiter():
            with cond:
                cond.wait()

        s.spawn("w", waiter)
        out = s.run()
    assert out.deadlock is not None and "no notifier" in out.deadlock


# --------------------------------------------------------------- harness


class _NS:
    """Attribute bag for scenario state."""


class Scenario:
    """One scenario: ``build`` its state (factory locks become the
    scheduler's), its ``workers``, the final state it ``observe``s and
    the invariant ``check`` asserts. ``known_bad`` marks a re-introduced
    race the sweep must find."""

    name = ""
    known_bad = False

    def build(self) -> Any:
        raise NotImplementedError

    def workers(self, st: Any) -> List[Tuple[str, Callable[[], None]]]:
        raise NotImplementedError

    def observe(self, st: Any) -> Any:
        return None

    def check(self, st: Any) -> None:
        pass


class RunResult:
    def __init__(self, kind: str, detail: str, schedule: List[int],
                 obs: Any) -> None:
        self.kind = kind  # ok | exception | deadlock | invariant | divergence
        self.detail = detail
        self.schedule = schedule
        self.obs = obs

    @property
    def failed(self) -> bool:
        return self.kind != "ok"

    def __repr__(self) -> str:
        return f"<{self.kind} schedule={self.schedule} {self.detail}>"


def _run(scn: Scenario, decide) -> Tuple[sched.Outcome, RunResult]:
    with sched.Scheduler(decide) as s:
        st = scn.build()
        for name, fn in scn.workers(st):
            s.spawn(name, fn)
        out = s.run()
        if out.deadlock is not None:
            return out, RunResult("deadlock", out.deadlock, out.schedule,
                                  None)
        if out.errors:
            return out, RunResult("exception", "; ".join(out.errors),
                                  out.schedule, None)
        obs = scn.observe(st)
        try:
            scn.check(st)
        except AssertionError as e:
            return out, RunResult("invariant", str(e), out.schedule, obs)
    return out, RunResult("ok", "", out.schedule, obs)


def _key(obs: Any) -> str:
    return json.dumps(obs, sort_keys=True, default=repr)


_ORACLE: Dict[str, List[str]] = {}


def sequential_outcomes(scn: Scenario) -> List[str]:
    """The final states of every thread-priority order (each run lets
    the highest-priority runnable thread go until it blocks or ends);
    orders whose run fails are left out, and one at least must pass."""
    if scn.name in _ORACLE:
        return _ORACLE[scn.name]
    with sched.Scheduler(sched.schedule_decider([])):
        n = len(scn.workers(scn.build()))
    allowed: List[str] = []
    for perm in itertools.permutations(range(n)):
        rank = {t: i for i, t in enumerate(perm)}

        def decide(step, ids, rank=rank):
            return min(range(len(ids)), key=lambda j: rank[ids[j]])

        _, r = _run(scn, decide)
        if not r.failed and _key(r.obs) not in allowed:
            allowed.append(_key(r.obs))
    assert allowed, f"{scn.name}: every sequential order failed"
    _ORACLE[scn.name] = allowed
    return allowed


def judge(scn: Scenario, r: RunResult) -> RunResult:
    if r.failed or _key(r.obs) in sequential_outcomes(scn):
        return r
    return RunResult("divergence",
                     f"final state {_key(r.obs)} matches no sequential "
                     f"order", r.schedule, r.obs)


def sweep(scn: Scenario, budget: int) -> Tuple[int, List[RunResult]]:
    """(runs, failures) of the breadth-first sweep under ``budget``."""
    failures: List[RunResult] = []

    def run_keep(decide):
        out, r = _run(scn, decide)
        r = judge(scn, r)
        if r.failed:
            failures.append(r)
        return out

    return len(sched.explore_dfs(run_keep, budget)), failures


# ------------------------------------------------------------- scenarios


class CoalescerDoubleBuffer(Scenario):
    """The coalescer's depth-1 pipelined hand-off (``_pl_pending`` and
    ``_pl_cond`` in server/coalescer.py): two producers contend for the
    one pending slot, the finalizer drains it. Both items are processed
    once and the slot ends empty."""

    name = "coalescer_double_buffer"

    def build(self):
        st = _NS()
        st.cond = make_condition("QueryCoalescer._pl_cond")
        st.pending: Optional[int] = None
        st.processed: List[int] = []
        return st

    def workers(self, st):
        def producer(item):
            def fn():
                with st.cond:
                    while st.pending is not None:
                        st.cond.wait(timeout=0.1)
                    st.pending = item
                    st.cond.notify_all()
            return fn

        def finalizer():
            for _ in range(2):
                while True:
                    with st.cond:
                        if st.pending is not None:
                            item = st.pending
                            break
                        st.cond.wait(timeout=0.1)
                st.processed.append(item)
                with st.cond:
                    st.pending = None
                    st.cond.notify_all()

        return [("producer0", producer(0)), ("producer1", producer(1)),
                ("finalizer", finalizer)]

    def observe(self, st):
        return {"processed": sorted(st.processed), "pending": st.pending}

    def check(self, st):
        assert sorted(st.processed) == [0, 1], st.processed
        assert st.pending is None


class ResultCacheStamp(Scenario):
    """The port's ResultCache against a writer bumping a version stamp:
    readers take (stamp, value) under the fragment lock and fill and
    look up with that stamp, so no hit is ever stale."""

    name = "result_cache_stamp"

    def build(self):
        from pilosa_tpu_torch.executor.result_cache import ResultCache
        st = _NS()
        st.cache = ResultCache(max_bytes=1 << 16, enabled=True)
        st.frag_lock = make_lock("Fragment._lock")
        st.version, st.value = 0, "v0"
        st.history = {0: "v0", 1: "v1"}
        st.hits: List[Tuple[int, str]] = []
        return st

    def workers(self, st):
        def reader():
            with st.frag_lock:
                gen, val = st.version, st.value
            st.cache.fill("k", gen, val, 8)
            with st.frag_lock:
                cur = st.version
            hit = st.cache.lookup("k", cur)
            if hit is not None:
                st.hits.append((cur, hit))

        def writer():
            with st.frag_lock:
                st.version, st.value = 1, "v1"

        return [("reader0", reader), ("reader1", reader), ("writer", writer)]

    def observe(self, st):
        return {"version": st.version, "value": st.value}

    def check(self, st):
        for gen, val in st.hits:
            assert st.history[gen] == val, f"stale hit at stamp {gen}"


class LayoutDemotePromote(Scenario):
    """The port's LayoutManager: demote against promote against a read
    staging the view. The layout may flip either way; the data never
    changes, and the counters reconcile."""

    name = "layout_demote_promote"
    DATA = "rows:7"

    def build(self):
        from pilosa_tpu_torch.core.layout import LayoutManager

        class _Frag:
            def optimize_storage(self):
                pass

        class _View:
            index, field, name = "i", "f", "standard"

            def __init__(self):
                self.layout_mode = "dense"
                self.fragments = {0: _Frag()}

            def trimmed_words(self):
                return 1

            def available_shards(self):
                return (0,)

            def set_layout(self, mode):
                changed = self.layout_mode != mode
                sched.checkpoint()
                self.layout_mode = mode
                return changed

            def sparse_bank(self, shards):
                sched.checkpoint()
                if self.layout_mode != "sparse":
                    return None
                bank = _NS()
                bank.n_rows, bank.nbytes = 1, 8
                return bank

        class _Holder:
            indexes: Dict[str, Any] = {}

            def index(self, name):
                return None

        st = _NS()
        st.view = _View()
        st.mgr = LayoutManager(_Holder(), interval_s=0)
        st.staged: List[Tuple[str, str]] = []
        return st

    def workers(self, st):
        def stager():
            mode = st.view.layout_mode
            sched.checkpoint()
            st.staged.append((mode, self.DATA))

        return [("demote", lambda: st.mgr.demote(st.view)),
                ("promote", lambda: st.mgr.promote(st.view)),
                ("stage", stager)]

    def observe(self, st):
        return {"mode": st.view.layout_mode}

    def check(self, st):
        for _mode, data in st.staged:
            assert data == self.DATA
        m = st.mgr
        assert m.demotions + m.demote_failures <= 1
        assert m.promotions <= 1
        assert st.view.layout_mode in ("dense", "sparse")


class BankCacheMissRace(Scenario):
    """A model of the JAX executor's bank-cache miss (no port
    counterpart; see the module docstring): probe under the lock, build
    outside it, re-check and insert (first insert wins) with an LRU
    evict and the ledger under the lock. Both misses get one bank, and
    the ledger mirrors the cache."""

    name = "bank_cache_miss_race"

    def build(self):
        st = _NS()
        st.lock = make_lock("Executor._bank_cache_lock")
        st.cache: Dict[str, Any] = {"old": _NS()}
        st.ledger = {"old"}
        st.max = 2
        st.results: Dict[str, Any] = {}
        return st

    def workers(self, st):
        def get(who, key):
            def fn():
                with st.lock:
                    b = st.cache.get(key)
                if b is not None:
                    st.results[who] = b
                    return
                sched.checkpoint()
                built = _NS()
                with st.lock:
                    cur = st.cache.get(key)
                    if cur is not None:
                        st.results[who] = cur
                        return
                    while len(st.cache) >= st.max:
                        victim = next(iter(st.cache))
                        st.cache.pop(victim)
                        st.ledger.discard(victim)
                    st.cache[key] = built
                    st.ledger.add(key)
                st.results[who] = built
            return fn

        return [("miss0", get("miss0", "a")), ("miss1", get("miss1", "a"))]

    def observe(self, st):
        return {"same": st.results["miss0"] is st.results["miss1"],
                "ledger_matches": st.ledger == set(st.cache)}

    def check(self, st):
        assert st.results["miss0"] is st.results["miss1"]
        assert st.ledger == set(st.cache)


class ClusterRouteAdopt(Scenario):
    """The port's Cluster: ``route_shards`` (the RESIZING check atomic
    with placement) against a join that pins the old placement before
    adding the member. Every shard routes to n1, where the data is."""

    name = "cluster_route_adopt"

    def build(self):
        from pilosa_tpu_torch.parallel.cluster import Cluster, Node
        st = _NS()
        st.c = Cluster(Node("n1", "http://a", True), replica_n=1)
        st.c.set_state("NORMAL")
        st.n2 = Node("n2", "http://b", False)
        st.routed: List[str] = []
        return st

    def workers(self, st):
        def router():
            by_node, _prev = st.c.route_shards("i", list(range(8)))
            st.routed.extend(sorted(by_node))

        def joiner():
            st.c.begin_resize()
            st.c.add_node(st.n2)

        return [("router", router), ("joiner", joiner)]

    def observe(self, st):
        return {"routed_to": sorted(set(st.routed))}

    def check(self, st):
        assert set(st.routed) <= {"n1"}, sorted(set(st.routed))


class BadResizeTwoStepRoute(ClusterRouteAdopt):
    """Re-introduced: the RESIZING check and the placement as two lock
    acquisitions of the port's Cluster. A join between them routes
    shards to a member that has not pulled."""

    name = "bad_resize_two_step_route"
    known_bad = True

    def workers(self, st):
        from pilosa_tpu_torch.parallel.cluster import STATE_RESIZING

        def router():
            c = st.c
            with c._lock:
                previous = c.state == STATE_RESIZING
            sched.checkpoint()
            by_node = c.shards_by_node("i", list(range(8)),
                                       previous=previous)
            st.routed.extend(sorted(by_node))

        def joiner():
            st.c.begin_resize()
            st.c.add_node(st.n2)

        return [("router", router), ("joiner", joiner)]


class BadBankCacheUnlockedEvict(Scenario):
    """Re-introduced (model): the LRU evict outside the cache lock as
    check-then-act; two racing misses pick one victim and the second
    ``pop`` raises KeyError."""

    name = "bad_bank_cache_unlocked_evict"
    known_bad = True

    def build(self):
        st = _NS()
        st.lock = make_lock("Executor._bank_cache_lock")
        st.cache: Dict[str, Any] = {"old": _NS()}
        st.max = 1
        return st

    def workers(self, st):
        def get(key):
            def fn():
                with st.lock:
                    st.cache[key] = _NS()
                if len(st.cache) > st.max:
                    victim = next(k for k in st.cache if k != key)
                    sched.checkpoint()
                    st.cache.pop(victim)
            return fn

        return [("miss0", get("a")), ("miss1", get("b"))]

    def observe(self, st):
        return {"keys": sorted(st.cache)}


class BadCacheStampThenRead(Scenario):
    """Re-introduced: a reader takes the value, then the stamp, without
    the fragment lock and fills the port's ResultCache with the torn
    pair; a second reader takes a stale hit at the new stamp."""

    name = "bad_cache_stamp_then_read"
    known_bad = True

    def build(self):
        return ResultCacheStamp().build()

    def workers(self, st):
        def torn_reader():
            val = st.value
            sched.checkpoint()
            gen = st.version
            st.cache.fill("k", gen, val, 8)

        def verifier():
            with st.frag_lock:
                gen, val = st.version, st.value
            hit = st.cache.lookup("k", gen)
            assert hit is None or hit == val, f"stale hit at stamp {gen}"

        def writer():
            with st.frag_lock:
                st.version, st.value = 1, "v1"

        return [("torn_reader", torn_reader), ("verifier", verifier),
                ("writer", writer)]

    def observe(self, st):
        return {"version": st.version}


class BadLockOrderABBA(Scenario):
    """Two factory locks taken in opposite orders: the wait-for graph
    must find the deadlock."""

    name = "bad_lock_order_abba"
    known_bad = True

    def build(self):
        st = _NS()
        st.a, st.b = make_lock("A"), make_lock("B")
        return st

    def workers(self, st):
        def t1():
            with st.a:
                with st.b:
                    pass

        def t2():
            with st.b:
                with st.a:
                    pass

        return [("t1", t1), ("t2", t2)]


GOOD = [CoalescerDoubleBuffer(), ResultCacheStamp(), LayoutDemotePromote(),
        BankCacheMissRace(), ClusterRouteAdopt()]
KNOWN_BAD = [BadResizeTwoStepRoute(), BadBankCacheUnlockedEvict(),
             BadCacheStampThenRead(), BadLockOrderABBA()]


def test_the_jax_corpus_is_covered():
    """Every scenario of the JAX package's corpus has its counterpart
    here, good and bad alike."""
    import tools.interleave as il
    assert {s.name for s in il.SCENARIOS} == \
        {s.name for s in GOOD + KNOWN_BAD}
    assert {s.name for s in il.SCENARIOS if s.known_bad} == \
        {s.name for s in KNOWN_BAD}


@pytest.mark.parametrize("scn", GOOD, ids=lambda s: s.name)
def test_good_scenarios_sweep_clean(scn):
    runs, failures = sweep(scn, DEFAULT_BUDGET)
    assert not failures, failures[:3]
    assert runs > 10


@pytest.mark.parametrize("scn", KNOWN_BAD, ids=lambda s: s.name)
def test_known_bad_found_within_default_budget(scn):
    runs, failures = sweep(scn, DEFAULT_BUDGET)
    assert failures, f"{scn.name}: not caught in {runs} schedules"


def test_known_bad_failure_is_replayable():
    """A found schedule reproduces its verdict when replayed, twice."""
    scn = BadBankCacheUnlockedEvict()
    _, failures = sweep(scn, DEFAULT_BUDGET)
    pinned = failures[0]
    kinds = [judge(scn, _run(scn, sched.schedule_decider(
        pinned.schedule))[1]).kind for _ in range(2)]
    assert kinds == [pinned.kind] * 2


def test_seed_index_reproducer_contract():
    """``rng_decider(default_rng([seed, index]))`` gives one schedule."""
    scn = BankCacheMissRace()
    a = _run(scn, sched.rng_decider(np.random.default_rng([7, 3])))[1]
    b = _run(scn, sched.rng_decider(np.random.default_rng([7, 3])))[1]
    assert a.schedule == b.schedule
