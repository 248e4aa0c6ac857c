"""Generation-keyed cross-request query result cache, after the JAX
package's ``executor/result_cache.py``.

Two tiers share one LRU byte budget and one counter set:

- **request tier**: key = the canonical request identity of
  ``utils/fingerprint.request_key`` (the key the coalescer dedups on);
  value = the shaped ``{"results": ...}`` response. A hit revalidates
  the dependency snapshot the fill recorded (every operand view's
  ``version_stamp()``, the row-attribute stores' generations and the
  column translator's size) with host dict reads, so it skips parse,
  plan, launch and fetch.
- **eval tier**: key = ``("eval", index, fingerprint, shard tuple)``,
  the fingerprint being the tree signature, the row ids and the
  predicate values of one terminal eval; generation = the operand
  views' fragment versions over those shards, stamped before the banks
  are read. Value = the eval's host answer (an int count, or the row's
  words as a numpy array). The lookup sits before the batch collector,
  so a cohort whose members all hit never forms; a miss fills from the
  host copy the answer already makes.

Writes invalidate implicitly: a mutation bumps its fragment's version,
the stored generation no longer matches, and the entry is dropped on
its next lookup (or ages out of the LRU).

Counters: hits and misses per tier, evictions, invalidations (exported
as ``pilosa_result_cache_*``); gauges ``bytes``/``entries``/``hit_ratio``
at scrape time; a memory-ledger entry under the host category
``result_cache``. Host-only module: dict work under one leaf lock; the
only nested acquisition is the ledger's (itself a leaf).
``PILOSA_TPU_RESULT_CACHE=0`` is the kill switch; ``[cache]`` config
keys can disable the cache but never re-enable it past the switch.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from pilosa_tpu_torch.utils.locks import make_lock
from pilosa_tpu_torch.utils.memledger import LEDGER

RESULT_CACHE_ENV = "PILOSA_TPU_RESULT_CACHE"
DEFAULT_MAX_BYTES = int(os.environ.get(
    "PILOSA_TPU_RESULT_CACHE_BYTES", 256 << 20))

TIERS = ("request", "eval")


def _env_enabled() -> bool:
    return os.environ.get(RESULT_CACHE_ENV, "1") != "0"


def approx_nbytes(obj: Any) -> int:
    """Cheap recursive host-size estimate of a shaped JSON response —
    the LRU byte budget needs a consistent approximation, not an exact
    figure, and a full json.dumps purely for sizing would double the
    serialization cost of every miss (the HTTP layer serializes the
    same dict again right after)."""
    if isinstance(obj, str):
        return 48 + len(obj)
    if isinstance(obj, (list, tuple)):
        return 56 + 8 * len(obj) + sum(map(approx_nbytes, obj))
    if isinstance(obj, dict):
        return 64 + sum(approx_nbytes(k) + approx_nbytes(v)
                        for k, v in obj.items())
    return 28  # ints/floats/bools/None: CPython small-object cost


class _Entry:
    __slots__ = ("gen", "value", "nbytes", "tier")

    def __init__(self, gen: Any, value: Any, nbytes: int,
                 tier: str) -> None:
        self.gen = gen        # generation snapshot / deps dict
        self.value = value    # shaped dict (request) | host array (eval)
        self.nbytes = int(nbytes)
        self.tier = tier


class ResultCache:
    """LRU byte-budgeted, generation-validated result store (see
    module docstring). One instance per Executor."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 enabled: Optional[bool] = None) -> None:
        self.enabled = _env_enabled() if enabled is None else (
            bool(enabled) and _env_enabled())
        self.max_bytes = max(0, int(max_bytes))
        self._lock = make_lock("ResultCache._lock")
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self.bytes = 0
        # Cumulative counters, per tier + derived totals. Kept on the
        # cache (not only in stats) so embedded users and tests read
        # them without a stats client.
        self.hits: Dict[str, int] = {t: 0 for t in TIERS}
        self.misses: Dict[str, int] = {t: 0 for t in TIERS}
        self.evictions = 0
        self.invalidations = 0  # stale entries dropped on lookup
        # Entries dropped because a resize moved their shards' ownership
        # (API._note_placement_change — the placement epoch guard).
        self.placement_invalidations = 0
        # Optional utils/stats sink (attached by the API layer, the
        # WORKLOAD.stats convention) so /metrics counters increment at
        # event time and stay true monotone counters.
        self.stats: Optional[Any] = None

    # ---------------------------------------------------------- config

    def configure(self, enabled: Optional[bool] = None,
                  max_bytes: Optional[int] = None) -> None:
        """[cache] config wiring. The env kill switch always wins:
        config can disable a cache the env allows, never the reverse."""
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled) and _env_enabled()
            if max_bytes is not None:
                self.max_bytes = max(0, int(max_bytes))
                self._evict_over_budget()
                self._ledger()  # a shrink evicts; keep /debug/memory true

    # --------------------------------------------------------- helpers

    def _count(self, name: str, tier: str) -> None:
        stats = self.stats
        if stats is not None:
            stats.count(f"result_cache.{name}", 1)
            stats.count(f"result_cache.{tier}.{name}", 1)

    def _note_hit(self, tier: str) -> None:
        # graftlint: disable=GL008 — closed key space: both counter
        # dicts are pre-seeded with exactly the TIERS keys and only
        # ever incremented, never grown.
        self.hits[tier] += 1
        self._count("hits", tier)

    def _note_miss(self, tier: str) -> None:
        # graftlint: disable=GL008 — same closed TIERS key space.
        self.misses[tier] += 1
        self._count("misses", tier)

    def _ledger(self) -> None:
        # Lock held (ledger lock is a leaf — the _jit_put precedent):
        # the aggregate entry tracks the cache's live host bytes so
        # /debug/memory totals include it and the watchdog's flight
        # recorder samples it without polling us.
        LEDGER.register("result_cache", "entries", self.bytes,
                        owner=self, entries=len(self._entries))

    def _drop_locked(self, key: Any, entry: _Entry) -> None:
        self._entries.pop(key, None)
        self.bytes -= entry.nbytes

    def _evict_over_budget(self) -> None:
        while self._entries and self.bytes > self.max_bytes:
            _, old = self._entries.popitem(last=False)
            self.bytes -= old.nbytes
            self.evictions += 1
            self._count("evictions", old.tier)

    # ----------------------------------------------------------- reads

    def lookup(self, key: Any, gen: Any, tier: str = "eval"
               ) -> Optional[Any]:
        """Eval-tier lookup: hit iff the stored generation equals
        `gen` exactly. A stale entry is dropped immediately (its bytes
        are dead weight — the generation can never match again)."""
        if not self.enabled:
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.gen == gen:
                self._entries.move_to_end(key)
                self._note_hit(tier)
                return e.value
            if e is not None:
                self._drop_locked(key, e)
                self.invalidations += 1
                self._ledger()
            self._note_miss(tier)
            return None

    def lookup_request(self, key: Any,
                       validate: Callable[[Dict[Any, Any]], bool]
                       ) -> Optional[Any]:
        """Request-tier lookup: the entry's stored dependency snapshot
        is revalidated by `validate` (holder version-stamp reads). The
        validator runs OUTSIDE the cache lock — it takes view locks,
        and holding ours across that would invert against nothing
        today but costs nothing to keep leaf-clean."""
        if not self.enabled:
            return None
        with self._lock:
            e = self._entries.get(key)
            deps = e.gen if e is not None else None
            value = e.value if e is not None else None
        if e is None:
            with self._lock:
                self._note_miss("request")
            return None
        if validate(deps):
            with self._lock:
                if self._entries.get(key) is e:
                    self._entries.move_to_end(key)
                self._note_hit("request")
            return value
        with self._lock:
            cur = self._entries.get(key)
            if cur is e:
                self._drop_locked(key, e)
                self.invalidations += 1
                self._ledger()
            self._note_miss("request")
        return None

    # ---------------------------------------------------------- writes

    def fill(self, key: Any, gen: Any, value: Any, nbytes: int,
             tier: str = "eval") -> None:
        if not self.enabled or self.max_bytes <= 0:
            return
        nbytes = max(0, int(nbytes))
        if nbytes > self.max_bytes:
            return  # one oversized value must not flush the cache
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[key] = _Entry(gen, value, nbytes, tier)
            self.bytes += nbytes
            self._evict_over_budget()
            self._ledger()

    def clear(self) -> None:
        with self._lock:
            self._entries = OrderedDict()
            self.bytes = 0
            self._ledger()

    def invalidate_placement(self, moved: Any) -> int:
        """Drop eval-tier entries whose shard tuple intersects `moved`
        (a set of ``(index, shard)`` pairs whose owner set changed in a
        resize — API._moved_shards). The generation stamps already make
        a stale HIT impossible; this makes the dead bytes provably gone
        at the placement transition instead of lingering until an LRU
        eviction. Request-tier entries are untouched: that tier only
        fills on non-clustered deployments (no placement to move).
        Returns the number of entries dropped."""
        if not moved:
            return 0
        moved = {(str(i), int(s)) for i, s in moved}
        with self._lock:
            dead = []
            for key, e in self._entries.items():
                if not (isinstance(key, tuple) and len(key) >= 4
                        and key[0] == "eval"):
                    continue
                iname, shard_tuple = key[1], key[3]
                if any((iname, int(s)) in moved for s in shard_tuple):
                    dead.append((key, e))
            for key, e in dead:
                self._drop_locked(key, e)
            if dead:
                self.placement_invalidations += len(dead)
                self.invalidations += len(dead)
                self._ledger()
            return len(dead)

    # ------------------------------------------------------- reporting

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        """The /debug/hotspots `resultCache` stanza: observed hit
        ratios the opportunity estimator's predictions are judged
        against."""
        with self._lock:
            hits = dict(self.hits)
            misses = dict(self.misses)
            h = sum(hits.values())
            m = sum(misses.values())
            return {
                "enabled": self.enabled,
                "bytes": self.bytes,
                "maxBytes": self.max_bytes,
                "entries": len(self._entries),
                "hits": h,
                "misses": m,
                "hitRatio": (h / (h + m)) if (h + m) else 0.0,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "placementInvalidations": self.placement_invalidations,
                "tiers": {t: {"hits": hits[t], "misses": misses[t]}
                          for t in TIERS},
            }

    def publish(self, stats: Optional[Any]) -> None:
        """Scrape-time gauges (counters were incremented at event
        time): pilosa_result_cache_bytes / _entries / _hit_ratio."""
        if stats is None:
            return
        snap = self.snapshot()
        stats.gauge("result_cache.bytes", snap["bytes"])
        stats.gauge("result_cache.entries", snap["entries"])
        stats.gauge("result_cache.hit_ratio", snap["hitRatio"])
